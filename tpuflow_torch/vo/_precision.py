"""True-f32 matmuls for the VO solvers.

Counterpart of ``tpuflow.vo._precision``. On the TPU the reference pins its
Gauss-Newton solvers to HIGHEST matmul precision, because the default bf16
passes walked the convergence-gated solve down another path (``dolly_z``
ATE +407%). The card's version of that demotion is TF32, which keeps about
three decimal digits: a solver decorated here runs with TF32 off for both
matmuls and convolutions (``core.ops.pin_f32_matmul``), and the flags are
restored when it returns.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, TypeVar

import torch

from tpuflow_torch.core import ops

F = TypeVar("F", bound=Callable[..., Any])


def pin_matmul_precision(fn: F) -> F:
    """Run ``fn`` with TF32 off, restoring the caller's flags after."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        ops.pin_f32_matmul()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped  # type: ignore[return-value]
