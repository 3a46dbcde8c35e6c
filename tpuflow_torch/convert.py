"""Carry configuration and stream state over from the JAX package.

The flow system has no learned weights; what crosses over is a
``PyramidConfig`` and the pyramid a stream carries from one frame to the
next. With both, a stream started in ``tpuflow`` continues here:
``np.asarray`` each level of ``tpuflow``'s ``build_gaussian_pyramid`` and
hand the list to ``pyramid_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch

from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.eval.timing import require_cuda

_FIELDS = tuple(f.name for f in dataclasses.fields(PyramidConfig))


def config_from_reference(cfg: Any) -> PyramidConfig:
    """This package's ``PyramidConfig`` from any object or mapping that has
    ``PyramidConfig``'s fields (such as ``tpuflow.core.config.PyramidConfig``).
    Missing fields raise."""
    if isinstance(cfg, Mapping):
        missing = [f for f in _FIELDS if f not in cfg]
        values = {f: cfg[f] for f in _FIELDS if f in cfg}
    else:
        missing = [f for f in _FIELDS if not hasattr(cfg, f)]
        values = {f: getattr(cfg, f) for f in _FIELDS if hasattr(cfg, f)}
    if missing:
        raise ValueError(f"config lacks PyramidConfig fields: {missing}")
    if values["adaptive_v_bands"] is not None:
        values["adaptive_v_bands"] = tuple(values["adaptive_v_bands"])
    return PyramidConfig(**values)


def pyramid_from_numpy(
    levels: Sequence[np.ndarray], device: torch.device | str | None = None
) -> list[torch.Tensor]:
    """A pyramid carry from (H, W) arrays ordered coarse first: float32,
    contiguous, on ``device``: the card unless the caller names another;
    raises without a card."""
    device = require_cuda() if device is None else torch.device(device)
    out = []
    for i, level in enumerate(levels):
        a = np.asarray(level)
        if a.ndim != 2:
            raise ValueError(f"level {i} has shape {a.shape}; (H, W) expected")
        if out and (out[-1].shape[0] > a.shape[0] or out[-1].shape[1] > a.shape[1]):
            raise ValueError("levels must be ordered coarse first")
        out.append(torch.from_numpy(np.array(a, np.float32)).to(device))
    return out
