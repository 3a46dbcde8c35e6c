"""Single-scale Lucas-Kanade dense flow.

Counterpart of ``tpuflow.flow.single_scale``. ``backend="torch"`` is the
parity path (``"jnp"`` in the JAX package). ``backend="cuda"`` is the fused
single-scale kernel (its ``"pallas"``): ``kernels.lk.lucas_kanade_fused``,
which launches K6 (K7 with ``return_confidence``) for CUDA tensors and runs
its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import Literal

import torch

from tpuflow_torch.kernels import lk, torch_ref

Backend = Literal["torch", "cuda"]
BACKENDS = ("torch", "cuda")


def lucas_kanade_single_scale(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    window_size: int = 5,
    *,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    backend: Backend = "torch",
    return_confidence: bool = False,
    relaxed_order: bool = False,
):
    """Dense (u, v) flow between two grayscale float32 frames: Sobel/8
    gradients on the averaged frame, unweighted ``window_size`` squared
    structure-tensor sums, Cramer solve gated on ``|det| > det_threshold``,
    zero flow on the window border. ``return_confidence`` adds the |det|
    plane. ``relaxed_order=True`` (``"cuda"`` only; the parity path ignores
    it) reassociates the Sobel and window sums, as
    ``PyramidConfig.relaxed_order``."""
    if backend == "cuda":
        return lk.lucas_kanade_fused(
            frame_prev,
            frame_curr,
            window_size=window_size,
            det_threshold=det_threshold,
            gaussian_weights=gaussian_weights,
            return_confidence=return_confidence,
            relaxed_order=relaxed_order,
        )
    if backend != "torch":
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    ix, iy, it = torch_ref.compute_gradients(frame_prev, frame_curr)
    return torch_ref.lucas_kanade_from_gradients(
        ix,
        iy,
        it,
        window_size=window_size,
        det_threshold=det_threshold,
        gaussian_weights=gaussian_weights,
        return_confidence=return_confidence,
    )
