"""Single-scale Lucas-Kanade dense flow.

Counterpart of ``tpuflow.flow.single_scale``. ``backend="torch"`` is the
parity path (``"jnp"`` in the JAX package). The fused single-scale CUDA
kernel (the Pallas ``_lk_kernel``) is not ported yet, so
``backend="cuda"`` raises.
"""

from __future__ import annotations

from typing import Literal

import torch

from tpuflow_torch.kernels import torch_ref

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
):
    """Dense (u, v) flow between two grayscale float32 frames: Sobel/8
    gradients on the averaged frame, unweighted ``window_size`` squared
    structure-tensor sums, Cramer solve gated on ``|det| > det_threshold``,
    zero flow on the window border. ``return_confidence`` adds the |det|
    plane."""
    if backend == "cuda":
        raise NotImplementedError(
            "single-scale backend='cuda' needs the fused single-scale LK "
            "kernel (pallas_lk._lk_kernel, K6), which is not ported yet; "
            "use backend='torch'"
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
