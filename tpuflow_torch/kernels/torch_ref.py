"""Plain PyTorch reference functions for Lucas-Kanade dense flow.

Counterpart of ``tpuflow.kernels.jnp_ref``, function for function and in
the same f32 expression order: Sobel/8 on the averaged frame (true
convolution, symmetric boundary), ``It = prev - curr``, unweighted window
sums over fully-interior windows with zero border flow, the Cramer solve in
divide form gated on ``|det| > det_threshold``, the ``map_coordinates``
backward warp, and the linspace pyramid resampling.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import ops

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32) / 8.0
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32) / 8.0


def compute_gradients(
    frame_prev: torch.Tensor, frame_curr: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatial Sobel gradients of the averaged frame + temporal difference."""
    frame_avg = (frame_prev + frame_curr) / 2.0
    ix = ops.conv2d_symm(frame_avg, SOBEL_X)
    iy = ops.conv2d_symm(frame_avg, SOBEL_Y)
    it = frame_prev - frame_curr
    return ix, iy, it


def lucas_kanade_from_gradients(
    ix: torch.Tensor,
    iy: torch.Tensor,
    it: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
):
    """Windowed least-squares flow solve (structure tensor + Cramer).

    Flow is zero on the ``window//2`` border and wherever
    ``|det| <= det_threshold``. ``return_confidence`` adds the |det| plane
    (zero on the border).
    """
    half = window_size // 2

    if gaussian_weights:
        wk = ops.gaussian_window_kernel(window_size, weight_sigma)

        def wsum(a):
            return ops.weighted_window_sum_valid(a, wk)
    else:
        def wsum(a):
            return ops.uniform_window_sum_valid(a, window_size)

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    s_xt = wsum(ix * it)
    s_yt = wsum(iy * it)

    det = s_xx * s_yy - s_xy * s_xy
    b0 = -s_xt
    b1 = -s_yt

    solvable = det.abs() > det_threshold
    safe_det = torch.where(solvable, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    u_in = torch.where(solvable, (s_yy * b0 - s_xy * b1) / safe_det, zero)
    v_in = torch.where(solvable, (s_xx * b1 - s_xy * b0) / safe_det, zero)

    pad = (half, half, half, half)
    u = torch.nn.functional.pad(u_in, pad)
    v = torch.nn.functional.pad(v_in, pad)
    if return_confidence:
        return u, v, torch.nn.functional.pad(det.abs(), pad)
    return u, v


def warp_image(
    image: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor
) -> torch.Tensor:
    """Bilinear backward warp: out(x, y) = image(x + u, y + v), OOB -> 0."""
    h, w = image.shape
    yy = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    return ops.map_coordinates_bilinear(image, yy + flow_v, xx + flow_u, cval=0.0)


def upsample_flow(
    flow_u: torch.Tensor, flow_v: torch.Tensor, target_shape: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear flow upsampling on the linspace grid, then u scaled by
    ``fine_w/coarse_w`` and v by ``fine_h/coarse_h``; (H, W) planes or
    (B, H, W) batches, each plane as alone."""
    ch, cw = flow_u.shape[-2:]
    th, tw = tuple(target_shape)[-2:]
    scale_x = tw / cw
    scale_y = th / ch
    u = ops.resize_bilinear(flow_u, th, tw) * scale_x
    v = ops.resize_bilinear(flow_v, th, tw) * scale_y
    return u, v


def downsample_image(image: torch.Tensor, scale_factor: float = 0.5) -> torch.Tensor:
    """One pyramid step: Gaussian smooth (sigma = 1/scale) then linspace
    bilinear resample to ``int(dim * scale)``, as the fused operator; an
    (H, W) plane or a (B, H, W) batch, each plane as alone."""
    sigma = 1.0 / scale_factor
    h, w = image.shape[-2:]
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    return ops.downsample_fused(image, nh, nw, sigma)


def build_gaussian_pyramid(
    image: torch.Tensor, num_levels: int, scale_factor: float = 0.5
) -> list[torch.Tensor]:
    """Gaussian pyramid, list ordered coarse -> fine (level 0 = coarsest),
    of an (H, W) frame or of each frame of a (B, H, W) batch (then every
    level is (B, h, w))."""
    levels = [image]
    current = image
    for _ in range(num_levels - 1):
        current = downsample_image(current, scale_factor)
        levels.append(current)
    levels.reverse()
    return levels


def ladder_value(band: torch.Tensor | None, ladder: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``ladder[band]`` chosen on the device (no host read; the index
    clamped into the ladder, as the kernels clamp it); ``ladder[0]`` where
    ``band`` is None. The plain versions' form of the band a
    device-controlled round reads: a 0-d tensor for one index, a (B, 1, 1)
    one for a (B,) band (one index a plane of a (B, H, W) batch)."""
    out = torch.full((), ladder[0], dtype=dtype, device=device)
    if band is None:
        return out
    idx = band.reshape(-1, 1, 1) if band.numel() > 1 else band.reshape(())
    idx = idx.clamp(0, len(ladder) - 1)
    for i in range(1, len(ladder)):
        out = torch.where(idx == i, torch.full((), ladder[i], dtype=dtype, device=device), out)
    return out
