"""S8.7 fixed-point Lucas-Kanade: the reference accelerator's integer
datapath, as torch int32 ops (the RTL numerics mode).

The port of ``tpuflow.kernels.fixed_point``, bit for bit:

- frame average ``(prev + curr) >> 1`` (integer floor);
- Sobel column/row sums, then an arithmetic ``>> 3`` (floor toward -inf),
  S12 gradients; the temporal difference on the center pixel;
- window sums of the five S12xS12 product planes into S32;
- det and numerators as S32xS32 products wrapped to 32 bits;
- the ``|det| > 1000`` gate, ``(num << 7) / det`` as a truncating signed
  division, and the clamp to +-1024 (+-8.0 px in S8.7);
- a zero border of ``half + 1`` pixels.

Everything is int32 with two's-complement wraparound, on the CPU and on
the card alike. The reference widens ``num`` and ``det`` with
``astype(jnp.int64)`` before ``num << 7``, but JAX without
``jax_enable_x64`` (which the repo never sets) gives int32 there, so its
shift wraps once ``|num| >= 2**24`` and its division is int32. This port
computes what the reference computes; widening to int64 would differ from
it on textured frames (ROADMAP divergence h).

The reference computes this in jnp, not Pallas, so there is no
hand-written kernel: these are plain torch ops on the frames' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DET_THRESHOLD = 1000
FRAC_BITS = 7
FLOW_CLAMP = 1024  # +-8.0 px in S8.7


def _trunc_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """SystemVerilog signed '/': truncation toward zero, in the operands'
    int32, as the reference's ``sign * sign * (|num| // |den|)``."""
    q = torch.abs(num) // torch.abs(den)
    return torch.sign(num) * torch.sign(den) * q


def lucas_kanade_s87(
    frame_prev_u8: torch.Tensor,
    frame_curr_u8: torch.Tensor,
    window_size: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RTL-datapath dense flow.

    Inputs: (H, W) uint8 frames, on any device. Returns float32 (u, v) in
    pixels (S8.7 codes divided by 128), on the frames' device.
    """
    p = frame_prev_u8.to(torch.int32)
    c = frame_curr_u8.to(torch.int32)
    h, w = p.shape
    avg = (p + c) >> 1  # 9-bit integer average, floor

    # 3x3 Sobel region (interior only, like the streaming line buffers).
    gh, gw = h - 2, w - 2

    def sh(a, dy, dx):
        return a[1 + dy : 1 + dy + gh, 1 + dx : 1 + dx + gw]

    sob_x = (
        -sh(avg, -1, -1) - 2 * sh(avg, 0, -1) - sh(avg, 1, -1)
        + sh(avg, -1, 1) + 2 * sh(avg, 0, 1) + sh(avg, 1, 1)
    )
    ix = sob_x >> 3  # arithmetic shift: floor division by 8
    sob_y = (
        -sh(avg, -1, -1) - 2 * sh(avg, -1, 0) - sh(avg, -1, 1)
        + sh(avg, 1, -1) + 2 * sh(avg, 1, 0) + sh(avg, 1, 1)
    )
    iy = sob_y >> 3
    it = sh(p, 0, 0) - sh(c, 0, 0)

    # Window sums of the five S12xS12 product planes -> S32 (wrapping
    # adds, so their order does not change the bits).
    half = window_size // 2
    oh, ow = gh - 2 * half, gw - 2 * half

    def wsum(a):
        out = a[0:oh, 0:ow]
        for dy in range(window_size):
            for dx in range(window_size):
                if dy or dx:
                    out = out + a[dy : dy + oh, dx : dx + ow]
        return out

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    s_xt = wsum(ix * it)
    s_yt = wsum(iy * it)

    # The RTL keeps the low 32 bits of each 64-bit product: int32
    # wraparound multiplication.
    det = s_xx * s_yy - s_xy * s_xy
    num_u = s_yy * s_xt - s_xy * s_yt
    num_v = s_xx * s_yt - s_xy * s_xt

    solvable = (det > DET_THRESHOLD) | (det < -DET_THRESHOLD)
    safe_det = torch.where(solvable, det, torch.ones_like(det))
    fu = _trunc_div(num_u << FRAC_BITS, safe_det)  # int32: wraps as the reference's
    fv = _trunc_div(num_v << FRAC_BITS, safe_det)
    fu = torch.where(solvable, fu.clamp(-FLOW_CLAMP, FLOW_CLAMP), 0)
    fv = torch.where(solvable, fv.clamp(-FLOW_CLAMP, FLOW_CLAMP), 0)

    pad = (half + 1,) * 4
    u = F.pad(fu.to(torch.float32) / (1 << FRAC_BITS), pad)
    v = F.pad(fv.to(torch.float32) / (1 << FRAC_BITS), pad)
    return u, v


def box_downsample_2x(frame_u8: torch.Tensor) -> torch.Tensor:
    """The RTL pyramid stage's 2x2 box-average downsample: the integer
    mean of each 2x2 block, floor, in the input's dtype."""
    f = frame_u8.to(torch.int32)
    h, w = f.shape
    blocks = f[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    return (blocks.sum(dim=(1, 3), dtype=torch.int32) >> 2).to(frame_u8.dtype)
