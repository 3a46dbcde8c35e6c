"""The S8.7 datapath's int32 shift wrap, for the tests and chip_smoke.py.

``tpuflow_torch.kernels.fixed_point.lucas_kanade_s87`` computes
``num << 7`` and the division in int32, as the JAX package's code does
without ``jax_enable_x64``. These helpers recompute the datapath's S32
terms on their own to count the solvable pixels where that shift wraps
(``|num| >= 2**24``), and to give the flow with the shift and division
widened to int64, as the JAX package's docstring describes it: the
witness that int32 and int64 differ on textured frames. Where nothing
wraps, the widened flow equals the shipped one, which the tests check.
"""

import torch
import torch.nn.functional as F

from tpuflow_torch.kernels.fixed_point import DET_THRESHOLD, FLOW_CLAMP, FRAC_BITS


def s32_terms(f0: torch.Tensor, f1: torch.Tensor, window_size: int = 5):
    """The S32 det and numerators (int32, wrapped) and the solvable gate."""
    p, c = f0.to(torch.int32), f1.to(torch.int32)
    avg = (p + c) >> 1
    gh, gw = p.shape[0] - 2, p.shape[1] - 2

    def sh(a, dy, dx):
        return a[1 + dy : 1 + dy + gh, 1 + dx : 1 + dx + gw]

    ix = (sh(avg, -1, 1) + 2 * sh(avg, 0, 1) + sh(avg, 1, 1)
          - sh(avg, -1, -1) - 2 * sh(avg, 0, -1) - sh(avg, 1, -1)) >> 3
    iy = (sh(avg, 1, -1) + 2 * sh(avg, 1, 0) + sh(avg, 1, 1)
          - sh(avg, -1, -1) - 2 * sh(avg, -1, 0) - sh(avg, -1, 1)) >> 3
    it = sh(p, 0, 0) - sh(c, 0, 0)
    oh, ow = gh - 2 * (window_size // 2), gw - 2 * (window_size // 2)

    def wsum(a):
        return sum(a[dy : dy + oh, dx : dx + ow]
                   for dy in range(window_size) for dx in range(window_size))

    s_xx, s_yy, s_xy = wsum(ix * ix), wsum(iy * iy), wsum(ix * iy)
    s_xt, s_yt = wsum(ix * it), wsum(iy * it)
    det = s_xx * s_yy - s_xy * s_xy
    num_u = s_yy * s_xt - s_xy * s_yt
    num_v = s_xx * s_yt - s_xy * s_xt
    return det, num_u, num_v, (det > DET_THRESHOLD) | (det < -DET_THRESHOLD)


def shift_wraps(f0: torch.Tensor, f1: torch.Tensor, window_size: int = 5) -> int:
    """Solvable pixels where ``num_u << 7`` or ``num_v << 7`` wraps in int32."""
    _, num_u, num_v, solvable = s32_terms(f0, f1, window_size)
    lim = 1 << (31 - FRAC_BITS)
    wraps = (num_u < -lim) | (num_u >= lim) | (num_v < -lim) | (num_v >= lim)
    return int((solvable & wraps).sum())


def lucas_kanade_s87_widened(f0: torch.Tensor, f1: torch.Tensor, window_size: int = 5):
    """The S8.7 flow with ``num << 7`` and the truncating division in int64."""
    det, num_u, num_v, solvable = s32_terms(f0, f1, window_size)
    det = torch.where(solvable, det, torch.ones_like(det)).to(torch.int64)
    pad = (window_size // 2 + 1,) * 4
    out = []
    for num in (num_u.to(torch.int64) << FRAC_BITS, num_v.to(torch.int64) << FRAC_BITS):
        q = torch.sign(num) * torch.sign(det) * (torch.abs(num) // torch.abs(det))
        q = torch.where(solvable, q.clamp(-FLOW_CLAMP, FLOW_CLAMP), 0)
        out.append(F.pad(q.to(torch.float32) / (1 << FRAC_BITS), pad))
    return tuple(out)
