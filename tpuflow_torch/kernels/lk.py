"""Fused Lucas-Kanade refinement step: the relaxed-order kernel and its
plain PyTorch version.

Counterpart of ``tpuflow.kernels.pallas_lk.lucas_kanade_refine`` with
``relaxed_order=True`` (K3): residual LK between ``frame_prev`` and the
warped current frame, the carried flow clipped to the band, the residual
accumulated unless ``converged``, and sum|du|, sum|dv| for the early-exit
test, in one pass. The CUDA kernel is ``csrc/lk_refine.cu``;
``lucas_kanade_refine_ref`` is the same function in plain PyTorch (separable
Sobel, shift-tree window sums, reciprocal-form solve, in the Pallas
kernel's f32 order), and is what ``lucas_kanade_refine`` runs for a tensor
on the CPU.
"""

from __future__ import annotations

import torch

from tpuflow_torch.kernels import _build

# Kernel launches; incremented only where the kernel is launched.
launch_counts = {"lk_refine": 0}


def _pad_frame(f: torch.Tensor, zeros: int) -> torch.Tensor:
    """Symmetric pad by 1 (edge included), then ``zeros`` rows/cols of 0."""
    f = torch.cat([f[:1], f, f[-1:]], dim=0)
    f = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    return torch.nn.functional.pad(f, (zeros, zeros, zeros, zeros))


def _sliding_sum_tree(a: torch.Tensor, w: int, out_rows: int, out_cols: int):
    """Sliding w-tap window sum over both axes by pairwise doubling, in the
    order of ``pallas_lk._sliding_sum_tree``: runs of 1, 2, 4, ... taps,
    then the binary decomposition of w, largest run first."""

    def axis_sum(x: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
        full = x.shape[axis]
        runs = {1: x}
        c = 1
        while c * 2 <= w:
            r = runs[c]
            ln = full - 2 * c + 1
            runs[2 * c] = r.narrow(axis, 0, ln) + r.narrow(axis, c, ln)
            c *= 2
        out = None
        off, rem = 0, w
        for size in sorted(runs, reverse=True):
            while rem >= size:
                piece = runs[size].narrow(axis, off, out_len)
                out = piece if out is None else out + piece
                off += size
                rem -= size
        return out

    return axis_sum(axis_sum(a, 0, out_rows), 1, out_cols)


def lucas_kanade_refine_ref(
    frame_prev: torch.Tensor,
    warped: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    converged: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    max_disp: float = 8.0,
    max_disp_v: float | None = None,
):
    """Plain PyTorch version of the relaxed-order refine kernel.

    Returns ``(u_next, v_next, sum|du|, sum|dv|)``, the sums as 0-d
    tensors on the input's device.
    """
    if max_disp_v is None:
        max_disp_v = max_disp
    h, w = frame_prev.shape
    half = window_size // 2
    # Padded frames hold image rows/cols -(half+1) .. N+half.
    p = _pad_frame(frame_prev, half)
    c = _pad_frame(warped, half)
    gh, gw = h + 2 * half, w + 2 * half

    avg = (p + c) * 0.5
    # Separable Sobel: [1,2,1] / [1,0,-1] down the rows over all columns,
    # then across the columns.
    sv = avg[0:gh] + 2.0 * avg[1 : gh + 1] + avg[2 : gh + 2]
    dv = avg[0:gh] - avg[2 : gh + 2]
    ix = (sv[:, 0:gw] - sv[:, 2 : gw + 2]) * 0.125
    iy = (dv[:, 0:gw] + 2.0 * dv[:, 1 : gw + 1] + dv[:, 2 : gw + 2]) * 0.125
    it = p[1 : gh + 1, 1 : gw + 1] - c[1 : gh + 1, 1 : gw + 1]

    def wsum(a):
        return _sliding_sum_tree(a, window_size, h, w)

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    b0 = -wsum(ix * it)
    b1 = -wsum(iy * it)

    det = s_xx * s_yy - s_xy * s_xy
    solvable = det.abs() > det_threshold
    zero = torch.zeros_like(det)
    one = torch.ones_like(det)
    inv = torch.where(solvable, one / torch.where(solvable, det, one), zero)
    du = (s_yy * b0 - s_xy * b1) * inv
    dv = (s_xx * b1 - s_xy * b0) * inv

    rows = torch.arange(h, device=det.device)[:, None]
    cols = torch.arange(w, device=det.device)[None, :]
    interior = (rows >= half) & (rows < h - half) & (cols >= half) & (cols < w - half)
    du = torch.where(interior, du, zero)
    dv = torch.where(interior, dv, zero)

    u_c = flow_u.clamp(-max_disp, max_disp)
    v_c = flow_v.clamp(-max_disp_v, max_disp_v)
    frozen = converged.reshape(()).to(torch.bool)
    u_next = torch.where(frozen, u_c, u_c + du)
    v_next = torch.where(frozen, v_c, v_c + dv)
    return u_next, v_next, du.abs().sum(), dv.abs().sum()


def lucas_kanade_refine(
    frame_prev: torch.Tensor,
    warped: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    converged: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    max_disp: float = 8.0,
    max_disp_v: float | None = None,
):
    """Relaxed-order refine step: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``converged`` is a 0-d bool tensor on
    the same device (read by the kernel, never by the host)."""
    if max_disp_v is None:
        max_disp_v = max_disp
    if window_size != 5:
        raise NotImplementedError(
            "the relaxed-order refine kernel is built for a 5x5 window"
        )
    planes = (frame_prev, warped, flow_u, flow_v)
    if frame_prev.ndim != 2 or any(t.shape != frame_prev.shape for t in planes):
        raise ValueError("frames and flow must share one (H, W) shape")
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"float32 expected, got {t.dtype}")
    if converged.dtype != torch.bool or converged.numel() != 1:
        raise TypeError("converged must be a one-element bool tensor")
    if any(t.device != frame_prev.device for t in (*planes, converged)):
        raise ValueError("all inputs must lie on one device")
    args = (window_size, det_threshold, float(max_disp), float(max_disp_v))
    if frame_prev.device.type == "cpu":
        return lucas_kanade_refine_ref(frame_prev, warped, flow_u, flow_v, converged, *args)
    if frame_prev.device.type != "cuda":
        raise ValueError(f"unsupported device {frame_prev.device}")
    if not all(t.is_contiguous() for t in (*planes, converged)):
        raise ValueError("the CUDA refine needs contiguous tensors")

    lib = _build.load()
    h, w = frame_prev.shape
    u_out = torch.empty_like(flow_u)
    v_out = torch.empty_like(flow_v)
    n_blocks = lib.tpuflow_lk_refine_blocks(h, w)
    parts = torch.empty((2, n_blocks), dtype=torch.float32, device=frame_prev.device)
    stream = torch.cuda.current_stream(frame_prev.device).cuda_stream
    code = lib.tpuflow_lk_refine(
        frame_prev.data_ptr(), warped.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(),
        converged.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(), h, w,
        float(det_threshold), float(max_disp), float(max_disp_v), stream,
    )
    _build.check(lib, code, "lk_refine")
    launch_counts["lk_refine"] += 1
    sums = parts.sum(dim=1)
    return u_out, v_out, sums[0], sums[1]
