"""Fused Lucas-Kanade kernels and their plain PyTorch versions.

Counterparts of two ``tpuflow.kernels.pallas_lk`` entry points, each in
both f32 orders and for windows 3, 5 and 7:

- ``lucas_kanade_refine``, one refinement step (``lucas_kanade_refine``):
  residual LK between ``frame_prev`` and the warped current frame, the
  carried flow clipped to the band, the residual accumulated unless
  ``converged``, and sum|du|, sum|dv| for the early-exit test, in one pass.
  ``relaxed_order=True`` is K3 (separable Sobel, shift-tree window sums),
  ``False`` is K5 (direct Sobel, sequential sums).
- ``lucas_kanade_fused``, single-scale flow (``lucas_kanade_fused``):
  (prev, curr) -> (u, v), K6, or (u, v, |det|) with ``return_confidence``,
  K7; uniform or Gaussian-weighted windows.

The CUDA kernels are ``csrc/lk_refine.cu`` and ``csrc/lk_fused.cu`` (one
tile kernel, ``csrc/lk_tile.cuh``). ``lucas_kanade_refine_ref`` and
``lucas_kanade_fused_ref`` are the same functions in plain PyTorch, in the
Pallas kernel's f32 expression order with its reciprocal-form solve, and
are what the wrappers run for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.kernels import _build

WINDOWS = (3, 5, 7)

# Kernel launches; incremented only where a kernel is launched.
launch_counts = {"lk_refine": 0, "lk_refine_exact": 0, "lk_fused": 0, "lk_fused_conf": 0}


def _check_window(window_size: int) -> None:
    # The TPU kernels' slab apron covers Sobel (1) + a window half of 3
    # (pallas_lk.py:671-672, :738-740).
    if window_size not in WINDOWS:
        raise ValueError(
            f"the fused LK kernels support windows {WINDOWS}, got {window_size}; "
            "use backend='torch'"
        )


def _window_taps(window_size: int, weight_sigma: float) -> tuple[float, ...]:
    """1-D separable factor of the Gaussian window, computed in f64 and cast
    to f32 (pallas_lk._window_taps)."""
    r = window_size // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / weight_sigma) ** 2)
    phi /= phi.sum()
    return tuple(float(t) for t in phi.astype(np.float32))


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


def _sliding_sum_sequential(a: torch.Tensor, w: int, out_rows: int, out_cols: int,
                            taps: tuple[float, ...] | None = None):
    """Sliding w-tap window sum, rows then columns, each tap added in turn
    (pallas_lk.py:262-277); ``taps`` weights each tap first."""

    def axis_sum(x: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
        out = None
        for d in range(w):
            piece = x.narrow(axis, d, out_len)
            if taps is not None:
                piece = taps[d] * piece
            out = piece if out is None else out + piece
        return out

    return axis_sum(axis_sum(a, 0, out_rows), 1, out_cols)


def _lk_solve_ref(frame_prev: torch.Tensor, frame_curr: torch.Tensor, window_size: int,
                  det_threshold: float, relaxed_order: bool,
                  taps: tuple[float, ...] | None = None):
    """The tile math of ``pallas_lk._lk_tile`` over the whole frame: the
    interior-masked (du, dv), det, and the interior mask."""
    h, w = frame_prev.shape
    half = window_size // 2
    # Padded frames hold image rows/cols -(half+1) .. N+half.
    p = _pad_frame(frame_prev, half)
    c = _pad_frame(frame_curr, half)
    gh, gw = h + 2 * half, w + 2 * half

    avg = (p + c) * 0.5
    if relaxed_order:
        # Separable Sobel: [1,2,1] / [1,0,-1] down the rows over all columns,
        # then across the columns.
        sv = avg[0:gh] + 2.0 * avg[1 : gh + 1] + avg[2 : gh + 2]
        dv = avg[0:gh] - avg[2 : gh + 2]
        ix = (sv[:, 0:gw] - sv[:, 2 : gw + 2]) * 0.125
        iy = (dv[:, 0:gw] + 2.0 * dv[:, 1 : gw + 1] + dv[:, 2 : gw + 2]) * 0.125
    else:
        def sh(dy: int, dx: int) -> torch.Tensor:
            return avg[1 + dy : 1 + dy + gh, 1 + dx : 1 + dx + gw]

        ix = (
            (sh(-1, -1) - sh(-1, 1)) + 2.0 * (sh(0, -1) - sh(0, 1)) + (sh(1, -1) - sh(1, 1))
        ) * 0.125
        iy = (
            (sh(-1, -1) - sh(1, -1)) + 2.0 * (sh(-1, 0) - sh(1, 0)) + (sh(-1, 1) - sh(1, 1))
        ) * 0.125
    it = p[1 : gh + 1, 1 : gw + 1] - c[1 : gh + 1, 1 : gw + 1]

    def wsum(a):
        if taps is None and relaxed_order:
            return _sliding_sum_tree(a, window_size, h, w)
        return _sliding_sum_sequential(a, window_size, h, w, taps)

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
    return torch.where(interior, du, zero), torch.where(interior, dv, zero), det, interior


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
    relaxed_order: bool = False,
):
    """Plain PyTorch version of the refine kernels (K3, K5).

    Returns ``(u_next, v_next, sum|du|, sum|dv|)``, the sums as 0-d
    tensors on the input's device.
    """
    if max_disp_v is None:
        max_disp_v = max_disp
    du, dv, _, _ = _lk_solve_ref(frame_prev, warped, window_size, det_threshold,
                                 relaxed_order)
    u_c = flow_u.clamp(-max_disp, max_disp)
    v_c = flow_v.clamp(-max_disp_v, max_disp_v)
    frozen = converged.reshape(()).to(torch.bool)
    u_next = torch.where(frozen, u_c, u_c + du)
    v_next = torch.where(frozen, v_c, v_c + dv)
    return u_next, v_next, du.abs().sum(), dv.abs().sum()


def _check_planes(planes, what: str) -> None:
    if planes[0].ndim != 2 or any(t.shape != planes[0].shape for t in planes):
        raise ValueError(f"{what} must share one (H, W) shape")
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"float32 expected, got {t.dtype}")


def _device_of(tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA LK kernels need contiguous tensors")
    return dev


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
    relaxed_order: bool = False,
):
    """Refine step: the CUDA kernel for CUDA tensors (K3 relaxed order, K5
    exact order), the plain version for CPU tensors. ``converged`` is a 0-d
    bool tensor on the same device (read by the kernel, never by the
    host)."""
    if max_disp_v is None:
        max_disp_v = max_disp
    _check_window(window_size)
    planes = (frame_prev, warped, flow_u, flow_v)
    _check_planes(planes, "frames and flow")
    if converged.dtype != torch.bool or converged.numel() != 1:
        raise TypeError("converged must be a one-element bool tensor")
    dev = _device_of((*planes, converged))
    args = (window_size, det_threshold, float(max_disp), float(max_disp_v), relaxed_order)
    if dev.type == "cpu":
        return lucas_kanade_refine_ref(frame_prev, warped, flow_u, flow_v, converged, *args)

    lib = _build.load()
    h, w = frame_prev.shape
    u_out = torch.empty_like(flow_u)
    v_out = torch.empty_like(flow_v)
    n_blocks = lib.tpuflow_lk_refine_blocks(h, w)
    parts = torch.empty((2, n_blocks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.tpuflow_lk_refine(
        frame_prev.data_ptr(), warped.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(),
        converged.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(), h, w, window_size, int(relaxed_order),
        float(det_threshold), float(max_disp), float(max_disp_v), stream,
    )
    name = "lk_refine" if relaxed_order else "lk_refine_exact"
    _build.check(lib, code, name)
    launch_counts[name] += 1
    sums = parts.sum(dim=1)
    return u_out, v_out, sums[0], sums[1]


def lucas_kanade_fused_ref(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
    relaxed_order: bool = False,
):
    """Plain PyTorch version of the fused single-scale kernels (K6, K7)."""
    taps = _window_taps(window_size, weight_sigma) if gaussian_weights else None
    du, dv, det, interior = _lk_solve_ref(frame_prev, frame_curr, window_size,
                                          det_threshold, relaxed_order, taps)
    if return_confidence:
        return du, dv, torch.where(interior, det.abs(), torch.zeros_like(det))
    return du, dv


def lucas_kanade_fused(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
    relaxed_order: bool = False,
):
    """Fused single-scale LK, (u, v) or (u, v, |det|) with
    ``return_confidence``: the CUDA kernel for CUDA tensors (K6, K7), the
    plain version for CPU tensors."""
    _check_window(window_size)
    _check_planes((frame_prev, frame_curr), "frames")
    dev = _device_of((frame_prev, frame_curr))
    args = (window_size, det_threshold, gaussian_weights, weight_sigma, return_confidence,
            relaxed_order)
    if dev.type == "cpu":
        return lucas_kanade_fused_ref(frame_prev, frame_curr, *args)

    lib = _build.load()
    h, w = frame_prev.shape
    u = torch.empty_like(frame_prev)
    v = torch.empty_like(frame_prev)
    det = torch.empty_like(frame_prev) if return_confidence else None
    taps = None
    if gaussian_weights:
        taps = (ctypes.c_float * window_size)(*_window_taps(window_size, weight_sigma))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.tpuflow_lk_fused(
        frame_prev.data_ptr(), frame_curr.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if det is None else det.data_ptr(), h, w, window_size, int(relaxed_order),
        taps, float(det_threshold), stream,
    )
    name = "lk_fused_conf" if return_confidence else "lk_fused"
    _build.check(lib, code, name)
    launch_counts[name] += 1
    return (u, v, det) if return_confidence else (u, v)
