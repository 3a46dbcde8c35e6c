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
- ``window_mxu=True`` on either (K10, ``pallas_lk._wsum_mxu``): the five
  structure-tensor planes are window-summed as banded-ones matrix
  products, a vertical (H, H + w - 1) operator and then one (128 + w - 1,
  128) block per 128 output columns; the Sobel form still follows
  ``relaxed_order`` and Gaussian taps take precedence over the flag. The
  JAX package honours the flag only on its batched route; here it holds
  for (H, W) planes too.

``refine_round`` is the refine kernel (K3, K5) as one round of the
pyramidal driver under device control, with its plain version
``refine_round_ref``: the round reads the level's converged latch (set:
the round is skipped and u, v pass through bit for bit) and the band index
from device memory, and the kernel itself sums its block partials in a
fixed order, latches ``sdu / n_px < thr & sdv / n_px < thr`` and counts
the round, so the driver reads nothing to the host and launches nothing
else.

``fused_tile_round`` is K6 as one round of the tiled pyramidal path under
device control, with its plain version ``fused_tile_round_ref``: the fused
solve on a tile extended by ``window // 2 + 1`` px, its crop zeroed
outside the level's global interior and added into the tile's ``u``,
``v`` in place, and sum|du|, sum|dv| over the crop, added in the kernel
from its block partials in a fixed order, unless the element's latch in
device memory is set (then nothing is read or written). One launch a
call. It does not latch: the tiled loop reduces the sums across the
mesh's ranks first and latches on the device from the reduced sums.

Both take the reference's parameters, in its order and with its defaults;
``tile_rows`` is accepted and ignored (the TPU's tiling). Each takes one
(H, W) plane or a (B, H, W) batch (the TPU kernels' batched entries,
``_refine_batched`` and ``_fused_batched``). A batch is one kernel launch;
each element is computed exactly as the same plane alone. For a batch the
refine's ``converged`` is a (B,) bool tensor and its sums are (B,)
tensors, one per element.

The CUDA kernels are ``csrc/lk_refine.cu`` and ``csrc/lk_fused.cu`` (one
column-walk kernel, ``csrc/lk_tile.cuh``), and ``csrc/lk_mxu.cu`` for
``window_mxu`` (a tile kernel of its own that keeps the window sums in
``mma.sync`` fragments). ``lucas_kanade_refine_ref`` and
``lucas_kanade_fused_ref`` are the same functions in plain PyTorch, in the
Pallas kernel's f32 expression order with its reciprocal-form solve (the
``window_mxu`` sums as ``torch.matmul`` in true f32), and are what the
wrappers run for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.core import ops
from tpuflow_torch.kernels import _build, torch_ref

WINDOWS = (3, 5, 7)

# Kernel launches; incremented only where a kernel is launched.
launch_counts = {
    "lk_refine": 0, "lk_refine_exact": 0, "lk_fused": 0, "lk_fused_conf": 0,
    "lk_refine_mxu": 0, "lk_fused_mxu": 0, "lk_fused_conf_mxu": 0, "lk_fused_tile_round": 0,
}


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
    """Symmetric pad by 1 (edge included), then ``zeros`` rows/cols of 0,
    over the last two dims."""
    f = torch.cat([f[..., :1, :], f, f[..., -1:, :]], dim=-2)
    f = torch.cat([f[..., :1], f, f[..., -1:]], dim=-1)
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

    return axis_sum(axis_sum(a, -2, out_rows), -1, out_cols)


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

    return axis_sum(axis_sum(a, -2, out_rows), -1, out_cols)


# Output columns per block of the horizontal window_mxu product
# (pallas_lk.py:166-179: one (128 + w - 1, 128) banded block per 128 lanes).
_MXU_BLOCK = 128


def _band(rows: int, cols: int, w: int, device: torch.device) -> torch.Tensor:
    """(rows, cols) banded-ones matrix, entry (i, j) = 1 for 0 <= j - i < w."""
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return ((j >= i) & (j < i + w)).to(torch.float32)


def _wsum_mxu_ref(a: torch.Tensor, w: int, out_rows: int, out_cols: int) -> torch.Tensor:
    """Sliding w-tap window sum over the last two dims as banded-ones
    products (``pallas_lk._wsum_mxu``): rows = Wv @ a with the (out_rows,
    out_rows + w - 1) band, then, for each 128-column output block, rows'
    (128 + w - 1)-column segment @ the (128 + w - 1, 128) band. The zero
    entries add exact zeros, so the sums equal the plain window sums up to
    the order of the matmul's adds. True f32 (TF32 pinned off) on the
    card. A batch runs plane by plane through the same two products: a
    GEMM blocks a (B, H, W) operand otherwise than an (H, W) one, so its
    adds would come in another order and an element would not equal its
    plane's call."""
    if a.ndim > 2:
        planes = [_wsum_mxu_ref(p, w, out_rows, out_cols) for p in a.flatten(0, -3)]
        return torch.stack(planes).unflatten(0, a.shape[:-2])
    if a.is_cuda:
        ops.pin_f32_matmul()
    rows = torch.matmul(_band(out_rows, a.shape[-2], w, a.device), a)
    n_blk = -(-out_cols // _MXU_BLOCK)
    # Zero columns past the last one make the ragged last block a full one:
    # they only meet band entries of output columns that are cut off.
    rows = torch.nn.functional.pad(rows, (0, n_blk * _MXU_BLOCK + w - 1 - rows.shape[-1]))
    segs = rows.unfold(-1, _MXU_BLOCK + w - 1, _MXU_BLOCK)
    sums = torch.matmul(segs, _band(_MXU_BLOCK, _MXU_BLOCK + w - 1, w, a.device).T)
    return sums.flatten(-2)[..., :out_cols]


def _lk_solve_ref(frame_prev: torch.Tensor, frame_curr: torch.Tensor, window_size: int,
                  det_threshold: float, relaxed_order: bool,
                  taps: tuple[float, ...] | None = None, window_mxu: bool = False):
    """The tile math of ``pallas_lk._lk_tile`` over whole (..., H, W)
    frames: the interior-masked (du, dv), det, and the interior mask."""
    h, w = frame_prev.shape[-2:]
    half = window_size // 2
    # Padded frames hold image rows/cols -(half+1) .. N+half.
    p = _pad_frame(frame_prev, half)
    c = _pad_frame(frame_curr, half)
    gh, gw = h + 2 * half, w + 2 * half

    avg = (p + c) * 0.5
    if relaxed_order:
        # Separable Sobel: [1,2,1] / [1,0,-1] down the rows over all columns,
        # then across the columns.
        sv = avg[..., 0:gh, :] + 2.0 * avg[..., 1 : gh + 1, :] + avg[..., 2 : gh + 2, :]
        dv = avg[..., 0:gh, :] - avg[..., 2 : gh + 2, :]
        ix = (sv[..., 0:gw] - sv[..., 2 : gw + 2]) * 0.125
        iy = (dv[..., 0:gw] + 2.0 * dv[..., 1 : gw + 1] + dv[..., 2 : gw + 2]) * 0.125
    else:
        def sh(dy: int, dx: int) -> torch.Tensor:
            return avg[..., 1 + dy : 1 + dy + gh, 1 + dx : 1 + dx + gw]

        ix = (
            (sh(-1, -1) - sh(-1, 1)) + 2.0 * (sh(0, -1) - sh(0, 1)) + (sh(1, -1) - sh(1, 1))
        ) * 0.125
        iy = (
            (sh(-1, -1) - sh(1, -1)) + 2.0 * (sh(-1, 0) - sh(1, 0)) + (sh(-1, 1) - sh(1, 1))
        ) * 0.125
    it = p[..., 1 : gh + 1, 1 : gw + 1] - c[..., 1 : gh + 1, 1 : gw + 1]

    def wsum(a):
        # Taps first, then window_mxu, then the Sobel order's own sums
        # (pallas_lk.py:256-277).
        if taps is None and window_mxu:
            return _wsum_mxu_ref(a, window_size, h, w)
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
    tile_rows: int | None = None,
    max_disp_v: float | None = None,
    relaxed_order: bool = False,
    window_mxu: bool = False,
):
    """Plain PyTorch version of the refine kernels (K3, K5; K10 with
    ``window_mxu``).

    Returns ``(u_next, v_next, sum|du|, sum|dv|)``, the sums as 0-d
    tensors (a plane) or (B,) tensors (a batch) on the input's device.
    """
    if max_disp_v is None:
        max_disp_v = max_disp
    du, dv, _, _ = _lk_solve_ref(frame_prev, warped, window_size, det_threshold,
                                 relaxed_order, window_mxu=window_mxu)
    u_c = flow_u.clamp(-max_disp, max_disp)
    v_c = flow_v.clamp(-max_disp_v, max_disp_v)
    batched = frame_prev.ndim == 3
    frozen = converged.reshape((-1, 1, 1) if batched else ()).to(torch.bool)
    u_next = torch.where(frozen, u_c, u_c + du)
    v_next = torch.where(frozen, v_c, v_c + dv)
    if batched:
        return u_next, v_next, du.abs().sum(dim=(-2, -1)), dv.abs().sum(dim=(-2, -1))
    return u_next, v_next, du.abs().sum(), dv.abs().sum()


def _check_planes(planes, what: str) -> None:
    if planes[0].ndim not in (2, 3) or any(t.shape != planes[0].shape for t in planes):
        raise ValueError(f"{what} must share one (H, W) or (B, H, W) shape")
    if planes[0].ndim == 3 and not 1 <= planes[0].shape[0] <= _build.MAX_BATCH:
        raise ValueError(f"batches of 1..{_build.MAX_BATCH} planes are supported")
    if planes[0].shape[-2] * planes[0].shape[-1] >= 2**31:
        raise ValueError("a plane must hold fewer than 2**31 pixels")
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
    tile_rows: int | None = None,
    max_disp_v: float | None = None,
    relaxed_order: bool = False,
    window_mxu: bool = False,
):
    """Refine step: the CUDA kernel for CUDA tensors (K3 relaxed order, K5
    exact order, K10 with ``window_mxu``), the plain version for CPU
    tensors. ``converged`` is a one-element bool tensor for a plane and a
    (B,) bool tensor for a batch, on the same device (read by the kernel,
    never by the host)."""
    if max_disp_v is None:
        max_disp_v = max_disp
    _check_window(window_size)
    planes = (frame_prev, warped, flow_u, flow_v)
    _check_planes(planes, "frames and flow")
    batch = frame_prev.shape[0] if frame_prev.ndim == 3 else 1
    if converged.dtype != torch.bool:
        raise TypeError("converged must be a bool tensor")
    if (frame_prev.ndim == 3 and converged.shape != (batch,)) or converged.numel() != batch:
        raise ValueError("converged must hold one flag per plane: (B,) for a batch")
    dev = _device_of((*planes, converged))
    if dev.type == "cpu":
        return lucas_kanade_refine_ref(
            frame_prev, warped, flow_u, flow_v, converged, window_size, det_threshold,
            float(max_disp), max_disp_v=float(max_disp_v), relaxed_order=relaxed_order,
            window_mxu=window_mxu)

    lib = _build.load()
    h, w = frame_prev.shape[-2:]
    u_out = torch.empty_like(flow_u)
    v_out = torch.empty_like(flow_v)
    if window_mxu:
        n_blocks = lib.tpuflow_lk_refine_mxu_blocks(h, w)
    else:
        n_blocks = lib.tpuflow_lk_refine_blocks(h, w, window_size)
    parts = torch.empty((2, batch, n_blocks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.tpuflow_lk_refine_mxu if window_mxu else lib.tpuflow_lk_refine
    code = fn(
        frame_prev.data_ptr(), warped.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(),
        converged.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(), batch, h, w, window_size,
        int(relaxed_order), float(det_threshold), float(max_disp), float(max_disp_v), stream,
    )
    name = "lk_refine_mxu" if window_mxu else "lk_refine" if relaxed_order else "lk_refine_exact"
    _build.check(lib, code, name)
    launch_counts[name] += 1
    # Each element's partials are summed alone, as its 2-D launch sums
    # them: the order of torch's reduction depends on how many sums one
    # call forms.
    sums = [parts[:, b].contiguous().sum(dim=1) for b in range(batch)]
    if frame_prev.ndim == 3:
        sums = torch.stack(sums, dim=1)
        return u_out, v_out, sums[0], sums[1]
    return u_out, v_out, sums[0][0], sums[0][1]


CTRL_ROWS = 3  # a round's control: latch, ticket, round count
MAX_LADDER = 8  # csrc/lk_tile.cuh kMaxLadder


def refine_blocks(height: int, width: int, window_size: int) -> int:
    """Block partials of one plane's refine launch (the CUDA kernel's
    grid; needs the library)."""
    return _build.load().tpuflow_lk_refine_blocks(height, width, window_size)


def round_sum_depth(height: int, width: int, window_size: int) -> int:
    """Rounded additions a block partial can pass through in a round's
    in-kernel sum (``lk_tile.cuh::finish_round``): its thread's strided
    adds over the partials, one in the block's threads (the first exact),
    a 5-level warp butterfly and the adds across the block's warps. The
    partials are non-negative, so the float32 sum lies within ``depth *
    2**-24`` relative of their exact sum (needs the library)."""
    threads = _build.load().tpuflow_lk_walk_threads()
    per_thread = -(-refine_blocks(height, width, window_size) // threads)
    return per_thread - 1 + 5 + threads // 32 - 1


def _check_round(planes, ctrl, band, ladder, window_size, parts) -> torch.device:
    _check_window(window_size)
    _check_planes(planes, "frames and flow")
    batch = planes[0].shape[0] if planes[0].ndim == 3 else 1
    if not 1 <= len(ladder) <= MAX_LADDER or (band is None and len(ladder) != 1):
        raise ValueError(f"a band ladder holds 1..{MAX_LADDER} bands, and several need a "
                         f"band index; got {ladder}")
    want = (CTRL_ROWS, batch) if planes[0].ndim == 3 else (CTRL_ROWS,)
    if ctrl.dtype != torch.int32 or tuple(ctrl.shape) != want:
        raise ValueError(f"ctrl must be an int32 tensor of shape {want} (latch, ticket, rounds)")
    if band is not None and (band.dtype != torch.int32 or band.numel() not in (1, batch)):
        raise ValueError("band must be an int32 tensor holding one index, or one a plane of "
                         "the batch")
    tensors = (*planes, ctrl) + (() if band is None else (band,))
    dev = _device_of(tensors + (() if parts is None else (parts,)))
    return dev


def refine_round_ref(
    frame_prev: torch.Tensor,
    warped: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    ctrl: torch.Tensor,
    *,
    ladder: tuple[float, ...],
    band: torch.Tensor | None = None,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    max_disp: float = 8.0,
    convergence_threshold: float = 0.01,
    relaxed_order: bool = False,
    parts: torch.Tensor | None = None,
):
    """Plain PyTorch version of ``refine_round``: the same outputs and the
    same updates of ``ctrl``, the sums over the whole plane (``parts`` is
    the kernel's and is left alone)."""
    batched = frame_prev.ndim == 3
    mdv = torch_ref.ladder_value(band, ladder, torch.float32, frame_prev.device)
    du, dv, _, _ = _lk_solve_ref(frame_prev, warped, window_size, det_threshold, relaxed_order)
    u_next = flow_u.clamp(-max_disp, max_disp) + du
    v_next = flow_v.clamp(-mdv, mdv) + dv
    latch = ctrl[0]
    ran = latch == 0
    skip = (~ran).reshape((-1, 1, 1) if batched else ())
    u_out = torch.where(skip, flow_u, u_next)
    v_out = torch.where(skip, flow_v, v_next)
    sdu, sdv = du.abs().sum(dim=(-2, -1)), dv.abs().sum(dim=(-2, -1))
    n_px = frame_prev.shape[-2] * frame_prev.shape[-1]
    # f32 on the device, as tpuflow's sdu / n_px < thr.
    now = (sdu / n_px < convergence_threshold) & (sdv / n_px < convergence_threshold)
    sums = torch.where(ran, torch.stack([sdu, sdv]), torch.zeros((), device=sdu.device))
    ctrl[2] += ran.to(torch.int32)
    ctrl[0] = torch.where(ran & now, torch.ones_like(latch), latch)
    return u_out, v_out, sums


def refine_round(
    frame_prev: torch.Tensor,
    warped: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    ctrl: torch.Tensor,
    *,
    ladder: tuple[float, ...],
    band: torch.Tensor | None = None,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    max_disp: float = 8.0,
    convergence_threshold: float = 0.01,
    relaxed_order: bool = False,
    parts: torch.Tensor | None = None,
):
    """One refine round under device control: the CUDA kernel for CUDA
    tensors (K3 relaxed order, K5 exact order), the plain version for CPU
    tensors. Returns ``(u_next, v_next, sums)``, ``sums`` the (2,) or
    (2, B) sum|du|, sum|dv| (0 for a skipped round).

    ``ctrl`` is the round's int32 control, (3,) for a plane or (3, B) for a
    batch: row 0 the converged latch (set: the round is skipped, u, v copied
    through bit for bit; else the round's ``sdu / n_px < thr & sdv / n_px <
    thr`` is ORed in), row 1 the kernel's ticket counter (0 between
    launches), row 2 the rounds run, each updated in place on the device.
    ``max_disp_v`` is ``ladder[band]`` (``band`` an int32 tensor, one index
    for every plane or, for a batch of independent streams, a (B,) one,
    plane b at ``ladder[band[b]]``; None takes ``ladder[0]``). ``parts``,
    optional, (2, B,
    ``refine_blocks(H, W, window)``) float32, receives the kernel's block
    partials (CUDA only)."""
    planes = (frame_prev, warped, flow_u, flow_v)
    dev = _check_round(planes, ctrl, band, ladder, window_size, parts)
    kw = dict(ladder=ladder, band=band, window_size=window_size, det_threshold=det_threshold,
              max_disp=max_disp, convergence_threshold=convergence_threshold,
              relaxed_order=relaxed_order)
    if dev.type == "cpu":
        return refine_round_ref(*planes, ctrl, **kw)

    lib = _build.load()
    h, w = frame_prev.shape[-2:]
    batch = frame_prev.shape[0] if frame_prev.ndim == 3 else 1
    n_blocks = lib.tpuflow_lk_refine_blocks(h, w, window_size)
    if parts is None:
        parts = torch.empty((2, batch, n_blocks), dtype=torch.float32, device=dev)
    elif parts.shape != (2, batch, n_blocks) or parts.dtype != torch.float32:
        raise ValueError(f"parts must be a float32 tensor of shape {(2, batch, n_blocks)}")
    u_out = torch.empty_like(flow_u)
    v_out = torch.empty_like(flow_v)
    sums = torch.empty((2, batch), dtype=torch.float32, device=dev)
    bands = (ctypes.c_float * len(ladder))(*ladder)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.tpuflow_lk_refine_round(
        frame_prev.data_ptr(), warped.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(),
        ctrl.data_ptr(), None if band is None else band.data_ptr(),
        0 if band is None else band.numel(), bands, len(ladder), u_out.data_ptr(),
        v_out.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), sums.data_ptr(), batch,
        h, w, window_size, int(relaxed_order), float(det_threshold), float(max_disp),
        float(convergence_threshold), stream)
    name = "lk_refine" if relaxed_order else "lk_refine_exact"
    _build.check(lib, code, name)
    launch_counts[name] += 1
    return u_out, v_out, sums if frame_prev.ndim == 3 else sums[:, 0]


def lucas_kanade_fused_ref(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    tile_rows: int | None = None,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
    relaxed_order: bool = False,
    window_mxu: bool = False,
):
    """Plain PyTorch version of the fused single-scale kernels (K6, K7;
    K10 with ``window_mxu`` and no Gaussian taps)."""
    taps = _window_taps(window_size, weight_sigma) if gaussian_weights else None
    du, dv, det, interior = _lk_solve_ref(frame_prev, frame_curr, window_size,
                                          det_threshold, relaxed_order, taps, window_mxu)
    if return_confidence:
        return du, dv, torch.where(interior, det.abs(), torch.zeros_like(det))
    return du, dv


def lucas_kanade_fused(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    tile_rows: int | None = None,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
    relaxed_order: bool = False,
    window_mxu: bool = False,
):
    """Fused single-scale LK, (u, v) or (u, v, |det|) with
    ``return_confidence``: the CUDA kernel for CUDA tensors (K6, K7; K10
    with ``window_mxu`` and no Gaussian taps), the plain version for CPU
    tensors."""
    _check_window(window_size)
    _check_planes((frame_prev, frame_curr), "frames")
    dev = _device_of((frame_prev, frame_curr))
    if dev.type == "cpu":
        return lucas_kanade_fused_ref(
            frame_prev, frame_curr, window_size, det_threshold,
            gaussian_weights=gaussian_weights, weight_sigma=weight_sigma,
            return_confidence=return_confidence, relaxed_order=relaxed_order,
            window_mxu=window_mxu)

    lib = _build.load()
    h, w = frame_prev.shape[-2:]
    batch = frame_prev.shape[0] if frame_prev.ndim == 3 else 1
    u = torch.empty_like(frame_prev)
    v = torch.empty_like(frame_prev)
    det = torch.empty_like(frame_prev) if return_confidence else None
    det_ptr = None if det is None else det.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    mxu = window_mxu and not gaussian_weights  # taps take precedence
    if mxu:
        code = lib.tpuflow_lk_fused_mxu(
            frame_prev.data_ptr(), frame_curr.data_ptr(), u.data_ptr(), v.data_ptr(),
            det_ptr, batch, h, w, window_size, int(relaxed_order), float(det_threshold), stream,
        )
    else:
        taps = None
        if gaussian_weights:
            taps = (ctypes.c_float * window_size)(*_window_taps(window_size, weight_sigma))
        code = lib.tpuflow_lk_fused(
            frame_prev.data_ptr(), frame_curr.data_ptr(), u.data_ptr(), v.data_ptr(),
            det_ptr, batch, h, w, window_size, int(relaxed_order), taps,
            float(det_threshold), stream,
        )
    name = ("lk_fused_conf" if return_confidence else "lk_fused") + ("_mxu" if mxu else "")
    _build.check(lib, code, name)
    launch_counts[name] += 1
    return (u, v, det) if return_confidence else (u, v)


def tile_round_blocks(height: int, width: int, window_size: int) -> int:
    """Block partials of one (height, width) extended tile's tile round
    (the CUDA kernel's grid; needs the library)."""
    return _build.load().tpuflow_lk_tile_round_blocks(height, width, window_size)


def launch_tile_round_empty(height: int, width: int, window_size: int = 5,
                            batch: int = 1) -> None:
    """Launch an empty kernel on the tile round's grid and block for a
    (height, width) extended tile on the current CUDA stream: what the
    grid's launch costs, beside a skipped round (a measurement)."""
    lib = _build.load()
    _build.check(lib, lib.tpuflow_lk_tile_round_empty(
        batch, height, width, window_size, torch.cuda.current_stream().cuda_stream),
        "tile round empty kernel")


def tile_round_depth_of(rows: int, threads: int, blocks: int) -> int:
    """Rounded additions a pixel's |du| can pass through on its way into a
    tile round's in-kernel sum, for a walk of ``rows`` output rows a
    block, ``threads`` a block and ``blocks`` partials an element: a
    lane's adds down its walk (the first exact), the warp's 5-level
    butterfly, the adds across the block's warps; then, in the element's
    last block, a thread's strided adds over the partials (the first
    exact), the butterfly and the warps again. The terms are
    non-negative, so the float32 sum lies within ``depth * 2**-24``
    relative of the exact sum."""
    warps = threads // 32
    per_thread = -(-blocks // threads)
    return (rows - 1 + 5 + warps - 1) + (per_thread - 1 + 5 + warps - 1)


def tile_round_depth(height: int, width: int, window_size: int) -> int:
    """``tile_round_depth_of`` the tile round's walk on a (height, width)
    extended tile (needs the library)."""
    lib = _build.load()
    return tile_round_depth_of(lib.tpuflow_lk_tile_round_rows(height, width, window_size),
                               lib.tpuflow_lk_walk_threads(),
                               tile_round_blocks(height, width, window_size))


def _check_tile_round(prev_ext, warped_ext, u, v, ctrl, window_size, parts):
    _check_window(window_size)
    _check_planes((prev_ext, warped_ext), "the extended tiles")
    _check_planes((u, v), "the tile's flow")
    ext = window_size // 2 + 1
    h, w = u.shape[-2:]
    if (u.ndim != prev_ext.ndim or u.shape[:-2] != prev_ext.shape[:-2]
            or prev_ext.shape[-2:] != (h + 2 * ext, w + 2 * ext)):
        raise ValueError(f"the extended tiles must be the flow's tile extended by {ext} px a "
                         f"side: got {tuple(prev_ext.shape)} for flow {tuple(u.shape)}")
    batch = u.shape[0] if u.ndim == 3 else 1
    want = (CTRL_ROWS, batch) if u.ndim == 3 else (CTRL_ROWS,)
    if ctrl.dtype != torch.int32 or tuple(ctrl.shape) != want:
        raise ValueError(f"ctrl must be an int32 tensor of shape {want} (latch, ticket, rounds)")
    dev = _device_of((prev_ext, warped_ext, u, v, ctrl)
                     + (() if parts is None else (parts,)))
    return dev, batch, ext


def tile_round_delta_ref(prev_ext, warped_ext, *, gy0: int, gx0: int, gh: int, gw: int,
                         window_size: int = 5, det_threshold: float = 1e-4,
                         relaxed_order: bool = False):
    """The (du, dv) a tile round adds: K6's plain solve on the extended
    tiles, cropped by ``window_size // 2 + 1`` px a side and zeroed outside
    the level's global interior."""
    ext = window_size // 2 + 1
    half = window_size // 2
    h, w = prev_ext.shape[-2] - 2 * ext, prev_ext.shape[-1] - 2 * ext
    du_e, dv_e, _, _ = _lk_solve_ref(prev_ext, warped_ext, window_size, det_threshold,
                                     relaxed_order)
    rows = torch.arange(h, device=du_e.device)[:, None] + gy0
    cols = torch.arange(w, device=du_e.device)[None, :] + gx0
    interior = (rows >= half) & (rows < gh - half) & (cols >= half) & (cols < gw - half)
    return (torch.where(interior, du_e[..., ext:ext + h, ext:ext + w], 0.0),
            torch.where(interior, dv_e[..., ext:ext + h, ext:ext + w], 0.0))


def fused_tile_round_ref(
    prev_ext: torch.Tensor,
    warped_ext: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    ctrl: torch.Tensor,
    *,
    gy0: int,
    gx0: int,
    gh: int,
    gw: int,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    relaxed_order: bool = False,
    parts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``fused_tile_round``: the same updates of
    ``flow_u``, ``flow_v`` and ``ctrl``; the sums over the whole crop
    (``parts`` is the kernel's and is left alone)."""
    du, dv = tile_round_delta_ref(prev_ext, warped_ext, gy0=gy0, gx0=gx0, gh=gh, gw=gw,
                                  window_size=window_size, det_threshold=det_threshold,
                                  relaxed_order=relaxed_order)
    batched = flow_u.ndim == 3
    ran = ctrl[0] == 0
    run = ran.reshape((-1, 1, 1) if batched else ())
    flow_u.copy_(torch.where(run, flow_u + du, flow_u))
    flow_v.copy_(torch.where(run, flow_v + dv, flow_v))
    ctrl[2] += ran.to(torch.int32)
    return torch.stack([du.abs().sum(dim=(-2, -1)), dv.abs().sum(dim=(-2, -1))])


def fused_tile_round(
    prev_ext: torch.Tensor,
    warped_ext: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    ctrl: torch.Tensor,
    *,
    gy0: int,
    gx0: int,
    gh: int,
    gw: int,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    relaxed_order: bool = False,
    parts: torch.Tensor | None = None,
) -> torch.Tensor:
    """One round of the tiled path on a halo-extended tile (K6's round
    form): the CUDA kernel for CUDA tensors (one launch, nothing else),
    the plain version for CPU tensors; neither reads a flag to the host.

    ``prev_ext``, ``warped_ext`` are the (H + 2 ext, W + 2 ext) tiles (or
    (B, ...) batches) extended by ``ext = window_size // 2 + 1`` px;
    ``flow_u``, ``flow_v`` the (H, W) tile's flow, to which the crop
    ``[ext:ext + H, ext:ext + W]`` of K6's (du, dv) is added in place, zero
    outside the global interior (``window_size // 2`` px inside the level's
    ``gh`` x ``gw`` border, the tile's origin at ``(gy0, gx0)``). ``ctrl``
    is the int32 (3,) or (3, B) control: row 0 the latch (set: the round
    is skipped, nothing read or written), row 1 the kernel's ticket (0
    between launches), row 2 the rounds run (the round adds 1). Returns
    the (2,) or (2, B) sum|du|, sum|dv| over the crop, which the kernel's
    last block adds from its block partials in a fixed order (``parts``,
    optional, (2, B, ``tile_round_blocks(H + 2 ext, W + 2 ext,
    window)``) float32, receives the partials). A skipped element's sums
    are not written, so they are undefined."""
    dev, batch, ext = _check_tile_round(prev_ext, warped_ext, flow_u, flow_v, ctrl,
                                        window_size, parts)
    kw = dict(gy0=gy0, gx0=gx0, gh=gh, gw=gw, window_size=window_size,
              det_threshold=det_threshold, relaxed_order=relaxed_order)
    if dev.type == "cpu":
        return fused_tile_round_ref(prev_ext, warped_ext, flow_u, flow_v, ctrl, **kw)

    lib = _build.load()
    he, we = prev_ext.shape[-2:]
    n_blocks = lib.tpuflow_lk_tile_round_blocks(he, we, window_size)
    if parts is None:
        parts = torch.empty((2, batch, n_blocks), dtype=torch.float32, device=dev)
    elif parts.shape != (2, batch, n_blocks) or parts.dtype != torch.float32:
        raise ValueError(f"parts must be a float32 tensor of shape {(2, batch, n_blocks)}")
    sums = torch.empty((2, batch) if flow_u.ndim == 3 else (2,), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.tpuflow_lk_fused_tile_round(
        prev_ext.data_ptr(), warped_ext.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(),
        ctrl.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), sums.data_ptr(), batch, he,
        we, ext, gy0, gx0, gh, gw, window_size, int(relaxed_order), float(det_threshold), stream)
    _build.check(lib, code, "lk_fused_tile_round")
    launch_counts["lk_fused_tile_round"] += 1
    return sums
