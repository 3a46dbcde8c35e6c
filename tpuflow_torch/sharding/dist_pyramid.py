"""Distributed pyramid build and flow upsampling on a tiled mesh.

Counterpart of ``tpuflow.sharding.dist_pyramid``. The pyramid's per-axis
operators (Gaussian blur fused with the linspace bilinear resample, and
the flow upsampler) are banded matrices (``core.ops._downsample_matrix_np``
/ ``_resample_matrix_np``: exact zeros outside a band of radius ~10 for
sigma = 2). So a rank holding a row or column tile of a level computes
its tile of the next level from its own rows plus a fixed halo: exchange
the overhang with the neighbours, then multiply by this rank's static
slice of the operator. No level is gathered whole.

The products are plain f32 ``torch.matmul`` calls, pinned to true f32 on
the card (``core.ops.pin_f32_matmul``), where the reference asks XLA for
``Precision.HIGHEST``. A rank's operator slice spans another contraction
extent than the single-device path's banded blocks, so the two agree to
f32 rounding (~1 ulp), not bit for bit.

Traffic per level build: O(halo * tile perimeter) bytes, not O(frame).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuflow_torch.core import ops
from tpuflow_torch.sharding.halo import _exchange_axis
from tpuflow_torch.sharding.mesh import FlowMesh


class _BandedShardPlan:
    """Static per-rank decomposition of a banded (m, n) operator for
    ``n_dev`` equal row shards of the output and column shards of the
    input: the stacked per-rank operator slices (of one width), the input
    column where each slice starts, and the halo that covers the largest
    overhang beyond a rank's own input tile."""

    __slots__ = ("mats", "starts", "halo", "width", "mb", "nb", "_on")

    def __init__(self, d_np: np.ndarray, n_dev: int):
        m, n = d_np.shape
        if m % n_dev or n % n_dev:
            raise ValueError(f"extents ({m}, {n}) must divide {n_dev} shards")
        mb, nb = m // n_dev, n // n_dev
        ranges = []
        for d in range(n_dev):
            blk = d_np[d * mb:(d + 1) * mb]
            nz = np.nonzero(np.abs(blk).sum(axis=0) > 0.0)[0]
            if not nz.size:
                raise ValueError("banded operator has an all-zero row block")
            ranges.append((int(nz[0]), int(nz[-1]) + 1))
        width = max(hi - lo for lo, hi in ranges)
        halo = 0
        starts, mats = [], []
        for d, (lo, _) in enumerate(ranges):
            lo2 = max(0, min(lo, n - width))
            halo = max(halo, d * nb - lo2, (lo2 + width) - (d + 1) * nb, 0)
            starts.append(lo2)
            mats.append(d_np[d * mb:(d + 1) * mb, lo2:lo2 + width])
        # The halo exchange relays at most one whole neighbour tile.
        if halo > nb:
            raise ValueError(f"banded halo {halo} exceeds the input tile {nb}")
        self.mats = np.stack(mats)  # (n_dev, mb, width), f64
        self.starts = np.array(starts, np.int64)
        self.halo = int(halo)
        self.width = int(width)
        self.mb, self.nb = mb, nb
        self._on: dict = {}

    def mat(self, idx: int, device: torch.device) -> torch.Tensor:
        """Rank ``idx``'s operator slice in f32 on ``device`` (memoised)."""
        key = (idx, device)
        if key not in self._on:
            self._on[key] = torch.from_numpy(np.ascontiguousarray(self.mats[idx], np.float32)).to(device)
        return self._on[key]


@functools.lru_cache(maxsize=None)
def _downsample_plan(n_src: int, n_dst: int, sigma: float, n_dev: int) -> _BandedShardPlan:
    return _BandedShardPlan(ops._downsample_matrix_np(n_src, n_dst, sigma), n_dev)


@functools.lru_cache(maxsize=None)
def _resample_plan(n_src: int, n_dst: int, n_dev: int) -> _BandedShardPlan:
    return _BandedShardPlan(ops._resample_matrix_np(n_src, n_dst), n_dev)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        ops.pin_f32_matmul()
    return a @ b


def _operand(plan: _BandedShardPlan, x: torch.Tensor, mesh: FlowMesh, axis_name: str,
             axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's operator slice and the input rows (axis 0) or columns
    (axis 1) it multiplies, halo included."""
    n_dev = mesh.shape[axis_name]
    idx = mesh.index(axis_name) if n_dev > 1 else 0
    start = int(plan.starts[idx]) - idx * plan.nb
    if n_dev > 1 and plan.halo:
        # Zero fill: the operator's columns never reach outside [0, n)
        # (the boundary reflection is folded into the matrix), so an edge
        # rank's fill is never read.
        x = _exchange_axis(x, mesh, axis_name, plan.halo, axis=axis, boundary="zero")
        start += plan.halo
    return plan.mat(idx, x.device), x.narrow(axis, start, plan.width)


def _apply_left(plan: _BandedShardPlan, x: torch.Tensor, mesh: FlowMesh,
                axis_name: str) -> torch.Tensor:
    """Local tile of ``D @ X`` for an X tiled along its rows."""
    mat, xs = _operand(plan, x, mesh, axis_name, axis=0)
    return _matmul(mat, xs)


def _apply_right(plan: _BandedShardPlan, x: torch.Tensor, mesh: FlowMesh,
                 axis_name: str) -> torch.Tensor:
    """Local tile of ``X @ D.T`` for an X tiled along its columns."""
    mat, xs = _operand(plan, x, mesh, axis_name, axis=1)
    return _matmul(xs, mat.T)


def sharded_downsample(
    tile: torch.Tensor,
    src_shape: tuple[int, int],
    dst_shape: tuple[int, int],
    sigma: float,
    *,
    mesh: FlowMesh,
) -> torch.Tensor:
    """One pyramid downsampling step on a tiled image.

    ``tile`` is this rank's (src_h/ty, src_w/tx) tile of the global
    ``src_shape`` image; returns its (dst_h/ty, dst_w/tx) tile of
    ``ops.downsample_fused(img, *dst_shape, sigma)``, to f32 rounding
    (~1 ulp)."""
    gh, gw = src_shape
    nh, nw = dst_shape
    out = _apply_left(_downsample_plan(gh, nh, sigma, mesh.ty), tile, mesh, "ty")
    return _apply_right(_downsample_plan(gw, nw, sigma, mesh.tx), out, mesh, "tx")


def sharded_upsample_flow(
    u: torch.Tensor,
    v: torch.Tensor,
    src_shape: tuple[int, int],
    dst_shape: tuple[int, int],
    *,
    mesh: FlowMesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled twin of ``torch_ref.upsample_flow`` (linspace bilinear resample
    and magnitude rescale) on flow tiles."""
    ch, cw = src_shape
    th, tw = dst_shape
    rp_h = _resample_plan(ch, th, mesh.ty)
    rp_w = _resample_plan(cw, tw, mesh.tx)

    def up(f):
        return _apply_right(rp_w, _apply_left(rp_h, f, mesh, "ty"), mesh, "tx")

    return up(u) * (tw / cw), up(v) * (th / ch)


@functools.lru_cache(maxsize=None)
def _row_slice(n_src: int, n_dst: int, n_dev: int, idx: int, device: torch.device) -> torch.Tensor:
    """Shard ``idx`` of ``n_dev`` row shards of the resample matrix, in f32
    on ``device`` (memoised), to upsample a whole coarse field straight
    into a tile."""
    if n_dst % n_dev:
        raise ValueError(f"{n_dst} rows must divide {n_dev} shards")
    mb = n_dst // n_dev
    m = ops._resample_matrix_np(n_src, n_dst)[idx * mb:(idx + 1) * mb]
    return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)


def replicated_to_sharded_upsample(
    u_full: torch.Tensor,
    v_full: torch.Tensor,
    dst_shape: tuple[int, int],
    *,
    mesh: FlowMesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample a whole (ch, cw) flow field, which every rank holds,
    straight into this rank's (dst_h/ty, dst_w/tx) tile: the transition
    from the replicated coarse levels to the tiled fine ones, without the
    whole fine field on any rank."""
    ch, cw = u_full.shape
    th, tw = dst_shape
    _, iy, ix = mesh.coords
    rows = _row_slice(ch, th, mesh.ty, iy, u_full.device)
    cols = _row_slice(cw, tw, mesh.tx, ix, u_full.device)

    def up(f):
        return _matmul(_matmul(rows, f), cols.T)

    return up(u_full) * (tw / cw), up(v_full) * (th / ch)
