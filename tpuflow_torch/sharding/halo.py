"""Halo exchange for spatially tiled image operators.

Counterpart of ``tpuflow.sharding.halo``. Window-crossing reads at tile
boundaries become exchanges of border strips with the neighbouring ranks
(``dist.batch_isend_irecv`` within the batch slice, where the reference
takes ``lax.ppermute``). Every function here works on this rank's local
tile.

Boundary semantics: interior tile edges receive neighbour data; true
image edges are filled locally, either by symmetric reflection (matching
``scipy.signal.convolve2d(boundary="symm")``, the gradient stage's
boundary) or by zeros (for operators whose border output is discarded).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuflow_torch.sharding.mesh import FlowMesh, counters, through_host


def _swap(mesh: FlowMesh, sends: list, recvs: list) -> None:
    """Post every (tensor, peer) send and receive at once and wait for all.
    gloo takes CPU tensors only, so on a card under gloo the strips go
    through host memory."""
    staged = bool(sends) and through_host(mesh.spatial, sends[0][0])
    ops = []
    for t, peer in sends:
        t = (t.to("cpu") if staged else t).contiguous()
        counters.halo_bytes += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, peer, group=mesh.spatial))
    bufs = []
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
        bufs.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.spatial))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for t, buf in bufs:
        t.copy_(buf)


def _exchange_axis(x: torch.Tensor, mesh: FlowMesh, axis_name: str, halo: int,
                   axis: int, boundary: str) -> torch.Tensor:
    """Extend the local tile by ``halo`` on both sides of ``axis`` (0 rows,
    1 columns) with neighbour data (interior) or boundary fill (image
    edges). The neighbours are this rank's predecessor and successor along
    ``axis_name`` ("ty" or "tx")."""
    if halo == 0:
        return x
    counters.halo_exchanges += 1
    dim = axis - 2  # the tile's last two dims; leading dims ride along
    n = mesh.shape[axis_name]
    idx = mesh.index(axis_name)
    lo_edge = x.narrow(dim, 0, halo)
    hi_edge = x.narrow(dim, x.shape[dim] - halo, halo)
    if boundary == "symm":
        top, bot = lo_edge.flip(dim), hi_edge.flip(dim)
    elif boundary == "zero":
        top, bot = torch.zeros_like(lo_edge), torch.zeros_like(hi_edge)
    else:
        raise ValueError(f"boundary must be 'symm' or 'zero', got {boundary!r}")

    b, iy, ix = mesh.coords

    def neighbour(step: int) -> int:
        if axis_name == "ty":
            return mesh.rank_at(b, iy + step, ix)
        return mesh.rank_at(b, iy, ix + step)

    sends, recvs = [], []
    # My top halo is my predecessor's bottom edge, and the other way round.
    if idx > 0:
        top = torch.empty_like(lo_edge)
        sends.append((lo_edge, neighbour(-1)))
        recvs.append((top, neighbour(-1)))
    if idx < n - 1:
        bot = torch.empty_like(hi_edge)
        sends.append((hi_edge, neighbour(1)))
        recvs.append((bot, neighbour(1)))
    _swap(mesh, sends, recvs)
    return torch.cat([top, x, bot], dim=dim)


def exchange_halo_2d(x: torch.Tensor, halo: int, mesh: FlowMesh, *,
                     boundary: str = "symm") -> torch.Tensor:
    """Extend a local (h, w) tile to (h + 2*halo, w + 2*halo).

    Columns are exchanged first and rows second, on the widened tile, so
    the corner halos arrive holding the diagonal neighbour's data (relayed
    through the vertical neighbour: no diagonal sends)."""
    x = _exchange_axis(x, mesh, "tx", halo, axis=1, boundary=boundary)
    return _exchange_axis(x, mesh, "ty", halo, axis=0, boundary=boundary)
