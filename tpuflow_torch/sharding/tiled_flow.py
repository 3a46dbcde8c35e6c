"""Tiled dense Lucas-Kanade flow over a process mesh.

Counterpart of ``tpuflow.sharding.tiled_flow``. The frame batch is cut
into a 2-D grid of tiles over a ("batch", "ty", "tx") mesh: each rank
computes the flow of its tile after a halo exchange of ``window // 2 + 1``
pixels (1 px of Sobel and the window's apron; ``HALO`` = 3 for the
default 5x5 window), then the tiles are gathered so that every rank holds
the whole result, as the reference's global output array is readable
everywhere. The reference computes this in jnp, outside Pallas, so the
tile's solve here is plain PyTorch ops: the symmetric-boundary gradients
at true image edges and the zero border and ``|det|`` gate of the
single-device path, which it matches (tests/test_torch_sharding.py).
"""

from __future__ import annotations

import torch

from tpuflow_torch.sharding import halo as halo_mod
from tpuflow_torch.sharding.mesh import FlowMesh, all_gather, assemble

HALO = 3  # Sobel (1) + window half (2) for the default 5x5 window


def _local_lk(avg_ext, it_ext, gy0, gx0, gh, gw, window, det_threshold):
    """LK on an extended local tile.

    avg_ext: (h + 2*(half + 1), w + ...) averaged frame with halo; it_ext:
    the temporal difference with a ``half``-pixel halo; (gy0, gx0): the
    global coordinates of the tile origin; (gh, gw): the global image
    shape."""
    half = window // 2
    ext = half + 1
    h = avg_ext.shape[0] - 2 * ext
    w = avg_ext.shape[1] - 2 * ext
    rh, rw = h + 2 * half, w + 2 * half  # gradient region (the window's apron)

    def sh(dy, dx):
        return avg_ext[1 + dy:1 + dy + rh, 1 + dx:1 + dx + rw]

    ix = ((sh(-1, -1) - sh(-1, 1)) + 2.0 * (sh(0, -1) - sh(0, 1)) + (sh(1, -1) - sh(1, 1))) * 0.125
    iy = ((sh(-1, -1) - sh(1, -1)) + 2.0 * (sh(-1, 0) - sh(1, 0)) + (sh(-1, 1) - sh(1, 1))) * 0.125
    it = it_ext

    def wsum(a):
        rows = a[0:h, :]
        for d in range(1, window):
            rows = rows + a[d:h + d, :]
        out = rows[:, 0:w]
        for d in range(1, window):
            out = out + rows[:, d:w + d]
        return out

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    b0 = -wsum(ix * it)
    b1 = -wsum(iy * it)

    det = s_xx * s_yy - s_xy * s_xy
    solvable = det.abs() > det_threshold
    inv = torch.where(solvable, 1.0 / torch.where(solvable, det, 1.0), 0.0)
    u = (s_yy * b0 - s_xy * b1) * inv
    v = (s_xx * b1 - s_xy * b0) * inv
    return _border_zero(u, v, gy0, gx0, gh, gw, half)


def _border_zero(u, v, gy0, gx0, gh, gw, half):
    """Zero the flow within ``half`` px of the global image border."""
    h, w = u.shape
    rows = torch.arange(h, device=u.device)[:, None] + gy0
    cols = torch.arange(w, device=u.device)[None, :] + gx0
    interior = (rows >= half) & (rows < gh - half) & (cols >= half) & (cols < gw - half)
    return torch.where(interior, u, 0.0), torch.where(interior, v, 0.0)


def check_tiling(shape, mesh: FlowMesh) -> tuple[int, int]:
    """The tile (th, tw) of a (B, H, W) batch; raises ``ValueError`` unless
    the mesh divides it."""
    if len(shape) != 3:
        raise ValueError(f"frames must be (B, H, W), got {tuple(shape)}")
    bsz, gh, gw = shape
    if bsz % mesh.batch or gh % mesh.ty or gw % mesh.tx:
        raise ValueError(
            f"frames {tuple(shape)} must divide the {mesh.batch}x{mesh.ty}x{mesh.tx} mesh tiling"
        )
    return gh // mesh.ty, gw // mesh.tx


def local_tiles(frames: torch.Tensor, mesh: FlowMesh) -> torch.Tensor:
    """This rank's (B / batch, th, tw) tiles of a global (B, H, W) batch,
    on the mesh's device."""
    th, tw = check_tiling(frames.shape, mesh)
    b, iy, ix = mesh.coords
    bl = frames.shape[0] // mesh.batch
    tile = frames[b * bl:(b + 1) * bl, iy * th:(iy + 1) * th, ix * tw:(ix + 1) * tw]
    return tile.to(device=mesh.device, dtype=torch.float32).contiguous()


def gather_tiles(u: torch.Tensor, v: torch.Tensor, mesh: FlowMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The global (B, H, W) ``u``, ``v`` on every rank from each rank's
    (B / batch, th, tw) tiles."""
    parts = all_gather(torch.stack([u, v]), mesh.group)  # mesh order, row-major
    per_b = mesh.ty * mesh.tx
    out = torch.cat([assemble(parts[b * per_b:(b + 1) * per_b], mesh.ty, mesh.tx)
                     for b in range(mesh.batch)], dim=1)
    return out[0], out[1]


def tiled_lucas_kanade_single_scale(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    mesh: FlowMesh,
    window_size: int = 5,
    det_threshold: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (u, v) flow of a (B, H, W) frame batch tiled over the mesh.

    Every rank of the mesh calls this with the same global frames and
    gets the global (B, H, W) flow back. B is split over "batch" and the
    spatial dims over ("ty", "tx"); raises ``ValueError`` where the mesh
    does not divide them or a tile is no wider than twice the halo."""
    th, tw = check_tiling(frame_prev.shape, mesh)
    half = window_size // 2
    halo = half + 1
    if th <= 2 * halo or tw <= 2 * halo:
        raise ValueError(f"tiles {th}x{tw} must exceed twice the halo ({2 * halo})")
    _, gh, gw = frame_prev.shape
    _, iy, ix = mesh.coords
    prev_l = local_tiles(frame_prev, mesh)
    curr_l = local_tiles(frame_curr, mesh)
    us, vs = [], []
    for prev, curr in zip(prev_l, curr_l):
        avg_ext = halo_mod.exchange_halo_2d((prev + curr) * 0.5, halo, mesh, boundary="symm")
        it_ext = halo_mod.exchange_halo_2d(prev - curr, half, mesh, boundary="zero")
        u, v = _local_lk(avg_ext, it_ext, iy * th, ix * tw, gh, gw, window_size, det_threshold)
        us.append(u)
        vs.append(v)
    return gather_tiles(torch.stack(us), torch.stack(vs), mesh)
