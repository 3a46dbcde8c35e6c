"""Tiled pyramidal Lucas-Kanade flow over a process mesh.

Counterpart of ``tpuflow.sharding.tiled_pyramidal``, with the same
level-dependent plan:

- **Every level whose tile is big enough runs tiled end to end.** The
  pyramid downsample and the flow upsample are banded per-axis operators,
  so each rank computes its tile of every level from its own rows plus a
  ~10 px halo exchanged with its neighbours (``dist_pyramid``): no frame
  is gathered.
- **Levels with too-small tiles run replicated.** A level is tiled only if
  its dims divide the mesh and its tile exceeds twice the warp halo, and
  every finer level is tiled too; the coarsest tiled level is gathered
  ONCE within the batch slice, and the coarser levels build and solve
  identically on every rank of it. When only the finest level is tiled,
  the gathered level is the raw frame.
- **Tiled refinement** at each level: the current frame's tile is
  extended by ``max_disp + 1`` rows and columns for the warp (the flow is
  clipped to the band, so the warp never reads past the halo), then by the
  ``window // 2 + 1`` px Sobel and window apron for the residual LK solve;
  the convergence test sums |du| and |dv| over the batch slice's tiles and
  every rank decides from the reduced sums alone, so every rank runs the
  same rounds.

Semantics: matches the single-device path with the fast path's
saturation (``lucas_kanade_pyramidal(..., rtl_clamp=True)``): exactly
where only the finest level is tiled, and to f32 rounding of the banded
per-rank operator products (~1 ulp on level images) where coarse levels
are tiled too; the tiled warp's tile-local coordinates round otherwise
than the global ones, so the flow agrees within 1e-3 px
(tests/test_torch_sharding.py). The adaptive vertical-band ladder
(``PyramidConfig.adaptive_v_bands``) is not applied on the tiled path, as
in the reference: every level runs the static ``max_disp_v_effective``
band.

``backend="cuda"`` runs the single-device fast path's kernels on the
extended tiles: the banded warp (K1 packed-u8 on the finest level, K2
packed-u16 on the coarse ones, K4 where the config packs nothing) and the
fused LK solve K6, and keeps the reference's control flow on the device,
as the untiled fast path does. The reference refines each tiled level in
a ``lax.while_loop`` whose condition is ``i < iterations & ~converged``,
``converged`` taken from ``lax.psum`` of the tiles' sum|du|, sum|dv|.
Here every tiled level launches all ``cfg.iterations`` rounds, and each
round reads the level's int32 latch from device memory: the flow is
clipped to the band where the latch is clear (a frozen flow is never
re-clipped), the warp (``warp.warp_round``) and K6's round form
(``lk.fused_tile_round``: the solve on the halo-extended tile, its crop
added into the tile's flow in place, block partials of |du|, |dv|) skip
where it is set; the partials are summed, all-reduced over the batch
slice on the card (NCCL) and ORed into the latch on the device as
``s / npix < thr`` in float32. Every rank gets the same reduced bits, so
every latch is the same, and every rank issues the same collectives in
the same order whether or not a round is skipped. No value is read to
the host, so one step is a fixed sequence of launches and collectives,
which ``flow.graphed.TiledGraphedStream`` captures as a CUDA graph on
each rank of an NCCL mesh. Each level's latch and rounds run sit in a
per-element (levels, 3) int32 table; ``counters.level_rounds`` is the
latest call's (local batch, levels) rounds, a device tensor. Replicated
levels run the single-device fast path's level under device control
(``warp.warp_round`` and ``lk.refine_round``, K3 relaxed order, K5 exact
order) at the static band, with no host read and no collective. For CPU
tensors each wrapper runs its plain version.

The parity path (``backend="torch"``) keeps the reference's loop with
the early exit read to the host once a round (``counters.
convergence_reads``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuflow_torch.core import ops
from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow.pyramidal import _refine_level, _refine_level_device, _warp_packing
from tpuflow_torch.flow.single_scale import BACKENDS
from tpuflow_torch.kernels import lk, torch_ref, warp
from tpuflow_torch.sharding import dist_pyramid
from tpuflow_torch.sharding import halo as halo_mod
from tpuflow_torch.sharding.mesh import FlowMesh, all_reduce_sum, counters
from tpuflow_torch.sharding.tiled_flow import _border_zero, _local_lk, check_tiling, gather_tiles, local_tiles


def _level_shapes(gh: int, gw: int, levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Global (h, w) per level, coarse to fine: the dims
    ``torch_ref.build_gaussian_pyramid`` produces."""
    dims = [(gh, gw)]
    h, w = gh, gw
    for _ in range(levels - 1):
        h, w = int(h * scale_factor), int(w * scale_factor)
        dims.append((h, w))
    dims.reverse()
    return dims


def _shard_plan(dims: list[tuple[int, int]], ty: int, tx: int, warp_halo: int) -> list[bool]:
    """Which levels run tiled: a level is tiled iff its dims divide the
    mesh, its tile exceeds twice the warp halo, and every finer level is
    tiled too (the build walks fine to coarse; once a level is gathered,
    the coarser levels stay replicated)."""
    sharded = [False] * len(dims)
    ok = True
    for lvl in range(len(dims) - 1, -1, -1):
        h, w = dims[lvl]
        good = h % ty == 0 and w % tx == 0 and h // ty > 2 * warp_halo and w // tx > 2 * warp_halo
        ok = ok and good
        sharded[lvl] = ok
    return sharded


def _inside(u, v, gy0, gx0, gh, gw):
    """Where the warp's global sample point lies inside the image."""
    h, w = u.shape
    yy = torch.arange(h, dtype=torch.float32, device=u.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=u.device)[None, :]
    gy = yy + gy0 + v
    gx = xx + gx0 + u
    return (gy >= 0) & (gy <= gh - 1) & (gx >= 0) & (gx <= gw - 1)


def _warp_tile(img_ext, u, v, halo, gy0, gx0, gh, gw):
    """Backward warp of a halo-extended tile with the local flow, bilinear,
    with the golden model's hard out-of-bounds cut-off at the true image
    borders. |u|, |v| <= halo - 1 (the caller clips)."""
    h, w = u.shape
    yy = torch.arange(h, dtype=torch.float32, device=u.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=u.device)[None, :].expand(h, w)
    val = ops.map_coordinates_bilinear(img_ext, yy + v + halo, xx + u + halo, cval=0.0)
    return torch.where(_inside(u, v, gy0, gx0, gh, gw), val, 0.0)


def _warp_tile_cuda(curr_ext, u, v, halo, gy0, gx0, gh, gw, max_disp,
                    max_disp_v=None, packed_u8=False, packed_u16=False):
    """The banded warp kernel on a halo-extended tile (the fast-path twin
    of :func:`_warp_tile`): the flow is zero-padded to the extended shape,
    the kernel warps the whole extended tile (its local out-of-bounds cut
    never fires at the centre: |flow| <= max_disp < halo), and the centre
    crop gets the exact global-border cut-off. The finest level's tile is
    raw frame data, integer-valued for 8-bit sources (the zero halo keeps
    it so), so the packed-u8 warp is exact there as on one device; the
    caller clips the flow to the band, so the clamp the packed warps
    require is a no-op re-clip."""
    h, w = u.shape
    pad = (halo, halo, halo, halo)
    out_ext = warp.warp_banded(
        curr_ext, F.pad(u, pad), F.pad(v, pad), max_disp=max_disp, max_disp_v=max_disp_v,
        clamp_flow=packed_u8 or packed_u16, packed_u8=packed_u8, packed_u16=packed_u16,
    )
    val = out_ext[halo:halo + h, halo:halo + w]
    return torch.where(_inside(u, v, gy0, gx0, gh, gw), val, 0.0)


def _local_lk_cuda(prev_ext, warped, gy0, gx0, gh, gw, mesh, window, det_threshold):
    """The fused single-scale LK kernel (K6) on extended tiles (fast-path
    twin of ``tiled_flow._local_lk``). ``prev_ext`` is the previous
    frame's tile already extended by ``window // 2 + 1`` px (symmetric
    fill); the warped tile is extended here. The symmetric fill at a true
    image edge is the kernel's own global symmetric pad for the one ring
    that matters; the kernel treats the extended tile as a whole image,
    and its handling of the outer ring reaches only outputs in the
    cropped-away halo. The global half-window border is zeroed after the
    crop."""
    half = window // 2
    ext = half + 1
    h, w = warped.shape
    warped_ext = halo_mod.exchange_halo_2d(warped, ext, mesh, boundary="symm")
    du_e, dv_e = lk.lucas_kanade_fused(prev_ext, warped_ext, window_size=window,
                                       det_threshold=det_threshold)
    return _border_zero(du_e[ext:ext + h, ext:ext + w], dv_e[ext:ext + h, ext:ext + w],
                        gy0, gx0, gh, gw, half)


def _tile_origin(dims, lvl, mesh):
    """Level ``lvl``'s global shape and this rank's tile origin there."""
    lh, lw = dims[lvl]
    _, iy, ix = mesh.coords
    return lh, lw, iy * (lh // mesh.ty), ix * (lw // mesh.tx)


def _refine_tiled(prev_t, curr_t, u, v, dims, lvl, mesh, cfg, backend):
    """Refinement rounds on this rank's tiles of level ``lvl``, the early
    exit read to the host once a round (the parity path's loop; with
    ``backend="cuda"`` the kernels' host-steered twin of
    ``_refine_tiled_device``)."""
    lh, lw, gy0, gx0 = _tile_origin(dims, lvl, mesh)
    finest = lvl == len(dims) - 1
    use_u8 = cfg.warp_packed_u8 and finest and backend == "cuda"
    use_u16 = cfg.warp_packed_u16 and not use_u8 and backend == "cuda"
    md, mdv = cfg.max_disp, cfg.max_disp_v_effective
    warp_halo = md + 1
    window = cfg.window_size
    half = window // 2
    thr = cfg.convergence_threshold
    npix = float(lh * lw)
    # The frames' extended tiles do not change between rounds.
    curr_ext = halo_mod.exchange_halo_2d(curr_t, warp_halo, mesh, boundary="zero")
    if backend == "cuda":
        prev_ext = halo_mod.exchange_halo_2d(prev_t, half + 1, mesh, boundary="symm")
    for i in range(cfg.iterations):
        u = u.clamp(-md, md)
        v = v.clamp(-mdv, mdv)
        if backend == "cuda":
            warped = _warp_tile_cuda(curr_ext, u, v, warp_halo, gy0, gx0, lh, lw, md, mdv,
                                     packed_u8=use_u8, packed_u16=use_u16)
            du, dv = _local_lk_cuda(prev_ext, warped, gy0, gx0, lh, lw, mesh, window,
                                    cfg.det_threshold)
        else:
            warped = _warp_tile(curr_ext, u, v, warp_halo, gy0, gx0, lh, lw)
            avg_ext = halo_mod.exchange_halo_2d((prev_t + warped) * 0.5, half + 1, mesh,
                                                boundary="symm")
            it_ext = halo_mod.exchange_halo_2d(prev_t - warped, half, mesh, boundary="zero")
            du, dv = _local_lk(avg_ext, it_ext, gy0, gx0, lh, lw, window, cfg.det_threshold)
        u = u + du
        v = v + dv
        if i + 1 == cfg.iterations:
            break
        # Global means over the batch slice's tiles; every rank reads the
        # same reduced bits, so every rank runs the same rounds.
        sums = all_reduce_sum(torch.stack([du.abs().sum(), dv.abs().sum()]), mesh.spatial)
        counters.convergence_reads += 1
        if bool((sums[0] / npix < thr) & (sums[1] / npix < thr)):
            break
    return u, v


def _refine_tiled_device(prev_t, curr_t, u, v, dims, lvl, mesh, cfg, ctrl):
    """``cfg.iterations`` rounds of the fast path on this rank's tiles of
    level ``lvl`` under device control: the reference's sharded
    ``lax.while_loop`` with its ``lax.psum`` early exit. ``ctrl`` is the
    level's (3,) int32 latch, ticket, rounds run, all 0 on entry (the
    ticket is the tile round kernel's, 0 between launches)."""
    lh, lw, gy0, gx0 = _tile_origin(dims, lvl, mesh)
    md, mdv = cfg.max_disp, cfg.max_disp_v_effective
    warp_halo = md + 1
    window = cfg.window_size
    ext = window // 2 + 1
    thr = cfg.convergence_threshold
    npix = float(lh * lw)
    th, tw = u.shape
    packing = _warp_packing(cfg, lvl == len(dims) - 1)
    latch = ctrl[0:1]
    pad = (warp_halo,) * 4
    # The frames' extended tiles do not change between rounds.
    curr_ext = halo_mod.exchange_halo_2d(curr_t, warp_halo, mesh, boundary="zero")
    prev_ext = halo_mod.exchange_halo_2d(prev_t, ext, mesh, boundary="symm")
    # Round 0 always runs (the latch starts clear), so what a skipped
    # round keeps here was written before; its sums are undefined, and the
    # latch they are ORed into is set.
    warped_ext = torch.empty_like(curr_ext)
    parts = None
    if curr_t.is_cuda:
        n_blocks = lk.tile_round_blocks(th + 2 * ext, tw + 2 * ext, window)
        parts = torch.empty((2, 1, n_blocks), dtype=torch.float32, device=u.device)
    frozen = latch != 0
    for i in range(cfg.iterations):
        # A frozen flow keeps the bits the round that latched left it.
        u = torch.where(frozen, u, u.clamp(-md, md))
        v = torch.where(frozen, v, v.clamp(-mdv, mdv))
        warp.warp_round(curr_ext, F.pad(u, pad), F.pad(v, pad), warped_ext, latch, max_disp=md,
                        ladder=(mdv,), packing=packing)
        val = warped_ext[warp_halo:warp_halo + th, warp_halo:warp_halo + tw]
        warped = torch.where(_inside(u, v, gy0, gx0, lh, lw), val, 0.0)
        warped_x = halo_mod.exchange_halo_2d(warped, ext, mesh, boundary="symm")
        sums = lk.fused_tile_round(prev_ext, warped_x, u, v, ctrl, gy0=gy0, gx0=gx0, gh=lh,
                                   gw=lw, window_size=window, det_threshold=cfg.det_threshold,
                                   parts=parts)
        if i + 1 == cfg.iterations:
            break  # the last round's latch decides nothing
        # Global means over the batch slice's tiles, reduced on the card:
        # every rank gets the same bits, so every rank latches alike.
        s_all = all_reduce_sum(sums, mesh.spatial)
        latch.bitwise_or_((s_all / npix < thr).all().to(torch.int32))
        frozen = latch != 0
    return u, v


def _one(prev_t, curr_t, mesh, cfg, backend, dims, sharded, ctrl):
    """Tiled pyramidal flow of one frame pair from this rank's finest
    tiles. ``ctrl`` is the pair's (levels, 3) int32 latch table, all 0 on
    entry, or None for the host-steered loop."""
    n_levels = cfg.levels
    sigma = 1.0 / cfg.scale_factor
    first_sharded = sharded.index(True)
    # Distributed pyramid build (fine to coarse): tiles of every tiled
    # level; whole (replicated) levels below, from ONE gather of the
    # coarsest tiled level.
    tiles_prev = {n_levels - 1: prev_t}
    tiles_curr = {n_levels - 1: curr_t}
    for lvl in range(n_levels - 1, first_sharded, -1):
        for tiles in (tiles_prev, tiles_curr):
            tiles[lvl - 1] = dist_pyramid.sharded_downsample(
                tiles[lvl], dims[lvl], dims[lvl - 1], sigma, mesh=mesh)
    full_prev: dict[int, torch.Tensor] = {}
    full_curr: dict[int, torch.Tensor] = {}
    if first_sharded > 0:
        counters.level_gathers += 1
        pair = mesh.gather_spatial(torch.stack([tiles_prev[first_sharded],
                                                tiles_curr[first_sharded]]))
        full_prev[first_sharded], full_curr[first_sharded] = pair[0], pair[1]
        for lvl in range(first_sharded, 0, -1):
            nh, nw = dims[lvl - 1]
            full_prev[lvl - 1] = ops.downsample_fused(full_prev[lvl], nh, nw, sigma)
            full_curr[lvl - 1] = ops.downsample_fused(full_curr[lvl], nh, nw, sigma)

    # Coarse-to-fine solve.
    u = v = None  # replicated flow (whole levels)
    u_t = v_t = None  # tiled flow (this rank's tiles)
    for lvl in range(n_levels):
        lh, lw = dims[lvl]
        if not sharded[lvl]:
            # Replicated level: the same solve on every rank of the slice.
            if lvl == 0:
                u = torch.zeros((lh, lw), dtype=torch.float32, device=prev_t.device)
                v = torch.zeros_like(u)
            else:
                u, v = torch_ref.upsample_flow(u, v, (lh, lw))
            if backend == "cuda":
                # The fast path's level under device control, at the static
                # band: no host read, no collective.
                level_ctrl = ctrl[lvl] if ctrl is not None else torch.zeros(
                    lk.CTRL_ROWS, dtype=torch.int32, device=u.device)
                u, v = _refine_level_device(full_prev[lvl], full_curr[lvl], u, v, cfg, level_ctrl,
                                            None, finest=False)
            else:
                u, v, _ = _refine_level(full_prev[lvl], full_curr[lvl], u, v, cfg,
                                        rtl_clamp=True)
            continue
        if lvl == 0:
            u_t = torch.zeros((lh // mesh.ty, lw // mesh.tx), dtype=torch.float32,
                              device=prev_t.device)
            v_t = torch.zeros_like(u_t)
        elif not sharded[lvl - 1]:
            u_t, v_t = dist_pyramid.replicated_to_sharded_upsample(u, v, (lh, lw), mesh=mesh)
        else:
            u_t, v_t = dist_pyramid.sharded_upsample_flow(u_t, v_t, dims[lvl - 1], (lh, lw),
                                                          mesh=mesh)
        if ctrl is not None:
            u_t, v_t = _refine_tiled_device(tiles_prev[lvl], tiles_curr[lvl], u_t, v_t, dims, lvl,
                                            mesh, cfg, ctrl[lvl])
        else:
            u_t, v_t = _refine_tiled(tiles_prev[lvl], tiles_curr[lvl], u_t, v_t, dims, lvl,
                                     mesh, cfg, backend)
    return u_t, v_t


def tiled_lucas_kanade_pyramidal(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    mesh: FlowMesh,
    config: PyramidConfig | None = None,
    backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal flow of a (B, H, W) frame batch tiled over the mesh.

    Every rank of the mesh calls this with the same global frames and gets
    the global (B, H, W) flow back. Matches ``lucas_kanade_pyramidal(...,
    rtl_clamp=True)`` (the module docstring states how closely) with
    ``backend="torch"``; ``backend="cuda"`` swaps the tile's warp and LK
    solve for the fast path's kernels and keeps the early exit on the
    device (no host read). Raises ``ValueError`` where the mesh does not
    divide the frames or the finest level's tiles are no wider than twice
    the warp halo (``max_disp + 1``)."""
    return _tiled_solve(frame_prev, frame_curr, mesh, config, backend,
                        device_control=backend == "cuda")


def _tiled_solve(frame_prev, frame_curr, mesh, config, backend, device_control):
    """``tiled_lucas_kanade_pyramidal`` under device control (one latch
    table a pair; ``counters.level_rounds`` set) or with the early exit
    read to the host (``device_control=False``; with ``backend="cuda"`` the
    same kernels' host-steered loop, the twin device control is held to)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device_control and backend != "cuda":
        raise ValueError("device control runs the kernels: backend='cuda'")
    cfg = config or PyramidConfig()
    check_tiling(frame_prev.shape, mesh)
    _, gh, gw = frame_prev.shape
    warp_halo = cfg.max_disp + 1
    dims = _level_shapes(gh, gw, cfg.levels, cfg.scale_factor)
    sharded = _shard_plan(dims, mesh.ty, mesh.tx, warp_halo)
    if not sharded[-1]:
        raise ValueError(
            f"finest-level tiles ({gh // mesh.ty}x{gw // mesh.tx}) must exceed twice "
            f"the warp halo ({2 * warp_halo})"
        )
    prev_l = local_tiles(frame_prev, mesh)
    curr_l = local_tiles(frame_curr, mesh)
    outs, ctrls = [], []
    for p, c in zip(prev_l, curr_l):
        ctrl = None
        if device_control:
            ctrl = torch.zeros((cfg.levels, lk.CTRL_ROWS), dtype=torch.int32, device=p.device)
            ctrls.append(ctrl)
        outs.append(_one(p, c, mesh, cfg, backend, dims, sharded, ctrl))
    counters.level_rounds = torch.stack([c[:, 2] for c in ctrls]) if ctrls else None
    return gather_tiles(torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                        mesh)
