"""Pyramidal (coarse-to-fine) Lucas-Kanade dense flow.

Counterpart of ``tpuflow.flow.pyramidal``: a loop over levels, coarse to
fine, and at each level up to ``cfg.iterations`` rounds of warp -> residual
LK -> accumulate with the reference's early exit.

``backend="torch"`` is the parity path (the JAX package's ``"jnp"``).
``backend="cuda"`` is the fast path (its ``"pallas"``), for every named
config: each round is one banded warp kernel (K1/K2 packed, K4 exact) and
one fused refine kernel (K3 relaxed order, K5 exact order), which launch
their CUDA kernels for CUDA tensors and run their plain PyTorch versions
for CPU tensors (``kernels.warp``, ``kernels.lk``).

The fast path keeps the reference's control flow on the device and reads
nothing to the host. The reference runs a level's rounds in a
``lax.while_loop`` whose condition is ``i < iterations & ~converged`` and
picks the adaptive band with ``lax.switch``. Here each level launches all
``cfg.iterations`` rounds, and each round's kernels read the level's
converged latch and the band index from device memory: a round after
convergence passes the flow through bit for bit (``warp.warp_round``,
``lk.refine_round``), the refine kernel latches its own sums, and the band
index from ``_select_band_index`` stays a device tensor. The rounds run at
each level are counted on the device (``counters.level_rounds``, read by a
caller after the frame if it wants them). So one step is a fixed sequence
of launches, which ``flow.graphed`` captures as a CUDA graph; on CPU
tensors the plain versions run the same driver.

The parity path keeps the reference's control flow with host reads: the
early-exit flag is read once per round (the ``lax.while_loop`` condition),
and with ``rtl_clamp`` and an adaptive band ladder the band index once per
level (the ``lax.switch`` operand). Both are counted in ``counters``; the
fast path leaves them at 0.

Batched streams (the reference's ``jax.vmap`` over the solve, BASELINE
config 4): every entry point also takes (B, H, W) frames and pyramids of
(B, h, w) levels, B independent streams. Each element is solved as its own
stream would be: its own band at each level, its own latch and round
count. On the fast path that is one launch a round for the whole batch,
each kernel reading its plane's latch and band index (``ctrl`` holds one
column an element, the band one index an element), and an element's flow
is its 2-D solve's bit for bit. Under ``vmap`` the reference runs a
level until every element has converged, its refine kernel re-clips a
converged element and its ``lax.switch`` runs every band on every
element; the batched ``lax.while_loop`` keeps an element's carry once its
own condition fails, so the per-frame result stands, and the port keeps
it (ROADMAP divergence p). The parity path solves each element in turn,
its host reads counted as a plane's.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow.single_scale import BACKENDS, Backend, lucas_kanade_single_scale
from tpuflow_torch.kernels import lk, torch_ref, warp


@dataclasses.dataclass
class Counters:
    """Host reads made by the pyramidal solve, and the rounds it ran."""

    convergence_reads: int = 0  # early-exit flags read to the host
    band_reads: int = 0  # adaptive band indices read to the host
    # Rounds run at each level by the latest parity-path solve, coarsest
    # level first (for a batch, one such list an element).
    level_iterations: list = dataclasses.field(default_factory=list)
    # The same for the latest fast-path solve: an int32 (levels,) tensor on
    # the solve's device, (B, levels) for a batch, written by the kernels
    # (never read here).
    level_rounds: torch.Tensor | None = None
    # Keyframe reseeds the VO front end's steps took (the reference's
    # lax.cond branch), by device: a one-element int32 tensor that the seed
    # kernel adds to on the device (``reseeds``). ``reset`` zeroes it in
    # place, so a captured step goes on adding to the tensor read here.
    reseed_counts: dict = dataclasses.field(default_factory=dict)

    def reseeds(self, device: torch.device) -> torch.Tensor:
        """The reseed counter on ``device``, made at its first use."""
        if device not in self.reseed_counts:
            self.reseed_counts[device] = torch.zeros(1, dtype=torch.int32, device=device)
        return self.reseed_counts[device]

    def reset(self) -> None:
        self.convergence_reads = 0
        self.band_reads = 0
        self.level_iterations = []
        self.level_rounds = None
        for count in self.reseed_counts.values():
            count.zero_()


counters = Counters()


def _warp_packing(cfg: PyramidConfig, finest: bool) -> str:
    """The fast path's warp variant: packed-u8 on the finest level (the raw
    8-bit frame), packed-u16 on the blurred coarse levels, f32 corners
    (K4) wherever the config packs nothing."""
    if cfg.warp_packed_u8 and finest:
        return "u8"
    if cfg.warp_packed_u16:
        return "u16"
    return "exact"


def _refine_level(
    img_prev: torch.Tensor,
    img_curr: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    cfg: PyramidConfig,
    rtl_clamp: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The parity path's level: iterative warp -> residual LK -> accumulate
    with the early exit read to the host.

    The residual is always accumulated; the loop then exits once both
    mean |du| and mean |dv| are below the convergence threshold. Returns
    the refined flow and the number of rounds run.
    """
    thr = cfg.convergence_threshold
    mdv = cfg.max_disp_v_effective
    u, v = flow_u, flow_v
    converged = torch.zeros((), dtype=torch.bool, device=img_prev.device)
    rounds = 0
    while rounds < cfg.iterations:
        if rtl_clamp:
            u = u.clamp(-cfg.max_disp, cfg.max_disp)
            v = v.clamp(-mdv, mdv)
        warped = torch_ref.warp_image(img_curr, u, v)
        du, dv = lucas_kanade_single_scale(
            img_prev, warped, cfg.window_size, det_threshold=cfg.det_threshold, backend="torch",
        )
        u = torch.where(converged, u, u + du)
        v = torch.where(converged, v, v + dv)
        converged = converged | ((du.abs().mean() < thr) & (dv.abs().mean() < thr))
        rounds += 1
        if rounds < cfg.iterations:
            counters.convergence_reads += 1
            if bool(converged):
                break
    return u, v, rounds


def _select_band_index(
    flow_v: torch.Tensor,
    bands: tuple[int, ...],
    frac_threshold: float,
    margin: int,
) -> torch.Tensor:
    """Index of the narrowest adequate vertical band, from the upsampled
    coarse-level flow: band ``b`` is rejected if more than
    ``frac_threshold`` of the masked interior's |v| exceeds ``b - 1``.
    Returns a 0-d int32 tensor on the flow's device for an (H, W) flow, and
    a (B,) one, each element's own index, for a (B, H, W) batch (the
    counts are sums of ones, exact in any order, so each equals its
    plane's)."""
    h, w = flow_v.shape[-2:]
    m_y = min(margin, max((h - 1) // 2, 0))
    m_x = min(margin, max((w - 1) // 2, 0))
    interior = flow_v[..., m_y : h - m_y, m_x : w - m_x].abs()
    n = interior.shape[-2] * interior.shape[-1]
    idx = torch.zeros(flow_v.shape[:-2], dtype=torch.int32, device=flow_v.device)
    for b in bands[:-1]:
        frac = (interior > (b - 1.0)).to(torch.float32).sum(dim=(-2, -1)) / n
        idx = idx + (frac > frac_threshold).to(torch.int32)
    return idx


def _refine_level_device(
    img_prev: torch.Tensor,
    img_curr: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    cfg: PyramidConfig,
    ctrl: torch.Tensor,
    band: torch.Tensor | None,
    finest: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cfg.iterations`` rounds of the fast path at one level under device
    control: round r does work only if the level had not converged before
    it (``ctrl``'s latch, the reference's while-loop condition); the band
    is ``adaptive_v_bands[band]``, or the static band where ``band`` is
    None. ``ctrl`` is this level's (3,) int32 latch, ticket and round count,
    all 0 on entry; for a (B, h, w) batch (3, B), one column and one band
    index an element."""
    ladder = cfg.adaptive_v_bands if band is not None else (cfg.max_disp_v_effective,)
    packing = _warp_packing(cfg, finest)
    # Round 0 always runs (the latch starts clear), so a skipped round's
    # kept ``warped`` is never read before it is written.
    warped = torch.empty_like(img_curr)
    u, v = flow_u, flow_v
    for _ in range(cfg.iterations):
        warp.warp_round(img_curr, u, v, warped, ctrl[0], max_disp=cfg.max_disp, ladder=ladder,
                        band=band, packing=packing)
        u, v, _ = lk.refine_round(
            img_prev, warped, u, v, ctrl, ladder=tuple(float(b) for b in ladder), band=band,
            window_size=cfg.window_size, det_threshold=cfg.det_threshold,
            max_disp=float(cfg.max_disp), convergence_threshold=cfg.convergence_threshold,
            relaxed_order=cfg.relaxed_order,
        )
    return u, v


def _refine_level_adaptive(
    img_prev: torch.Tensor,
    img_curr: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    cfg: PyramidConfig,
    rtl_clamp: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``_refine_level`` at the vertical band picked from the coarse
    solve's interior |v| statistics (one host read per level)."""
    bands = cfg.adaptive_v_bands
    assert bands is not None
    margin = 2 * (cfg.max_disp + cfg.window_size)
    idx = int(_select_band_index(flow_v, bands, cfg.adaptive_v_frac, margin))
    counters.band_reads += 1
    vcfg = dataclasses.replace(cfg, max_disp_v=bands[idx], adaptive_v_bands=None)
    return _refine_level(img_prev, img_curr, flow_u, flow_v, vcfg, rtl_clamp)


def lucas_kanade_pyramidal(
    frame_prev: torch.Tensor,
    frame_curr: torch.Tensor,
    num_levels: int = 3,
    window_size: int = 5,
    num_iterations: int = 3,
    *,
    config: PyramidConfig | None = None,
    backend: Backend = "torch",
    rtl_clamp: bool = False,
    return_levels: bool = False,
):
    """Coarse-to-fine dense flow between two (H, W) float32 frames, or
    between each pair of two (B, H, W) batches (B independent streams, each
    element solved as alone; the reference's ``jax.vmap``).

    Gaussian pyramids (sigma = 1/scale smoothing + linspace bilinear
    resample), zero flow at the coarsest level, then per level
    upsample-and-scale and up to ``iterations`` rounds of (warp, residual
    LK, accumulate) with early exit. ``return_levels=True`` also returns the
    per-level flows ``[(u_0, v_0), ...]``, coarsest first.

    **8-bit input contract** (configs with ``warp_packed_u8``, such as
    ``production``, under ``backend="cuda"``): frames carry integer values
    in [0, 255]. ``warp_packed_u16`` needs values in [0, 255].
    """
    cfg = config or PyramidConfig(
        levels=num_levels, window_size=window_size, iterations=num_iterations
    )
    pyr_prev = torch_ref.build_gaussian_pyramid(frame_prev, cfg.levels, cfg.scale_factor)
    pyr_curr = torch_ref.build_gaussian_pyramid(frame_curr, cfg.levels, cfg.scale_factor)
    return lucas_kanade_pyramidal_from_pyramids(
        pyr_prev, pyr_curr, cfg, backend=backend, rtl_clamp=rtl_clamp,
        return_levels=return_levels,
    )


def lucas_kanade_pyramidal_from_pyramids(
    pyr_prev: list[torch.Tensor],
    pyr_curr: list[torch.Tensor],
    cfg: PyramidConfig,
    *,
    backend: Backend = "torch",
    rtl_clamp: bool = False,
    return_levels: bool = False,
):
    """Coarse-to-fine refinement on prebuilt Gaussian pyramids (coarse
    first), so a stream can reuse each frame's pyramid. Levels are (h, w)
    planes or (B, h, w) batches, one stream an element."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if pyr_prev[0].ndim not in (2, 3) or any(
            a.shape != b.shape or a.ndim != pyr_prev[0].ndim for a, b in zip(pyr_prev, pyr_curr)):
        raise ValueError("the two pyramids must hold levels of one shape each, all (h, w) or "
                         "all (B, h, w)")
    if backend == "cuda":
        return _from_pyramids_device(pyr_prev, pyr_curr, cfg, return_levels)
    if pyr_prev[0].ndim == 3:
        return _from_pyramids_each(pyr_prev, pyr_curr, cfg, backend, rtl_clamp, return_levels)
    flow_u = torch.zeros_like(pyr_prev[0])
    flow_v = torch.zeros_like(pyr_prev[0])

    # The adaptive band exists only where the flow is clamped (here with
    # rtl_clamp), and only at levels with a coarse solve to derive it from.
    adaptive = cfg.adaptive_v_bands is not None and rtl_clamp

    levels = []
    iterations = []
    for level in range(cfg.levels):
        img_prev = pyr_prev[level]
        img_curr = pyr_curr[level]
        if level > 0:
            flow_u, flow_v = torch_ref.upsample_flow(flow_u, flow_v, tuple(img_prev.shape))
        refine = _refine_level_adaptive if adaptive and level > 0 else _refine_level
        flow_u, flow_v, rounds = refine(img_prev, img_curr, flow_u, flow_v, cfg, rtl_clamp)
        iterations.append(rounds)
        if return_levels:
            levels.append((flow_u, flow_v))
    counters.level_iterations = iterations

    if return_levels:
        return flow_u, flow_v, levels
    return flow_u, flow_v


def _from_pyramids_each(pyr_prev, pyr_curr, cfg: PyramidConfig, backend: Backend,
                        rtl_clamp: bool, return_levels: bool):
    """The parity path on a batch: each element's solve in turn, with its
    own early exit and band and its own host reads, counted as a plane's.
    ``counters.level_iterations`` holds one list of rounds an element."""
    outs, iterations = [], []
    for b in range(pyr_prev[0].shape[0]):
        outs.append(lucas_kanade_pyramidal_from_pyramids(
            [p[b] for p in pyr_prev], [c[b] for c in pyr_curr], cfg, backend=backend,
            rtl_clamp=rtl_clamp, return_levels=return_levels))
        iterations.append(counters.level_iterations)
    counters.level_iterations = iterations
    u = torch.stack([o[0] for o in outs])
    v = torch.stack([o[1] for o in outs])
    if not return_levels:
        return u, v
    levels = [(torch.stack([o[2][i][0] for o in outs]), torch.stack([o[2][i][1] for o in outs]))
              for i in range(cfg.levels)]
    return u, v, levels


def _from_pyramids_device(pyr_prev, pyr_curr, cfg: PyramidConfig, return_levels: bool):
    """The fast path's coarse-to-fine solve under device control: no host
    read, the same launches every frame, one launch a round for a whole
    batch."""
    dev = pyr_prev[0].device
    flow_u = torch.zeros_like(pyr_prev[0])
    flow_v = torch.zeros_like(pyr_prev[0])
    # Each level's latch, ticket and round count (one column an element of
    # a batch), cleared once a solve.
    ctrl = torch.zeros((cfg.levels, lk.CTRL_ROWS, *pyr_prev[0].shape[:-2]), dtype=torch.int32,
                       device=dev)
    margin = 2 * (cfg.max_disp + cfg.window_size)
    levels = []
    for level in range(cfg.levels):
        img_prev = pyr_prev[level]
        band = None
        if level > 0:
            flow_u, flow_v = torch_ref.upsample_flow(flow_u, flow_v, tuple(img_prev.shape))
            if cfg.adaptive_v_bands is not None:
                band = _select_band_index(flow_v, cfg.adaptive_v_bands, cfg.adaptive_v_frac,
                                          margin)
        flow_u, flow_v = _refine_level_device(
            img_prev, pyr_curr[level], flow_u, flow_v, cfg, ctrl[level], band,
            finest=level == cfg.levels - 1)
        if return_levels:
            levels.append((flow_u, flow_v))
    # (levels,) for a plane; (B, levels) for a batch, as the tiled path's.
    counters.level_rounds = ctrl[:, 2].T if ctrl.ndim == 3 else ctrl[:, 2]
    if return_levels:
        return flow_u, flow_v, levels
    return flow_u, flow_v


def lucas_kanade_pyramidal_step(
    pyr_prev: list[torch.Tensor],
    frame_curr: torch.Tensor,
    cfg: PyramidConfig,
    *,
    backend: Backend = "torch",
    rtl_clamp: bool = False,
):
    """One streaming step: ``(pyr_prev, frame) -> (u, v, pyr_curr)``, for
    an (H, W) frame or a (B, H, W) batch of B independent streams (the
    carry's levels then (B, h, w)).

    Builds only the new frame's pyramid and returns it as the next step's
    carry. Seed the carry with ``torch_ref.build_gaussian_pyramid(first,
    cfg.levels, cfg.scale_factor)``, or with ``convert.pyramid_from_numpy``
    to continue a stream started elsewhere.
    """
    pyr_curr = torch_ref.build_gaussian_pyramid(frame_curr, cfg.levels, cfg.scale_factor)
    u, v = lucas_kanade_pyramidal_from_pyramids(
        pyr_prev, pyr_curr, cfg, backend=backend, rtl_clamp=rtl_clamp
    )
    return u, v, pyr_curr
