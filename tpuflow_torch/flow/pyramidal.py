"""Pyramidal (coarse-to-fine) Lucas-Kanade dense flow.

Counterpart of ``tpuflow.flow.pyramidal``: a loop over levels, coarse to
fine, and at each level up to ``cfg.iterations`` rounds of warp -> residual
LK -> accumulate with the reference's early exit.

``backend="torch"`` is the parity path (the JAX package's ``"jnp"``).
``backend="cuda"`` is the fast path (its ``"pallas"``): each round is one
banded warp kernel and one fused refine kernel (``kernels.warp``,
``kernels.lk``), which launch their CUDA kernels for CUDA tensors and run
their plain PyTorch versions for CPU tensors.

Two kinds of host read keep the JAX control flow exactly: the early-exit
flag is read once per round (the ``lax.while_loop`` condition), and with
an adaptive band ladder the band index once per level (the ``lax.switch``
operand). Both are counted in ``counters``.
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
    # Rounds run at each level by the latest solve, coarsest level first.
    level_iterations: list[int] = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.convergence_reads = 0
        self.band_reads = 0
        self.level_iterations = []


counters = Counters()


def _warp_packing(cfg: PyramidConfig, finest: bool) -> str:
    """The fast path's warp variant: packed-u8 on the finest level (the raw
    8-bit frame), packed-u16 on the blurred coarse levels."""
    if cfg.warp_packed_u8 and finest:
        return "u8"
    if cfg.warp_packed_u16:
        return "u16"
    raise NotImplementedError(
        "backend='cuda' with unpacked warps needs the exact banded warp "
        "kernel (pallas_warp._warp_block exact branch, K4), which is not "
        "ported yet; use a packed config such as 'production' or "
        "backend='torch'"
    )


def _check_fast_path(cfg: PyramidConfig) -> None:
    if not cfg.relaxed_order:
        raise NotImplementedError(
            "backend='cuda' with exact-order sums needs the exact-order refine "
            "kernel (pallas_lk._lk_tile relaxed_order=False, K5), which is not "
            "ported yet; use a relaxed-order config such as 'production' or "
            "backend='torch'"
        )
    for finest in (False, True):
        _warp_packing(cfg, finest)


def _refine_level(
    img_prev: torch.Tensor,
    img_curr: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    cfg: PyramidConfig,
    backend: Backend,
    rtl_clamp: bool = False,
    finest: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Iterative warp -> residual LK -> accumulate at one level.

    The residual is always accumulated; the loop then exits once both
    mean |du| and mean |dv| are below the convergence threshold. Returns
    the refined flow and the number of rounds run.
    """
    n_px = img_prev.shape[0] * img_prev.shape[1]
    thr = cfg.convergence_threshold
    mdv = cfg.max_disp_v_effective
    u, v = flow_u, flow_v
    converged = torch.zeros((), dtype=torch.bool, device=img_prev.device)
    rounds = 0
    while rounds < cfg.iterations:
        if backend == "cuda":
            warped = warp.warp_banded(
                img_curr, u, v, max_disp=cfg.max_disp, max_disp_v=mdv,
                packing=_warp_packing(cfg, finest),
            )
            u, v, sdu, sdv = lk.lucas_kanade_refine(
                img_prev, warped, u, v, converged,
                window_size=cfg.window_size, det_threshold=cfg.det_threshold,
                max_disp=float(cfg.max_disp), max_disp_v=float(mdv),
            )
            # f32 on the device, as tpuflow's sdu / n_px < thr.
            now_converged = (sdu / n_px < thr) & (sdv / n_px < thr)
        else:
            if rtl_clamp:
                u = u.clamp(-cfg.max_disp, cfg.max_disp)
                v = v.clamp(-mdv, mdv)
            warped = torch_ref.warp_image(img_curr, u, v)
            du, dv = lucas_kanade_single_scale(
                img_prev, warped, cfg.window_size,
                det_threshold=cfg.det_threshold, backend="torch",
            )
            u = torch.where(converged, u, u + du)
            v = torch.where(converged, v, v + dv)
            now_converged = (du.abs().mean() < thr) & (dv.abs().mean() < thr)
        converged = converged | now_converged
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
    Returns a 0-d int32 tensor on the flow's device."""
    h, w = flow_v.shape
    m_y = min(margin, max((h - 1) // 2, 0))
    m_x = min(margin, max((w - 1) // 2, 0))
    interior = flow_v[m_y : h - m_y, m_x : w - m_x].abs()
    n = interior.numel()
    idx = torch.zeros((), dtype=torch.int32, device=flow_v.device)
    for b in bands[:-1]:
        frac = (interior > (b - 1.0)).to(torch.float32).sum() / n
        idx = idx + (frac > frac_threshold).to(torch.int32)
    return idx


def _refine_level_adaptive(
    img_prev: torch.Tensor,
    img_curr: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    cfg: PyramidConfig,
    backend: Backend,
    rtl_clamp: bool = False,
    finest: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``_refine_level`` at the vertical band picked from the coarse
    solve's interior |v| statistics (one host read per level)."""
    bands = cfg.adaptive_v_bands
    assert bands is not None
    margin = 2 * (cfg.max_disp + cfg.window_size)
    idx = int(_select_band_index(flow_v, bands, cfg.adaptive_v_frac, margin))
    counters.band_reads += 1
    vcfg = dataclasses.replace(cfg, max_disp_v=bands[idx], adaptive_v_bands=None)
    return _refine_level(
        img_prev, img_curr, flow_u, flow_v, vcfg, backend, rtl_clamp, finest
    )


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
    """Coarse-to-fine dense flow between two (H, W) float32 frames.

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
    first), so a stream can reuse each frame's pyramid."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda":
        _check_fast_path(cfg)
    flow_u = torch.zeros_like(pyr_prev[0])
    flow_v = torch.zeros_like(pyr_prev[0])

    # The adaptive band exists only where the flow is clamped (fast path or
    # rtl_clamp), and only at levels with a coarse solve to derive it from.
    adaptive = cfg.adaptive_v_bands is not None and (backend == "cuda" or rtl_clamp)

    levels = []
    iterations = []
    for level in range(cfg.levels):
        img_prev = pyr_prev[level]
        img_curr = pyr_curr[level]
        if level > 0:
            flow_u, flow_v = torch_ref.upsample_flow(flow_u, flow_v, tuple(img_prev.shape))
        finest = level == cfg.levels - 1
        refine = _refine_level_adaptive if adaptive and level > 0 else _refine_level
        flow_u, flow_v, rounds = refine(
            img_prev, img_curr, flow_u, flow_v, cfg, backend, rtl_clamp, finest
        )
        iterations.append(rounds)
        if return_levels:
            levels.append((flow_u, flow_v))
    counters.level_iterations = iterations

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
    """One streaming step: ``(pyr_prev, frame) -> (u, v, pyr_curr)``.

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
