"""Bundle adjustment with Schur-complement reduction.

Counterpart of ``tpuflow.vo.ba``:

- a fixed-size observation table (``obs_uv``, ``obs_cam``, ``obs_lm``,
  ``obs_valid``); dead observations carry zero weight;
- per-observation (2x6, 2x3) Jacobians of the residual at the identity
  tangent, in closed form (the reference takes ``jax.jacfwd``; the tests
  hold the two to each other): with ``pc = R p + t`` and the left update
  ``exp(xi) (R, t)``, d pc / d xi = [I | -hat(pc)] and d pc / d p = R;
- the per-camera, per-landmark and per-(landmark, camera) sums as sorted
  segment sums (``segment_sum``), which add in the same order on every
  run: on the card ``index_add_`` adds by atomics in an order that
  changes from run to run, and the LM accept/reject loop amplifies such
  differences;
- the reduced camera system ``S = H_pp - B H_ll^-1 B^T``, gauge fixed by
  exact elimination, solved densely after Jacobi scaling (6K x 6K for K
  keyframes).

Observations sharded across devices (``axis_name``) are multi-GPU work,
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuflow_torch.vo import se3
from tpuflow_torch.vo._precision import pin_matmul_precision


class BAProblem(NamedTuple):
    poses_r: torch.Tensor    # (K, 3, 3)
    poses_t: torch.Tensor    # (K, 3)
    landmarks: torch.Tensor  # (M, 3)
    obs_uv: torch.Tensor     # (N, 2) pixel observations
    obs_cam: torch.Tensor    # (N,) int camera index
    obs_lm: torch.Tensor     # (N,) int landmark index
    obs_valid: torch.Tensor  # (N,) bool
    intrinsics: torch.Tensor  # (4,) = (fx, fy, cx, cy)


def _no_axis(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "bundle adjustment over observations sharded across devices is "
            "multi-GPU work, not ported yet (ROADMAP.md, queue 1 item 9)"
        )


def segment_sum(values: torch.Tensor, keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``zeros((num_segments, ...)).index_add_(0, keys, values)`` with a
    fixed order of addition: the rows are stably sorted by key, placed in
    a (segment, rank) table and summed along the rank, a reduction PyTorch
    takes in one order for a given shape. Keys lie in [0, num_segments).
    Reads the largest segment's size to the host."""
    n = keys.shape[0]
    flat = values.reshape(n, int(np.prod(values.shape[1:])))
    out_shape = (num_segments, *values.shape[1:])
    if n == 0:
        return values.new_zeros(out_shape)
    keys = keys.to(torch.int64)
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]
    counts = torch.bincount(sorted_keys, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=keys.device) - starts[sorted_keys]
    table = flat.new_zeros(num_segments, int(counts.max()), flat.shape[1])
    table[sorted_keys, rank] = flat[order]
    return table.sum(dim=1).reshape(out_shape)


def project(r, t, p, intrinsics):
    """Pinhole projection of world points p (..., 3) under (R, t)."""
    pc = (r @ p[..., None])[..., 0] + t
    fx, fy, cx, cy = intrinsics.unbind(-1)
    z = pc[..., 2].clamp(min=1e-6)
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)


def reprojection_errors(p: BAProblem) -> torch.Tensor:
    """(N,) residual norms (invalid observations read 0)."""
    pred = project(p.poses_r[p.obs_cam], p.poses_t[p.obs_cam], p.landmarks[p.obs_lm],
                   p.intrinsics)
    d = pred - p.obs_uv
    e = torch.sqrt((d * d).sum(dim=1))
    return torch.where(p.obs_valid, e, 0.0)


def _obs_blocks(p: BAProblem, huber_delta: float):
    """Per-observation residuals, Jacobians and robust weights.

    Weight: Huber down to ``huber_delta``, zero beyond 25x it, and zero
    where the landmark sits at or behind the camera (depth <= 1e-2)."""
    r = p.poses_r[p.obs_cam]
    t = p.poses_t[p.obs_cam]
    pc = (r @ p.landmarks[p.obs_lm][..., None])[..., 0] + t
    fx, fy, cx, cy = p.intrinsics.unbind(-1)
    z = pc[:, 2].clamp(min=1e-6)
    res = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], dim=1) - p.obs_uv

    # d (u, v) / d pc; the clamp passes d z only above its floor.
    live = (pc[:, 2] > 1e-6).to(pc.dtype)
    zero = torch.zeros_like(z)
    z2 = z * z
    j_proj = torch.stack([
        torch.stack([fx / z, zero, -fx * pc[:, 0] / z2 * live], dim=1),
        torch.stack([zero, fy / z, -fy * pc[:, 1] / z2 * live], dim=1),
    ], dim=1)  # (N, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    jp = j_proj @ torch.cat([eye, -se3.hat(pc)], dim=2)  # (N, 2, 6)
    jl = j_proj @ r                                       # (N, 2, 3)

    norm = torch.sqrt((res * res).sum(dim=1))
    huber = torch.where(norm <= huber_delta, 1.0, huber_delta / (norm + 1e-12))
    w = torch.where(p.obs_valid, huber, 0.0)
    w = torch.where(norm > 25.0 * huber_delta, 0.0, w)
    w = torch.where(pc[:, 2] > 1e-2, w, 0.0)
    return res, jp, jl, w


def _damp(h: torch.Tensor, damping: float) -> torch.Tensor:
    """Levenberg-style relative damping plus a 1e-6 absolute floor."""
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    return h + torch.diag_embed(damping * d + 1e-6)


@pin_matmul_precision
def gauss_newton_step(
    p: BAProblem,
    damping: float = 1e-4,
    huber_delta: float = 4.0,
    axis_name: str | None = None,
    num_cams: int | None = None,
    num_lms: int | None = None,
    fixed_cams: tuple[int, ...] = (0,),
) -> BAProblem:
    """One damped Gauss-Newton step with Schur-complement reduction.

    ``fixed_cams``: cameras pinned by exact elimination. Monocular BA has a
    7-DOF gauge (pose of one camera + global scale); pin two cameras, or
    one camera plus external scale, for a fully determined system."""
    _no_axis(axis_name)
    k = num_cams or p.poses_r.shape[0]
    m = num_lms or p.landmarks.shape[0]

    res, jp, jl, w = _obs_blocks(p, huber_delta)
    ww = w[:, None, None]
    jpt = jp.transpose(1, 2)
    jlt = jl.transpose(1, 2)
    hpp_o = (jpt @ jp) * ww
    hll_o = (jlt @ jl) * ww
    hpl_o = (jpt @ jl) * ww
    wres = (res * w[:, None])[..., None]
    bp_o = -(jpt @ wres)[..., 0]
    bl_o = -(jlt @ wres)[..., 0]

    cam, lm = p.obs_cam.to(torch.int64), p.obs_lm.to(torch.int64)
    hpp = segment_sum(hpp_o, cam, k)
    hll = segment_sum(hll_o, lm, m)
    b_blocks = segment_sum(hpl_o, lm * k + cam, m * k).reshape(m, k, 6, 3)
    bp = segment_sum(bp_o, cam, k)
    bl = segment_sum(bl_o, lm, m)

    hll = _damp(hll, damping)
    hpp = _damp(hpp, damping)
    hll_inv = torch.linalg.inv_ex(hll)[0]

    # Reduced camera system: S = blockdiag(H_pp) - sum_m B_m H_ll,m^-1 B_m^T.
    diag = torch.arange(k, device=hpp.device)
    s = hpp.new_zeros(k, 6, k, 6)
    s[diag, :, diag, :] = hpp
    b_hinv = torch.einsum("mkab,mbc->mkac", b_blocks, hll_inv)
    s = s - torch.einsum("mkac,mldc->kald", b_hinv, b_blocks)
    rhs = bp - torch.einsum("mkac,mc->ka", b_hinv, bl)

    # Gauge fixing by exact elimination: fixed cameras get dx = 0.
    for c in fixed_cams:
        s[c] = 0.0
        s[:, :, c] = 0.0
        s[c, :, c, :] = torch.eye(6, dtype=s.dtype, device=s.device)
        rhs[c] = 0.0

    # Jacobi-scaled dense solve (the raw system spans ~f^2 in f32).
    s2 = s.reshape(6 * k, 6 * k)
    d = torch.rsqrt(torch.diagonal(s2).clamp(min=1e-12))
    s2 = s2 * d[:, None] * d[None, :]
    y = torch.linalg.solve_ex(s2, (rhs.reshape(6 * k) * d)[:, None])[0][:, 0]
    dxp = (y * d).reshape(k, 6)

    # Back-substitute landmarks: dx_l = H_ll^-1 (b_l - B^T dx_p).
    bt_dxp = torch.einsum("mkab,ka->mb", b_blocks, dxp)
    dxl = (hll_inv @ (bl - bt_dxp)[..., None])[..., 0]

    new_r, new_t = se3.retract(p.poses_r, p.poses_t, dxp)
    return p._replace(poses_r=new_r, poses_t=new_t, landmarks=p.landmarks + dxl)


def _robust_cost(p: BAProblem, huber_delta: float) -> float:
    """Huber-robustified total reprojection cost over valid observations
    (one host read)."""
    e = reprojection_errors(p)
    quad = 0.5 * e * e
    lin = huber_delta * (e - 0.5 * huber_delta)
    c = torch.where(e <= huber_delta, quad, lin)
    return float(torch.where(p.obs_valid, c, 0.0).sum())


def solve(
    p: BAProblem,
    iterations: int = 10,
    damping: float = 1e-4,
    huber_delta: float = 4.0,
    axis_name: str | None = None,
    fixed_cams: tuple[int, ...] = (0,),
    adaptive: bool = True,
) -> BAProblem:
    """Run ``iterations`` damped Gauss-Newton steps.

    ``adaptive`` (the Levenberg-Marquardt schedule, driven from the host):
    a step that raises the robust cost is rejected and retried at 10x the
    damping; an accepted step divides it by 3. ``adaptive=False`` runs the
    fixed-damping loop."""
    _no_axis(axis_name)
    if not adaptive:
        for _ in range(iterations):
            p = gauss_newton_step(p, damping=damping, huber_delta=huber_delta,
                                  fixed_cams=fixed_cams)
        return p

    lam = damping
    cost = _robust_cost(p, huber_delta)
    for _ in range(iterations):
        trial = gauss_newton_step(p, damping=lam, huber_delta=huber_delta,
                                  fixed_cams=fixed_cams)
        trial_cost = _robust_cost(trial, huber_delta)
        if trial_cost <= cost or not np.isfinite(cost):
            p, cost = trial, trial_cost
            lam = max(lam / 3.0, 1e-8)
        else:
            lam = min(lam * 10.0, 1e4)
    return p
