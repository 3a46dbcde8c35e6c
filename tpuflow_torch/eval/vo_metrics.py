"""Trajectory accuracy metrics for the VO back-end: ATE and RPE.

The flow side of the framework is gated by the 13-pattern metric suite
(tpuflow.eval.verifier, mirroring reference
python/optical_flow_verifier.py:586-634); this is the same ruler for the
trajectory side, which the reference has no counterpart for. Standard
TUM-RGBD-style definitions:

- **ATE (absolute trajectory error)**: RMSE of camera positions after
  the optimal similarity alignment (Umeyama) of the estimated trajectory
  onto ground truth. Monocular VO has a 7-DOF gauge freedom (SE(3) +
  scale), so alignment is Sim(3) by default.
- **RPE (relative pose error)**: RMSE over per-step relative-pose
  deltas — translation magnitude (world units, after applying the
  Umeyama scale) and rotation angle (degrees). Drift per step, immune to
  the global gauge.

A copy of ``tpuflow.eval.vo_metrics`` (pure NumPy), so the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def camera_centers(poses_r: np.ndarray, poses_t: np.ndarray) -> np.ndarray:
    """World-frame camera positions from world->camera poses.

    ``x_cam = R x_world + t`` => center ``c = -R^T t``.
    """
    poses_r = np.asarray(poses_r, np.float64)
    poses_t = np.asarray(poses_t, np.float64)
    return -np.einsum("kij,ki->kj", poses_r, poses_t)


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform mapping ``src`` onto ``dst``.

    Umeyama (TPAMI 1991) closed form: returns (s, R, t) minimizing
    ``sum ||dst_i - (s * R @ src_i + t)||^2``. ``with_scale=False``
    constrains s=1 (SE(3) alignment, for metric-scale trajectories).
    Both inputs are (N, 3) point sets, N >= 3 for a unique rotation
    (degenerate sets still yield the optimal residual, just not a unique
    R).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"point sets must both be (N, 3), got {src.shape} vs {dst.shape}")
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    x = src - mu_src
    y = dst - mu_dst
    n = src.shape[0]
    cov = y.T @ x / n
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    rot = u @ sgn @ vt
    if with_scale:
        var_src = (x * x).sum() / n
        scale = float(np.trace(np.diag(d) @ sgn) / max(var_src, 1e-18))
    else:
        scale = 1.0
    trans = mu_dst - scale * rot @ mu_src
    return scale, rot, trans


def ate_rmse(
    est_r: np.ndarray,
    est_t: np.ndarray,
    gt_r: np.ndarray,
    gt_t: np.ndarray,
    with_scale: bool = True,
) -> Tuple[float, float]:
    """Absolute trajectory error after optimal (Sim(3)) alignment.

    Returns ``(rmse, scale)`` — the aligned position RMSE in ground-truth
    units and the recovered monocular scale factor.
    """
    est_c = camera_centers(est_r, est_t)
    gt_c = camera_centers(gt_r, gt_t)
    scale, rot, trans = umeyama_alignment(est_c, gt_c, with_scale=with_scale)
    aligned = scale * est_c @ rot.T + trans
    err = aligned - gt_c
    return float(np.sqrt((err * err).sum(axis=1).mean())), scale


def _pose_mats(
    poses_r: np.ndarray, poses_t: np.ndarray, scale: float = 1.0
) -> np.ndarray:
    """(K, 4, 4) camera->world matrices, translation scaled by ``scale``."""
    k = len(poses_r)
    mats = np.tile(np.eye(4), (k, 1, 1))
    for i in range(k):
        r = np.asarray(poses_r[i], np.float64)
        t = np.asarray(poses_t[i], np.float64)
        mats[i, :3, :3] = r.T
        mats[i, :3, 3] = -scale * (r.T @ t)
    return mats


def rpe(
    est_r: np.ndarray,
    est_t: np.ndarray,
    gt_r: np.ndarray,
    gt_t: np.ndarray,
    delta: int = 1,
    scale: float | None = None,
) -> Tuple[float, float]:
    """Relative pose error over ``delta``-step pose deltas.

    Returns ``(rpe_trans, rpe_rot_deg)``: RMSE of the translation
    magnitude of the relative-pose residual ``E_i = (Q_i^gt)^-1 Q_i^est``
    with ``Q_i = P_i^-1 P_{i+delta}`` (camera->world), and RMSE of its
    rotation angle in degrees. ``scale=None`` recovers the monocular
    scale from Umeyama alignment first; pass ``scale=1.0`` for
    metric-scale trajectories.
    """
    if scale is None:
        _, scale = ate_rmse(est_r, est_t, gt_r, gt_t, with_scale=True)
    est_m = _pose_mats(est_r, est_t, scale=scale)
    gt_m = _pose_mats(gt_r, gt_t, scale=1.0)
    k = len(est_m)
    if k <= delta:
        raise ValueError(f"need more than delta={delta} poses, got {k}")
    t_sq, r_sq = [], []
    for i in range(k - delta):
        q_est = np.linalg.inv(est_m[i]) @ est_m[i + delta]
        q_gt = np.linalg.inv(gt_m[i]) @ gt_m[i + delta]
        e = np.linalg.inv(q_gt) @ q_est
        t_sq.append(float(e[:3, 3] @ e[:3, 3]))
        cos_a = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_sq.append(float(np.degrees(np.arccos(cos_a)) ** 2))
    return float(np.sqrt(np.mean(t_sq))), float(np.sqrt(np.mean(r_sq)))


def trajectory_metrics(
    est_r: np.ndarray,
    est_t: np.ndarray,
    gt_r: np.ndarray,
    gt_t: np.ndarray,
    with_scale: bool = True,
) -> Dict[str, float]:
    """All trajectory metrics in one dict (the VO analog of
    tpuflow.eval.metrics.compute_all_metrics).

    ``with_scale=False`` scores METRIC trajectories (e.g. the
    tightly-coupled VI refinement's): SE(3) alignment only, so a scale
    error shows up in ATE instead of being absorbed by the gauge.
    """
    ate, scale = ate_rmse(est_r, est_t, gt_r, gt_t, with_scale=with_scale)
    rpe_t, rpe_r = rpe(est_r, est_t, gt_r, gt_t, delta=1, scale=scale)
    return {
        "ate_rmse": ate,
        "rpe_trans": rpe_t,
        "rpe_rot_deg": rpe_r,
        "scale": scale,
    }
