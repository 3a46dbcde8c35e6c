"""Tightly coupled visual-inertial trajectory refinement.

Counterpart of ``tpuflow.vo.vi_graph``. Where ``imu.estimate_scale_and_
gravity`` fits scale, gravity and velocities to a frozen visual
trajectory, this re-optimizes the trajectory itself: keyframe states
(R_wb, p, v) and one global vision scale, under

- IMU factors between consecutive keyframes (preintegrated increments,
  known gravity, zero or estimated shared biases):
      r_R = Log(dR^T R_wb_i^T R_wb_j)
      r_v = R_wb_i^T (v_j - v_i - g dt) - dv
      r_p = R_wb_i^T (p_j - p_i - v_i dt - 0.5 g dt^2) - dp
- vision factors: the monocular trajectory's consecutive relative poses,
  translation scaled by the unknown s:
      r_vR = Log(dR_vis^T R_wb_i^T R_wb_j)
      r_vt = s dt_vis - R_wb_i^T (p_j - p_i)
- a gauge prior pinning node 0's pose.

Full-state Gauss-Newton: the residual vector is one function of the
stacked tangent (9K + 1 for log-scale, + 6 bias states with
``estimate_bias``), re-linearized each iteration by ``torch.func.jacfwd``
(the reference's ``jax.jacfwd``), its per-edge terms computed for all
edges at once. The reference's ``lax.scan`` over iterations is a loop.
``h = J^T J + 1e-8 I`` is ill-conditioned in float32, so the solve runs
with TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.vo import se3
from tpuflow_torch.vo._precision import pin_matmul_precision
from tpuflow_torch.vo.imu import ImuIncrement, estimate_scale_and_gravity


class ViSolution(NamedTuple):
    poses_r: np.ndarray   # (K, 3, 3) world->camera, metric translations
    poses_t: np.ndarray   # (K, 3)
    velocities: np.ndarray  # (K, 3) world frame
    scale: float          # vision-to-metric scale factor applied
    residual_rms: float   # final weighted residual RMS
    gyro_bias: np.ndarray | None = None   # (3,) with estimate_bias
    accel_bias: np.ndarray | None = None  # (3,)


def _mv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., 3, 3) @ (..., 3)."""
    return (m @ x[..., None])[..., 0]


@pin_matmul_precision
def _solve_states(r_wb0, p0, v0, meas, gravity, weights, iterations: int,
                  estimate_bias: bool = False):
    """Gauss-Newton over (R_wb, p, v) x K + log-scale (+ shared biases
    when ``estimate_bias``), dense normal equations."""
    (imu_dr, imu_dv, imu_dp, imu_dt, vis_dr, vis_dt,
     j_r_bg, j_v_bg, j_v_ba, j_p_bg, j_p_ba) = meas
    w_gyro, w_acc, w_vr, w_vt = weights
    k = r_wb0.shape[0]
    n_t = 9 * k + 1 + (6 if estimate_bias else 0)
    dev = r_wb0.device
    dt = imu_dt[:, None]

    def residuals(tangent, r_wb, p, v, log_s, bias):
        phi = tangent[: 3 * k].reshape(k, 3)
        dp_t = tangent[3 * k : 6 * k].reshape(k, 3)
        dv_t = tangent[6 * k : 9 * k].reshape(k, 3)
        ds = tangent[9 * k]
        b = bias + tangent[9 * k + 1 : 9 * k + 7] if estimate_bias else bias
        b_g, b_a = b[:3], b[3:]
        r_new = r_wb @ se3.so3_exp(phi)
        p_new = p + dp_t
        v_new = v + dv_t
        s = torch.exp(log_s + ds)

        ri, rj = r_new[:-1], r_new[1:]
        rit = ri.transpose(1, 2)
        # First-order bias-corrected increments (ImuIncrement Jacobians).
        dr_c = imu_dr @ se3.so3_exp(j_r_bg @ b_g)
        dv_c = imu_dv + j_v_bg @ b_g + j_v_ba @ b_a
        dp_c = imu_dp + j_p_bg @ b_g + j_p_ba @ b_a
        r_imu = se3.so3_log(dr_c.transpose(1, 2) @ (rit @ rj))
        r_vel = _mv(rit, v_new[1:] - v_new[:-1] - gravity * dt) - dv_c
        r_pos = _mv(rit, p_new[1:] - p_new[:-1] - v_new[:-1] * dt - 0.5 * gravity * dt * dt) - dp_c
        r_vr = se3.so3_log(vis_dr.transpose(1, 2) @ (rit @ rj))
        r_vt = s * vis_dt - _mv(rit, p_new[1:] - p_new[:-1])
        edge_res = torch.cat([w_gyro * r_imu, w_acc * r_vel, w_acc * r_pos,
                              w_vr * r_vr, w_vt * r_vt], dim=1).reshape(-1)
        # Gauge prior on node 0's pose; a soft zero prior on the biases.
        prior = 10.0 * torch.cat([phi[0], dp_t[0]])
        if estimate_bias:
            prior = torch.cat([prior, 0.5 * b])
        return torch.cat([edge_res, prior])

    r_wb, p, v = r_wb0, p0, v0
    log_s = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.zeros(6, dtype=torch.float32, device=dev)
    zero = torch.zeros(n_t, dtype=torch.float32, device=dev)
    eye = torch.eye(n_t, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        res = residuals(zero, r_wb, p, v, log_s, bias)
        jac = jacfwd(residuals)(zero, r_wb, p, v, log_s, bias)
        h = jac.T @ jac + 1e-8 * eye
        dx = torch.linalg.solve(h, -(jac.T @ res))
        r_wb = r_wb @ se3.so3_exp(dx[: 3 * k].reshape(k, 3))
        p = p + dx[3 * k : 6 * k].reshape(k, 3)
        v = v + dx[6 * k : 9 * k].reshape(k, 3)
        log_s = log_s + dx[9 * k]
        if estimate_bias:
            bias = bias + dx[9 * k + 1 : 9 * k + 7]
    final = residuals(zero, r_wb, p, v, log_s, bias)
    rms = torch.sqrt(torch.mean(final * final))
    return r_wb, p, v, torch.exp(log_s), rms, bias


def solve_vi(
    poses_r: np.ndarray,
    poses_t: np.ndarray,
    increments: Sequence[ImuIncrement],
    gravity: np.ndarray,
    iterations: int = 12,
    w_gyro: float = 10.0,
    w_acc: float = 5.0,
    w_vis_rot: float = 1.0,
    w_vis_trans: float = 1.0,
    r_cam_imu: np.ndarray | None = None,
    estimate_bias: bool = False,
    init_scale: float | None = None,
    init_velocities: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> ViSolution:
    """Refine a monocular trajectory into a metric one with IMU factors, on
    ``device`` (the card unless the caller names another; raises without a
    card).

    ``poses_r``/``poses_t``: world->camera keyframe poses of the visual
    solve (up to scale). ``increments``: K-1 increments between
    consecutive keyframes, each with samples. ``gravity``: the world-frame
    gravity vector. Poses start from vision (positions pre-scaled by the
    linear alignment's scale, or ``init_scale``), velocities from the same
    alignment (or ``init_velocities``).

    ``estimate_bias=True`` adds shared gyro/accel bias states, applied
    through the increments' first-order bias Jacobians with a soft zero
    prior; the increments must carry them (``bias_jacobians=True``).
    """
    k = len(poses_r)
    if len(increments) != k - 1:
        raise ValueError(f"need K-1={k - 1} increments for K={k} poses, got {len(increments)}")
    if k < 4:
        raise ValueError("VI refinement needs >= 4 keyframes")
    if any(int(inc.n_samples) == 0 for inc in increments):
        raise ValueError(
            "every keyframe interval needs IMU coverage for tight coupling "
            "(an increment has n_samples == 0)"
        )
    if estimate_bias and any(inc.j_r_bg is None for inc in increments):
        raise ValueError(
            "estimate_bias needs increments preintegrated with bias_jacobians=True "
            "(zero Jacobians would pin the biases instead of estimating them)"
        )
    dev = resolve_device(device)
    poses_r = np.asarray(poses_r, np.float64)
    poses_t = np.asarray(poses_t, np.float64)
    r_ci = np.eye(3) if r_cam_imu is None else np.asarray(r_cam_imu, np.float64)

    if init_scale is not None and init_velocities is not None:
        s0, v0 = float(init_scale), np.asarray(init_velocities, np.float64)
    else:
        s0, _g, v0, _rms = estimate_scale_and_gravity(
            poses_r, poses_t, list(increments), r_cam_imu=r_cam_imu
        )
    s0 = max(float(s0), 1e-3)
    r_wb0 = np.transpose(poses_r, (0, 2, 1)) @ r_ci   # IMU body -> world
    centers = -np.einsum("kij,ki->kj", poses_r, poses_t)
    p0 = centers * s0

    # Vision measurements: consecutive relative body poses, translations
    # from the s0-scaled positions, so the solved scale is a correction
    # near 1 and the vision-to-metric scale is s0 times it.
    vis_dr = np.stack([r_wb0[i].T @ r_wb0[i + 1] for i in range(k - 1)])
    vis_dt = np.stack([r_wb0[i].T @ (p0[i + 1] - p0[i]) for i in range(k - 1)])

    def f32(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    z33 = torch.zeros((3, 3), dtype=torch.float32, device=dev)

    def stack(field):
        return torch.stack([z33 if getattr(inc, field) is None else f32(getattr(inc, field))
                            for inc in increments])

    meas = (
        stack("delta_r"), stack("delta_v"), stack("delta_p"),
        torch.stack([f32(inc.dt) for inc in increments]),
        f32(vis_dr), f32(vis_dt),
        stack("j_r_bg"), stack("j_v_bg"), stack("j_v_ba"), stack("j_p_bg"), stack("j_p_ba"),
    )
    r_wb, p, v, s_corr, rms, bias = _solve_states(
        f32(r_wb0), f32(p0), f32(v0), meas, f32(gravity),
        (float(w_gyro), float(w_acc), float(w_vis_rot), float(w_vis_trans)),
        int(iterations), estimate_bias=estimate_bias,
    )
    host = torch.cat([r_wb.reshape(-1), p.reshape(-1), v.reshape(-1), s_corr[None], rms[None],
                      bias]).cpu().numpy()
    r_wb = host[: 9 * k].reshape(k, 3, 3)
    p = host[9 * k : 12 * k].reshape(k, 3)
    vel = host[12 * k : 15 * k].reshape(k, 3)
    s_corr, rms, bias_np = host[15 * k], host[15 * k + 1], host[15 * k + 2 :]
    out_r = np.transpose(r_wb @ r_ci.T, (0, 2, 1))     # back to world->camera
    out_t = -np.einsum("kij,kj->ki", out_r, p)
    return ViSolution(
        poses_r=out_r.astype(np.float32),
        poses_t=out_t.astype(np.float32),
        velocities=np.asarray(vel, np.float64).astype(np.float32),
        scale=float(s0) * float(s_corr),
        residual_rms=float(rms),
        gyro_bias=bias_np[:3].copy() if estimate_bias else None,
        accel_bias=bias_np[3:].copy() if estimate_bias else None,
    )
