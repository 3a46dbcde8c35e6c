"""IMU preintegration and gyro-aided pose-graph factors.

Counterpart of ``tpuflow.vo.imu``. Between two keyframe timestamps the raw
gyro and accelerometer samples are integrated once into relative motion
increments (dR, dv, dp) that do not depend on the absolute state
(on-manifold preintegration, Forster et al.), which keeps IMU rates out of
the optimizer.

- ``preintegrate`` is the reference's ``lax.scan`` over samples as a
  sequential loop in float32 with TF32 off. The per-sample rotation steps
  ``Exp(w h)`` (and, for the bias Jacobians, the right Jacobians and
  ``hat(a)``) do not depend on the carry and are computed for all samples
  at once; the recursion itself is a handful of tiny operations a sample,
  each a launch on the card.
- ``preintegrate_segments`` splits a stream at keyframe times on the host;
  an interval with no sample gives the identity increment with
  ``n_samples=0``, which callers treat as missing data.
- ``estimate_scale_and_gravity`` is the linear visual-inertial alignment,
  a host ``numpy.linalg.lstsq`` as in the reference.
- ``gyro_rotation_edges`` adds the increments' rotations to a pose graph
  as rotation-only edges.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.vo import se3
from tpuflow_torch.vo._precision import pin_matmul_precision


class ImuIncrement(NamedTuple):
    """Preintegrated motion over one interval, in the frame of the starting
    body pose."""

    delta_r: torch.Tensor  # (3, 3) rotation increment
    delta_v: torch.Tensor  # (3,) velocity increment (gravity-free)
    delta_p: torch.Tensor  # (3,) position increment (gravity-free)
    dt: torch.Tensor       # () total duration
    # Raw samples integrated; 0 = no IMU coverage (identity by
    # construction), to be treated as missing data, not as "no motion".
    n_samples: int = 0
    # First-order bias Jacobians (Forster et al.): a bias update db
    # re-corrects the increments without re-integrating:
    #   dR(b + db_g) ~= dR Exp(j_r_bg db_g)
    #   dv(b + db)   ~= dv + j_v_bg db_g + j_v_ba db_a
    #   dp(b + db)   ~= dp + j_p_bg db_g + j_p_ba db_a
    j_r_bg: torch.Tensor | None = None   # (3, 3)
    j_v_bg: torch.Tensor | None = None
    j_v_ba: torch.Tensor | None = None
    j_p_bg: torch.Tensor | None = None
    j_p_ba: torch.Tensor | None = None


def _f32(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@pin_matmul_precision
def preintegrate(
    gyro,
    accel,
    dt,
    gyro_bias=None,
    accel_bias=None,
    bias_jacobians: bool = False,
    *,
    device: torch.device | str | None = None,
) -> ImuIncrement:
    """Integrate raw IMU samples into an :class:`ImuIncrement` on
    ``device`` (the card unless the caller names another; raises without a
    card).

    gyro, accel: (N, 3) body angular velocity (rad/s) and specific force
    (m/s^2). ``dt``: a scalar sample period or (N,) per-sample periods.
    Each sample is held for its dt:

        dR_{k+1} = dR_k Exp((w_k - b_g) dt)
        dv_{k+1} = dv_k + dR_k (a_k - b_a) dt
        dp_{k+1} = dp_k + dv_k dt + 0.5 dR_k (a_k - b_a) dt^2

    Gravity is not removed (consumers subtract it at the factor level).
    ``bias_jacobians=True`` also accumulates the five 3x3 first-order bias
    Jacobians (``vo.vi_graph``'s bias estimation needs them).
    """
    dev = resolve_device(device)
    gyro = _f32(gyro, dev)
    accel = _f32(accel, dev)
    n = gyro.shape[0]
    dts = _f32(dt, dev).expand(n)
    if gyro_bias is not None:
        gyro = gyro - _f32(gyro_bias, dev)
    if accel_bias is not None:
        accel = accel - _f32(accel_bias, dev)

    wh = gyro * dts[:, None]
    steps = se3.so3_exp(wh)                       # (N, 3, 3), off the carry
    r = torch.eye(3, dtype=torch.float32, device=dev)
    v = torch.zeros(3, dtype=torch.float32, device=dev)
    p = torch.zeros(3, dtype=torch.float32, device=dev)

    if bias_jacobians:
        a_hats = se3.hat(accel)
        right = se3.so3_right_jacobian(wh)
        j_r, j_vg, j_va, j_pg, j_pa = (torch.zeros((3, 3), dtype=torch.float32, device=dev)
                                       for _ in range(5))
        for k in range(n):
            h, a, step_r = dts[k], accel[k], steps[k]
            a_world = r @ a
            # The bias Jacobians use the pre-update r, j_r and j_v*.
            r_a_jr = r @ a_hats[k] @ j_r
            j_pg = j_pg + j_vg * h - 0.5 * r_a_jr * h * h
            j_pa = j_pa + j_va * h - 0.5 * r * h * h
            j_vg = j_vg - r_a_jr * h
            j_va = j_va - r * h
            j_r = step_r.T @ j_r - right[k] * h
            p = p + v * h + 0.5 * a_world * h * h
            v = v + a_world * h
            r = r @ step_r
        return ImuIncrement(
            delta_r=r, delta_v=v, delta_p=p, dt=dts.sum(), n_samples=n,
            j_r_bg=j_r, j_v_bg=j_vg, j_v_ba=j_va, j_p_bg=j_pg, j_p_ba=j_pa,
        )

    for k in range(n):
        h = dts[k]
        a_world = r @ accel[k]
        p = p + v * h + 0.5 * a_world * h * h
        v = v + a_world * h
        r = r @ steps[k]
    return ImuIncrement(delta_r=r, delta_v=v, delta_p=p, dt=dts.sum(), n_samples=n)


def preintegrate_segments(
    times: np.ndarray,
    gyro: np.ndarray,
    accel: np.ndarray,
    boundaries: np.ndarray,
    bias_jacobians: bool = False,
    *,
    device: torch.device | str | None = None,
) -> list[ImuIncrement]:
    """Split a sample stream at ``boundaries`` and preintegrate each
    [b_k, b_{k+1}) segment on ``device`` (the card unless the caller names
    another). ``times``: (N,) strictly increasing sample times;
    ``boundaries``: (K,) strictly increasing keyframe times. Returns K-1
    increments; samples outside [b_0, b_{K-1}) are ignored."""
    dev = resolve_device(device)
    times = np.asarray(times, np.float64)
    boundaries = np.asarray(boundaries, np.float64)
    if len(boundaries) < 2:
        return []
    if not (np.diff(times) > 0).all():
        raise ValueError("IMU timestamps must be strictly increasing")
    if not (np.diff(boundaries) > 0).all():
        raise ValueError("boundary timestamps must be strictly increasing")
    gyro = np.asarray(gyro)
    accel = np.asarray(accel)
    out = []
    # Sample k covers [t_k, t_{k+1}); the last sample gets the median dt.
    dts = np.diff(times)
    dts = np.append(dts, np.median(dts) if len(dts) else 0.0)
    for k in range(len(boundaries) - 1):
        lo, hi = boundaries[k], boundaries[k + 1]
        sel = (times >= lo) & (times < hi)
        if not sel.any():
            out.append(ImuIncrement(
                delta_r=torch.eye(3, dtype=torch.float32, device=dev),
                delta_v=torch.zeros(3, dtype=torch.float32, device=dev),
                delta_p=torch.zeros(3, dtype=torch.float32, device=dev),
                dt=torch.tensor(hi - lo, dtype=torch.float32, device=dev),
                n_samples=0,
            ))
            continue
        out.append(preintegrate(gyro[sel], accel[sel], dts[sel],
                                bias_jacobians=bias_jacobians, device=dev))
    return out


def _host(increments, field: str) -> np.ndarray:
    """One field of every increment, stacked on the host in one copy."""
    return torch.stack([getattr(inc, field) for inc in increments]).cpu().numpy()


def estimate_scale_and_gravity(
    poses_r: np.ndarray,
    poses_t: np.ndarray,
    increments: list[ImuIncrement],
    r_cam_imu: np.ndarray | None = None,
) -> tuple[float, np.ndarray, np.ndarray, float]:
    """Visual-inertial alignment: the monocular metric scale.

    Given the solved up-to-scale world->camera keyframe poses and the
    gravity-free increments between consecutive keyframes, solve the
    linear system (Mur-Artal-style VI initialization) for scale s, gravity
    g (VO world frame) and per-keyframe velocities:

        s (p_{i+1} - p_i) = v_i dt_i + 0.5 g dt_i^2 + R_cw_i dp_i
        v_{i+1} - v_i     = g dt_i + R_cw_i dv_i

    ``r_cam_imu``: the camera-from-IMU rotation extrinsic. Returns
    ``(scale, gravity (3,), velocities (K, 3), residual_rms)``. Needs
    K >= 4 and real acceleration variation; check ``residual_rms`` and
    |gravity| ~ 9.81 before trusting the scale. Host ``lstsq``.
    """
    k = len(poses_r)
    if len(increments) != k - 1:
        raise ValueError(f"need K-1={k - 1} increments for K={k} poses, got {len(increments)}")
    if k < 4:
        raise ValueError("scale/gravity alignment needs >= 4 keyframes")
    poses_r = np.asarray(poses_r, np.float64)
    poses_t = np.asarray(poses_t, np.float64)
    centers = -np.einsum("kij,ki->kj", poses_r, poses_t)  # up-to-scale p_hat
    r_cw = np.transpose(poses_r, (0, 2, 1))               # camera->world
    if r_cam_imu is not None:
        # IMU-frame vectors -> camera -> world is r_cw_i @ r_cam_imu.
        r_cw = r_cw @ np.asarray(r_cam_imu, np.float64)
    inc_dp = _host(increments, "delta_p").astype(np.float64)
    inc_dv = _host(increments, "delta_v").astype(np.float64)
    inc_dt = _host(increments, "dt")

    n_unknown = 1 + 3 + 3 * k                # s, g, v_0..v_{K-1}
    rows = []
    rhs = []
    for i in range(k - 1):
        dt = float(inc_dt[i])
        dp = r_cw[i] @ inc_dp[i]
        dv = r_cw[i] @ inc_dv[i]
        # Position block: s dp_hat - v_i dt - 0.5 dt^2 g = dp
        a = np.zeros((3, n_unknown))
        a[:, 0] = centers[i + 1] - centers[i]
        a[:, 1:4] = -0.5 * dt * dt * np.eye(3)
        a[:, 4 + 3 * i : 7 + 3 * i] = -dt * np.eye(3)
        rows.append(a)
        rhs.append(dp)
        # Velocity block: v_{i+1} - v_i - dt g = dv
        b = np.zeros((3, n_unknown))
        b[:, 1:4] = -dt * np.eye(3)
        b[:, 4 + 3 * i : 7 + 3 * i] = -np.eye(3)
        b[:, 4 + 3 * (i + 1) : 7 + 3 * (i + 1)] = np.eye(3)
        rows.append(b)
        rhs.append(dv)
    a_mat = np.concatenate(rows)
    b_vec = np.concatenate(rhs)
    x, _, _, _ = np.linalg.lstsq(a_mat, b_vec, rcond=None)
    resid = a_mat @ x - b_vec
    rms = float(np.sqrt(np.mean(resid * resid)))
    return float(x[0]), x[1:4], x[4:].reshape(k, 3), rms


@pin_matmul_precision
def gyro_rotation_edges(
    g,
    increments: list[ImuIncrement],
    node_pairs: list[tuple[int, int]],
    weight: float = 2.0,
    r_cam_imu: np.ndarray | None = None,
):
    """Append rotation-only gyro edges to a ``pose_graph.PoseGraph``.

    Each increment's dR is the body rotation between the two keyframes of
    ``node_pairs[k]`` (cam->world: ``R_cw_j = R_cw_i dR``). The graph's
    edge is ``T_i^-1 T_j`` on world->camera poses, whose rotation block is
    ``R_i^T dR^T R_i``: the body increment conjugated by node i's absolute
    rotation, taken from the graph's current estimate (as
    ``constant_velocity_edges`` anchors its predictions). With
    ``r_cam_imu`` the increment is first re-expressed in camera axes.
    Translation components are masked out; ``weight`` above the odometry
    edges' 1.0 reflects the gyro's lower rotation noise.
    """
    from tpuflow_torch.vo.pose_graph import _mask_of

    if len(increments) != len(node_pairs):
        raise ValueError(f"{len(increments)} increments for {len(node_pairs)} node pairs")
    if not increments:
        return g
    dev = g.poses_r.device
    r_ci = (torch.eye(3, dtype=torch.float32, device=dev) if r_cam_imu is None
            else _f32(r_cam_imu, dev))
    e = len(node_pairs)
    idx_i = torch.as_tensor([i for i, _ in node_pairs], dtype=g.edge_i.dtype, device=dev)
    idx_j = torch.as_tensor([j for _, j in node_pairs], dtype=g.edge_j.dtype, device=dev)
    dr = torch.stack([inc.delta_r for inc in increments]).to(dev)
    ri = g.poses_r[idx_i.long()]
    er = ri.transpose(1, 2) @ (r_ci @ dr @ r_ci.T).transpose(1, 2) @ ri
    mask_new = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], device=dev).expand(e, 6)
    return g._replace(
        edge_i=torch.cat([g.edge_i, idx_i]),
        edge_j=torch.cat([g.edge_j, idx_j]),
        edge_r=torch.cat([g.edge_r, er]),
        edge_t=torch.cat([g.edge_t, torch.zeros((e, 3), dtype=torch.float32, device=dev)]),
        edge_valid=torch.cat([g.edge_valid, torch.ones(e, dtype=torch.bool, device=dev)]),
        edge_weight=torch.cat(
            [g.edge_weight, torch.full((e,), float(weight), dtype=torch.float32, device=dev)]
        ),
        edge_mask=torch.cat([_mask_of(g), mask_new]),
    )
