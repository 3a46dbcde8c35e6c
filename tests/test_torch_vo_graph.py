"""The port's pose graph, IMU preintegration and visual-inertial refinement
(``tpuflow_torch.vo.pose_graph``, ``vo.imu``, ``vo.vi_graph``,
``io.imu``) against ``tpuflow`` on the CPU, inputs made from a seed with
numpy.

Limits, each beside the figure measured on this CPU:

- Pose graph, on a seeded 6-node graph with a loop edge, per-edge weights
  and a rotation-only (masked) edge: residuals within 1e-6 (measured
  6.0e-8); one Gauss-Newton step and ``solve(10)`` within 2e-6 in R and t
  (measured at most 1.8e-7: the sorted segment sums add the blocks in
  another order than XLA's scatter-adds, and LAPACK's LU solves each);
  the solved graph's residuals below 1e-3 and its translations within
  1e-2 of the truth (the reference's own test). ``constant_velocity_edges``
  within 1e-6 (measured 6.0e-8). At a perfect edge, where ``so3_log``
  takes ``arccos`` at exactly 1, the Jacobians are finite and within 1e-5
  of JAX's ``jacfwd`` (measured 2.8e-6, on entries up to the poses'
  translations; on the identity edge, exact).
- Preintegration over 150 seeded samples, with and without biases and
  bias Jacobians: every field within 5e-6 (measured 4.2e-7, in dR: 150
  float32 3x3 products, each ``Exp(w h)`` computed for all samples at
  once, and XLA's fused multiply-adds); segments
  (the reference's split, with an empty one) the same, the empty one the
  identity with n_samples 0 and its duration.
- The scale/gravity alignment on identical increments: identical (the
  same numpy); on increments preintegrated by each package, scale within
  1e-4 relative and gravity within 1e-4 of |g| (the increments' float32
  differences; measured 3.1e-7 m/s^2).
- Gyro edges: within 1e-6 (measured 6.0e-8), with and without an
  extrinsic.
- VI refinement on ``tests/test_vo_imu.py``'s problems (recovery, a
  corrupted vision position, bias estimation with 30 iterations): poses,
  velocities and biases within 1e-5, scale within 1e-5 relative, residual
  RMS within 1e-7 (measured at most 3.0e-7 in R, 2.9e-7 in t, 1.4e-6 in
  v, 1.2e-7 relative in scale, 4.3e-9 in RMS and 1.2e-7 in the biases:
  the same Gauss-Newton path, ``jacfwd`` columns equal to JAX's to
  float32 rounding, and LAPACK's solve in both).
- ``io.imu``: the port's file read by the reference and the reference's
  by the port, bit for bit.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.io import imu as jimu_io
from tpuflow.vo import imu as jimu
from tpuflow.vo import pose_graph as jpg
from tpuflow.vo import se3 as jse3
from tpuflow.vo import vi_graph as jvi
from tpuflow_torch import convert
from tpuflow_torch.io import imu as imu_io
from tpuflow_torch.vo import imu, pose_graph, vi_graph

sys.path.insert(0, str(Path(__file__).parent))
from test_vo_imu import _gt_trajectory, _synth_gyro, _vi_problem, _yaw  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one CPU thread, as tests/test_torch_vo.py runs it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def _noisy_graph(seed=0, k=6, masked=True):
    """A chain of k poses with exact odometry edges and a loop edge, started
    from perturbed poses (node 0 at the truth). Returns the JAX graph and
    the ground-truth translations."""
    rng = np.random.default_rng(seed)

    def rand_pose(scale):
        return jse3.se3_exp(jnp.asarray(rng.normal(0, scale, 6).astype(np.float32)))

    gt = [jse3.se3_exp(jnp.zeros(6))]
    for _ in range(k - 1):
        gt.append(jse3.compose(*gt[-1], *rand_pose(0.3)))
    gt_r = jnp.stack([g[0] for g in gt])
    gt_t = jnp.stack([g[1] for g in gt])
    pairs = [(i, i + 1) for i in range(k - 1)] + [(0, k - 1)]
    er, et = zip(*(jse3.compose(*jse3.inverse(gt_r[i], gt_t[i]), gt_r[j], gt_t[j])
                   for i, j in pairs))
    init = [(gt_r[0], gt_t[0])] + [jse3.compose(gt_r[i], gt_t[i], *rand_pose(0.1))
                                   for i in range(1, k)]
    mask = np.ones((len(pairs), 6), np.float32)
    if masked:
        mask[2, :3] = 0.0  # a rotation-only edge
    g = jpg.PoseGraph(
        poses_r=jnp.stack([p[0] for p in init]), poses_t=jnp.stack([p[1] for p in init]),
        edge_i=jnp.asarray([i for i, _ in pairs], jnp.int32),
        edge_j=jnp.asarray([j for _, j in pairs], jnp.int32),
        edge_r=jnp.stack(er), edge_t=jnp.stack(et),
        edge_valid=jnp.ones(len(pairs), bool),
        edge_weight=jnp.asarray(rng.uniform(0.5, 2.0, len(pairs)).astype(np.float32)),
        edge_mask=jnp.asarray(mask) if masked else None,
    )
    return g, np.asarray(gt_r), np.asarray(gt_t)


def _port(g):
    return convert.pose_graph_from_reference(g, device="cpu")


def test_pose_graph_residuals_and_step_match():
    g, _, _ = _noisy_graph()
    np.testing.assert_allclose(pose_graph.residuals(_port(g)).numpy(),
                               np.asarray(jpg.residuals(g)), rtol=0, atol=1e-6)
    got = pose_graph.gauss_newton_step(_port(g))
    want = jpg.gauss_newton_step(g)
    np.testing.assert_allclose(got.poses_r.numpy(), np.asarray(want.poses_r), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.poses_t.numpy(), np.asarray(want.poses_t), rtol=0, atol=2e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_pose_graph_solve_matches_and_converges(masked):
    g, _, gt_t = _noisy_graph(seed=1, masked=masked)
    got = pose_graph.solve(_port(g), iterations=10, device="cpu")
    want = jpg.solve(g, iterations=10)
    np.testing.assert_allclose(got.poses_r.numpy(), np.asarray(want.poses_r), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.poses_t.numpy(), np.asarray(want.poses_t), rtol=0, atol=2e-6)
    if not masked:  # every edge exact and whole: the truth is the optimum
        assert float(pose_graph.residuals(got).abs().max()) < 1e-3
        np.testing.assert_allclose(got.poses_t.numpy(), gt_t, atol=1e-2)


def test_constant_velocity_edges_match():
    g, _, _ = _noisy_graph(seed=2)
    got = pose_graph.constant_velocity_edges(_port(g), weight=0.5)
    want = jpg.constant_velocity_edges(g, weight=0.5)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(_np(a).astype(np.float64), np.asarray(b).astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=name)
    short = _port(g)._replace(poses_r=_port(g).poses_r[:2], poses_t=_port(g).poses_t[:2])
    assert pose_graph.constant_velocity_edges(short) is short


def _jax_jacobians(g):
    zero = jnp.zeros(6)

    def one(i, j, rm, tm):
        args = (g.poses_r[i], g.poses_t[i], g.poses_r[j], g.poses_t[j], rm, tm)
        return (jax.jacfwd(jpg._edge_residual, argnums=0)(zero, zero, *args),
                jax.jacfwd(jpg._edge_residual, argnums=1)(zero, zero, *args))

    return jax.vmap(one)(g.edge_i, g.edge_j, g.edge_r, g.edge_t)


def test_perfect_edge_jacobian_finite_and_matches():
    # Poses at the truth: every edge is satisfied, so so3_log meets
    # arccos(1) (whose derivative is infinite) on each of them.
    g, gt_r, gt_t = _noisy_graph(seed=3, masked=False)
    g = g._replace(poses_r=jnp.asarray(gt_r), poses_t=jnp.asarray(gt_t))
    ident = g._replace(poses_r=jnp.tile(jnp.eye(3)[None], (6, 1, 1)), poses_t=jnp.zeros((6, 3)),
                       edge_r=jnp.tile(jnp.eye(3)[None], (6, 1, 1)), edge_t=jnp.zeros((6, 3)))
    for case, atol in ((g, 1e-5), (ident, 0.0)):
        _, ji, jj = pose_graph.edge_jacobians(_port(case))
        wi, wj = _jax_jacobians(case)
        for got, want in ((ji, wi), (jj, wj)):
            assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# IMU
# ---------------------------------------------------------------------------


def _samples(seed=1, n=150):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(n, 3)).astype(np.float32),
            rng.normal(scale=3.0, size=(n, 3)).astype(np.float32))


def _assert_increments(got, want, atol=5e-6):
    assert int(got.n_samples) == int(want.n_samples)
    for name, a, b in zip(want._fields, got, want):
        if name == "n_samples" or b is None:
            assert (a is None) == (b is None), name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("jacobians", [False, True])
def test_preintegrate_matches(biased, jacobians):
    gyro, accel = _samples()
    kw = dict(gyro_bias=[0.01, -0.02, 0.015], accel_bias=[0.05, -0.08, 0.03]) if biased else {}
    dts = np.random.default_rng(3).uniform(0.004, 0.006, len(gyro))
    got = imu.preintegrate(gyro, accel, dts, bias_jacobians=jacobians, device="cpu", **kw)
    want = jimu.preintegrate(gyro, accel, dts, bias_jacobians=jacobians, **kw)
    _assert_increments(got, want)


def test_preintegrate_segments_matches():
    gyro, accel = _samples(8, 300)
    times = np.arange(300) * 0.005
    times = np.where(times < 1.3, times, times + 1.0)  # a gap: [1.3, 2.3) has no sample
    bounds = np.array([0.0, 0.75, 1.2, 1.3, 2.2])
    got = imu.preintegrate_segments(times, gyro, accel, bounds, bias_jacobians=True, device="cpu")
    want = jimu.preintegrate_segments(times, gyro, accel, bounds, bias_jacobians=True)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _assert_increments(a, b)
    empty = got[-1]
    assert empty.n_samples == 0
    np.testing.assert_array_equal(empty.delta_r.numpy(), np.eye(3))
    assert abs(float(empty.dt) - 0.9) < 1e-6
    assert imu.preintegrate_segments(times, gyro, accel, bounds[:1], device="cpu") == []


def test_preintegrate_segments_validation():
    t = np.array([0.0, 1.0, 0.5])
    z3 = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="IMU timestamps"):
        imu.preintegrate_segments(t, z3, z3, np.array([0.0, 1.0]), device="cpu")
    with pytest.raises(ValueError, match="boundary"):
        imu.preintegrate_segments(np.array([0.0, 1.0, 2.0]), z3, z3, np.array([1.0, 0.0]),
                                  device="cpu")


@pytest.mark.parametrize("extrinsic", [False, True])
def test_estimate_scale_and_gravity_matches(extrinsic):
    rs, tsv, incs, *_ = _vi_problem()
    r_ci = _yaw(np.radians(35.0)) if extrinsic else None
    port_incs = [convert.imu_increment_from_reference(inc, device="cpu") for inc in incs]
    got = imu.estimate_scale_and_gravity(rs, tsv, port_incs, r_cam_imu=r_ci)
    want = jimu.estimate_scale_and_gravity(rs, tsv, incs, r_cam_imu=r_ci)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Increments preintegrated by each package.
    own = imu.preintegrate_segments(*_vi_imu(), device="cpu")
    got = imu.estimate_scale_and_gravity(rs, tsv, own, r_cam_imu=r_ci)
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4 * np.linalg.norm(want[1]))
    with pytest.raises(ValueError, match="K-1"):
        imu.estimate_scale_and_gravity(rs, tsv, own[:-1])
    with pytest.raises(ValueError, match=">= 4"):
        imu.estimate_scale_and_gravity(rs[:3], tsv[:3], own[:2])


def _vi_imu(k=8, frame_dt=0.25, rate=1000.0, lam=0.4):
    """The samples behind ``_vi_problem``'s increments."""
    g_world = np.array([0.0, 0.0, -9.81])
    amp, om = 0.5, 2 * np.pi * 0.8
    kf_times = np.arange(k) * frame_dt
    ts = np.arange(int(kf_times[-1] * rate) + 1) / rate
    gyro = np.tile(np.array([0.0, lam, 0.0], np.float32), (len(ts), 1))
    accel = np.stack([_yaw(lam * t).T @ (np.array([-amp * om * om * np.sin(om * t), 0, 0])
                                         - g_world) for t in ts]).astype(np.float32)
    return ts, gyro, accel, kf_times


@pytest.mark.parametrize("extrinsic", [False, True])
def test_gyro_rotation_edges_match(extrinsic):
    k = 5
    gt_r, gt_t = _gt_trajectory(k, yaw_step_deg=4.0)
    times, gyro, accel = _synth_gyro(gt_r, frame_dt=0.5)
    r_ci = _yaw(np.radians(30.0)) if extrinsic else None
    if extrinsic:
        gyro = (r_ci.T @ gyro.T).T.astype(np.float32)
    g0, _, _ = _noisy_graph(seed=4, k=k)
    g0 = g0._replace(poses_r=jnp.asarray(gt_r, jnp.float32), poses_t=jnp.asarray(gt_t, jnp.float32))
    pairs = [(i, i + 1) for i in range(k - 1)]
    want_incs = jimu.preintegrate_segments(times, gyro, accel, np.arange(k) * 0.5)
    want = jimu.gyro_rotation_edges(g0, want_incs, pairs, weight=3.0, r_cam_imu=r_ci)
    got_incs = imu.preintegrate_segments(times, gyro, accel, np.arange(k) * 0.5, device="cpu")
    got = imu.gyro_rotation_edges(_port(g0), got_incs, pairs, weight=3.0, r_cam_imu=r_ci)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(_np(a).astype(np.float64), np.asarray(b).astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=name)
    # Measured through the extrinsic on the truth: near-zero rotation residuals.
    assert float(pose_graph.residuals(got)[-len(pairs):].abs().max()) < 1e-2
    with pytest.raises(ValueError, match="node pairs"):
        imu.gyro_rotation_edges(_port(g0), got_incs, pairs[:-1])


def test_imu_io_roundtrip_with_reference(tmp_path):
    rng = np.random.default_rng(2)
    n = 20
    t = np.cumsum(rng.uniform(0.004, 0.006, n))
    gyro = rng.normal(size=(n, 3)).astype(np.float32)
    accel = rng.normal(size=(n, 3)).astype(np.float32)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    imu_io.save_imu(ours, t, gyro, accel, header="port")
    jimu_io.save_imu(theirs, t, gyro, accel, header="port")
    assert ours.read_text() == theirs.read_text()
    for a, b in zip(imu_io.load_imu(theirs), jimu_io.load_imu(ours)):
        np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.txt"
    for text in ("0.0 1 2 3 4 5\n", "# only comments\n", "1 0 0 0 0 0 0\n0 0 0 0 0 0 0\n"):
        bad.write_text(text)
        with pytest.raises(ValueError):
            imu_io.load_imu(bad)


# ---------------------------------------------------------------------------
# VI refinement
# ---------------------------------------------------------------------------


def _biased_problem():
    """``test_vi_refinement_estimates_biases``'s increments: the exact
    samples with constant gyro and accel biases, with bias Jacobians."""
    rs, tsv, _, g_world, *_ = _vi_problem()
    ts, gyro, accel, kf_times = _vi_imu()
    gyro = gyro + np.array([0.015, -0.01, 0.02], np.float32)
    accel = accel + np.array([0.15, -0.1, 0.2], np.float32)
    incs = jimu.preintegrate_segments(ts, gyro, accel, kf_times, bias_jacobians=True)
    return rs, tsv, incs, g_world


def _corrupted_problem():
    rs, tsv, incs, g_world, *_ = _vi_problem()
    centers = -np.einsum("kij,ki->kj", rs, tsv)
    centers[4] += np.array([0.05, -0.03, 0.02])
    return rs, -np.einsum("kij,kj->ki", rs, centers), incs, g_world


VI_CASES = {
    "recovers": (lambda: _vi_problem()[:4], {}),
    "corrupted": (_corrupted_problem, {}),
    "biases": (_biased_problem, dict(estimate_bias=True, iterations=30, w_vis_rot=5.0)),
}


@pytest.mark.parametrize("case", sorted(VI_CASES))
def test_solve_vi_matches(case):
    make, kw = VI_CASES[case]
    rs, tsv, incs, g_world = make()
    want = jvi.solve_vi(rs, tsv, incs, g_world, **kw)
    port_incs = [convert.imu_increment_from_reference(inc, device="cpu") for inc in incs]
    got = vi_graph.solve_vi(rs, tsv, port_incs, g_world, device="cpu", **kw)
    for f in ("poses_r", "poses_t", "velocities"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=1e-5,
                                   err_msg=f)
    assert abs(got.scale - want.scale) <= 1e-5 * want.scale
    assert abs(got.residual_rms - want.residual_rms) <= 1e-7
    if kw.get("estimate_bias"):
        np.testing.assert_allclose(got.gyro_bias, want.gyro_bias, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.accel_bias, want.accel_bias, rtol=0, atol=1e-5)
    else:
        assert got.gyro_bias is None and got.accel_bias is None


def test_solve_vi_validation():
    rs, tsv, incs, g_world, *_ = _vi_problem()
    incs = [convert.imu_increment_from_reference(inc, device="cpu") for inc in incs]
    with pytest.raises(ValueError, match="K-1"):
        vi_graph.solve_vi(rs, tsv, incs[:-1], g_world, device="cpu")
    with pytest.raises(ValueError, match=">= 4"):
        vi_graph.solve_vi(rs[:3], tsv[:3], incs[:2], g_world, device="cpu")
    hole = list(incs)
    hole[2] = hole[2]._replace(n_samples=0)
    with pytest.raises(ValueError, match="coverage"):
        vi_graph.solve_vi(rs, tsv, hole, g_world, device="cpu")
    with pytest.raises(ValueError, match="bias_jacobians"):
        vi_graph.solve_vi(rs, tsv, incs, g_world, estimate_bias=True, device="cpu")


def test_graph_and_imu_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _, _ = _noisy_graph()
    rs, tsv, incs, g_world, *_ = _vi_problem()
    gyro, accel = _samples()
    for call in (
        lambda: pose_graph.solve(_port(g)),
        lambda: imu.preintegrate(gyro, accel, 0.005),
        lambda: imu.preintegrate_segments(np.arange(150) * 0.005, gyro, accel, [0.0, 0.5]),
        lambda: vi_graph.solve_vi(rs, tsv, incs, g_world),
        lambda: convert.pose_graph_from_reference(g),
        lambda: convert.imu_increment_from_reference(incs[0]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
