"""The port's visual odometry (``tpuflow_torch.vo``, ``eval.vo_metrics``,
``eval.vo_verifier``) against ``tpuflow`` on the CPU, ``backend="torch"``
against ``backend="jnp"``, inputs made from a seed with numpy.

Limits, each beside the figure measured on this CPU:

- se3: 2e-6 absolute on unit-scale inputs (measured <= 4.8e-7: one-ulp
  differences in 3x3 products and the trig functions).
- tracking: the Shi-Tomasi response to 2e-6 of the plane's largest value
  (measured 0: the same shifted adds in the same order); ``seed_grid``'s
  positions and flags identical; ``sample_flow`` identical (the same
  lerps in the same order); ``advance`` and the forward-backward check:
  flags and ages identical, positions within 1.5e-5 px (measured 7.6e-6,
  one ulp of a position near 64: XLA:CPU contracts the jitted step's
  lerp and add into FMAs).
- FrontEnd: alive, ids, landmark counter and loss log identical over init
  and 3-4 steps; positions within 2e-3 px (measured 3.8e-4 px: the flow's
  f32 solve amplifies one-ulp differences of the pyramid, as
  ``tests/test_torch_pyramidal.py`` records).
- BA: residuals, the closed-form Jacobians and the robust weights each
  within 4e-6 of their largest entry of JAX's (``jacfwd``) values
  (measured 9.7e-7, 1.6e-7, 1.6e-7 and 1.4e-6: the weight is a Huber ratio
  of norms rounded otherwise); one Gauss-Newton step within 1e-5
  rad / 2e-4 / 5e-4 (rotations / translations / landmarks; measured
  7.2e-6 / 5.4e-5 / 1.1e-4: the Schur solve amplifies the sums' other
  order); an 8-iteration LM solve within 1e-5 / 2e-4 / 1e-3 and mean
  reprojection error within 1e-5 px (measured 3.8e-6 / 4.6e-5 / 1.6e-4,
  4.2e-7 px).
- epipolar: E equal up to sign within 1e-4 of its largest entry (measured
  2.9e-5: six IRLS rounds of f32 eigh and SVD); the chosen R within 1e-4
  (measured 8.3e-6 clean, 1.7e-5 with half the rows invalid) and t within
  5e-4 (measured 1.5e-4 / 1.2e-4, on t_z, which the scene leaves near 0 and
  least determined); the ``good`` mask and the vote identical;
  triangulated landmarks within 1e-4 relative of JAX's (measured 2.4e-5)
  and the fallback row identical.
- Pipeline: ``run_odometry`` on the verifier's rendered ``strafe_x``:
  identical keyframes and track count; rotations within 1e-2 (measured
  1.3e-3 on one thread, 3.1e-3 on eight); camera centers, after the
  Sim(3) alignment onto JAX's that the monocular gauge leaves free, within
  0.005 (measured 0.0013 on a path of 0.19 on one thread; 0.0018 on eight,
  at a relative scale of 1.090: the scale drifts chaotically with one-ulp
  flow differences, as the reference records between hosts); the
  metrics within the reference's cross-platform gate of the
  JAX run (``CROSS_PLATFORM_THRESHOLD`` with ``CROSS_METRIC_FLOORS``) and
  inside the absolute bounds.
- vo_metrics and the verifier's thresholds: the same numbers and verdicts
  (the same numpy).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tpuflow.eval import patterns as jpatterns
from tpuflow.eval import vo_metrics as jmetrics
from tpuflow.eval import vo_verifier as jverifier
from tpuflow.vo import ba as jba
from tpuflow.vo import device_loop as jdl
from tpuflow.vo import epipolar as jepi
from tpuflow.vo import se3 as jse3
from tpuflow.vo import tracking as jtr
from tpuflow.vo.pipeline import run_odometry as jax_run_odometry
from tpuflow_torch import convert
from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.eval import patterns, vo_metrics, vo_verifier
from tpuflow_torch.vo import ba, device_loop, epipolar, se3, tracking
from tpuflow_torch.vo.pipeline import OdometrySession, run_odometry

sys.path.insert(0, str(Path(__file__).parent))
from test_vo import _make_ba_problem, _two_view_scene  # noqa: E402

DATA = Path(__file__).resolve().parents[1] / "tpuflow" / "eval" / "data"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread. The VO step is thousands of small
    ops, each an OpenMP region on every core by default; beside the other
    test workers those regions wait on busy cores (measured: the chunked
    session test 0.41 s alone, 152 s in the six-worker run, 0.74 s on one
    thread beside seven busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _fields(nt):
    """A tpuflow NamedTuple as a dict of numpy arrays (carry as levels)."""
    return {
        f: [np.asarray(c) for c in v] if f == "carry" else np.asarray(v)
        for f, v in zip(nt._fields, nt)
    }


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

SE3_CASES = {
    "hat": lambda m, a: m.hat(a["w"]),
    "so3_exp": lambda m, a: m.so3_exp(a["w"]),
    "so3_exp_small": lambda m, a: m.so3_exp(a["w"] * 1e-5),
    "so3_log": lambda m, a: m.so3_log(m.so3_exp(a["w"])),
    "se3_exp": lambda m, a: m.se3_exp(a["xi"]),
    "se3_exp_zero": lambda m, a: m.se3_exp(a["xi"] * 0.0),
    "compose": lambda m, a: m.compose(*m.se3_exp(a["xi"]), *m.se3_exp(a["xi2"])),
    "inverse": lambda m, a: m.inverse(*m.se3_exp(a["xi"])),
    "transform": lambda m, a: m.transform(*m.se3_exp(a["xi"]), a["pts"]),
    "retract": lambda m, a: m.retract(*m.se3_exp(a["xi"]), a["xi2"]),
    "so3_right_jacobian": lambda m, a: m.so3_right_jacobian(a["w"]),
}


@pytest.mark.parametrize("case", sorted(SE3_CASES))
def test_se3_matches_reference(case):
    rng = np.random.default_rng(7)
    args = {
        "w": rng.normal(0, 0.5, 3).astype(np.float32),
        "xi": rng.normal(0, 0.3, 6).astype(np.float32),
        "xi2": rng.normal(0, 0.3, 6).astype(np.float32),
        "pts": rng.normal(0, 2.0, (5, 3)).astype(np.float32),
    }
    want = SE3_CASES[case](jse3, {k: jnp.asarray(v) for k, v in args.items()})
    got = SE3_CASES[case](se3, {k: torch.from_numpy(v) for k, v in args.items()})
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)


def test_se3_batches_as_the_reference_maps():
    rng = np.random.default_rng(8)
    xi = rng.normal(0, 0.3, (4, 6)).astype(np.float32)
    xi[0] = 0.0  # the small-angle branch inside a batch
    r, t = se3.se3_exp(torch.from_numpy(xi))
    jr, jt = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=2e-6)
    assert torch.equal(r[0], torch.eye(3))


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------


def _texture(h=120, w=160):
    return jpatterns.load_base_texture(w, h).astype(np.float32)


def test_shi_tomasi_response_matches():
    frame = _texture()
    got = tracking.shi_tomasi_response(torch.from_numpy(frame)).numpy()
    want = np.asarray(jtr.shi_tomasi_response(jnp.asarray(frame)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("margin", [0, 13, 40])
@pytest.mark.parametrize("source", ["texture", "noise", "flat"])
def test_seed_grid_identical(margin, source):
    rng = np.random.default_rng(margin)
    frame = {
        "texture": _texture(),
        "noise": rng.uniform(0, 255, (120, 160)).astype(np.float32),
        "flat": np.full((120, 160), 7.0, np.float32),  # every cell ties
    }[source]
    got = tracking.seed_grid(torch.from_numpy(frame), grid_step=16, margin=margin)
    want = jtr.seed_grid(jnp.asarray(frame), grid_step=16, margin=margin)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if margin == 40:  # cells wholly inside the stripe: all -inf, index 0
        assert not bool(got.alive[0]) and got.xy[0].tolist() == [0.0, 0.0]


def _flow_and_tracks(seed, h=60, w=80, n=200):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3, 3, (h, w)).astype(np.float32)
    v = rng.uniform(-3, 3, (h, w)).astype(np.float32)
    xy = np.stack([rng.uniform(-4, w + 3, n), rng.uniform(-4, h + 3, n)], 1).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    age = rng.integers(0, 5, n).astype(np.int32)
    return u, v, xy, alive, age


def test_sample_flow_identical():
    u, v, xy, _, _ = _flow_and_tracks(1)
    got = tracking.sample_flow(*map(torch.from_numpy, (u, v, xy))).numpy()
    want = np.asarray(jtr.sample_flow(*map(jnp.asarray, (u, v, xy))))
    np.testing.assert_array_equal(got, want)


def test_advance_and_forward_backward_check_identical():
    u, v, xy, alive, age = _flow_and_tracks(2)
    ub, vb = -u[::-1], -v[::-1]
    jt = jtr.Tracks(jnp.asarray(xy), jnp.asarray(xy), jnp.asarray(age), jnp.asarray(alive))
    tt = tracking.Tracks(*map(torch.from_numpy, (xy, xy.copy(), age, alive)))
    ja = jtr.advance(jt, jnp.asarray(u), jnp.asarray(v), margin=3)
    ta = tracking.advance(tt, torch.from_numpy(u), torch.from_numpy(v), margin=3)
    jf = jtr.forward_backward_check(ja, jnp.asarray(xy), jnp.asarray(ub), jnp.asarray(vb), 1.0)
    tf = tracking.forward_backward_check(
        ta, torch.from_numpy(xy), torch.from_numpy(ub.copy()), torch.from_numpy(vb.copy()), 1.0
    )
    for got, want in ((ta, ja), (tf, jf)):
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0, atol=1.5e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(tf.alive.sum()) < int(ta.alive.sum())  # the check culls some


# ---------------------------------------------------------------------------
# FrontEnd: backend="torch" against backend="jnp"
# ---------------------------------------------------------------------------


def _frames(n, h=120, w=160, blank_at=None):
    base = _texture(h, w)
    out = [nd_shift(base, (0.3 * i, -1.2 * i), order=1, mode="nearest") for i in range(n)]
    if blank_at is not None:
        out[blank_at] = np.full((h, w), 128.0, np.float32)
    return out


def _assert_records(got, want, xy_atol=2e-3):
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal(got.lm.numpy(), np.asarray(want.lm))
    assert int(got.n_landmarks) == int(want.n_landmarks)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0, atol=xy_atol)


def _assert_states(got, want):
    for f in ("alive", "track_lm", "n_landmarks", "frame_index", "max_alive",
              "tracking_lost", "loss_frames", "loss_count", "age"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


FRONT_ENDS = {
    "stride1": dict(keyframe_stride=1, fb_check_threshold=None, blank_at=None),
    # Off-keyframe steps with dead slots: the masked reseed must not write.
    "stride2_fb_loss": dict(keyframe_stride=2, fb_check_threshold=1.0, blank_at=2),
}


@pytest.mark.parametrize("name", sorted(FRONT_ENDS))
def test_front_end_matches_reference(name):
    kw = dict(FRONT_ENDS[name])
    frames = _frames(5 if kw["blank_at"] else 4, blank_at=kw.pop("blank_at"))
    jfe = jdl.FrontEnd(grid_step=16, backend="jnp", **kw)
    tfe = device_loop.FrontEnd(grid_step=16, backend="torch", **kw)
    js, jo = jfe.init(frames[0])
    ts, to = tfe.init(torch.from_numpy(frames[0]))
    _assert_records(to, jo)
    for frame in frames[1:]:
        js, jo = jfe.step(js, frame)
        ts, to = tfe.step(ts, torch.from_numpy(frame))
        _assert_records(to, jo)
        _assert_states(ts, js)
    if name == "stride2_fb_loss":
        assert int(ts.loss_count) == 1 and int(ts.loss_frames[0]) == 2


def test_masked_reseed_off_a_keyframe_is_bit_identical():
    # keyframe_stride=2, a step onto an odd frame with dead slots: the
    # select writes nothing, so the table is the advanced one, bit for bit.
    frames = _frames(2)
    fe = device_loop.FrontEnd(grid_step=16, keyframe_stride=2, backend="torch")
    state, _ = fe.init(torch.from_numpy(frames[0]))
    state = state._replace(alive=state.alive & (torch.arange(state.alive.numel()) % 3 > 0))
    nxt, _ = fe.step(state, torch.from_numpy(frames[1]))
    u, v = fe._flow(state.carry, fe.carry_of_frame(torch.from_numpy(frames[1])))
    adv = tracking.advance(tracking.Tracks(state.xy, state.start_xy, state.age, state.alive),
                           u, v, margin=fe.margin_for(120, 160))
    assert bool((~adv.alive).any())
    for got, want in ((nxt.xy, adv.xy), (nxt.alive, adv.alive), (nxt.age, adv.age),
                      (nxt.track_lm, state.track_lm), (nxt.n_landmarks, state.n_landmarks)):
        assert torch.equal(got, want)


def test_front_end_continues_a_reference_state():
    # A session started in tpuflow continues here from its converted state.
    frames = _frames(4)
    jfe = jdl.FrontEnd(grid_step=16, backend="jnp")
    js, _ = jfe.init(frames[0])
    js, _ = jfe.step(js, frames[1])
    ts = convert.front_end_state_from_reference(_fields(js), "cpu")
    assert [tuple(c.shape) for c in ts.carry] == [tuple(c.shape) for c in js.carry]
    tfe = device_loop.FrontEnd(grid_step=16, backend="torch")
    for frame in frames[2:]:
        js, jo = jfe.step(js, frame)
        ts, to = tfe.step(ts, torch.from_numpy(frame))
        _assert_records(to, jo)
        _assert_states(ts, js)


def test_scan_steps_equals_step_by_step():
    frames = _frames(4)
    fe = device_loop.FrontEnd(grid_step=16, keyframe_stride=2, backend="torch")
    state, _ = fe.init(torch.from_numpy(frames[0]))
    scanned, stack = fe.scan_steps(state, torch.from_numpy(np.stack(frames[1:])))
    for i, frame in enumerate(frames[1:]):
        state, obs = fe.step(state, torch.from_numpy(frame))
        for a, b in zip(obs, stack):
            assert torch.equal(a, b[i])
    for a, b in zip(scanned[1:], state[1:]):
        assert torch.equal(a, b)


def test_front_end_cache_and_unported_options():
    cfg = PYRAMID_CONFIGS["default"]
    a = device_loop.get_front_end(16, 1, None, "torch", config=cfg)
    assert a is device_loop.get_front_end(16, 1, None, "torch", config=cfg)
    assert a is not device_loop.get_front_end(16, 2, None, "torch", config=cfg)
    # A mesh front end is never shared through the cache, and carries the
    # raw frame (the tiled flow builds its own pyramids).
    mesh = object()
    tiled = device_loop.get_front_end(16, 1, None, "torch", mesh=mesh, config=cfg)
    assert tiled.mesh is mesh and tiled is not device_loop.get_front_end(
        16, 1, None, "torch", mesh=mesh, config=cfg)
    frame = torch.zeros((32, 32))
    assert len(tiled.carry_of_frame(frame)) == 1 and tiled.carry_of_frame(frame)[0] is frame
    with pytest.raises(TypeError, match="torch tensors"):
        a.init(np.zeros((32, 32), np.float32))
    with pytest.raises(ValueError, match="backend"):
        device_loop.FrontEnd(backend="jnp")


# ---------------------------------------------------------------------------
# Bundle adjustment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ba_problem():
    problem, _ = _make_ba_problem(np.random.default_rng(1234), noise=0.5)
    return problem, convert.ba_problem_from_reference(_fields(problem), "cpu")


def test_closed_form_jacobians_match_jacfwd(ba_problem):
    jp_, tp = ba_problem
    for got, want in zip(ba._obs_blocks(tp, 4.0), jba._obs_blocks(jp_, 4.0)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6 * np.abs(want).max())


def test_segment_sum_is_index_add():
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 7, 50))
    vals = torch.from_numpy(rng.normal(size=(50, 2, 3)))  # f64: the order does not show
    want = torch.zeros(9, 2, 3, dtype=torch.float64).index_add_(0, keys, vals)
    torch.testing.assert_close(ba.segment_sum(vals, keys, 9), want, rtol=1e-12, atol=1e-12)
    assert ba.segment_sum(vals[:0], keys[:0], 4).shape == (4, 2, 3)


def test_gauss_newton_step_matches(ba_problem):
    jp_, tp = ba_problem
    got = ba.gauss_newton_step(tp)
    want = jba.gauss_newton_step(jp_)
    for f, atol in (("poses_r", 1e-5), ("poses_t", 2e-4), ("landmarks", 5e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=atol)


def test_lm_solve_matches(ba_problem):
    jp_, tp = ba_problem
    got = ba.solve(tp, iterations=8)
    want = jba.solve(jp_, iterations=8)
    for f, atol in (("poses_r", 1e-5), ("poses_t", 2e-4), ("landmarks", 1e-3)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=atol)
    e_got = float(ba.reprojection_errors(got).mean())
    e_want = float(jba.reprojection_errors(want).mean())
    assert abs(e_got - e_want) < 1e-5 and e_got < 0.6
    # Observations "sharded" over a one-rank process group: the all-reduce
    # is the identity, so the solve gives the same bits
    # (tests/test_torch_vo_mesh.py holds four shards).
    group = torch.distributed.ProcessGroupGloo(torch.distributed.HashStore(), 0, 1)
    for a, b in zip(ba.solve(tp, iterations=8, axis_name=group), got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# epipolar
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_view():
    intr, pts, r_rel, t_rel, uv1, uv2 = _two_view_scene(np.random.default_rng(1234))
    return np.asarray(intr), pts, r_rel, t_rel, uv1, uv2


def test_essential_up_to_sign(two_view):
    intr, _, _, _, uv1, uv2 = two_view
    valid = np.ones(len(uv1), bool)
    x1, x2 = (np.asarray(jepi.normalize_pixels(jnp.asarray(u), jnp.asarray(intr)))
              for u in (uv1, uv2))
    want = np.asarray(jepi.essential_irls(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid)))
    got = epipolar.essential_irls(_t(x1), _t(x2), _t(valid)).numpy()
    sign = np.sign((got * want).sum())
    np.testing.assert_allclose(sign * got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("corrupt", [False, True])
def test_two_view_init_matches(two_view, corrupt):
    intr, _, r_rel, _, uv1, uv2 = two_view
    valid = np.ones(len(uv1), bool)
    if corrupt:  # half the rows corrupted and marked invalid
        uv2 = uv2.copy()
        uv2[::2] += np.random.default_rng(5).uniform(-80, 80, (len(uv2[::2]), 2))
        valid[::2] = False
    want = jepi.two_view_init(*map(jnp.asarray, (uv1, uv2, valid, intr)))
    got = epipolar.two_view_init(*map(_t, (uv1, uv2, valid, intr)))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=5e-4)
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(want.good))
    assert int(got.n_good) == int(want.n_good)
    np.testing.assert_allclose(got.r.numpy(), r_rel, atol=5e-3)


def test_triangulate_landmarks_matches(two_view):
    intr, pts, r_rel, t_rel, uv1, uv2 = two_view
    n = len(pts)
    args = dict(
        poses_r=np.stack([np.eye(3, dtype=np.float32), r_rel]),
        poses_t=np.stack([np.zeros(3, np.float32), t_rel]),
        obs_uv=np.concatenate([uv1, uv2]),
        obs_cam=np.r_[np.zeros(n), np.ones(n)].astype(np.int32),
        obs_lm=np.r_[np.arange(n), np.arange(n)].astype(np.int32),
        obs_valid=np.arange(2 * n) != n + 5,  # landmark 5 seen once: fallback
        intrinsics=intr,
        fallback=np.full((n, 3), -123.0, np.float32),
    )
    want = np.asarray(jepi.triangulate_landmarks(
        **{k: jnp.asarray(v) for k, v in args.items()}, n_landmarks=n))
    got = epipolar.triangulate_landmarks(**{k: _t(v) for k, v in args.items()},
                                         n_landmarks=n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(got[5], args["fallback"][5])


# ---------------------------------------------------------------------------
# Pipeline, metrics, verifier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def strafe():
    gt_r, gt_t = vo_verifier.SEQUENCES["strafe_x"](vo_verifier.N_FRAMES)
    frames = vo_verifier.render_sequence(gt_r, gt_t)
    kw = dict(init_depth=vo_verifier.PLANE_DEPTH, ba_iterations=10)
    want = jax_run_odometry(frames, vo_verifier.intrinsics(), backend="jnp", **kw)
    got = run_odometry(frames, vo_verifier.intrinsics(), backend="torch", device="cpu", **kw)
    return gt_r, gt_t, frames, got, want


def test_rendered_sequences_match_reference():
    for name in vo_verifier.SEQUENCES:
        gt = vo_verifier.SEQUENCES[name](3)
        for a, b in zip(gt, jverifier.SEQUENCES[name](3)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(vo_verifier.render_sequence(*gt), jverifier.render_sequence(*gt)):
            np.testing.assert_array_equal(a, b)


def test_run_odometry_strafe_matches_reference(strafe, tmp_path):
    gt_r, gt_t, _, got, want = strafe
    assert got.keyframe_indices == want.keyframe_indices
    assert got.track_count == want.track_count
    assert got.track_loss_frames == want.track_loss_frames == []
    np.testing.assert_allclose(got.poses_r, want.poses_r, rtol=0, atol=1e-2)
    centers = vo_metrics.camera_centers(got.poses_r, got.poses_t)
    ref = jmetrics.camera_centers(want.poses_r, want.poses_t)
    s, r, t = vo_metrics.umeyama_alignment(centers, ref)
    np.testing.assert_allclose(s * centers @ r.T + t, ref, rtol=0, atol=0.005)

    def result(r):
        m = vo_metrics.trajectory_metrics(r.poses_r, r.poses_t, gt_r, gt_t)
        m["metric_poses"] = False
        return [{"sequence": "strafe_x", "n_frames": 8, "metrics": m,
                 "track_count": r.track_count}]

    path = tmp_path / "jax_run.json"
    path.write_text(json.dumps({"sequences": {"strafe_x": result(want)[0]}, "backend": "jnp"}))
    assert vo_verifier.check_absolute_bounds(result(got), verbose=False)
    assert vo_verifier.compare_against_baseline(
        result(got), path, vo_verifier.CROSS_PLATFORM_THRESHOLD,
        abs_floor=vo_verifier.CROSS_METRIC_FLOORS, backend="torch", verbose=False,
    )


def test_session_process_frames_equals_process_frame(strafe):
    _, _, frames, _, _ = strafe
    intr = vo_verifier.intrinsics()
    eager = OdometrySession(intr, keyframe_stride=2, device="cpu")
    for f in frames[:5]:
        eager.process_frame(f)
    chunked = OdometrySession(intr, keyframe_stride=2, device="cpu")
    chunked.process_frames(np.stack(frames[:3]))
    chunked.process_frames(torch.from_numpy(np.stack(frames[3:5])))
    assert chunked.keyframes == eager.keyframes == [0, 2, 4]
    for a, b in zip(chunked.obs_uv + chunked.obs_lm + chunked.obs_valid,
                    eager.obs_uv + eager.obs_lm + eager.obs_valid):
        np.testing.assert_array_equal(a, b)
    assert chunked.n_landmarks == eager.n_landmarks
    np.testing.assert_array_equal(chunked.lm_first_uv, eager.lm_first_uv)
    np.testing.assert_array_equal(chunked.track_lm, eager.track_lm)
    assert chunked._prev_frame.shape == (240, 320)
    assert chunked._tracks.alive.shape == (300,)


def test_essential_init_solve_runs(strafe):
    _, _, frames, _, _ = strafe
    sess = OdometrySession(vo_verifier.intrinsics(), device="cpu")
    for f in frames[:4]:
        sess.process_frame(f)
    boot = sess.solve(ba_iterations=4, essential_init=True)
    windowed = sess.solve(ba_iterations=4, window=2)
    for r in (boot, windowed):
        assert np.isfinite(r.poses_t).all() and r.mean_reprojection_error < 1.0
    np.testing.assert_array_equal(windowed.poses_t[:2], 0.0)  # held at their start


def test_trajectory_metrics_match(rng):
    r = np.asarray(jax.vmap(jse3.so3_exp)(jnp.asarray(rng.normal(0, 0.1, (6, 3)),
                                                      jnp.float32)))
    t = rng.normal(0, 1, (6, 3))
    r2 = r @ np.asarray(jse3.so3_exp(jnp.asarray([0.01, -0.02, 0.005])))
    t2 = 1.7 * t + rng.normal(0, 0.01, t.shape)
    for with_scale in (True, False):
        assert vo_metrics.trajectory_metrics(r2, t2, r, t, with_scale) == \
            jmetrics.trajectory_metrics(r2, t2, r, t, with_scale)
    assert vo_metrics.rpe(r2, t2, r, t, delta=2) == jmetrics.rpe(r2, t2, r, t, delta=2)


BASELINES = ["vo_baseline.json", "vo_pallas_baseline.json"]


@pytest.mark.parametrize("base", BASELINES)
@pytest.mark.parametrize("other", BASELINES)
def test_verifier_thresholds_match_reference(base, other, capsys):
    # The committed baselines' sequences gated against each other: the
    # same verdicts as tpuflow's functions for the same backend.
    path = DATA / base
    results = list(json.loads((DATA / other).read_text())["sequences"].values())
    assert vo_verifier.check_absolute_bounds(results) == jverifier.check_absolute_bounds(results)
    for port, ref in (("torch", "jnp"), ("cuda", "pallas")):
        for platform in ("cpu", "tpu"):
            got = vo_verifier.default_threshold(port, platform, path)
            want = jverifier.default_threshold(ref, platform, path)
            if ref == "pallas" and platform != json.loads(path.read_text())["platform"]:
                # The one intended difference: Pallas runs only on the
                # TPU, so the reference gives it 10% anywhere; the port's
                # cuda run on another platform is cross-platform.
                assert got == (vo_verifier.CROSS_PLATFORM_THRESHOLD,
                               vo_verifier.CROSS_METRIC_FLOORS)
            else:
                assert got == want
            kw = dict(abs_floor=got[1], platform=platform, pyramid_config="default")
            assert vo_verifier.compare_against_baseline(results, path, got[0], backend=port,
                                                        **kw) == \
                jverifier.compare_against_baseline(results, path, got[0], backend=ref, **kw)
    capsys.readouterr()


def test_base_texture_equals_reference():
    # Any size, as the reference's PIL resize (tests/test_torch_patterns_gen.py holds more).
    for w, h in ((320, 240), (160, 120)):
        np.testing.assert_array_equal(patterns.load_base_texture(w, h),
                                      jpatterns.load_base_texture(w, h))


def test_update_baseline_records_provenance(tmp_path, capsys):
    results = list(json.loads((DATA / "vo_pallas_baseline.json").read_text())["sequences"]
                   .values())[:3]
    path = tmp_path / "vo_cuda.json"
    vo_verifier.update_baseline(results, path, backend="cuda", pyramid_config="default",
                                platform="gpu", device_name="card")
    doc = json.loads(path.read_text())
    assert (doc["backend"], doc["platform"], doc["device"]) == ("pallas", "gpu", "card")
    assert vo_verifier.default_threshold("cuda", "gpu", path) == (10.0, 1e-4)
    assert vo_verifier.gate(results, path, "cuda", "gpu")
    assert not vo_verifier.gate(results, path, "torch", "gpu")  # provenance
    capsys.readouterr()


def test_unported_sequences_and_unknown_names():
    # Every sequence of the reference is ported now; an unknown name exits.
    assert list(vo_verifier.SEQUENCES) == list(jverifier.SEQUENCES)
    with pytest.raises(SystemExit):
        vo_verifier.run_suite(["no_such"], device="cpu")
    with pytest.raises(SystemExit):
        vo_verifier.verify_sequence("no_such", device="cpu")


def test_vo_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    # Without a card, no VO entry point falls back to the CPU by itself.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = vo_verifier.intrinsics()
    for call in (
        lambda: OdometrySession(intr),
        lambda: run_odometry([np.zeros((32, 32), np.float32)], intr),
        lambda: vo_verifier.run_suite(["dolly_z"]),
        lambda: vo_verifier.main(["--sequence", "dolly_z"]),
        lambda: convert.ba_problem_from_reference({}),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert OdometrySession(intr, device="cpu").device.type == "cpu"
