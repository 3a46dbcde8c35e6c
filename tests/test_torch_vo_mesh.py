"""The port's VO stack over a process mesh on the CPU: the mesh-tiled
session (``OdometrySession(mesh=...)``), its resume guards and
conversion from ``tpuflow``, bundle adjustment over sharded observations
(``ba.solve`` / ``gauss_newton_step`` with ``axis_name`` a process group)
and ``sharding.initialize_multihost``. The cases of tests/test_vo.py
(``test_ba_distributed_matches_single``,
``test_tiled_flow_session_matches_untiled``, ``test_mesh_resume_guard``)
and tests/test_multihost.py.

The port runs in gloo worker processes (tests/mesh_harness.py): four
ranks on a (1, 2, 2) mesh for every case, started once for the module,
and two ranks for ``initialize_multihost``. The JAX side runs here.

Limits:
- the tiled session against an untiled ``rtl_clamp`` session of the port:
  alive flags and landmark ids identical, live tracks within 1e-3 px (the
  reference's test);
- a ``tpuflow`` tiled session carried over and continued beside the same
  session continued in ``tpuflow``: alive flags and ids identical, live
  tracks within 2e-3 px (the front end's limit between the packages,
  tests/test_torch_vo_state.py);
- sharded BA: 6 Gauss-Newton steps reach a mean reprojection error under
  0.05 px and camera translations within 2e-2 of the unsharded solve and
  of the reference's sharded one (the reference's limits: the per-shard
  partial sums add in another order, and the Schur complement amplifies
  that within a step); the sharded LM solve's mean reprojection error
  within 1e-4 px of the unsharded solve's, and two sharded solves bit
  for bit equal.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from scipy.ndimage import shift as nd_shift

from tpuflow.eval import patterns as jpatterns
from tpuflow.sharding import make_flow_mesh as jax_mesh
from tpuflow.vo import ba as jba
from tpuflow.vo.pipeline import OdometrySession as JaxSession
from tpuflow_torch.vo import ba, device_loop
from tpuflow_torch.vo.pipeline import OdometrySession

sys.path.insert(0, str(Path(__file__).parent))
from mesh_harness import run_ranks  # noqa: E402
from test_vo import _make_ba_problem  # noqa: E402

W, H = 128, 64
INTR = (80.0, 80.0, W / 2.0, H / 2.0)
CASES = ["vo_session", "vo_resume", "vo_convert", "ba_sharded"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as the other port test files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    base = jpatterns.load_base_texture(W, H).astype(np.float32)
    return [nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest").astype(np.float32)
            for i in range(6)]


@pytest.fixture(scope="module")
def problem():
    return _make_ba_problem(np.random.default_rng(1234))[0]


@pytest.fixture(scope="module")
def jax_tiled(frames):
    """A ``tpuflow`` session tiled over a (1, 2, 2) mesh after 3 frames (its
    meta and state), and the same session after 2 more."""
    sess = JaxSession(INTR, grid_step=16, mesh=jax_mesh(batch=1, ty=2, tx=2))
    for f in frames[:3]:
        sess.process_frame(f)
    meta, state = sess.meta_dict(), {k: np.asarray(v) for k, v in sess.state_dict().items()}
    for f in frames[3:5]:
        sess.process_frame(f)
    return meta, state, sess


@pytest.fixture(scope="module")
def port(tmp_path_factory, frames, problem, jax_tiled):
    meta, state, _ = jax_tiled
    inp = {"intr": np.asarray(INTR, np.float32), "vo_frames": np.stack(frames),
           "conv_meta": np.array(json.dumps(meta)), "conv_frames": np.stack(frames[3:5])}
    inp.update({f"conv_state/{k}": v for k, v in state.items()})
    dtypes = {"obs_cam": np.int64, "obs_lm": np.int64, "obs_valid": bool}
    inp.update({f"ba/{f}": np.asarray(getattr(problem, f), dtypes.get(f, np.float32))
                for f in ba.BAProblem._fields})
    return run_ranks(tmp_path_factory.mktemp("vo_mesh"), 4, "1,2,2", CASES, inp)


def _torch_problem(problem) -> ba.BAProblem:
    dtypes = {"obs_cam": torch.int64, "obs_lm": torch.int64, "obs_valid": torch.bool}
    return ba.BAProblem(**{f: torch.from_numpy(np.array(getattr(problem, f))).to(
        dtypes.get(f, torch.float32)) for f in ba.BAProblem._fields})


def _assert_tracks(got: dict, valid, lm, uv, atol: float):
    np.testing.assert_array_equal(got["valid"], np.stack(valid))
    np.testing.assert_array_equal(got["lm"], np.stack(lm))
    both = np.stack(valid)
    np.testing.assert_allclose(got["uv"][both], np.stack(uv)[both], rtol=0, atol=atol)


# -- the tiled session -------------------------------------------------------------------------


def test_tiled_flow_session_matches_untiled(port, frames):
    ss = OdometrySession(INTR, grid_step=16, device="cpu")
    ss._fe = device_loop.FrontEnd(grid_step=16, keyframe_stride=1, backend="torch",
                                  rtl_clamp=True)
    for f in frames:
        ss.process_frame(f)
    got = {k[len("vo_session/"):]: v for k, v in port[0].items() if k.startswith("vo_session/")}
    _assert_tracks(got, ss.obs_valid, ss.obs_lm, ss.obs_uv, atol=1e-3)
    assert got["valid"].sum(axis=1).min() > 0
    for res in port[1:]:
        for key in ("uv", "valid", "lm"):
            np.testing.assert_array_equal(res[f"vo_session/{key}"], got[key])


def test_mesh_resume_guard(port):
    """A tiled session resumes only with its mesh, and an untiled one only
    without; the resumed tiled session continues bit for bit."""
    for res in port:
        assert res["vo_resume/untiled_refused"], "a tiled checkpoint loaded without its mesh"
        assert res["vo_resume/mesh_refused"], "an untiled checkpoint loaded with a mesh"
        assert res["vo_resume/same_mesh"] and res["vo_resume/tiled_meta"]
        assert res["vo_resume/identical"]


def test_tiled_session_from_reference(port, jax_tiled):
    _, _, jsess = jax_tiled
    res = port[0]
    assert res["vo_convert/refused"], "a tiled tpuflow session converted without a mesh"
    got = {k[len("vo_convert/"):]: v for k, v in res.items() if k.startswith("vo_convert/")}
    _assert_tracks(got, jsess.obs_valid, jsess.obs_lm, jsess.obs_uv, atol=2e-3)


# -- bundle adjustment over sharded observations -----------------------------------------------


def _jax_sharded_steps(problem, steps: int):
    """tests/test_vo.py's sharded solve: ``steps`` Gauss-Newton steps with
    the observations sharded over 4 devices."""
    k, m = problem.poses_r.shape[0], problem.landmarks.shape[0]
    rep, obs = P(), P("obs")

    @functools.partial(shard_map, mesh=Mesh(np.array(jax.devices()[:4]), ("obs",)),
                       in_specs=(rep, rep, rep, obs, obs, obs, obs, rep),
                       out_specs=(rep, rep, rep), check_vma=False)
    def step(pr, pt, lm, uv, cam, lmi, valid, intr):
        prob = jba.BAProblem(pr, pt, lm, uv, cam, lmi, valid, intr)
        for _ in range(steps):
            prob = jba.gauss_newton_step(prob, axis_name="obs", num_cams=k, num_lms=m)
        return prob.poses_r, prob.poses_t, prob.landmarks

    return jax.jit(step)(*problem)


def _mean_error(tp: ba.BAProblem, **fields) -> float:
    return float(ba.reprojection_errors(tp._replace(**{
        k: torch.from_numpy(v) for k, v in fields.items()})).mean())


def test_ba_distributed_matches_single(port, problem):
    assert problem.obs_uv.shape[0] % 4 == 0  # four equal shards, no padding
    tp = _torch_problem(problem)
    single = ba.solve(tp, iterations=6, adaptive=False)
    _, jpt, _ = _jax_sharded_steps(problem, 6)
    res = port[0]
    e_dist = _mean_error(tp, poses_r=res["ba_sharded/poses_r"], poses_t=res["ba_sharded/poses_t"],
                         landmarks=res["ba_sharded/landmarks"])
    e_single = float(ba.reprojection_errors(single).mean())
    assert e_dist < 0.05 and e_single < 0.05, (e_dist, e_single)
    np.testing.assert_allclose(res["ba_sharded/poses_t"], single.poses_t.numpy(), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(res["ba_sharded/poses_t"], np.asarray(jpt), rtol=0, atol=2e-2)
    for other in port[1:]:
        np.testing.assert_array_equal(other["ba_sharded/poses_t"], res["ba_sharded/poses_t"])


def test_ba_sharded_lm_solve_matches_single(port, problem):
    tp = _torch_problem(problem)
    single = ba.solve(tp, iterations=8)
    res = port[0]
    e_dist = _mean_error(tp, poses_r=res["ba_sharded/lm_poses_r"],
                         poses_t=res["ba_sharded/lm_poses_t"],
                         landmarks=res["ba_sharded/lm_landmarks"])
    assert abs(e_dist - float(ba.reprojection_errors(single).mean())) < 1e-4
    assert all(bool(r["ba_sharded/lm_repeat"]) for r in port)


# -- initialize_multihost ----------------------------------------------------------------------


def test_two_process_initialize_multihost(tmp_path):
    """Two ranks join through a file rendezvous; a second call is an
    idempotent no-op (False), and a sum crosses the process boundary."""
    ranks = run_ranks(tmp_path, 2, "none", ["multihost"], {"unused": np.zeros(1)}, timeout=120)
    for res in ranks:
        assert res["joined"] and not res["multihost/reentry"]
        assert int(res["multihost/world"]) == 2
        np.testing.assert_array_equal(res["multihost/sum"], [3.0])
