"""The port's loop closure, chunked pose-graph pipeline and the verifier's
chunked sequences (``tpuflow_torch.vo.loop_closure``,
``vo.pipeline.run_odometry_chunked``, ``eval.vo_verifier``) against
``tpuflow`` on the CPU, ``backend="torch"`` against ``backend="jnp"``.

Limits, each beside the figure measured on this CPU:

- ``keyframe_descriptor`` and ``detect_loops``: identical (the same numpy).
- ``loop_edge`` on the verifier's rendered pairs. Zero-baseline branch
  (``strafe_x`` frames 0 and 1, 1.2 px): the support identical, R = I
  and t within 1e-6 (measured 1.3e-7: the median flow shift's last
  digit). Essential branch (``arc_yaw`` and ``strafe_x`` frames 0 and 7):
  the support identical, R within 5e-4 (measured 1.2e-4) and t within
  2.5% of |t| (measured 1.1%: on the fronto-parallel plane the essential
  fit's translation direction is weakly determined, and the two flows
  differ by up to 2e-3 px, as ``tests/test_torch_vo.py`` records). A
  blank pair: None from both.
- ``run_odometry_chunked`` on ``tests/test_vo.py``'s chunked sequences:
  the keyframe nodes, the pose graph's edges (i, j) and the loss frames
  identical; rotations within 1e-2 (measured 2.0e-4, and 5.3e-3 across
  the occlusion, where the chunk after it re-anchors with fresh scale);
  camera centers, after the Sim(3) alignment the monocular gauge leaves
  free, within 1% of the path's extent on the continuous sequence
  (measured 0.27%) and within 50% across the occlusion (measured 17%: the
  segments on either side are not metrically connected, as the reference
  documents, so their relative scale is chaos); the pose graph's residual
  (``mean_reprojection_error``) below 1e-6 in both packages. With IMU
  (``tests/test_vo_imu.py``'s zero-gyro data): the same nodes and edges
  (the gyro edges included), rotations within 1e-2 (measured 5.0e-5),
  centers within 1% of the extent (measured 0.08%), the residual within
  1e-4 of JAX's (measured 9.5e-8 of 7.6e-3) and every rotation within 3
  degrees of the identity.
- The verifier's ``square_loop`` and ``swing_imu`` through the port on the
  CPU: inside the absolute bounds, and against the committed
  ``vo_baseline.json`` (JAX on the CPU) within the reference's
  cross-platform rule (``CROSS_PLATFORM_THRESHOLD`` with
  ``CROSS_METRIC_FLOORS``), which records the monocular scale's chaos
  between hosts; ``swing_imu`` scored metric, as the baseline is.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tpuflow.eval import patterns as jpatterns
from tpuflow.flow import lucas_kanade_pyramidal as jax_pyramidal
from tpuflow.vo import loop_closure as jlc
from tpuflow.vo import pipeline as jpipeline
from tpuflow.vo import pose_graph as jpg
from tpuflow_torch.eval import vo_metrics, vo_verifier
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal
from tpuflow_torch.vo import loop_closure, pipeline, pose_graph

DATA = Path(__file__).resolve().parents[1] / "tpuflow" / "eval" / "data"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one CPU thread, as tests/test_torch_vo.py runs it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# loop closure
# ---------------------------------------------------------------------------


def test_keyframe_descriptor_identical():
    base = jpatterns.load_base_texture(480, 120).astype(np.float32)
    for frame in (base[:, :160], base[:, :160] * 1.3 + 20.0, base[:, 300:460], base[:7, :5],
                  np.full((64, 64), 3.0, np.float32)):
        np.testing.assert_array_equal(loop_closure.keyframe_descriptor(frame),
                                      jlc.keyframe_descriptor(frame))
    np.testing.assert_array_equal(loop_closure.keyframe_descriptor(base, size=8),
                                  jlc.keyframe_descriptor(base, size=8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_loops_identical(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(12, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[6] = d[1]
    d[9] = 0.9 * d[2] + 0.1 * d[9]
    d[3] = d[2]  # too close to count
    for kw in (dict(), dict(min_separation=4, threshold=0.5, max_pairs=2),
               dict(min_separation=11, threshold=-1.0)):
        assert loop_closure.detect_loops(d, **kw) == jlc.detect_loops(d, **kw)
    assert loop_closure.detect_loops(d[:3]) == []


@pytest.fixture(scope="module")
def jax_flow():
    return jax.jit(lambda p, c: jax_pyramidal(p, c, backend="jnp"))


def _port_flow(p, c):
    return lucas_kanade_pyramidal(p, c, backend="torch")


@pytest.mark.parametrize("name,i,j", [("strafe_x", 0, 1), ("arc_yaw", 0, 7),
                                      ("strafe_x", 0, 7), ("blank", 0, 1)])
def test_loop_edge_matches(jax_flow, name, i, j):
    if name == "blank":
        frames = [np.full((240, 320), 128.0, np.float32)] * 2
    else:
        frames = vo_verifier.render_sequence(*vo_verifier.SEQUENCES[name](8))
    kw = dict(depth=vo_verifier.PLANE_DEPTH, grid_step=16)
    want = jlc.loop_edge(frames[i], frames[j], vo_verifier.intrinsics(), jax_flow, **kw)
    got = loop_closure.loop_edge(frames[i], frames[j], vo_verifier.intrinsics(), _port_flow,
                                 device="cpu", **kw)
    if want is None:
        assert got is None
        return
    assert got[2] == want[2]
    if j - i == 1:  # zero-baseline branch
        np.testing.assert_array_equal(got[0], np.eye(3))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=5e-4)
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=0.025 * np.linalg.norm(want[1]))
    assert got[0].dtype == got[1].dtype == np.float32


# ---------------------------------------------------------------------------
# run_odometry_chunked
# ---------------------------------------------------------------------------


def _shifted(w, h, steps, px=1.2):
    base = jpatterns.load_base_texture(w, h).astype(np.float32)
    return [nd_shift(base, (0.0, -px * i), order=1, mode="nearest") for i in steps]


def _loss_frames():
    blank = np.full((120, 320), 128.0, np.float32)
    return _shifted(320, 120, range(4)) + [blank, blank] + _shifted(320, 120, range(6, 9))


def _imu_data(n=8, rate=10.0):
    m = int(n * 20)
    return (np.arange(m) / (20.0 * rate), np.zeros((m, 3), np.float32),
            np.zeros((m, 3), np.float32)), np.arange(n) / rate


CHUNKED = {
    # name: (frames, intrinsics, keyword arguments, Sim(3) limit of the extent)
    "pose_graph": (lambda: _shifted(320, 240, range(10)), (300.0, 300.0, 160.0, 120.0),
                   dict(chunk_size=6, overlap=2, ba_iterations=8), 0.01),
    "track_loss": (_loss_frames, (150.0, 150.0, 160.0, 60.0),
                   dict(chunk_size=5, grid_step=16, ba_iterations=4, fb_check_threshold=1.0),
                   0.5),
    "imu": (lambda: _shifted(160, 120, range(8)), (150.0, 150.0, 80.0, 60.0),
            dict(chunk_size=5, ba_iterations=6), 0.01),
}


def _run_both(monkeypatch, name):
    """The sequence through both packages; returns both results and the
    pose graphs each handed to its solver."""
    make, intr, kw, _ = CHUNKED[name]
    frames = make()
    if name == "imu":
        imu, times = _imu_data()
        kw = dict(kw, imu=imu, frame_times=times)
    graphs = {}
    for key, mod in (("jax", jpg), ("torch", pose_graph)):
        solve = mod.solve

        def spy(g, *a, _key=key, _solve=solve, **k):
            graphs[_key] = g
            return _solve(g, *a, **k)

        monkeypatch.setattr(mod, "solve", spy)
    want = jpipeline.run_odometry_chunked(frames, intr, **kw)
    got = pipeline.run_odometry_chunked(frames, intr, device="cpu", **kw)
    return got, want, graphs


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_run_odometry_chunked_matches(monkeypatch, name):
    got, want, graphs = _run_both(monkeypatch, name)
    assert got.keyframe_indices == want.keyframe_indices
    assert got.track_loss_frames == want.track_loss_frames
    assert got.track_loss_frames == ([4] if name == "track_loss" else [])
    for f in ("edge_i", "edge_j"):
        np.testing.assert_array_equal(getattr(graphs["torch"], f).numpy(),
                                      np.asarray(getattr(graphs["jax"], f)))
    np.testing.assert_allclose(graphs["torch"].edge_weight.numpy(),
                               np.asarray(graphs["jax"].edge_weight))
    np.testing.assert_allclose(got.poses_r, want.poses_r, rtol=0, atol=1e-2)
    assert got.metric_scale is None and want.metric_scale is None
    assert got.metric_poses is want.metric_poses is False
    ours = vo_metrics.camera_centers(got.poses_r, got.poses_t)
    ref = vo_metrics.camera_centers(want.poses_r, want.poses_t)
    s, r, t = vo_metrics.umeyama_alignment(ours, ref)
    extent = np.abs(ref - ref[0]).max()
    np.testing.assert_allclose(s * ours @ r.T + t, ref, rtol=0, atol=CHUNKED[name][3] * extent)
    if name == "imu":  # gyro edges after the odometry edges; the zero-gyro truth
        assert graphs["torch"].edge_mask is not None
        angles = [np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
                  for r in got.poses_r]
        assert max(angles) < 3.0
        assert abs(got.mean_reprojection_error - want.mean_reprojection_error) < 1e-4
    else:
        assert got.mean_reprojection_error < 1e-6 and want.mean_reprojection_error < 1e-6


def test_run_odometry_chunked_imu_coverage(capsys):
    frames = _shifted(160, 120, range(8))
    intr = (150.0, 150.0, 80.0, 60.0)
    times = np.arange(8) / 4.0  # [0, 1.75] s
    z = np.zeros((100, 3), np.float32)
    kw = dict(chunk_size=5, ba_iterations=2, device="cpu")
    with pytest.raises(ValueError, match="frame_times"):
        pipeline.run_odometry_chunked(frames, intr, imu=(np.arange(100) / 50.0, z, z), **kw)
    with pytest.raises(ValueError, match="time base"):
        pipeline.run_odometry_chunked(frames, intr, imu=(1.69e9 + np.arange(100) / 50.0, z, z),
                                      frame_times=times, **kw)
    res = pipeline.run_odometry_chunked(frames, intr, imu=(np.arange(100) / 100.0, z, z),
                                        frame_times=times, **kw)
    assert len(res.keyframe_indices) == 8
    assert "WARNING: 3 of 7 keyframe intervals have no IMU samples" in capsys.readouterr().out
    assert res.metric_scale is None
    with pytest.raises(ValueError, match="overlap"):
        pipeline.run_odometry_chunked(frames, intr, overlap=1, **kw)


# ---------------------------------------------------------------------------
# the verifier's chunked sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["square_loop", "swing_imu"])
def test_chunked_sequences_against_committed_baseline(name, capsys):
    results = vo_verifier.run_suite([name], backend="torch", device="cpu")
    baseline = json.loads((DATA / "vo_baseline.json").read_text())["sequences"][name]
    assert results[0]["n_frames"] == baseline["n_frames"] == vo_verifier.SEQUENCE_LENGTHS[name]
    assert results[0]["metrics"]["metric_poses"] is (name == "swing_imu")
    assert vo_verifier.check_absolute_bounds(results)
    threshold, floor = vo_verifier.default_threshold("torch", "tpu", DATA / "vo_baseline.json")
    assert (threshold, floor) == (vo_verifier.CROSS_PLATFORM_THRESHOLD,
                                  vo_verifier.CROSS_METRIC_FLOORS)
    assert vo_verifier.compare_against_baseline(
        results, DATA / "vo_baseline.json", threshold, abs_floor=floor, backend="torch",
        pyramid_config="default", platform="cpu",
    )
    capsys.readouterr()


def test_chunked_sequence_definitions_match_reference():
    from tpuflow.eval import vo_verifier as jverifier

    assert vo_verifier.SEQUENCE_MODES == jverifier.SEQUENCE_MODES
    assert vo_verifier.SEQUENCE_LENGTHS == jverifier.SEQUENCE_LENGTHS
    for name in ("square_loop", "swing_imu"):
        for a, b in zip(vo_verifier.SEQUENCES[name](17), jverifier.SEQUENCES[name](17)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(vo_verifier._imu_swing(16), jverifier._imu_swing(16)):
        np.testing.assert_array_equal(a, b)
    # A texture and intrinsics of the caller's: 1080p as the smoke renders.
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (108, 192)).astype(np.float32)
    gt = vo_verifier.SEQUENCES["square_loop"](5)
    frames = vo_verifier.render_sequence(*gt, 192, 108, base=base, intr=(180.0, 180.0, 96.0, 54.0))
    assert len(frames) == 5 and frames[0].shape == (108, 192)
    np.testing.assert_allclose(frames[0], base, atol=1e-3)
    with pytest.raises(ValueError, match="texture"):
        vo_verifier.render_sequence(*gt, 320, 240, base=base)


def test_update_baseline_keeps_the_other_sequences(tmp_path, capsys):
    path = tmp_path / "vo.json"
    seqs = list(json.loads((DATA / "vo_pallas_baseline.json").read_text())["sequences"].values())
    kw = dict(backend="cuda", pyramid_config="default", platform="gpu", device_name="card")
    vo_verifier.update_baseline(seqs[:3], path, **kw)
    before = path.read_text()
    vo_verifier.update_baseline(seqs[3:], path, **kw)
    after = json.loads(path.read_text())["sequences"]
    assert list(after) == [s["sequence"] for s in seqs]
    assert {k: after[k] for k in list(after)[:3]} == json.loads(before)["sequences"]
    vo_verifier.update_baseline(seqs[3:], path, backend="torch", platform="cpu")  # replaced
    assert list(json.loads(path.read_text())["sequences"]) == [s["sequence"] for s in seqs[3:]]
    capsys.readouterr()
