"""The port's session state (``OdometrySession.compact``, ``state_dict`` /
``meta_dict`` / ``from_state``, ``vo.checkpoint``, ``convert.
session_from_reference``) and its VO CLI (``python -m tpuflow_torch.vo``)
against ``tpuflow`` on the CPU, ``backend="torch"`` against ``"jnp"``.

Limits, each beside the figure measured on this CPU:

- ``compact`` after the same six frames in both packages: keyframes, the
  frozen prefix's keyframes, the landmark remap (``obs_lm``, ``obs_valid``,
  ``track_lm``, ``lm_first_uv``, ``lm_first_kf``) and ``n_landmarks``
  identical; the frozen and anchored rotations within 1e-3 (measured
  5.4e-5) and translations within 2e-3 on a path of 0.21 (measured
  6.2e-4), the carried landmarks within 1% of their distance (measured
  0.40%): the bundle adjustment's limits of ``tests/test_torch_vo.py``
  (the front end's positions differ by up to 2e-3 px and the monocular
  depth of each landmark amplifies it).
- ``state_dict``: the same keys, shapes and dtypes as ``tpuflow``'s.
- A ``tpuflow`` session (compacted, with a loss in its log) crossing over
  through ``convert.session_from_reference`` and continued 3 frames
  beside the same session continued in ``tpuflow``: alive flags, ids,
  landmark counter and loss log identical, live positions within 2e-3 px
  (the front end's limit), the solve's rotations within 1e-2 and camera
  centers within 0.005 after Sim(3) alignment (the pipeline's limits).
- The port's own save, load and continue: poses, landmarks, keyframes,
  track table and loss log bit-identical to the uninterrupted session,
  with and without ``compact``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tpuflow.eval import patterns as jpatterns
from tpuflow.vo.pipeline import OdometrySession as JaxSession
from tpuflow_torch import convert
from tpuflow_torch.eval import vo_metrics
from tpuflow_torch.io import frames as fio
from tpuflow_torch.vo import checkpoint
from tpuflow_torch.vo.pipeline import OdometrySession, run_odometry_chunked

sys.path.insert(0, str(Path(__file__).parent))
from cli_harness import run_cli_main  # noqa: E402

W, H = 320, 120
INTR = (150.0, 150.0, W / 2.0, H / 2.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one CPU thread, as tests/test_torch_vo.py runs it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pan():
    """A 1.2 px/frame pan."""
    base = jpatterns.load_base_texture(W, H).astype(np.float32)
    return [nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest") for i in range(10)]


@pytest.fixture(scope="module")
def frames(pan):
    """The pan with a blank (occluded) frame at index 4."""
    return pan[:4] + [np.full((H, W), 128.0, np.float32)] + pan[5:]


def _port_session(**kw):
    return OdometrySession(INTR, grid_step=16, fb_check_threshold=1.0, device="cpu", **kw)


def _front_end_equal(a, b):
    for f in ("xy", "start_xy", "age", "alive", "track_lm", "n_landmarks", "frame_index",
              "max_alive", "tracking_lost", "loss_frames", "loss_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# compact and state_dict against tpuflow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compacted(pan):
    jax_sess = JaxSession(INTR, grid_step=16)
    port = OdometrySession(INTR, grid_step=16, device="cpu")
    fresh = None
    for i, f in enumerate(pan[:6]):
        jax_sess.process_frame(f)
        port.process_frame(f)
        if i == 2:
            fresh = (jax_sess.state_dict(), port.state_dict())
    jax_sess.compact(keep_last=3, ba_iterations=5)
    port.compact(keep_last=3, ba_iterations=5)
    return jax_sess, port, fresh


def test_compact_matches_reference(compacted):
    jax_sess, port, _ = compacted
    assert port.keyframes == jax_sess.keyframes == [3, 4, 5]
    assert port.frozen_kf == jax_sess.frozen_kf == [0, 1, 2]
    assert port.n_landmarks == jax_sess.n_landmarks
    for name in ("obs_lm", "obs_valid"):
        for a, b in zip(getattr(port, name), getattr(jax_sess, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("track_lm", "lm_first_uv", "lm_first_kf"):
        np.testing.assert_array_equal(getattr(port, name), getattr(jax_sess, name), err_msg=name)
    for name, atol in (("frozen_r", 1e-3), ("anchor_r", 1e-3), ("frozen_t", 2e-3),
                       ("anchor_t", 2e-3)):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_sess, name), rtol=0,
                                   atol=atol, err_msg=name)
    dist = np.linalg.norm(port.lm_xyz - jax_sess.lm_xyz, axis=1)
    assert (dist <= 0.01 * np.linalg.norm(jax_sess.lm_xyz, axis=1)).all()
    # The device's slot -> id table and landmark counter followed the remap.
    assert int(port._dev.n_landmarks) == port.n_landmarks
    np.testing.assert_array_equal(port._dev.track_lm.numpy(), jax_sess.track_lm)


@pytest.mark.parametrize("which", ["fresh", "compacted"])
def test_state_dict_layout_matches_reference(compacted, which):
    jax_sess, port, fresh = compacted
    want, got = fresh if which == "fresh" else (jax_sess.state_dict(), port.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
    assert ("anchor_r" in got) is (which == "compacted")
    meta = port.meta_dict()
    assert sorted(meta) == sorted(jax_sess.meta_dict())
    assert (meta["backend"], meta["tiled"]) == ("torch", False)


def test_compact_is_a_noop_on_a_short_window(frames):
    sess = OdometrySession(INTR, grid_step=16, device="cpu")
    for f in frames[:3]:
        sess.process_frame(f)
    sess.compact(keep_last=8)
    assert len(sess.obs_uv) == 3 and sess.anchor_r is None and sess.frozen_kf == []


# ---------------------------------------------------------------------------
# a tpuflow session resumed in the port
# ---------------------------------------------------------------------------


def test_session_from_reference_continues(frames):
    jax_sess = JaxSession(INTR, grid_step=16, fb_check_threshold=1.0)
    for f in frames[:7]:
        jax_sess.process_frame(f)
    assert jax_sess.track_loss_frames == [4]
    jax_sess.compact(keep_last=3, ba_iterations=4)
    port = convert.session_from_reference(jax_sess.meta_dict(), jax_sess.state_dict(),
                                          device="cpu")
    assert port.backend == "torch" and port.frozen_kf == jax_sess.frozen_kf
    assert port.track_loss_frames == [4]
    for f in frames[7:10]:
        jax_sess.process_frame(f)
        port.process_frame(f)
    d, j = port._dev, jax_sess._dev
    for f in ("alive", "track_lm", "n_landmarks", "loss_frames", "loss_count",
              "tracking_lost", "max_alive", "age"):
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    alive = d.alive.numpy()
    np.testing.assert_allclose(d.xy.numpy()[alive], np.asarray(j.xy)[alive], rtol=0, atol=2e-3)
    got, want = port.solve(ba_iterations=4), jax_sess.solve(ba_iterations=4)
    assert got.keyframe_indices == want.keyframe_indices
    assert got.track_loss_frames == want.track_loss_frames == [4]
    np.testing.assert_allclose(got.poses_r, want.poses_r, rtol=0, atol=1e-2)
    ours = vo_metrics.camera_centers(got.poses_r, got.poses_t)
    ref = vo_metrics.camera_centers(want.poses_r, want.poses_t)
    s, r, t = vo_metrics.umeyama_alignment(ours, ref)
    np.testing.assert_allclose(s * ours @ r.T + t, ref, rtol=0, atol=0.005)


# ---------------------------------------------------------------------------
# the port's own checkpoint / resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [False, True])
def test_resume_bit_identical(frames, tmp_path, compact):
    straight, first = _port_session(), _port_session()
    for f in frames[:7]:
        straight.process_frame(f)
        first.process_frame(f)
    if compact:
        straight.compact(keep_last=3, ba_iterations=4)
        first.compact(keep_last=3, ba_iterations=4)
    checkpoint.save(first, str(tmp_path / "ck"))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["meta.json", "state.pt"]
    resumed = checkpoint.load(str(tmp_path / "ck"), device="cpu")
    assert resumed.track_loss_frames == [4] and resumed.frame_index == 6
    _front_end_equal(resumed._dev, straight._dev)
    for f in frames[7:]:
        straight.process_frame(f)
        resumed.process_frame(f)
    _front_end_equal(resumed._dev, straight._dev)
    a, b = straight.solve(ba_iterations=4), resumed.solve(ba_iterations=4)
    assert a.keyframe_indices == b.keyframe_indices
    assert a.track_loss_frames == b.track_loss_frames == [4]
    for f in ("poses_r", "poses_t", "landmarks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert len(a.keyframe_indices) == 10 and (len(straight.frozen_kf) == 4) is compact


def test_from_state_reads_the_reference_conventions(frames):
    sess = _port_session()
    for f in frames[:6]:
        sess.process_frame(f)
    state = sess.state_dict()
    assert "anchor_r" not in state and "frozen_kf" not in state  # omitted while empty
    meta = dict(sess.meta_dict(), backend="pallas")
    state["track_loss_frames"] = np.asarray([-1], np.int64)  # the old empty sentinel
    again = OdometrySession.from_state(meta, state, device="cpu")
    assert again.backend == "cuda" and again.track_loss_frames == []
    assert OdometrySession.from_state(dict(meta, backend="jnp"), state,
                                      device="cpu").backend == "torch"


def test_tiled_sessions_raise(frames, tmp_path):
    sess = _port_session()
    for f in frames[:2]:
        sess.process_frame(f)
    checkpoint.save(sess, str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        checkpoint.load(str(tmp_path / "ck"), mesh=object(), device="cpu")
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    (tmp_path / "ck" / "meta.json").write_text(json.dumps(dict(meta, tiled=True)))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        checkpoint.load(str(tmp_path / "ck"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        OdometrySession.from_state(dict(meta, tiled=True), sess.state_dict(), device="cpu")


# ---------------------------------------------------------------------------
# the CLI: tests/test_vo_cli.py's cases against python -m tpuflow_torch.vo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vo_cli_frames")
    base = jpatterns.load_base_texture(W, H).astype(np.float32)
    for i in range(8):
        fio.save_frame_bin(d / f"frame_{i:02d}.bin",
                           nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest"))
    return d


def run_cli(argv, capsys):
    from tpuflow_torch.vo.__main__ import main

    return run_cli_main(main, argv, capsys)


def _argv(d):
    return [str(d), "--width", str(W), "--height", str(H), "--intrinsics", "150", "150",
            "160", "60", "--device", "cpu"]


def test_cli_incremental_export_and_checkpoint(frame_dir, tmp_path, capsys):
    poses, ckpt = tmp_path / "poses.txt", tmp_path / "ckpt"
    out = run_cli(_argv(frame_dir) + ["--export-poses", str(poses), "--checkpoint", str(ckpt)],
                  capsys)
    assert "keyframes: 8" in out and "reprojection error" in out
    rows = np.loadtxt(poses)  # KITTI: 12 floats a keyframe, the first the identity
    assert rows.shape == (8, 12)
    np.testing.assert_allclose(rows[0], np.eye(3, 4).ravel(), atol=1e-6)
    x = rows[:, 3]
    assert x[-1] > x[1] > 0 or x[-1] < x[1] < 0
    out2 = run_cli(_argv(frame_dir) + ["--resume", str(ckpt)], capsys)
    assert "resumed session at frame 7" in out2 and "keyframes: 16" in out2


def test_cli_chunked_mode(frame_dir, capsys):
    out = run_cli(_argv(frame_dir) + ["--chunked", "--chunk-size", "5"], capsys)
    assert "keyframes: 8" in out


def test_cli_missing_frames_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        run_cli([str(tmp_path), "--device", "cpu"], capsys)
    assert exc.value.code == 1
    assert "need >=2 frames" in capsys.readouterr().err


def test_cli_resume_rejects_constructor_flags(frame_dir, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    run_cli(_argv(frame_dir) + ["--checkpoint", str(ckpt)], capsys)
    for flags in (["--backend", "cuda"], ["--keyframe-stride", "2"], ["--grid-step", "32"],
                  ["--init-depth", "2.0"], ["--fb-check", "1.0"],
                  ["--pyramid-config", "shallow"]):
        with pytest.raises(SystemExit) as exc:
            run_cli(_argv(frame_dir) + ["--resume", str(ckpt)] + flags, capsys)
        assert exc.value.code == 2, flags
        assert "--resume" in capsys.readouterr().err


def test_cli_chunked_only_flags_rejected_without_chunked(frame_dir, capsys):
    for flags in (["--loop-closure"], ["--chunk-size", "4"], ["--motion-prior", "0.5"],
                  ["--imu", "x.txt"]):
        with pytest.raises(SystemExit) as exc:
            run_cli(_argv(frame_dir) + flags, capsys)
        assert exc.value.code == 2, flags
        assert "--chunked" in capsys.readouterr().err
    for flags in (["--chunked", "--checkpoint", "x"], ["--frame-rate", "4"]):
        with pytest.raises(SystemExit) as exc:
            run_cli(_argv(frame_dir) + flags, capsys)
        assert exc.value.code == 2, flags


def test_state_entry_points_need_a_card(monkeypatch, frame_dir, tmp_path, capsys):
    sess = _port_session()
    sess.process_frame(np.zeros((32, 48), np.float32))
    checkpoint.save(sess, str(tmp_path / "ck"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: checkpoint.load(str(tmp_path / "ck")),
        lambda: OdometrySession.from_state(sess.meta_dict(), sess.state_dict()),
        lambda: convert.session_from_reference(sess.meta_dict(), sess.state_dict()),
        lambda: run_odometry_chunked([np.zeros((32, 48), np.float32)] * 6, INTR),
        lambda: run_cli(_argv(frame_dir)[:-2], capsys),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
