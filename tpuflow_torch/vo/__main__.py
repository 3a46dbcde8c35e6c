"""Visual-odometry CLI: frames in, trajectory out.

The port of ``python -m tpuflow.vo``. Reads the flow CLI's frame formats
(``.bin``, ``$readmemh`` ``.mem``, ``.png``) or a video file, runs the
incremental ``OdometrySession`` (optionally with bounded-memory
``compact`` and checkpoint/resume) or the chunked local-BA plus global
pose-graph pipeline (optionally with loop closure and IMU), and exports the
poses in the KITTI odometry format (12 floats a line: the 3x4
camera-to-world matrix, row-major).

    python -m tpuflow_torch.vo FRAME_DIR --intrinsics 150 150 160 120 \
        [--chunked --loop-closure] [--compact-window 8] \
        [--export-poses poses.txt] [--plot traj.png] \
        [--checkpoint DIR | --resume DIR] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and fails without
one. Pillow (``.png`` frames), matplotlib (``--plot``) and OpenCV (video)
are imported only where a flag or an input needs them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _need(module: str, what: str):
    """Import an optional module, or exit with a clear error."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError:
        print(f"error: {what} needs {module.split('.')[0]}, which is not installed",
              file=sys.stderr)
        sys.exit(1)


def _iter_frames(args):
    """Yield grayscale float32 frames lazily: with --compact-window the
    session state is bounded, so ingestion has to be too."""
    from tpuflow_torch.io import frames as fio

    d = Path(args.frame_dir)
    if d.is_file():
        from tpuflow_torch.io.video import VideoFrameStream

        yield from VideoFrameStream(str(d), max_frames=args.max_frames)
        return
    paths = sorted(d.glob(args.glob))
    if len(paths) < 2:
        print(f"error: need >=2 frames matching {args.glob} in {d}", file=sys.stderr)
        sys.exit(1)
    for p in paths:
        if p.suffix == ".png":
            image = _need("PIL.Image", "reading .png frames")
            yield np.asarray(image.open(p).convert("L"), np.float32)
        elif p.suffix == ".mem":
            yield fio.load_frame_mem(p, args.width, args.height)
        else:
            yield fio.load_frame_bin(p, args.width, args.height)


def _chain_first(first: np.ndarray, rest):
    yield first
    yield from rest


def _export_kitti(path: str, poses_r: np.ndarray, poses_t: np.ndarray) -> None:
    """Camera-to-world 3x4 a line (KITTI odometry). The poses are
    world-to-camera (x_cam = R x_world + t), so they are inverted."""
    with open(path, "w") as f:
        for r, t in zip(poses_r, poses_t):
            m = np.concatenate([r.T, (-r.T @ t)[:, None]], axis=1)
            f.write(" ".join(f"{x:.9e}" for x in m.ravel()) + "\n")


def _plot_trajectory(path: str, positions: np.ndarray) -> None:
    matplotlib = _need("matplotlib", "--plot")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(positions[:, 0], positions[:, 2], "b.-", markersize=3)
    ax.plot(positions[0, 0], positions[0, 2], "go", label="start")
    ax.plot(positions[-1, 0], positions[-1, 2], "rs", label="end")
    ax.set_xlabel("x (arbitrary monocular scale)")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.set_title("tpuflow_torch VO trajectory (top-down)")
    ax.legend()
    plt.tight_layout()
    plt.savefig(path, dpi=120)
    plt.close(fig)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="tpuflow_torch visual odometry: frame sequence -> "
        "bundle-adjusted keyframe trajectory"
    )
    parser.add_argument("frame_dir", type=str,
                        help="frame directory, or a video file (mp4/avi/...)")
    parser.add_argument("--glob", type=str, default="frame_*.bin")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="cap on frames ingested from a video file")
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--intrinsics", type=float, nargs=4,
                        metavar=("FX", "FY", "CX", "CY"), default=None,
                        help="pinhole intrinsics; default fx=fy=width/2, "
                        "principal point at the image center")
    parser.add_argument("--keyframe-stride", type=int, default=1)
    parser.add_argument("--grid-step", type=int, default=16)
    parser.add_argument("--init-depth", type=float, default=5.0)
    parser.add_argument("--ba-iterations", type=int, default=8)
    parser.add_argument("--backend", type=str, default="torch", choices=["torch", "cuda"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the pipeline runs: the card (default; fails "
                        "without one) or the CPU")
    parser.add_argument("--pyramid-config", type=str, default="default",
                        help="named flow config for the front end (see "
                        "tpuflow_torch.core.config.PYRAMID_CONFIGS)")
    parser.add_argument("--fb-check", type=float, default=None, metavar="PX",
                        help="forward-backward flow consistency culling threshold in "
                        "px (e.g. 1.0); also enables tracking-loss detection")
    parser.add_argument("--essential-init", action="store_true",
                        help="bootstrap poses from the 8-point essential matrix "
                        "instead of identity and the depth prior")
    parser.add_argument("--chunked", action="store_true",
                        help="local-BA chunks + global pose-graph fusion (bounded "
                        "problem size; enables --loop-closure)")
    parser.add_argument("--chunk-size", type=int, default=6)
    parser.add_argument("--loop-closure", action="store_true")
    parser.add_argument("--motion-prior", type=float, default=0.0, metavar="W",
                        help="chunked mode: constant-velocity prior weight (0 = off; "
                        "odometry edges weigh 1.0)")
    parser.add_argument("--imu", type=str, default=None, metavar="FILE",
                        help="IMU samples (t wx wy wz ax ay az text, "
                        "tpuflow_torch.io.imu): gyro rotation edges in the pose "
                        "graph (--chunked only; needs --frame-rate)")
    parser.add_argument("--frame-rate", type=float, default=None,
                        help="frame rate in Hz, mapping frame indices to the IMU "
                        "time axis (frame i at t = i / rate)")
    parser.add_argument("--imu-weight", type=float, default=2.0,
                        help="information scale of the gyro rotation edges relative "
                        "to odometry edges (1.0)")
    parser.add_argument("--imu-tight", action="store_true",
                        help="tightly coupled VI refinement after the pose-graph "
                        "solve: poses become METRIC when the IMU covers every "
                        "keyframe interval and gravity recovers physically")
    parser.add_argument("--compact-window", type=int, default=None, metavar="K",
                        help="incremental mode: marginalize to the last K keyframes "
                        "whenever the window exceeds 2K")
    parser.add_argument("--checkpoint", type=str, default=None, metavar="DIR",
                        help="save the session after the run")
    parser.add_argument("--resume", type=str, default=None, metavar="DIR",
                        help="resume a checkpointed session before processing "
                        "the frames")
    parser.add_argument("--export-poses", type=str, default=None,
                        help="KITTI-format 3x4 pose per keyframe")
    parser.add_argument("--plot", type=str, default=None, help="top-down trajectory PNG")
    args = parser.parse_args(argv)

    # Mode and flag validation: a flag the mode would ignore is an error.
    if args.resume:
        # The session's settings come from the checkpoint on resume.
        overridden = [name for name, val, default in (
            ("--fb-check", args.fb_check, None),
            ("--backend", args.backend, parser.get_default("backend")),
            ("--keyframe-stride", args.keyframe_stride,
             parser.get_default("keyframe_stride")),
            ("--grid-step", args.grid_step, parser.get_default("grid_step")),
            ("--init-depth", args.init_depth, parser.get_default("init_depth")),
            ("--pyramid-config", args.pyramid_config,
             parser.get_default("pyramid_config")),
        ) if val != default]
        if overridden:
            print(f"error: {', '.join(overridden)} cannot change on --resume (the "
                  "checkpointed session's settings apply; start a new session to "
                  "change them)", file=sys.stderr)
            sys.exit(2)
    if not args.imu:
        bad = [name for name, val in (
            ("--frame-rate", args.frame_rate),
            ("--imu-weight", args.imu_weight != parser.get_default("imu_weight") or None),
            ("--imu-tight", args.imu_tight or None),
        ) if val]
        if bad:
            print(f"error: {', '.join(bad)} require(s) --imu", file=sys.stderr)
            sys.exit(2)
    if args.chunked:
        bad = [name for name, val in (
            ("--checkpoint", args.checkpoint),
            ("--resume", args.resume),
            ("--compact-window", args.compact_window),
            ("--essential-init", args.essential_init or None),
        ) if val]
        if bad:
            print(f"error: {', '.join(bad)} only apply to the incremental (non "
                  "--chunked) mode", file=sys.stderr)
            sys.exit(2)
    else:
        bad = [name for name, val in (
            ("--motion-prior", args.motion_prior),
            ("--imu", args.imu),
            ("--loop-closure", args.loop_closure),
            ("--chunk-size", args.chunk_size != parser.get_default("chunk_size") or None),
        ) if val]
        if bad:
            print(f"error: {', '.join(bad)} require(s) --chunked (they configure the "
                  "pose-graph chunk pipeline; incremental mode has none)", file=sys.stderr)
            sys.exit(2)

    if args.plot:
        _need("matplotlib", "--plot")  # before the run, not after it
    frame_iter = iter(_iter_frames(args))
    try:
        first = next(frame_iter)
    except StopIteration:
        print(f"error: no frames in {args.frame_dir}", file=sys.stderr)
        sys.exit(1)
    h, w = first.shape
    intr = tuple(args.intrinsics) if args.intrinsics else (w / 2.0, w / 2.0, w / 2.0, h / 2.0)
    print(f"size: {w}x{h}  intrinsics: {intr}")

    if args.chunked:
        from tpuflow_torch.vo.pipeline import run_odometry_chunked

        # Random access across overlapping chunks: the clip is held in
        # memory (bound it with --max-frames).
        frames = [first] + list(frame_iter)
        if len(frames) < 2:
            print("error: need >= 2 frames", file=sys.stderr)
            sys.exit(1)
        print(f"frames: {len(frames)}")
        imu_data = None
        frame_times = None
        if args.imu:
            if args.frame_rate is None:
                print("error: --imu requires --frame-rate (to place frames on the "
                      "IMU time axis)", file=sys.stderr)
                sys.exit(2)
            from tpuflow_torch.io.imu import load_imu

            imu_data = load_imu(args.imu)
            frame_times = np.arange(len(frames)) / args.frame_rate
            print(f"imu: {len(imu_data[0])} samples, gyro rotation edges at weight "
                  f"{args.imu_weight}")
        res = run_odometry_chunked(
            frames, intr, chunk_size=args.chunk_size,
            grid_step=args.grid_step, init_depth=args.init_depth,
            ba_iterations=args.ba_iterations, backend=args.backend,
            loop_closure=args.loop_closure,
            motion_prior_weight=args.motion_prior,
            fb_check_threshold=args.fb_check,
            pyramid_config=args.pyramid_config,
            imu=imu_data, frame_times=frame_times,
            imu_weight=args.imu_weight, imu_tight=args.imu_tight,
            device=args.device,
        )
    else:
        from tpuflow_torch.vo import checkpoint
        from tpuflow_torch.vo.pipeline import OdometrySession

        if args.resume:
            sess = checkpoint.load(args.resume, device=args.device)
            print(f"resumed session at frame {sess.frame_index} "
                  f"({len(sess.keyframes)} window keyframes)")
        else:
            sess = OdometrySession(
                intr, keyframe_stride=args.keyframe_stride,
                grid_step=args.grid_step, init_depth=args.init_depth,
                backend=args.backend, fb_check_threshold=args.fb_check,
                pyramid_config=args.pyramid_config, device=args.device,
            )
        n = 0
        for f in _chain_first(first, frame_iter):
            sess.process_frame(f)
            n += 1
            if args.compact_window and len(sess.keyframes) > 2 * args.compact_window:
                sess.compact(keep_last=args.compact_window, ba_iterations=args.ba_iterations)
        print(f"frames: {n}")
        res = sess.solve(ba_iterations=args.ba_iterations, essential_init=args.essential_init)
        if args.checkpoint:
            checkpoint.save(sess, args.checkpoint)
            print(f"session checkpoint -> {args.checkpoint}")

    if res.metric_scale is not None:
        if res.metric_poses:
            print("poses are METRIC (tight VI refinement; applied vision-to-metric "
                  f"scale {res.metric_scale:.4f})")
        else:
            print(f"metric scale (VI alignment): {res.metric_scale:.4f} world units per "
                  "VO unit")
    if res.track_loss_frames:
        print(
            f"WARNING: tracking lost at frame(s) {res.track_loss_frames} (occlusion / "
            "violent motion) — trajectory segments across each loss are re-anchored "
            "and NOT metrically connected",
            file=sys.stderr,
        )
    poses_r = np.asarray(res.poses_r)
    poses_t = np.asarray(res.poses_t)
    positions = np.stack([-r.T @ t for r, t in zip(poses_r, poses_t)])
    dists = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    print(f"keyframes: {len(res.keyframe_indices)}  "
          f"mean reprojection error: {res.mean_reprojection_error:.3f} px")
    print(f"path length: {dists.sum():.3f}  net displacement: "
          f"{np.linalg.norm(positions[-1] - positions[0]):.3f} (monocular scale)")

    if args.export_poses:
        _export_kitti(args.export_poses, poses_r, poses_t)
        print(f"poses (KITTI 3x4) -> {args.export_poses}")
    if args.plot:
        _plot_trajectory(args.plot, positions)
        print(f"trajectory plot -> {args.plot}")


if __name__ == "__main__":
    main()
