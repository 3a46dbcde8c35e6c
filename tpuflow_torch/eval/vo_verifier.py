"""VO trajectory verification: synthetic sequences with analytic pose
ground truth, ATE/RPE scoring, and the committed-baseline regression gate.

The port of ``tpuflow.eval.vo_verifier``: a textured fronto-parallel
plane at depth ``PLANE_DEPTH`` rendered under a known SE(3) trajectory
through the planar homography ``H = K (R + t n^T / d) K^-1`` and scored
against the truth. ``strafe_x``, ``dolly_z`` and ``arc_yaw`` run the
incremental session (``vo.pipeline.run_odometry``); ``square_loop`` runs
the chunked pose-graph pipeline with loop closure, and ``swing_imu`` the
chunked pipeline with exact synthetic IMU and the tight visual-inertial
refinement, scored metric (``SEQUENCE_MODES``). It imports neither JAX nor
``tpuflow``: the base texture comes from the suite fixture
(``patterns.load_base_texture``) and the committed baselines are read as
files.

The run goes to the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``). Baselines record the backend in
the JAX package's names (``cuda`` -> ``pallas``, ``torch`` -> ``jnp``) and
the platform (``gpu``, ``cpu``; the reference's are ``tpu`` and ``cpu``).
A run on another platform than its baseline's is compared under the
reference's cross-platform rule (``CROSS_PLATFORM_THRESHOLD`` with
``CROSS_METRIC_FLOORS``); the card's own baseline
(``data/vo_cuda_baseline.json``) holds ``backend="cuda"`` to 10% with the
1e-4 dust floor. The absolute bounds are the primary gate either way.

CLI:
    python -m tpuflow_torch.eval.vo_verifier --backend cuda --compare-baseline
    python -m tpuflow_torch.eval.vo_verifier --device cpu --compare-baseline
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.eval import patterns as patterns_mod
from tpuflow_torch.eval.vo_metrics import trajectory_metrics
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.vo.pipeline import run_odometry, run_odometry_chunked

BASELINE_DIR = Path(__file__).resolve().parents[2] / "tpuflow" / "eval" / "data"
VO_BASELINE = BASELINE_DIR / "vo_baseline.json"
VO_PALLAS_BASELINE = BASELINE_DIR / "vo_pallas_baseline.json"
VO_CUDA_BASELINE = Path(__file__).resolve().parent / "data" / "vo_cuda_baseline.json"
# The committed baseline each backend is compared with by default.
DEFAULT_BASELINES = {"torch": VO_BASELINE, "cuda": VO_CUDA_BASELINE}
# This package's backend -> the JAX package's name for the same path.
BASELINE_BACKEND = {"cuda": "pallas", "torch": "jnp"}

WIDTH, HEIGHT = 320, 240
FX = FY = 300.0
PLANE_DEPTH = 5.0
N_FRAMES = 8
GATED_METRICS = ("ate_rmse", "rpe_trans", "rpe_rot_deg")


def _yaw(angle_rad: float) -> np.ndarray:
    """Rotation about the camera y axis (pan)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _pose_from_center(r_wc: np.ndarray, center) -> Tuple[np.ndarray, np.ndarray]:
    """world->camera (R, t) for a camera at ``center`` with cam->world
    rotation ``r_wc``: R = r_wc^T, t = -R c."""
    r = r_wc.T
    return r, -(r @ np.asarray(center, np.float64))


def _poses(centers, rotations) -> Tuple[np.ndarray, np.ndarray]:
    rs, ts = zip(*(_pose_from_center(r, c) for r, c in zip(rotations, centers)))
    return np.stack(rs), np.stack(ts)


# Motions sized for ~1-2 px/frame image flow at fx=300, depth 5.
def _poses_strafe(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pure lateral translation: +0.02 world units/frame along x."""
    return _poses([[0.02 * i, 0.0, 0.0] for i in range(n)], [np.eye(3)] * n)


def _poses_dolly(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward translation toward the plane: +0.02/frame along z."""
    return _poses([[0.0, 0.0, 0.02 * i] for i in range(n)], [np.eye(3)] * n)


def _poses_arc(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Lateral translation plus 0.15 deg/frame yaw."""
    return _poses(
        [[0.015 * i, 0.0, 0.0] for i in range(n)],
        [_yaw(np.radians(0.15) * i) for i in range(n)],
    )


def _poses_square(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """A closed square loop over the plane, 4 sides of (n - 1) // 4 steps
    of 0.018, back to the start: the last frames revisit the first pose."""
    side = max((n - 1) // 4, 1)
    c = np.zeros(3)
    centers = [c.copy()]
    for d in ([0.018, 0, 0], [0, 0.018, 0], [-0.018, 0, 0], [0, -0.018, 0]):
        for _ in range(side):
            c = c + np.asarray(d, np.float64)
            centers.append(c.copy())
    return _poses(centers, [np.eye(3)] * len(centers))


# The visual-inertial sequence: steady lateral drift plus a sinusoidal
# swing. The swing gives the accelerometer the acceleration that scale and
# gravity need; the drift keeps the velocity positive (pure oscillation is
# a vision bundle-adjustment degeneracy on the planar scene). Closed forms
# shared by the poses and the IMU samples.
SWING_AMP, SWING_HZ, SWING_DRIFT, SWING_FRAME_RATE = 0.03, 0.5, 0.1, 4.0
GRAVITY_W = np.array([0.0, 0.0, -9.81])


def _swing_x(t: np.ndarray):
    om = 2 * np.pi * SWING_HZ
    return SWING_DRIFT * t + SWING_AMP * np.sin(om * t)


def _poses_swing(n: int) -> Tuple[np.ndarray, np.ndarray]:
    return _poses([[_swing_x(i / SWING_FRAME_RATE), 0.0, 0.0] for i in range(n)],
                  [np.eye(3)] * n)


def _imu_swing(n: int, rate_hz: float = 200.0):
    """Exact IMU for the swing: zero gyro, specific force f = a_world - g
    in the world-aligned body frame. Returns (times, gyro, accel,
    frame_times)."""
    om = 2 * np.pi * SWING_HZ
    t_end = (n - 1) / SWING_FRAME_RATE
    m = int(t_end * rate_hz) + 1
    ts = np.arange(m) / rate_hz
    ax = -SWING_AMP * om * om * np.sin(om * ts)
    accel = np.stack([ax, np.zeros(m), np.full(m, -GRAVITY_W[2])], 1).astype(np.float32)
    gyro = np.zeros((m, 3), np.float32)
    frame_times = np.arange(n) / SWING_FRAME_RATE
    return ts, gyro, accel, frame_times


SEQUENCES = {
    "strafe_x": _poses_strafe,
    "dolly_z": _poses_dolly,
    "arc_yaw": _poses_arc,
    "square_loop": _poses_square,
    "swing_imu": _poses_swing,
}
# The pipeline each sequence runs, where it is not the incremental
# session: the square loop runs the chunked pose-graph pipeline with loop
# closure (the revisit is the point); swing_imu the chunked pipeline with
# exact IMU and the tight VI refinement, scored metric (SE(3) alignment
# only, so a scale error shows in ATE). swing_imu's ATE is limited by the
# vision on the planar scene, not by the IMU.
SEQUENCE_MODES = {
    "square_loop": "chunked_loop",
    "swing_imu": "chunked_imu_tight",
}
# Fixed lengths where the geometry sets one (four full sides; full swing
# periods); ``n_frames`` applies to the rest.
SEQUENCE_LENGTHS = {"square_loop": 17, "swing_imu": 16}


def intrinsics() -> Tuple[float, float, float, float]:
    return (FX, FY, WIDTH / 2.0, HEIGHT / 2.0)


def render_sequence(
    poses_r: np.ndarray,
    poses_t: np.ndarray,
    width: int = WIDTH,
    height: int = HEIGHT,
    depth: float = PLANE_DEPTH,
    *,
    base: np.ndarray | None = None,
    intr: Tuple[float, float, float, float] | None = None,
) -> List[np.ndarray]:
    """Each camera's view of the textured plane Z = ``depth``: the base
    texture inverse-warped by H_{0->i}^-1, bilinear, edge-replicated.
    ``base``: an (height, width) texture in place of the suite's 320x240
    one; ``intr``: (fx, fy, cx, cy) in place of ``intrinsics()``."""
    from scipy.ndimage import map_coordinates

    if base is None:
        base = patterns_mod.load_base_texture(width, height)
    base = np.asarray(base, np.float32)
    if base.shape != (height, width):
        raise ValueError(f"texture {base.shape} is not {(height, width)}")
    fx, fy, cx, cy = intr if intr is not None else intrinsics()
    k_mat = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    k_inv = np.linalg.inv(k_mat)
    n_vec = np.array([0.0, 0.0, 1.0])

    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    pix_h = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1)

    frames = []
    for r, t in zip(poses_r, poses_t):
        h_mat = k_mat @ (
            np.asarray(r, np.float64) + np.outer(np.asarray(t, np.float64), n_vec) / depth
        ) @ k_inv
        src = np.linalg.inv(h_mat) @ pix_h
        src = src[:2] / src[2:3]
        frame = map_coordinates(
            base,
            [src[1].reshape(height, width), src[0].reshape(height, width)],
            order=1,
            mode="nearest",
        )
        frames.append(frame.astype(np.float32))
    return frames


# ---------------------------------------------------------------------------
# Verification + baseline regression
# ---------------------------------------------------------------------------


def _check_names(names: List[str]) -> None:
    unknown = [n for n in names if n not in SEQUENCES]
    if unknown:
        raise SystemExit(
            f"Unknown sequence(s): {', '.join(unknown)}. "
            f"Available: {', '.join(SEQUENCES)}"
        )


def verify_sequence(
    name: str,
    n_frames: int = N_FRAMES,
    backend: str = "torch",
    ba_iterations: int = 10,
    verbose: bool = True,
    pyramid_config: str = "default",
    device: torch.device | str | None = None,
) -> Dict[str, Any]:
    """Render one sequence, run its VO pipeline (``SEQUENCE_MODES``), score
    ATE/RPE."""
    _check_names([name])
    n_frames = SEQUENCE_LENGTHS.get(name, n_frames)
    gt_r, gt_t = SEQUENCES[name](n_frames)
    frames = render_sequence(gt_r, gt_t)
    n_frames = len(frames)  # what was rendered
    kw = dict(init_depth=PLANE_DEPTH, ba_iterations=ba_iterations, backend=backend,
              pyramid_config=pyramid_config, device=device)
    mode = SEQUENCE_MODES.get(name)
    if mode == "chunked_loop":
        result = run_odometry_chunked(frames, intrinsics(), chunk_size=6, loop_closure=True,
                                      **kw)
    elif mode == "chunked_imu_tight":
        imu_t, imu_gyro, imu_accel, frame_times = _imu_swing(n_frames)
        result = run_odometry_chunked(
            frames, intrinsics(), chunk_size=6, imu=(imu_t, imu_gyro, imu_accel),
            frame_times=frame_times, imu_tight=True, **kw,
        )
    else:
        result = run_odometry(frames, intrinsics(), **kw)
    # Keyframe stride 1: keyframe poses line up with the truth's frames.
    # Metric (VI-refined) trajectories are scored with SE(3) alignment
    # only: the recovered scale is part of what is graded.
    kf = result.keyframe_indices
    metrics = trajectory_metrics(result.poses_r, result.poses_t, gt_r[kf], gt_t[kf],
                                 with_scale=not result.metric_poses)
    metrics["mean_reprojection_error"] = float(result.mean_reprojection_error)
    metrics["metric_poses"] = bool(result.metric_poses)
    if verbose:
        print(
            f"{name:12s} ate_rmse={metrics['ate_rmse']:.5f} "
            f"rpe_trans={metrics['rpe_trans']:.5f} "
            f"rpe_rot={metrics['rpe_rot_deg']:.4f}deg "
            f"scale={metrics['scale']:.3f} "
            f"reproj={metrics['mean_reprojection_error']:.3f}px "
            f"tracks={result.track_count}"
        )
    return {
        "sequence": name,
        "n_frames": n_frames,
        "metrics": metrics,
        "track_count": int(result.track_count),
    }


def run_suite(
    sequence_names: Optional[List[str]] = None,
    backend: str = "torch",
    verbose: bool = True,
    n_frames: int = N_FRAMES,
    ba_iterations: int = 10,
    pyramid_config: str = "default",
    device: torch.device | str | None = None,
) -> List[Dict[str, Any]]:
    """Every sequence (or those named) on ``device``: the card unless the
    caller names another; raises without a card."""
    names = sequence_names or list(SEQUENCES)
    _check_names(names)
    dev = resolve_device(device)
    return [
        verify_sequence(
            n, n_frames=n_frames, backend=backend, ba_iterations=ba_iterations,
            verbose=verbose, pyramid_config=pyramid_config, device=dev,
        )
        for n in names
    ]


# Cross-host spread of the CPU (parity) suite: per-metric spreads up to
# +-50% relative between x86 hosts while every absolute score stayed
# excellent (the reference's measurement), so the CPU gate uses this as a
# breakage detector and the absolute bounds as the accuracy ruler.
CPU_CROSS_HOST_THRESHOLD = 60.0

# Absolute trajectory-accuracy bounds: the platform-independent primary
# gate (every sequence spans >= ~0.1 world units).
ABS_ATE_BOUNDS = {"square_loop": 0.05, "swing_imu": 0.12}
ABS_ATE_DEFAULT = 0.03
ABS_RPE_ROT_DEG = 1.0
MIN_TRACK_COUNT = 100

# Relative threshold between platforms (the reference measured 0.1-2.3%
# between its TPU and CPU runs of the incremental sequences with the
# solvers pinned to full f32, up to ~35% on the chunked ones).
CROSS_PLATFORM_THRESHOLD = 60.0

# Per-metric absolute floors for a comparison across hosts or platforms: a
# change flags only if it exceeds the floor absolutely and the threshold
# relatively.
CROSS_METRIC_FLOORS = {
    "ate_rmse": 0.005,
    "rpe_trans": 0.005,
    "rpe_rot_deg": 0.25,
}


def default_threshold(
    backend: str, platform: str, baseline_path: Path = VO_BASELINE
) -> tuple[float, dict | float]:
    """(threshold, abs_floor) for (backend, this run's platform, baseline).

    - Another platform than the baseline's: CROSS_PLATFORM_THRESHOLD with
      the metric floors. (The reference gives its fast path 10% on any
      platform, since Pallas runs only on its TPU; the card's ``cuda`` run
      against that TPU baseline is a cross-platform comparison.)
    - ``cuda`` on the baseline's platform: 10% with the 1e-4 dust floor
      (the card repeats its bits).
    - ``torch`` on the baseline's platform: CPU_CROSS_HOST_THRESHOLD with
      the metric floors.
    """
    base_platform = None
    if baseline_path.exists():
        try:
            base_platform = json.loads(baseline_path.read_text()).get("platform")
        except (OSError, json.JSONDecodeError):
            pass
    if base_platform is not None and base_platform != platform:
        return CROSS_PLATFORM_THRESHOLD, CROSS_METRIC_FLOORS
    if backend == "cuda":
        return 10.0, 1e-4
    return CPU_CROSS_HOST_THRESHOLD, CROSS_METRIC_FLOORS


def check_absolute_bounds(results: List[Dict[str, Any]], verbose: bool = True) -> bool:
    """Primary accuracy gate: platform-independent absolute bounds."""
    ok = True
    for r in results:
        name = r["sequence"]
        m = r["metrics"]
        bound = ABS_ATE_BOUNDS.get(name, ABS_ATE_DEFAULT)
        if not m["ate_rmse"] < bound:
            ok = False
            print(f"  ABSOLUTE BOUND {name}: ate_rmse {m['ate_rmse']:.5f} >= {bound}")
        if not m["rpe_rot_deg"] < ABS_RPE_ROT_DEG:
            ok = False
            print(
                f"  ABSOLUTE BOUND {name}: rpe_rot {m['rpe_rot_deg']:.4f} "
                f">= {ABS_RPE_ROT_DEG} deg"
            )
        if not r["track_count"] > MIN_TRACK_COUNT:
            ok = False
            print(f"  ABSOLUTE BOUND {name}: track_count {r['track_count']} <= {MIN_TRACK_COUNT}")
    if verbose:
        print(
            "VO absolute-bounds check: "
            + ("all sequences within bounds" if ok else "FAILURES detected")
        )
    return ok


def compare_against_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path = VO_BASELINE,
    threshold_percent: float = 10.0,
    abs_floor: float | Dict[str, float] = 1e-4,
    verbose: bool = True,
    backend: str | None = None,
    pyramid_config: str | None = None,
    platform: str | None = None,
) -> bool:
    """True = no regressions: each gated metric within
    ``threshold_percent`` of the baseline, or within ``abs_floor`` of it
    absolutely. A baseline of another backend (``cuda`` matches
    ``pallas``, ``torch`` matches ``jnp``) or pyramid config fails
    outright; another platform is noted."""
    if not baseline_path.exists():
        print(f"No VO baseline at {baseline_path}; skipping regression check.")
        return True
    doc = json.loads(baseline_path.read_text())
    base_backend = doc.get("backend")
    run_backend = BASELINE_BACKEND.get(backend, backend) if backend is not None else None
    if run_backend is not None and base_backend is not None and run_backend != base_backend:
        print(
            f"PROVENANCE MISMATCH: VO baseline captured with backend="
            f"{base_backend!r} but this run uses backend={backend!r} ({run_backend!r})."
        )
        return False
    base_platform = doc.get("platform")
    if platform is not None and base_platform is not None and platform != base_platform:
        print(
            f"PROVENANCE NOTE: VO baseline captured on platform={base_platform!r}; "
            f"this run executes on {platform!r}. Relative comparison is "
            f"cross-platform (see CROSS_PLATFORM_THRESHOLD); absolute bounds are "
            f"the primary gate."
        )
    base_cfg = doc.get("pyramid_config", "default")
    if pyramid_config is not None and pyramid_config != base_cfg:
        print(
            f"PROVENANCE MISMATCH: VO baseline captured with pyramid_config="
            f"{base_cfg!r} but this run uses pyramid_config={pyramid_config!r}."
        )
        return False
    baseline = doc.get("sequences", {})
    all_passed = True
    for result in results:
        name = result["sequence"]
        if name not in baseline:
            if verbose:
                print(f"  {name}: not in baseline (skipping)")
            continue
        base_mp = baseline[name]["metrics"].get("metric_poses")
        curr_mp = result["metrics"].get("metric_poses")
        if base_mp is not None and curr_mp is not None and base_mp != curr_mp:
            all_passed = False
            print(
                f"  REGRESSION {name}: metric_poses changed {base_mp} -> {curr_mp} "
                f"(scoring regime switch)"
            )
            continue
        for metric in GATED_METRICS:
            curr = result["metrics"][metric]
            base = baseline[name]["metrics"][metric]
            floor = abs_floor.get(metric, 1e-4) if isinstance(abs_floor, dict) else abs_floor
            if abs(curr - base) <= floor:
                continue
            if base <= floor:
                all_passed = False
                print(f"  REGRESSION {name}: {metric} {curr:.5f} (baseline ~0)")
                continue
            change = 100.0 * (curr - base) / base
            if abs(change) > threshold_percent:
                all_passed = False
                print(
                    f"  REGRESSION {name}: {metric} {change:+.1f}% "
                    f"(current={curr:.5f}, baseline={base:.5f})"
                )
    if verbose:
        print(
            "VO regression check: "
            + ("all sequences within threshold" if all_passed else "FAILURES detected")
        )
    return all_passed


def update_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path = VO_BASELINE,
    backend: str | None = None,
    pyramid_config: str | None = None,
    platform: str | None = None,
    device_name: str | None = None,
) -> None:
    """Write the baseline, with the backend in the JAX package's names, the
    platform and, on a card, its name. Where the file holds a baseline of
    the same backend, config and platform, its sequences that this run did
    not cover stay as they are, entry for entry; otherwise it is
    replaced."""
    data: Dict[str, Any] = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "sequences": {r["sequence"]: r for r in results},
    }
    if backend is not None:
        data["backend"] = BASELINE_BACKEND.get(backend, backend)
    if pyramid_config is not None:
        data["pyramid_config"] = pyramid_config
    if platform is not None:
        data["platform"] = platform
    if device_name is not None:
        data["device"] = device_name
    if baseline_path.exists():
        old = json.loads(baseline_path.read_text())
        if all(old.get(key) == data.get(key) for key in ("backend", "pyramid_config", "platform")):
            data["sequences"] = {**old.get("sequences", {}), **data["sequences"]}
    baseline_path.parent.mkdir(parents=True, exist_ok=True)
    baseline_path.write_text(json.dumps(data, indent=2))
    print(f"VO baseline updated: {baseline_path}")


def gate(
    results: List[Dict[str, Any]],
    baseline_path: Path,
    backend: str,
    platform: str,
    pyramid_config: str = "default",
    threshold: float | None = None,
) -> bool:
    """The absolute bounds and the baseline comparison under
    ``default_threshold`` (or ``threshold`` with the dust floor)."""
    bounds_ok = check_absolute_bounds(results)
    if threshold is None:
        threshold, floor = default_threshold(backend, platform, baseline_path)
    else:
        floor = 1e-4
    ok = compare_against_baseline(
        results, baseline_path, threshold, abs_floor=floor, backend=backend,
        pyramid_config=pyramid_config, platform=platform,
    )
    return ok and bounds_ok


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Verify tpuflow_torch VO trajectory accuracy (ATE/RPE) on synthetic "
        "sequences with analytic pose ground truth"
    )
    parser.add_argument("--sequence", type=str, nargs="+", default=None)
    parser.add_argument("--backend", type=str, default="torch", choices=["torch", "cuda"])
    parser.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="where the pipeline runs: the card (default; fails without one) or the CPU",
    )
    parser.add_argument("--frames", type=int, default=N_FRAMES)
    parser.add_argument("--ba-iterations", type=int, default=10)
    parser.add_argument("--compare-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument(
        "--regression-threshold", type=float, default=None,
        help="percent gate against the baseline, with the 1e-4 dust floor; default "
        "from default_threshold (10 for cuda on the baseline's platform, else 60 with "
        "per-metric floors). The absolute bounds are enforced regardless.",
    )
    parser.add_argument(
        "--baseline", type=str, default=None,
        help="baseline JSON; default tpuflow_torch/eval/data/vo_cuda_baseline.json for "
        "--backend cuda, tpuflow/eval/data/vo_baseline.json for torch",
    )
    parser.add_argument("--pyramid-config", type=str, default="default")
    args = parser.parse_args(argv)

    results = run_suite(
        args.sequence, backend=args.backend, n_frames=args.frames,
        ba_iterations=args.ba_iterations, pyramid_config=args.pyramid_config,
        device=args.device,
    )
    platform = "gpu" if args.device == "cuda" else "cpu"
    baseline = Path(args.baseline) if args.baseline else DEFAULT_BASELINES[args.backend]
    if args.update_baseline:
        update_baseline(
            results, baseline, backend=args.backend, pyramid_config=args.pyramid_config,
            platform=platform,
            device_name=torch.cuda.get_device_name(0) if platform == "gpu" else None,
        )
    if args.compare_baseline and not gate(
        results, baseline, args.backend, platform, args.pyramid_config,
        args.regression_threshold,
    ):
        print("\nVO regression detected! Review changes before committing.")
        sys.exit(1)


if __name__ == "__main__":
    main()
