"""Frame-pair and frame-stream flow CLI: ``python -m tpuflow_torch.flow``.

The port of ``python -m tpuflow.flow``, flag for flag, with
``--backend torch|cuda|rtl`` (the JAX package's ``jnp|pallas|rtl``) and
``--device``:

    python -m tpuflow_torch.flow FRAME_DIR [--pyramidal [--pyramid-config NAME]]
        [--backend torch|cuda|rtl] [--device cuda|cpu] [--width W --height H]
        [--region x0 x1 y0 y1] [--export flow.txt] [--plot flow.png]
        [--per-level-plots DIR] [--compare other.txt]
    python -m tpuflow_torch.flow FRAME_DIR --sequence [--glob 'frame_*.bin'] ...
    python -m tpuflow_torch.flow VIDEO_FILE ...

Pair mode loads ``frame_00``/``frame_01`` (``.bin``, or ``.mem`` with
``--mem``), runs single scale (``cuda``: K6), pyramidal (``cuda``: K1-K5 by
config) or the S8.7 integer datapath (``rtl``, single-scale pairs only),
and prints mean/std statistics over the test region. Sequence mode streams
every frame through ``io.stream.FrameStream`` -> ``device_pairs`` ->
:func:`stream_flow` (the pyramid carried from frame to frame) and prints
the throughput, first pair excluded, and the mean flow magnitude from one
read at the end of the stream.

The flow runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run); with no card the run fails. ``--plot`` and
``--per-level-plots`` need matplotlib, video input OpenCV.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal, lucas_kanade_pyramidal_step
from tpuflow_torch.flow.single_scale import lucas_kanade_single_scale
from tpuflow_torch.io import frames as fio
from tpuflow_torch.io.stream import FrameStream, device_pairs
from tpuflow_torch.kernels import fixed_point, torch_ref


def region_stats(u: np.ndarray, v: np.ndarray, region) -> dict:
    """Mean/std statistics over the test region (x0, x1, y0, y1)."""
    x0, x1, y0, y1 = region
    ru = u[y0:y1, x0:x1]
    rv = v[y0:y1, x0:x1]
    mag = np.sqrt(ru**2 + rv**2)
    return {
        "mean_u": float(ru.mean()),
        "mean_v": float(rv.mean()),
        "std_u": float(ru.std()),
        "std_v": float(rv.std()),
        "mean_magnitude": float(mag.mean()),
        "nonzero_fraction": float((mag > 1e-6).mean()),
    }


def stream_flow(
    frames: Iterable,
    cfg: PyramidConfig | None = None,
    backend: str = "torch",
    device: torch.device | str | None = None,
    window_size: int = 5,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Yield each consecutive pair's (u, v) on ``device`` (the card unless
    the caller names another). The frames are uploaded once each, two
    ahead (``io.stream.device_pairs``). With a pyramid
    ``cfg``, each frame's Gaussian pyramid is built once and carried to
    the next pair (``lucas_kanade_pyramidal_step``); without one, single
    scale at ``window_size``."""
    carry = None
    for prev, curr in device_pairs(frames, lookahead=2, device=device):
        if cfg is None:
            yield lucas_kanade_single_scale(prev, curr, window_size, backend=backend)
            continue
        if carry is None:
            carry = torch_ref.build_gaussian_pyramid(prev, cfg.levels, cfg.scale_factor)
        u, v, carry = lucas_kanade_pyramidal_step(carry, curr, cfg, backend=backend)
        yield u, v


def mean_magnitude(mags: list[torch.Tensor]) -> float:
    """The stream's mean flow magnitude from the pairs' device scalars, in
    one read."""
    return float(torch.stack(mags).sum()) / len(mags)


def _run_sequence(d: Path, args) -> None:
    """Stream a frame sequence (a directory of .bin frames, or a video)
    through the flow and report throughput."""
    if d.is_file():
        from tpuflow_torch.io.video import VideoFrameStream

        stream = VideoFrameStream(str(d))
        if stream.frame_count is not None and stream.frame_count < 2:
            print(f"error: {d} has fewer than 2 frames", file=sys.stderr)
            sys.exit(1)
        n_frames = stream.frame_count or "?"
        src = f"video {d.name}"
    else:
        paths = sorted(d.glob(args.glob))
        if len(paths) < 2:
            print(f"error: need >=2 frames matching {args.glob} in {d}", file=sys.stderr)
            sys.exit(1)
        stream = FrameStream(paths, width=args.width, height=args.height)
        n_frames = len(paths)
        src = f"{len(paths)} files"

    dev = resolve_device(args.device)
    cfg = PYRAMID_CONFIGS[args.pyramid_config] if args.pyramidal else None
    mode = f"pyramidal[{args.pyramid_config}]" if args.pyramidal else "single-scale"

    n = 0
    mags = []  # device scalars: no read a pair
    t0 = None
    for u, v in stream_flow(stream, cfg, args.backend, dev, args.window_size):
        if t0 is None:  # the first pair (kernel build, allocator) is not timed
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        mags.append(torch.sqrt(u * u + v * v).mean())
        n += 1
        if args.export:
            fio.save_flow_text(
                f"{args.export}.{n:04d}", u.cpu().numpy(), v.cpu().numpy(),
                header=f"pair {n} ({src})",
            )
    if n == 0:
        print(f"error: no frame pairs decoded from {d}", file=sys.stderr)
        sys.exit(1)
    mean_mag = mean_magnitude(mags)  # the one end-of-stream read
    dt = time.perf_counter() - t0
    done = max(n - 1, 1)
    print(f"mode: {mode}  backend: {args.backend}  device: {dev.type}  "
          f"frames: {n_frames} ({src})  pairs: {n}")
    print(f"throughput: {done / dt:.1f} pairs/s "
          f"({dt / done * 1e3:.2f} ms/pair, first pair excluded)")
    print(f"mean flow magnitude: {mean_mag:.3f} px")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m tpuflow_torch.flow",
        description="Dense Lucas-Kanade flow on a frame_00/01 pair",
    )
    parser.add_argument(
        "frame_dir",
        help="directory containing frame_00.bin and frame_01.bin "
        "(or .mem with --mem), or a video file (implies --sequence, "
        "decoded at native resolution)",
    )
    parser.add_argument("--mem", action="store_true",
                        help="load $readmemh .mem frames instead of .bin")
    parser.add_argument("--sequence", action="store_true",
                        help="stream ALL .bin frames in frame_dir (sorted) through the "
                        "flow via the prefetching FrameStream and report throughput")
    parser.add_argument("--glob", type=str, default="frame_*.bin",
                        help="frame filename pattern for --sequence")
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--pyramidal", action="store_true",
                        help="coarse-to-fine instead of single-scale")
    parser.add_argument("--pyramid-config", type=str, default="default",
                        help=f"named config ({', '.join(sorted(PYRAMID_CONFIGS))})")
    parser.add_argument("--window-size", type=int, default=5)
    parser.add_argument("--backend", type=str, default="torch",
                        choices=["torch", "cuda", "rtl"],
                        help="torch = parity float32; cuda = the hand-written kernels; "
                        "rtl = S8.7 integer datapath (single-scale pairs only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the flow is computed: the card (default; fails "
                        "without one) or the CPU, where the kernels' plain versions run")
    parser.add_argument("--region", type=int, nargs=4,
                        metavar=("X0", "X1", "Y0", "Y1"),
                        default=[55, 85, 105, 135],
                        help="stats region (reference test region default)")
    parser.add_argument("--export", type=str, default=None,
                        help="write x-y-u-v flow text dump here")
    parser.add_argument("--plot", type=str, default=None,
                        help="write a quiver plot PNG here (needs matplotlib)")
    parser.add_argument("--per-level-plots", type=str, default=None, metavar="DIR",
                        help="with --pyramidal: write per-pyramid-level U/V/magnitude "
                        "snapshots into DIR (needs matplotlib)")
    parser.add_argument("--compare", type=str, default=None,
                        help="x-y-u-v dump to diff against")
    args = parser.parse_args(argv)

    d = Path(args.frame_dir)
    if args.backend == "rtl" and (args.pyramidal or args.sequence or d.is_file()):
        print("error: --backend rtl is single-scale frame-pair only (the reference "
              "RTL's integer datapath; video input implies --sequence)",
              file=sys.stderr)
        sys.exit(2)

    if args.sequence or d.is_file():
        _run_sequence(d, args)
        return
    ext = "mem" if args.mem else "bin"
    f0p, f1p = d / f"frame_00.{ext}", d / f"frame_01.{ext}"
    for p in (f0p, f1p):
        if not p.exists():
            print(f"error: {p} not found", file=sys.stderr)
            sys.exit(1)
    load = fio.load_frame_mem if args.mem else fio.load_frame_bin
    f0 = load(f0p, args.width, args.height)
    f1 = load(f1p, args.width, args.height)
    dev = resolve_device(args.device)

    levels = None
    if args.pyramidal:
        cfg = PYRAMID_CONFIGS[args.pyramid_config]
        out = lucas_kanade_pyramidal(
            torch.from_numpy(f0).to(dev), torch.from_numpy(f1).to(dev),
            config=cfg, backend=args.backend, return_levels=bool(args.per_level_plots),
        )
        if args.per_level_plots:
            u, v, levels = out
        else:
            u, v = out
        mode = f"pyramidal[{args.pyramid_config}]"
    elif args.backend == "rtl":
        u, v = fixed_point.lucas_kanade_s87(
            torch.from_numpy(np.clip(f0, 0, 255).astype(np.uint8)).to(dev),
            torch.from_numpy(np.clip(f1, 0, 255).astype(np.uint8)).to(dev),
            window_size=args.window_size,
        )
        mode = "single-scale[S8.7 RTL]"
    else:
        u, v = lucas_kanade_single_scale(
            torch.from_numpy(f0).to(dev), torch.from_numpy(f1).to(dev),
            window_size=args.window_size, backend=args.backend,
        )
        mode = "single-scale"
    u = u.cpu().numpy()
    v = v.cpu().numpy()

    x0, x1, y0, y1 = args.region
    stats = region_stats(u, v, args.region)
    print(f"mode: {mode}  backend: {args.backend}  device: {dev.type}  "
          f"frame: {args.width}x{args.height}")
    print(f"test region x[{x0}:{x1}] y[{y0}:{y1}]:")
    for k, val in stats.items():
        print(f"  {k:18s} {val:10.4f}")

    if args.export:
        fio.save_flow_text(args.export, u, v,
                           header=f"tpuflow_torch {mode} backend={args.backend}")
        print(f"flow field -> {args.export}")

    if args.compare:
        cu, cv = fio.load_flow_text(args.compare)
        if cu.shape != u.shape:
            print(f"error: compare dump shape {cu.shape} != {u.shape}", file=sys.stderr)
            sys.exit(1)
        du = np.abs(u - cu)
        dv = np.abs(v - cv)
        print(f"vs {args.compare}: mae_u={du.mean():.4f} "
              f"mae_v={dv.mean():.4f} max_u={du.max():.4f} "
              f"max_v={dv.max():.4f}")

    if args.plot:
        from tpuflow_torch.eval import visualize

        visualize.quiver_plot(u, v, f"tpuflow_torch {mode}", args.plot)
        print(f"quiver plot -> {args.plot}")

    if args.per_level_plots and levels is not None:
        from tpuflow_torch.eval import visualize

        visualize.save_pyramid_levels(
            [(lu.cpu().numpy(), lv.cpu().numpy()) for lu, lv in levels], args.per_level_plots)
        print(f"per-level snapshots -> {args.per_level_plots}")


if __name__ == "__main__":
    main()
