"""Per-stage device time and roofline accounting for the flow pipeline on
one NVIDIA GPU.

Counterpart of ``tpuflow.eval.profile``: the same stages, with the same
names (``(pallas)`` read as ``(cuda)``; the ``(MXU)`` row is the same
banded f32 matmul, here ``torch.matmul``) and the same bytes model, so the
two reports line up row for row:

- fused LK, the banded warps (packed variants by config), gaussian blur,
  2x resize and the 3-level pyramid build: device time per call, CUDA
  events around back-to-back calls queued behind a GPU spin
  (``eval.timing.device_ms``; inputs L2-warm), with the achieved GB/s of
  the bytes model and its share of the card's DRAM peak;
- ``pyramidal total (fast)``: ms per frame of bench.py's streaming loop on
  noise frames (alternating frames, the pyramid carried, each frame
  perturbed by the carried u and v), each step one CUDA graph replay
  (``flow.graphed``), host clock around the loop, ending in
  ``torch.cuda.synchronize()``; the median of three runs, all three kept;
- ``pyramidal total (benign)``, adaptive-band configs only: the same loop
  on the natural mountain-texture pair with 2 px horizontal motion (the
  committed ``data/natural_1080x1920.npz`` frame, shifted with
  ``ops.map_coordinates_bilinear``, gray 128 fill). The fixture is 1080p,
  so at other sizes the row is left out, with a note.

``profile_pipeline`` measures on the card by default and raises where there
is none. ``device="cpu"`` runs the plain versions under the host clock,
for the CPU schema test only: its rows carry no GB/s and no roofline
share, which are device metrics. Run on a card:
``python -m tpuflow_torch.eval.profile --config production``.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.core import ops
from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.eval.timing import card_label, device_ms, require_cuda, resolve_device
from tpuflow_torch.flow import graphed, pyramidal
from tpuflow_torch.kernels import lk, torch_ref, warp

# NVIDIA H100 SXM HBM3 peak (data sheet), for the roofline share.
HBM_GBPS = 3350.0
NATURAL = Path(__file__).resolve().parent / "data" / "natural_1080x1920.npz"
NATURAL_SHAPE = (1080, 1920)
STREAM_ITERS = 15  # loop iterations per timed run: two frames each
STREAM_RUNS = 3


def natural_pair(dx: float = 2.0, device: torch.device | str | None = None):
    """The natural 1080p frame and the same frame shifted ``dx`` px right
    (bilinear, gray 128 fill), as ``tpuflow.eval.profile._natural_pair``,
    on ``device``: the card unless the caller names another."""
    dev = resolve_device(device)
    f0 = torch.from_numpy(np.load(NATURAL)["frame"].astype(np.float32)).to(dev)
    h, w = f0.shape
    yy = torch.arange(h, dtype=torch.float32, device=f0.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=f0.device)[None, :].expand(h, w)
    return f0, ops.map_coordinates_bilinear(f0, yy, xx - dx, cval=128.0)


def _host_ms(fn, reps: int = 2) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_ms_per_frame(prev: torch.Tensor, curr: torch.Tensor, cfg: PyramidConfig,
                        iters: int = STREAM_ITERS, runs: int = STREAM_RUNS) -> list[float]:
    """ms per frame of bench.py's streaming loop, one reading per run: each
    iteration streams ``curr`` then ``prev``, each perturbed by 1e-9 times
    the carried u and v, the new frame's pyramid carried to the next step.
    On the card the step is one CUDA graph replay (``flow.graphed``, as the
    reference jits the loop); on the CPU the eager driver. Host clock
    around each run, ending in a device synchronize."""
    pyr = torch_ref.build_gaussian_pyramid(prev, cfg.levels, cfg.scale_factor)
    u = torch.zeros_like(prev)
    v = torch.zeros_like(prev)
    if prev.device.type == "cuda":
        step = graphed.GraphedStream(pyr, cfg).step
    else:
        def step(frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            nonlocal pyr
            fu, fv, pyr = pyramidal.lucas_kanade_pyramidal_step(pyr, frame, cfg, backend="cuda")
            return fu, fv

    def run(n: int) -> float:
        nonlocal u, v
        _sync(prev.device)
        t0 = time.perf_counter()
        for _ in range(n):
            u1, v1 = step(curr + (u + v) * 1e-9)
            u, v = step(prev + (u1 + v1) * 1e-9)
        _sync(prev.device)
        return (time.perf_counter() - t0) * 1e3 / (2 * n)

    run(1)  # warm-up
    return [run(iters) for _ in range(runs)]


def profile_pipeline(height: int = 1080, width: int = 1920, config: str = "default",
                     device: torch.device | str | None = None) -> list[dict]:
    """Measure each stage at (height, width) under a named config; returns
    the report rows."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = PYRAMID_CONFIGS[config]
    h, w = height, width
    px = h * w
    mdv = cfg.max_disp_v_effective

    def plane(rng, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32)).to(dev)

    x = plane(np.random.default_rng(0), 0, 255)
    rng = np.random.default_rng(1)
    curr = plane(rng, 0, 255)
    u0 = plane(rng, -3, 3)
    curr_u8 = torch.floor(curr)

    def banded(image, packing):
        return lambda: warp.warp_banded(image, u0, u0, cfg.max_disp, clamp_flow=True,
                                        max_disp_v=mdv, packing=packing)

    stages = [
        ("fused LK (cuda)",
         lambda: lk.lucas_kanade_fused(x, curr, relaxed_order=cfg.relaxed_order)[0],
         16 * px),  # 2 frame reads + 2 flow writes
        ("banded warp (cuda)", banded(curr, "exact"), 16 * px),  # frame + 2 flows in, frame out
        ("gaussian blur s=2", lambda: ops.gaussian_filter(x, 2.0), 8 * px),
    ]
    if cfg.warp_packed_u8:
        stages.insert(2, ("banded warp (packed u8)", banded(curr_u8, "u8"), 16 * px))
    if cfg.warp_packed_u16:
        stages.insert(2, ("banded warp (packed u16)", banded(curr, "u16"), 16 * px))
    stages += [
        ("resize 2x down (MXU)", lambda: ops.resize_bilinear(x, h // 2, w // 2), 5 * px),
        ("pyramid build (3 lvl)", lambda: torch_ref.build_gaussian_pyramid(x, 3), 8 * px),
    ]

    rows = []
    for name, fn, bytes_model in stages:
        ms = device_ms(fn) if on_card else _host_ms(fn)
        row = {"stage": name, "ms": ms, "bytes_model": bytes_model}
        if on_card:
            row["effective_gbps"] = bytes_model / (ms * 1e-3) / 1e9
            row["hbm_fraction"] = row["effective_gbps"] / HBM_GBPS
        rows.append(row)

    iters, runs = (STREAM_ITERS, STREAM_RUNS) if on_card else (1, 1)

    def total(name, prev, nxt):
        runs_ms = stream_ms_per_frame(prev, nxt, cfg, iters, runs)
        return {"stage": name, "ms": statistics.median(runs_ms), "bytes_model": None,
                "runs_ms": runs_ms}

    rows.append(total("pyramidal total (fast)", plane(rng, 0, 255), curr))
    if cfg.adaptive_v_bands is not None:
        if (h, w) == NATURAL_SHAPE:
            rows.append(total("pyramidal total (benign)", *natural_pair(device=dev)))
        else:
            print(f"note: 'pyramidal total (benign)' left out: the natural frame is "
                  f"{NATURAL_SHAPE[1]}x{NATURAL_SHAPE[0]}, the profile {w}x{h}")
    return rows


def format_report(rows: list[dict], height: int, width: int, device_label: str) -> str:
    lines = [
        f"tpuflow_torch pipeline profile @ {width}x{height} on {device_label} "
        "(device ms per call; totals: host-clock ms/frame)",
        f"{'stage':26s} {'ms':>8s} {'GB/s':>8s} {'%HBM roofline':>14s}",
    ]
    for r in rows:
        gbps = f"{r['effective_gbps']:8.0f}" if "effective_gbps" in r else "       -"
        frac = (
            f"{100 * r['hbm_fraction']:13.1f}%" if "hbm_fraction" in r else "             -"
        )
        runs = ("  runs " + ", ".join(f"{t:.4f}" for t in r["runs_ms"])) if "runs_ms" in r else ""
        lines.append(f"{r['stage']:26s} {r['ms']:8.4f} {gbps} {frac}{runs}")
    return "\n".join(lines)


def trace_solve(height: int, width: int, config: str, trace_dir: str) -> Path:
    """A torch.profiler chrome trace of one pyramidal solve on the card."""
    from torch.profiler import ProfilerActivity, profile

    dev = require_cuda()
    cfg = PYRAMID_CONFIGS[config]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0, 255, (height, width)).astype(np.float32)).to(dev)
    if cfg.warp_packed_u8:
        a = a.round()  # the 8-bit input contract
    b = a.roll(2, dims=1)
    pyramidal.lucas_kanade_pyramidal(a, b, config=cfg, backend="cuda")  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pyramidal.lucas_kanade_pyramidal(a, b, config=cfg, backend="cuda")
        torch.cuda.synchronize()
    path = Path(trace_dir) / f"pyramidal_{config}_{width}x{height}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def main() -> None:
    import argparse
    import json
    import platform
    from datetime import datetime, timezone

    parser = argparse.ArgumentParser(description="Profile the flow pipeline on the GPU")
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--config", type=str, default="default", choices=sorted(PYRAMID_CONFIGS),
                        help="named pyramid config")
    parser.add_argument("--json", type=str, default=None, metavar="PATH",
                        help="also write the rows as JSON")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="also write a torch.profiler chrome trace of one pyramidal "
                        "solve into DIR")
    args = parser.parse_args()
    require_cuda()
    label = card_label()
    rows = profile_pipeline(args.height, args.width, args.config)
    print(format_report(rows, args.height, args.width, label))
    if args.json:
        doc = {
            "timestamp": datetime.now(timezone.utc).isoformat(),
            "height": args.height,
            "width": args.width,
            "config": args.config,
            "host": platform.node(),
            "device": label,
            "stages": rows,
        }
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2))
        print(f"profile snapshot -> {path}")
    if args.trace:
        print(f"device trace -> {trace_solve(args.height, args.width, args.config, args.trace)}")


if __name__ == "__main__":
    main()
