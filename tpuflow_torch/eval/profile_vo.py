"""Per-stage latency of the VO front end's step on one NVIDIA GPU.

The port of ``tpuflow.eval.profile_vo``, with its six rows:

- ``flow step (build+solve)``: one streaming flow step on a carried
  pyramid (``lucas_kanade_pyramidal_step``): the new frame's pyramid and
  the coarse-to-fine solve;
- ``pyramid build (1 frame)``: the build alone;
- ``seed_grid (Shi-Tomasi)``: the full-frame corner response and grid-cell
  argmax of the keyframe reseed, ungated (``kernels.seed.seed_grid``: the
  seed kernel on the card, the plain version on the CPU);
- ``advance (track gathers)``: dense-flow sampling and border cull of the
  track table;
- ``full VO step``: the whole ``FrontEnd.step`` (flow, advance, loss
  stats, the reseed gated on the keyframe predicate);
- ``unexplained (full - flow - seed - advance)``: the accounting row.

Clocks. On the card every row's ``ms`` is device time
(``eval.timing.device_ms``: CUDA events around back-to-back calls queued
behind a GPU spin), taken in the form the port serves: the flow step as
one replay of its captured CUDA graph (``flow.graphed.capture``) and the
full step as one replay of the front end's captured step
(``FrontEnd.scan_steps`` over a one-frame chunk, which also copies the
state in and the ObsRecord and state out); the other rows' bodies are
single launches or short op chains, timed as they are called. The fast
path reads nothing to the host (``backend="cuda"``), so each body's
device time is its work alone, and the accounting row subtracts device
time from device time. Each row also keeps the eager body's host clock
(``eager_host_ms``: ``PROFILE_CALLS`` calls ending in a synchronize,
median of ``PROFILE_RUNS`` runs, each in ``eager_runs_ms``), and the two
graphed rows the eager body's device time (``eager_device_ms``, from
``EAGER_REPS`` calls a batch so that the launch queue holds them all).

The frames are the natural mountain-texture pair with 2 px horizontal
motion (``eval.profile.natural_pair``: the texture resized as PIL's
bilinear filter resizes it, no PIL needed), as the reference makes them.
The front end runs ``backend="cuda"`` on the card; ``device="cpu"`` runs
the parity path (``"torch"``) once per row by host clock, for the CPU
schema test only, with no device time.

Run on a card: ``python -m tpuflow_torch.eval.profile_vo --config production``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.eval import profile
from tpuflow_torch.eval.timing import card_label, device_ms, resolve_device
from tpuflow_torch.flow import graphed
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal_step
from tpuflow_torch.kernels import seed, torch_ref
from tpuflow_torch.vo import tracking
from tpuflow_torch.vo.device_loop import get_front_end

PROFILE_CALLS = 10  # calls a host-clock run on the card
PROFILE_RUNS = 3
HOST_CLOCK = "host"  # host clock to a synchronize (the CPU's rows)
DEVICE_CLOCK = "device"  # CUDA events (every row on the card)
# Back-to-back calls a batch when an eager step's device time is read: an
# eager step launches 150-260 kernels, and the calls must all fit in the
# launch queue behind the GPU spin, or they run at the host's pace.
EAGER_REPS = 2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev: torch.device, calls: int, runs: int) -> list[float]:
    """ms a call by host clock around ``calls`` calls ending in a device
    synchronize, one reading a run, after one warm-up call."""
    fn()
    readings = []
    for _ in range(runs):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(dev)
        readings.append((time.perf_counter() - t0) * 1e3 / calls)
    return readings


def profile_vo(
    height: int = 1080,
    width: int = 1920,
    config: str = "production",
    grid_step: int = 16,
    fb_check: float | None = None,
    device: torch.device | str | None = None,
) -> list[dict]:
    """The six rows at (height, width) under a named config, on ``device``
    (the card unless the caller names another; raises without a card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = PYRAMID_CONFIGS[config]
    backend = "cuda" if on_card else "torch"
    h, w = height, width

    frame0, frame1 = profile.natural_pair(h, w, device=dev)
    pyr0 = torch_ref.build_gaussian_pyramid(frame0, cfg.levels, cfg.scale_factor)
    rng = np.random.default_rng(3)
    u0 = torch.from_numpy(rng.uniform(-2, 2, (h, w)).astype(np.float32)).to(dev)

    fe = get_front_end(grid_step=grid_step, keyframe_stride=1,
                       fb_check_threshold=fb_check, backend=backend, config=cfg)
    state0, _ = fe.init(frame0)
    tracks0 = tracking.Tracks(state0.xy, state0.start_xy, state0.age, state0.alive)
    margin = fe.margin_for(h, w)
    seed_margin = fe.margin_for(h, w, for_cull=False)

    def flow_step():
        return lucas_kanade_pyramidal_step(pyr0, frame1, cfg, backend=backend, rtl_clamp=True)

    stages = [
        ("flow step (build+solve)", flow_step),
        ("pyramid build (1 frame)",
         lambda: torch_ref.build_gaussian_pyramid(frame1, cfg.levels, cfg.scale_factor)),
        ("seed_grid (Shi-Tomasi)",
         lambda: seed.seed_grid(frame1, grid_step=grid_step, margin=seed_margin)),
        ("advance (track gathers)", lambda: tracking.advance(tracks0, u0, u0, margin=margin)),
        ("full VO step", lambda: fe.step(state0, frame1)),
    ]
    if not on_card:
        rows = []
        for name, fn in stages:
            runs_ms = host_ms(fn, dev, 1, 1)
            rows.append({"stage": name, "ms": statistics.median(runs_ms), "clock": HOST_CLOCK,
                         "runs_ms": runs_ms})
        return _with_accounting(rows, HOST_CLOCK)

    # The rows timed as the graph replays the port serves.
    served = {"flow step (build+solve)": _replay(flow_step, dev),
              "full VO step": lambda: fe.scan_steps(state0, frame1[None])}
    rows = []
    for name, fn in stages:
        runs_ms = host_ms(fn, dev, PROFILE_CALLS, PROFILE_RUNS)
        row = {"stage": name, "ms": device_ms(served.get(name, fn)), "clock": DEVICE_CLOCK,
               "eager_host_ms": statistics.median(runs_ms), "eager_runs_ms": runs_ms}
        if name in served:
            row["eager_device_ms"] = device_ms(fn, reps=EAGER_REPS)
        rows.append(row)
    return _with_accounting(rows, DEVICE_CLOCK)


def _replay(body, dev: torch.device):
    """``body`` captured once as a CUDA graph (``flow.graphed.capture``);
    returns a call that replays it and counts its launches."""
    graph, _, replays, _, _ = graphed.capture(body, torch.cuda.Stream(dev))

    def replay():
        graph.replay()
        replays.replays += 1

    return replay


def _with_accounting(rows: list[dict], clock: str) -> list[dict]:
    """The rows and the accounting row: the full step less the flow step,
    the seed and the advance, each on the same clock."""
    comp = {r["stage"]: r["ms"] for r in rows}
    explained = (
        comp["flow step (build+solve)"]
        + comp["seed_grid (Shi-Tomasi)"]
        + comp["advance (track gathers)"]
    )
    rows.append({
        "stage": "unexplained (full - flow - seed - advance)",
        "ms": comp["full VO step"] - explained,
        "clock": clock,
    })
    return rows


def format_rows(rows: list[dict]) -> list[str]:
    lines = []
    for r in rows:
        form, eager = "", ""
        if "eager_device_ms" in r:  # a graph replay, beside its eager body
            form = ", graph replay"
            eager = f"  eager: device {r['eager_device_ms']:.4f} ms,"
        if "eager_host_ms" in r:
            eager += (f"  {'' if eager else 'eager: '}host {r['eager_host_ms']:.4f} ms (runs "
                      + ", ".join(f"{t:.4f}" for t in r["eager_runs_ms"]) + ")")
        lines.append(f"  {r['stage']:42s} {r['ms']:8.4f} ms ({r['clock']} clock{form}){eager}")
    return lines


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json
    import platform
    from datetime import datetime, timezone
    from pathlib import Path

    parser = argparse.ArgumentParser(description="Per-stage profile of the VO serving step")
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--config", type=str, default="production",
                        choices=sorted(PYRAMID_CONFIGS))
    parser.add_argument("--grid-step", type=int, default=16)
    parser.add_argument("--fb-check", type=float, default=None)
    parser.add_argument("--json", type=str, default=None, metavar="PATH")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="the card (default; fails without one) or the CPU "
                        "(parity path, one call a row by host clock, no device time)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    label = card_label() if dev.type == "cuda" else "cpu"
    rows = profile_vo(args.height, args.width, args.config, args.grid_step, args.fb_check,
                      device=dev)
    print(f"VO serving profile @ {args.width}x{args.height} "
          f"config={args.config} fb={args.fb_check} on {label}")
    for line in format_rows(rows):
        print(line)
    if args.json:
        doc = {
            "timestamp": datetime.now(timezone.utc).isoformat(),
            "height": args.height,
            "width": args.width,
            "config": args.config,
            "grid_step": args.grid_step,
            "fb_check": args.fb_check,
            "host": platform.node(),
            "device": label,
            "stages": rows,
        }
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2))
        print(f"profile snapshot -> {path}")


if __name__ == "__main__":
    main()
