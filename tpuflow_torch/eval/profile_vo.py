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

Clocks. The flow step and the full step read the flow's early-exit flag
and band index to the host (``flow/pyramidal.py``), so a device-event
reading of them would count the host's gaps as well. So every row's
``ms`` is the host clock around ``PROFILE_CALLS`` calls ending in
``torch.cuda.synchronize()``, the median of ``PROFILE_RUNS`` runs, and the
accounting row subtracts like from like. The three bodies with no host
read (build, seed, advance) also carry ``device_ms``
(``eval.timing.device_ms``: CUDA events around back-to-back calls queued
behind a GPU spin). Each row names its clock.

The frames are the natural mountain-texture pair with 2 px horizontal
motion: at 1080p the committed ``data/natural_1080x1920.npz`` frame
(``eval.profile.natural_pair``); other sizes resize the texture with PIL
(bilinear), as the reference does. The front end runs ``backend="cuda"``
on the card; ``device="cpu"`` runs the parity path (``"torch"``) once per
row, for the CPU schema test only, with no device time.

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
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal_step
from tpuflow_torch.kernels import seed, torch_ref
from tpuflow_torch.vo import tracking
from tpuflow_torch.vo.device_loop import get_front_end

PROFILE_CALLS = 10  # calls a timed run on the card
PROFILE_RUNS = 3
HOST_CLOCK = "host"  # host clock to a synchronize, median of the runs


def natural_frames(height: int, width: int, device: torch.device, dx: float = 2.0):
    """The natural frame and it shifted ``dx`` px right (gray 128 fill) on
    ``device``: the committed frame at 1080p, else the texture resized
    with PIL's bilinear filter (``tpuflow.eval.profile._natural_pair``)."""
    if (height, width) == profile.NATURAL_SHAPE:
        return profile.natural_pair(dx, device=device)
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"a {width}x{height} natural frame needs Pillow (PIL); the committed one is "
            f"{profile.NATURAL_SHAPE[1]}x{profile.NATURAL_SHAPE[0]}"
        ) from exc
    from scipy.ndimage import shift as nd_shift

    from tpuflow_torch.eval.natural import TEXTURE

    img = Image.open(TEXTURE).convert("L").resize((width, height), Image.Resampling.BILINEAR)
    f0 = np.array(img, dtype=np.float32)
    f1 = nd_shift(f0, (0.0, dx), order=1, mode="constant", cval=128.0).astype(np.float32)
    return torch.from_numpy(f0).to(device), torch.from_numpy(f1).to(device)


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

    frame0, frame1 = natural_frames(h, w, dev)
    pyr0 = torch_ref.build_gaussian_pyramid(frame0, cfg.levels, cfg.scale_factor)
    rng = np.random.default_rng(3)
    u0 = torch.from_numpy(rng.uniform(-2, 2, (h, w)).astype(np.float32)).to(dev)

    fe = get_front_end(grid_step=grid_step, keyframe_stride=1,
                       fb_check_threshold=fb_check, backend=backend, config=cfg)
    state0, _ = fe.init(frame0)
    tracks0 = tracking.Tracks(state0.xy, state0.start_xy, state0.age, state0.alive)
    margin = fe.margin_for(h, w)
    seed_margin = fe.margin_for(h, w, for_cull=False)

    stages = [
        ("flow step (build+solve)", False,
         lambda: lucas_kanade_pyramidal_step(pyr0, frame1, cfg, backend=backend,
                                             rtl_clamp=True)),
        ("pyramid build (1 frame)", True,
         lambda: torch_ref.build_gaussian_pyramid(frame1, cfg.levels, cfg.scale_factor)),
        ("seed_grid (Shi-Tomasi)", True,
         lambda: seed.seed_grid(frame1, grid_step=grid_step, margin=seed_margin)),
        ("advance (track gathers)", True,
         lambda: tracking.advance(tracks0, u0, u0, margin=margin)),
        ("full VO step", False, lambda: fe.step(state0, frame1)),
    ]
    calls, runs = (PROFILE_CALLS, PROFILE_RUNS) if on_card else (1, 1)
    rows = []
    for name, no_host_read, fn in stages:
        runs_ms = host_ms(fn, dev, calls, runs)
        row = {"stage": name, "ms": statistics.median(runs_ms), "clock": HOST_CLOCK,
               "runs_ms": runs_ms}
        if on_card and no_host_read:
            row["device_ms"] = device_ms(fn)
        rows.append(row)
    comp = {r["stage"]: r["ms"] for r in rows}
    explained = (
        comp["flow step (build+solve)"]
        + comp["seed_grid (Shi-Tomasi)"]
        + comp["advance (track gathers)"]
    )
    rows.append({
        "stage": "unexplained (full - flow - seed - advance)",
        "ms": comp["full VO step"] - explained,
        "clock": HOST_CLOCK,
    })
    return rows


def format_rows(rows: list[dict]) -> list[str]:
    lines = []
    for r in rows:
        dev_ms = f"  device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
        runs = ("  runs " + ", ".join(f"{t:.4f}" for t in r["runs_ms"])) if "runs_ms" in r else ""
        lines.append(f"  {r['stage']:42s} {r['ms']:8.3f} ms ({r['clock']} clock){dev_ms}{runs}")
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
                        "(parity path, one call a row, no device time)")
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
