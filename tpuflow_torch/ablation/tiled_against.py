"""The graphed tiled flow step of this tree against another checkout's, in
turns on the same card or cards.

Each version runs in processes of its own (both packages are named
``tpuflow_torch``): the other checkout's package imported from its root,
this tree's from here, in the order other, this, this, other. Each run
captures ``flow.TiledGraphedStream`` at 1080p on an NCCL mesh (1x1x1 on
one card, or 1x2x2 with one rank per card on four) under
``production_fullband`` and ``default``, replays it over streams of
alternating pairs of a textured frame and it shifted by 2 px, and prints,
for rank 0, the graphed ms a pair (host clock, median and spread of 3
streams of 8 pairs), the device busy ms of one replay with its parts in
the port's kernels, in copies and in NCCL's kernels, and that replay's
kernels and copies (torch.profiler). Needs CUDA devices; the other
checkout needs a ``tpuflow_torch`` with ``TiledGraphedStream``. For
example, against the parent commit unpacked under the gitignored
``build/``:

    git archive HEAD~1 tpuflow_torch | tar -x -C build/parent_tree
    python -m tpuflow_torch.ablation.tiled_against build/parent_tree --cards 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CONFIGS = ("production_fullband", "default")
HEIGHT, WIDTH = 1080, 1920
PAIRS, RUNS = 8, 3
THIS_ROOT = Path(__file__).resolve().parents[2]


def _frames(seed: int = 0):
    import numpy as np
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(seed)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (HEIGHT, WIDTH)), 2.0))
    b = shift(a, (0.0, 2.0), order=1, mode="constant", cval=128.0)
    return a.astype(np.float32), b.astype(np.float32)


def _rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank: the graphed step under each config; rank 0 writes the
    readings to ``out``."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch import PYRAMID_CONFIGS
    from tpuflow_torch.flow import TiledGraphedStream
    from tpuflow_torch.sharding import initialize_multihost, make_flow_mesh

    initialize_multihost(f"file://{store}", world, rank, backend="nccl")
    shape = (1, 1, 1) if world == 1 else (1, 2, world // 2)
    mesh = make_flow_mesh(*shape, device=torch.device("cuda", rank))
    a, b = (torch.from_numpy(f).to(mesh.device) for f in _frames())
    doc = {}
    for config in CONFIGS:
        stream = TiledGraphedStream(a[None], PYRAMID_CONFIGS[config], mesh)

        def pairs():
            stream.reset(a[None])
            for i in range(PAIRS):
                stream.step((b if i % 2 == 0 else a)[None])

        pairs()
        ms = []
        for _ in range(RUNS):
            dist.barrier(mesh.group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pairs()
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - t0) / PAIRS)
        stream.reset(a[None])
        dist.barrier(mesh.group)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stream.step(b[None])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = [sum(e.self_device_time_total for e in events if part(e.key)) / 1000
                for part in (lambda k: True, lambda k: "tpuflow_" in k,
                             lambda k: k.startswith("Mem"), lambda k: "nccl" in k.lower())]
        copies = sum(e.count for e in events if e.key.startswith("Mem"))
        doc[config] = {"graphed_ms": sorted(ms), "busy_ms": busy,
                       "kernels": sum(e.count for e in events) - copies, "copies": copies}
        del stream
    dist.barrier()
    if rank == 0:
        Path(out).write_text(json.dumps(doc))
    dist.destroy_process_group()


def _worker(world: int, out: str) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as work:
        mp.spawn(_rank, args=(world, f"{work}/store", out), nprocs=world, join=True)


def run(root: Path, world: int) -> dict:
    """One version's readings: this file run under ``root``'s package."""
    with tempfile.TemporaryDirectory() as work:
        out = f"{work}/readings.json"
        env = dict(os.environ, PYTHONPATH=str(root))
        subprocess.run([sys.executable, __file__, "--worker", str(world), out], env=env,
                       check=True, timeout=900)
        return json.loads(Path(out).read_text())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, nargs="?",
                        help="a checkout root holding the other tpuflow_torch")
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4),
                        help="1: mesh 1x1x1 on card 0; 4: mesh 1x2x2, one rank a card")
    parser.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        _worker(int(args.worker[0]), args.worker[1])
        return
    if args.other is None:
        parser.error("the other checkout's root is required")
    import torch

    from tpuflow_torch.eval.timing import card_label

    if torch.cuda.device_count() < args.cards:
        raise SystemExit(f"{args.cards} cards asked for, {torch.cuda.device_count()} present")
    roots = {"other": args.other.resolve(), "this": THIS_ROOT}
    mesh = "1x1x1" if args.cards == 1 else "1x2x2"
    print(f"graphed tiled step, 1080p, NCCL mesh {mesh}, on {card_label()}: this tree against "
          f"{args.other}", flush=True)
    doc = {"card": card_label(), "mesh": mesh, "runs": []}
    for label in ("other", "this", "this", "other"):
        got = run(roots[label], args.cards)
        doc["runs"].append({"version": label, **got})
        for config, r in got.items():
            ms = r["graphed_ms"]
            print(f"{label} {config}: graphed {ms[len(ms) // 2]:.3f} ms a pair (spread "
                  f"{ms[0]:.3f}-{ms[-1]:.3f}); rank 0's replay busy {r['busy_ms'][0]:.3f} ms "
                  f"({r['busy_ms'][1]:.3f} in the port's kernels, {r['busy_ms'][2]:.3f} in "
                  f"copies, {r['busy_ms'][3]:.3f} in NCCL), {r['kernels']} kernels and "
                  f"{r['copies']} copies a replay", flush=True)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
