"""Whether an NCCL world's teardown returns, with the port's CUDA graphs
alive, freed or released: the witness of the teardown order that
``sharding.mesh`` documents.

Each scenario starts one process a card (NCCL, world = the cards, at most
4), makes its meshes at 240x320, steps a ``flow.TiledGraphedStream`` on
each (or the eager tiled step, or nothing), then tears down; each rank
runs the teardown under its own watchdog
(``faulthandler.dump_traceback_later``: the stacks are written and the
process exits), so a hang costs the watchdog's seconds, not the caller's
time limit. The scenarios, smallest first:

- ``groups``: no mesh, two process groups of every rank, one all-reduce
  on each, then ``dist.destroy_process_group()``;
- ``made``: three meshes (1x2x2, 1x4x1, 2x1x2) made, no flow run;
- ``eager``: three meshes, the eager tiled step on each (no graph);
- ``one_freed``: one 1x2x2 mesh, its stream deleted and collected;
- ``freed``: three meshes, every stream deleted and collected;
- ``live``: one 1x2x2 mesh, its stream still referenced;
- ``released``: three meshes with their streams alive, each mesh released
  (``sharding.release_mesh``: its graphs closed, then its groups
  destroyed), then ``dist.destroy_process_group()``.

Prints one line a scenario (each rank's teardown seconds, or that its
watchdog fired, with the file of its stacks) and one JSON object. Needs
four CUDA devices:

    python -m tpuflow_torch.ablation.teardown [--scenarios groups made ...]
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
import time
from pathlib import Path

THREE = ((1, 2, 2), (1, 4, 1), (2, 1, 2))
# name -> (meshes, what runs on each: "graph", "eager" or None, what
# happens to the graphs before the world is destroyed: "keep", "free" or
# "release")
SCENARIOS = {
    "groups": ((), None, "keep"),
    "made": (THREE, None, "keep"),
    "eager": (THREE, "eager", "keep"),
    "one_freed": (((1, 2, 2),), "graph", "free"),
    "freed": (THREE, "graph", "free"),
    "live": (((1, 2, 2),), "graph", "keep"),
    "released": (THREE, "graph", "release"),
}
HEIGHT, WIDTH = 240, 320
SETUP_S = 240.0  # a rank's start, meshes and captures
TEARDOWN_S = 60.0  # a rank's teardown; a normal one takes seconds


def _frames(batch: int):
    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (HEIGHT, WIDTH)), 2.0))
    a = torch.from_numpy(a.astype(np.float32))
    return a.expand(batch, -1, -1).contiguous(), a.roll(2, dims=1).expand(batch, -1, -1)


def _rank(rank: int, world: int, addr: str, scenario: str, out: str) -> None:
    import faulthandler
    import gc

    import torch
    import torch.distributed as dist

    from tpuflow_torch import PYRAMID_CONFIGS
    from tpuflow_torch.flow import TiledGraphedStream
    from tpuflow_torch.sharding import (initialize_multihost, make_flow_mesh, release_mesh,
                                        tiled_lucas_kanade_pyramidal)

    shapes, run_on, graphs = SCENARIOS[scenario]
    stacks = open(f"{out}/{scenario}_rank{rank}_stacks.txt", "w")  # noqa: SIM115
    faulthandler.dump_traceback_later(SETUP_S, exit=True, file=stacks)
    initialize_multihost(addr, world, rank, backend="nccl")
    dev = torch.device("cuda", rank)
    cfg = PYRAMID_CONFIGS["default"]
    if not shapes:
        for _ in range(2):
            g = dist.new_group(list(range(world)))
            dist.all_reduce(torch.ones(1, device=dev), group=g)
    meshes, streams = [], []
    for shape in shapes:
        mesh = make_flow_mesh(*shape, device=dev)
        a, b = (f.to(dev) for f in _frames(shape[0]))
        if run_on == "graph":
            streams.append(TiledGraphedStream(a, cfg, mesh))
            streams[-1].step(b.contiguous())
        elif run_on == "eager":
            tiled_lucas_kanade_pyramidal(a, b.contiguous(), mesh, config=cfg, backend="cuda")
        meshes.append(mesh)
    torch.cuda.synchronize(dev)
    faulthandler.cancel_dump_traceback_later()
    faulthandler.dump_traceback_later(TEARDOWN_S, exit=True, file=stacks)
    t0 = time.perf_counter()
    if graphs == "free":
        streams.clear()
        gc.collect()
        torch.cuda.synchronize(dev)
    elif graphs == "release":
        for mesh in meshes:
            release_mesh(mesh)
    dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    Path(f"{out}/{scenario}_rank{rank}.json").write_text(json.dumps({"teardown_s": seconds}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(scenario: str, world: int, out: str) -> dict:
    """One scenario in ``world`` fresh processes; returns each rank's
    result."""
    import torch.multiprocessing as mp

    addr = f"tcp://localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, addr, scenario, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SETUP_S + TEARDOWN_S + 30.0
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    ranks = []
    for r, p in enumerate(procs):
        if p.is_alive():  # past both watchdogs: kill it
            p.kill()
            p.join()
        result = Path(f"{out}/{scenario}_rank{r}.json")
        ranks.append({"exit": p.exitcode,
                      "teardown_s": json.loads(result.read_text())["teardown_s"]
                      if result.exists() else None,
                      "stacks": f"{out}/{scenario}_rank{r}_stacks.txt"})
    return {"scenario": scenario, "meshes": ["x".join(map(str, m)) for m in SCENARIOS[scenario][0]],
            "returned": all(r["exit"] == 0 and r["teardown_s"] is not None for r in ranks),
            "ranks": ranks}


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenarios", nargs="+", choices=list(SCENARIOS),
                        default=list(SCENARIOS))
    parser.add_argument("--out", default=None, help="directory for the ranks' files")
    args = parser.parse_args()
    world = min(torch.cuda.device_count(), 4)
    if world < 4:
        raise SystemExit(f"teardown: needs four CUDA devices, found {world}")
    from tpuflow_torch.kernels import _build

    _build.load()  # built once here, not by every rank at once
    out = args.out or tempfile.mkdtemp(prefix="tpuflow_teardown_")
    Path(out).mkdir(parents=True, exist_ok=True)
    results = []
    for scenario in args.scenarios:
        t0 = time.perf_counter()
        r = run(scenario, world, out)
        results.append(r)
        times = ", ".join("watchdog fired" if x["teardown_s"] is None
                          else f"{x['teardown_s']:.2f} s" for x in r["ranks"])
        print(f"[teardown] {scenario} ({' '.join(r['meshes']) or 'no mesh'}; "
              f"{SCENARIOS[scenario][1] or 'nothing run'}, graphs {SCENARIOS[scenario][2]}): "
              f"{'returned' if r['returned'] else 'did not return'}; ranks: {times}; "
              f"exit codes {[x['exit'] for x in r['ranks']]}; {time.perf_counter() - t0:.1f} s "
              f"in all; stacks under {out}", flush=True)
    print(json.dumps({"teardown": results}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
