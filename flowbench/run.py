#!/usr/bin/env python3
"""The benchmark of tpuflow_torch's served flow path: one cell, one run.

    python3 flowbench/run.py --workload CELL --seed N --seconds S --trace 0|1

``CELL`` is a workload of ``BENCHMARK.json``. The run makes the cell's
frames from the seed on the card (a host ring of 8-bit frames), loads the
kernels' library (built first, into ``build/tpuflow_torch/``, where this
checkout has none), captures the cell's one graph
(``tpuflow_torch.flow.GraphedStream``), warms up through the same path,
measures for S seconds, checks the timed steps' flow against the plain
reference in ``flowbench/reference/`` and prints one JSON line last on
standard output. Each step of the window: host frames into
``tpuflow_torch.io.stream.prefetch_to_device`` (the traffic's lookahead),
its device frame into ``GraphedStream.step`` (one graph replay), the
graph's round counter added into a device accumulator, and an end event.
``recorded`` traffic keeps at most ``in_flight`` steps on the card;
``live`` traffic hands frame k over only once step k - 1 has ended.

``--trace 1`` is a separate run: the window's last ``TRACE_SECONDS`` run
under ``torch.profiler`` and give the device's per-layer metrics and
``breakdown``; the host clock's per-layer metrics are read over the steps
before it, which no profiler slows.

``--device cpu`` rehearses the run on the CPU at a tiny frame size
(``CPU_SHAPE``), the program's plain versions stepping eagerly; it writes
no device metric and is never used on the card.

Exit codes: 0 with a result line (``correct`` may be false); 2 where the
card or the cards the cell asks for are missing; 3 where ``jax``,
``jaxlib``, ``flax`` or ``tpuflow`` was loaded; 1 on any other failure.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = _process_age_s()
_T_IMPORT = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "flowbench"
# Every build and kernel cache inside the checkout, at fixed paths.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import platform  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flowbench.harness import check, frames, roofline, spec, trace  # noqa: E402

CPU_SHAPE = (96, 160)
# Warm-up: at least this many steps, and on the card this many seconds of
# them: runs of the card's cells often began up to 4% slower for their
# first 5-30 s of load, then stayed at the faster rate.
WARMUP_STEPS = {"cuda": 32, "cpu": 3}
WARMUP_SECONDS = {"cuda": 20.0, "cpu": 0.0}
TRACE_SECONDS = 2.0
# Flows kept for the check: about this many planes, within this many bytes.
CHECK_PLANES = 32
CHECK_BYTES = 512 * 2**20
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuflow"}


class NoCard(RuntimeError):
    pass


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


class EagerStream:
    """The CPU rehearsal's stream: the program's eager step on CPU tensors
    (``backend="cuda"`` runs the kernels' plain versions there), with the
    graph's interface."""

    def __init__(self, first: torch.Tensor, cfg) -> None:
        from tpuflow_torch.kernels import torch_ref

        self.cfg = cfg
        self.carry = torch_ref.build_gaussian_pyramid(first.to(torch.float32), cfg.levels,
                                                      cfg.scale_factor)
        self.level_rounds = torch.zeros(tuple(first.shape[:-2]) + (cfg.levels,),
                                        dtype=torch.int32)

    def step(self, frame: torch.Tensor):
        from tpuflow_torch.flow import pyramidal

        u, v, self.carry = pyramidal.lucas_kanade_pyramidal_step(
            self.carry, frame.to(torch.float32), self.cfg, backend="cuda")
        self.level_rounds = pyramidal.counters.level_rounds
        return u, v


def _pyramid_config(config: dict):
    from tpuflow_torch.core.config import PyramidConfig

    fields = dict(config["pyramid"])
    if fields.get("adaptive_v_bands") is not None:
        fields["adaptive_v_bands"] = tuple(fields["adaptive_v_bands"])
    return PyramidConfig(**fields)


def _import_program():
    import tpuflow_torch

    where = Path(tpuflow_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"tpuflow_torch was imported from {where}, not from this checkout")


def _card_label() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _check_steps(batch: int, plane_bytes: int) -> int:
    per_step = 8 * plane_bytes * batch  # u and v, float32
    return max(2, min(math.ceil(CHECK_PLANES / batch), CHECK_BYTES // max(per_step, 1)))


def _diagnose(record: dict, done: dict, complete: list, steps: list, t0: float,
              t_end: float, setup_s: float, marks: dict) -> None:
    """Two lines on standard error that no metric carries: frames/s over
    each 5 s of the window (a slow start shows there), and the latency's
    spread, the host's time a step and the set-up's parts."""
    ends_at = np.array([done[k] for k in complete])
    edges = np.arange(t0, t_end + 1e-9, 5.0)
    rates = [record["streams"] * int(((ends_at > a) & (ends_at <= b)).sum()) / (b - a)
             for a, b in zip(edges, edges[1:])]
    print(f"flowbench: frames/s by 5 s {' '.join(f'{r:.1f}' for r in rates)}", file=sys.stderr)
    q = np.percentile(np.array(record["latencies_s"]) * 1e3, [50, 95, 99, 100])
    host = {p: np.array(record[f"{p}_host_s"]) * 1e3 for p in ("input", "step")}
    print(f"flowbench: {len(complete)} steps complete of {len(steps)}; latency ms p50 "
          f"{q[0]:.4f} p95 {q[1]:.4f} p99 {q[2]:.4f} max {q[3]:.4f}; host ms a step (mean, p99): "
          f"input {host['input'].mean():.4f}, {np.percentile(host['input'], 99):.4f}; step "
          f"{host['step'].mean():.4f}, {np.percentile(host['step'], 99):.4f}; setup "
          f"{setup_s:.3f} s: to the cell {setup_s - (t0 - marks['start']):.3f}, ring "
          f"{marks['ring'] - marks['start']:.3f}, library and capture "
          f"{marks['capture'] - marks['ring']:.3f}, warm-up {marks['warm'] - marks['capture']:.3f}",
          file=sys.stderr)


def run(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        root: Path = ROOT, control: bool = False) -> dict:
    """One run of one cell: the result line's object, with the compared
    numbers under ``checks``. ``control`` (``calibrate.py``) also reads the
    control and adds every element's readings under ``rows``."""
    cell = spec.cell(workload, root)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{cell.name} needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} present")
    _import_program()
    from tpuflow_torch.flow import GraphedStream
    from tpuflow_torch.io.stream import prefetch_to_device

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    cfg = _pyramid_config(cell.config)
    height, width = ((cell.config["height"], cell.config["width"]) if device == "cuda"
                     else CPU_SHAPE)
    traffic = cell.traffic
    batch = traffic["streams"]
    live = traffic["source"] == "live"
    lookahead = 0 if live else int(traffic["lookahead"])
    in_flight = 1 if live else int(traffic["in_flight"])

    marks = {"start": time.perf_counter()}
    ring = frames.make_ring(traffic, height, width, seed, dev)
    first = torch.from_numpy(ring[0] if batch > 1 else ring[0, 0]).to(dev)
    marks["ring"] = time.perf_counter()
    stream = GraphedStream(first, cfg) if device == "cuda" else EagerStream(first, cfg)
    marks["capture"] = time.perf_counter()
    levels_shape = tuple(stream.level_rounds.shape)
    acc_all = torch.zeros(levels_shape, dtype=torch.int64, device=dev)
    acc_traced = torch.zeros(levels_shape, dtype=torch.int64, device=dev)

    ends: dict[int, torch.cuda.Event] = {}
    cpu_end: dict[int, float] = {}  # the CPU rehearsal's steps end on the host
    span = contextlib.nullcontext

    def wait_for(k: int) -> None:  # a live camera: frame k once step k - 1 has ended
        if k - 1 in ends:
            with span("flowbench.wait"):
                ends[k - 1].synchronize()

    source = frames.Source(ring, first_step=1, wait_for=wait_for if live else None)
    uploads = prefetch_to_device(iter(source), lookahead=lookahead, device=dev)
    rng = np.random.default_rng([seed % 2**64, 0xC4EC])
    keep = _check_steps(batch, height * width)
    kept: list[tuple[int, torch.Tensor, torch.Tensor]] = []
    seen = 0
    host = {"input": {}, "step": {}}
    step_no = 1

    def one_step(acc: torch.Tensor, sample: bool) -> None:
        nonlocal step_no, seen
        k = step_no
        if not live and k - in_flight in ends:
            with span("flowbench.wait"):
                ends[k - in_flight].synchronize()
        with span("flowbench.input"):
            t_a = time.perf_counter()
            frame = next(uploads)
            t_b = time.perf_counter()
        with span("flowbench.step"):
            u, v = stream.step(frame)
            t_c = time.perf_counter()
        with span("flowbench.count"):
            acc.add_(stream.level_rounds)
            if device == "cuda":
                ends[k] = torch.cuda.Event(enable_timing=True)
                ends[k].record()
            else:
                cpu_end[k] = time.perf_counter()
        host["input"][k] = t_b - t_a - source.waited.get(k + lookahead, 0.0)
        host["step"][k] = t_c - t_b
        if sample:  # reservoir sample of the window's steps, drawn from the seed
            seen += 1
            if len(kept) < keep:
                kept.append((k, u, v))
            else:
                j = int(rng.integers(seen))
                if j < keep:
                    kept[j] = (k, u, v)
        step_no += 1

    def sync() -> None:
        if device == "cuda":
            torch.cuda.synchronize(dev)

    scratch = torch.zeros_like(acc_all)
    warm_until = time.perf_counter() + WARMUP_SECONDS[device]
    for i in itertools.count():
        if i >= WARMUP_STEPS[device] and time.perf_counter() >= warm_until:
            break
        one_step(scratch, sample=False)
    sync()
    marks["warm"] = time.perf_counter()

    def window(acc: torch.Tensor, until: float) -> list[int]:
        steps = []
        while time.perf_counter() < until:
            k = step_no
            one_step(acc, sample=True)
            steps.append(k)
        return steps

    e0 = None
    if device == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        e0.synchronize()
    t0 = time.perf_counter()
    setup_s = _AGE_AT_IMPORT + (t0 - _T_IMPORT)
    reduced = None
    traced_steps: list[int] = []
    if traced:
        # The host clock's steps first, with no profiler before them (its
        # teardown slows the host's later steps), then the profiled part.
        from torch.profiler import ProfilerActivity, profile, record_function

        traced_s = min(TRACE_SECONDS, seconds / 2)
        host_steps = window(acc_all, t0 + seconds - traced_s)
        sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda"
                                               else [])
        span = record_function
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                traced_steps = window(acc_traced, time.perf_counter() + traced_s)
                sync()
        span = contextlib.nullcontext
        if device == "cuda":
            reduced = trace.reduce(*trace.events(prof))
        del prof
        steps = host_steps + traced_steps
    else:
        steps = host_steps = window(acc_all, t0 + seconds)
    t_end = t0 + seconds if not traced else time.perf_counter()
    sync()

    # End of each step on the host clock, from its event and e0.
    done = {k: t0 + e0.elapsed_time(ends[k]) / 1e3 if e0 is not None else cpu_end[k]
            for k in steps}
    complete = [k for k in steps if done[k] <= t_end] if not traced else steps
    latencies = [done[k] - source.handed[k] for k in complete]
    memory_peak = (torch.cuda.max_memory_allocated(dev) if device == "cuda"
                   else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rounds_all = (acc_all + acc_traced).cpu().numpy()
    rounds_traced = acc_traced.cpu().numpy()

    record = {
        "device": device,
        "streams": batch,
        "seconds": seconds,
        "setup_s": setup_s,
        "frames": batch * len(complete),
        "latencies_s": latencies,
        "input_host_s": [host["input"][k] for k in host_steps],
        "step_host_s": [host["step"][k] for k in host_steps],
        "rounds": {"total": int(rounds_all.sum()), "frames": batch * len(steps)},
        "trace": None,
    }
    if reduced is not None:
        shapes = roofline.level_shapes(height, width, cfg.levels, cfg.scale_factor)
        record["trace"] = dict(reduced, frames=batch * len(traced_steps),
                               bound_s=roofline.bound_s(rounds_traced, shapes))

    if latencies:
        _diagnose(record, done, complete, steps, t0, t_end, setup_s, marks)

    # The check, once the window has closed and the program's state is freed.
    uploads.close()
    del stream, uploads, first
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = spec.reference(cell.config, root)
    t_check = time.perf_counter()
    readings = check.compare(kept, ring, cell.config["pyramid"], ref, dev, control=control)
    check_s = time.perf_counter() - t_check
    checks = check.judge(readings, cell.config["checks"])

    names = [m["name"] for m in (cell.per_layer if traced else cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    metrics = {}
    for name in names:
        value = spec.reader(name, root)(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
                "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": platform.processor() or platform.machine(),
                "count": 0, "memory_peak_bytes": int(memory_peak)}
    out = {
        "correct": bool(checks["correct"]),
        "attempted": batch * len(steps),
        "failed": int(checks["failed"]),
        "metrics": metrics,
        "device": info,
    }
    if traced and reduced is not None:
        info["busy_s"] = reduced["busy_s"]
        info["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    if control:
        out["rows"] = readings
    print(f"flowbench: {len(readings)} planes checked in {check_s:.2f} s", file=sys.stderr)
    out["checks"] = checks["numbers"]
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace), args.device)
    except NoCard as exc:
        print(f"flowbench: no result: {exc}", file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"flowbench: no result: loaded modules {bad} (jax, jaxlib, flax or tpuflow)",
              file=sys.stderr)
        return 3
    if args.device == "cuda":
        print(f"card: {_card_label()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
