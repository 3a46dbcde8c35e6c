"""Device timing and the card's label, shared by ``chip_smoke.py``, the
stage profiler and the ablations.

``device_ms`` times a callable on the card with CUDA events around
back-to-back calls that queue behind a GPU spin, so the host's launch
overhead does not show in the reading. ``card_label`` is the card's name
and power limit as ``nvidia-smi`` gives them; every time this package
prints carries it.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def device_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the device time of one call, each batch
    timed with CUDA events around ``reps`` back-to-back calls. The calls
    queue behind a GPU spin that outlasts their enqueue, so the host's
    launch overhead does not show in the reading."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    readings = []
    for _ in range(batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * enqueue_s * 2.0e9) + 1_000_000)  # ~4x the enqueue at 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / reps)
    return statistics.median(readings)


def card_label() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def require_cuda() -> torch.device:
    """The first CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on a GPU unless the CPU is asked for")
    return torch.device("cuda", 0)
