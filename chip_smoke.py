#!/usr/bin/env python3
"""Smoke run of tpuflow_torch's main path on one NVIDIA GPU.

Drives the streaming pyramidal Lucas-Kanade path that serves frames,
``lucas_kanade_pyramidal_step`` with ``PYRAMID_CONFIGS["production"]`` and
``backend="cuda"``, on a stream of 8-bit 1080p frames, and checks each
hand-written CUDA kernel on it against its plain PyTorch version. Phases,
one line each (any failure raises and the script exits non-zero):

1. device: the card (name and power limit from nvidia-smi), the TF32 flags;
2. build: nvcc builds every kernel from tpuflow_torch/csrc/;
3. kernels: each kernel at the main path's shapes against its plain version
   on the card, with its median device time and the plain version's (CUDA
   events);
4. main path: 16 frames streamed through the kernels (launch counts reset
   just before, read just after), then the same stream through the plain
   versions on the card, compared frame by frame;
5. profile: device time by kernel and the device's busy share over 4
   frames (torch.profiler).

Limits on the card: the warps (K1, K2) bit-exact against their plain
versions; the refine (K3) u, v within 1e-5 px and its sums to rtol 1e-5
(block partials summed in another order); the stream: the same rounds per
level on every frame and max |du|, |dv| <= 1e-3 px.

It prints one JSON object of the kernels' readings on the line before the
last, and ``{"ok": true, "device": {...}}`` as the last line. Frames are
made from ``--seed`` with numpy and scipy. Needs one CUDA device; fails
without one. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as nd_shift

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step
from tpuflow_torch.core import ops
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import _build, launch_counts, lk, reset_launch_counts, torch_ref, warp

HEIGHT, WIDTH = 1080, 1920
N_FRAMES = 16
SHIFT_PX = 2.0
STREAM_ATOL = 1e-3
REFINE_ATOL = 1e-5
SUM_RTOL = 1e-5
KERNELS = {
    "warp_packed_u8": ("tpuflow_torch/csrc/warp.cu", "tpuflow/kernels/pallas_warp.py:498"),
    "warp_packed_u16": ("tpuflow_torch/csrc/warp.cu", "tpuflow/kernels/pallas_warp.py:498"),
    "lk_refine": ("tpuflow_torch/csrc/lk_refine.cu", "tpuflow/kernels/pallas_lk.py:573"),
}


def make_frames(seed: int, height: int = HEIGHT, width: int = WIDTH):
    """An 8-bit textured frame and the same frame shifted right by 2 px
    (gray-128 fill): integer gray levels, the production config's contract."""
    rng = np.random.default_rng(seed)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (height, width)), 2.0))
    b = nd_shift(a, (0.0, SHIFT_PX), order=1, mode="constant", cval=128.0)
    return a.astype(np.float32), b.astype(np.float32)


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check_kernels(dev, a, b, rng):
    """Phase 3: every kernel at the path's shapes against its plain version."""
    cfg = PYRAMID_CONFIGS["production"]
    pyr_a = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    pyr_b = torch_ref.build_gaussian_pyramid(b, cfg.levels, cfg.scale_factor)
    readings = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for level in reversed(range(cfg.levels)):
        prev, curr = pyr_a[level], pyr_b[level]
        shape = tuple(prev.shape)
        flow = [torch.from_numpy(rng.uniform(-9.0, 9.0, shape).astype(np.float32)).to(dev)
                for _ in range(2)]
        packing = "u8" if level == cfg.levels - 1 else "u16"
        name = f"warp_packed_{packing}"
        for band in (2, 3, 8):
            args = (curr, *flow, cfg.max_disp, band, packing)
            got, want = warp.warp_banded(*args), warp.warp_banded_ref(*args)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            if err != 0.0:
                raise AssertionError(f"{name} band {band} at {shape}: max |d| {err} != 0")
        args = (curr, *flow, cfg.max_disp, 8, packing)
        ms = time_ms(lambda: warp.warp_banded(*args))
        plain_ms = time_ms(lambda: warp.warp_banded_ref(*args))
        print(f"[kernels] {name} {shape[0]}x{shape[1]}: bit-exact at bands 2/3/8, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms)")
        if "ms" not in readings[name]:  # the largest shape on the path
            readings[name].update(ms=ms, plain_ms=plain_ms, shape=list(shape))

        warped = warp.warp_banded(*args)
        err = sums_rel = 0.0
        for frozen in (False, True):
            conv = torch.tensor(frozen, device=dev)
            rargs = (prev, warped, *flow, conv, cfg.window_size, cfg.det_threshold, 8.0, 3.0)
            got, want = lk.lucas_kanade_refine(*rargs), lk.lucas_kanade_refine_ref(*rargs)
            torch.cuda.synchronize()
            err = max(err, max_abs(got[0], want[0]), max_abs(got[1], want[1]))
            sums_rel = max(sums_rel, *(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                                       for g, w in zip(got[2:], want[2:])))
            if err > REFINE_ATOL or sums_rel > SUM_RTOL:
                raise AssertionError(
                    f"lk_refine at {shape} converged={frozen}: max |d| {err}, sums rel {sums_rel}"
                )
            readings["lk_refine"]["max_abs_err"] = max(readings["lk_refine"]["max_abs_err"], err)
        conv = torch.tensor(False, device=dev)
        rargs = (prev, warped, *flow, conv, cfg.window_size, cfg.det_threshold, 8.0, 3.0)
        ms = time_ms(lambda: lk.lucas_kanade_refine(*rargs))
        plain_ms = time_ms(lambda: lk.lucas_kanade_refine_ref(*rargs))
        print(f"[kernels] lk_refine {shape[0]}x{shape[1]}: max |d| {err:.3g} px, "
              f"sums rel {sums_rel:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms)")
        if "ms" not in readings["lk_refine"]:
            readings["lk_refine"].update(ms=ms, plain_ms=plain_ms, shape=list(shape))
    return readings


@contextmanager
def plain_versions():
    """Swap each kernel wrapper for its plain PyTorch version."""
    saved = warp.warp_banded, lk.lucas_kanade_refine
    warp.warp_banded, lk.lucas_kanade_refine = warp.warp_banded_ref, lk.lucas_kanade_refine_ref
    try:
        yield
    finally:
        warp.warp_banded, lk.lucas_kanade_refine = saved


def run_stream(a, b, n_frames: int = N_FRAMES):
    """Stream n frames (b, a, b, ...) through the production path. Returns
    the flows, the rounds per level of each frame and the seconds taken."""
    cfg = PYRAMID_CONFIGS["production"]
    carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    flows, rounds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        u, v, carry = lucas_kanade_pyramidal_step(carry, b if i % 2 == 0 else a, cfg,
                                                  backend="cuda")
        flows.append((u, v))
        rounds.append(list(pyramidal.counters.level_iterations))
    torch.cuda.synchronize()
    return flows, rounds, time.perf_counter() - t0


def mean_epe(flows, margin: int = 32) -> float:
    """Mean end-point error on the interior against the known shift: +2 px
    for a->b pairs, -2 px for b->a."""
    errs = []
    for i, (u, v) in enumerate(flows):
        truth = SHIFT_PX if i % 2 == 0 else -SHIFT_PX
        du = u[margin:-margin, margin:-margin] - truth
        dv = v[margin:-margin, margin:-margin]
        errs.append(float(torch.sqrt(du * du + dv * dv).mean()))
    return float(np.mean(errs))


def profile_stream(a, b) -> None:
    """Device time by kernel and the device's busy share over a 4-frame
    stream (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_stream(a, b, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, seconds = run_stream(a, b, 4)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] 4 frames under the profiler: wall {1000 * seconds / 4:.3f} ms/frame, "
          f"device busy {busy_us / 4000:.3f} ms/frame ({100 * busy_us / 1e6 / seconds:.1f}%)")
    print(f"[profile] {'device us/frame':>15} {'calls/frame':>11}  kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"[profile] {e.self_device_time_total / 4:15.1f} {e.count / 4:11.1f}  {e.key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ops.pin_f32_matmul()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {_build.library_path().name} ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)")

    # 3. kernels
    fa, fb = make_frames(args.seed)
    a, b = torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev)
    rng = np.random.default_rng(args.seed + 1)
    readings = check_kernels(dev, a, b, rng)

    # 4. main path
    run_stream(a, b, 2)  # warm-up: cuBLAS handles, operator blocks on the card
    reset_launch_counts()
    pyramidal.counters.reset()
    flows, rounds, seconds = run_stream(a, b)
    counts = launch_counts()
    reads = (pyramidal.counters.convergence_reads, pyramidal.counters.band_reads)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for u, v in flows:
        finite = bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())
        if u.shape != (HEIGHT, WIDTH) or not finite:
            raise AssertionError("main path gave non-finite or misshapen flow")
    epe = mean_epe(flows)
    print(f"[main] {N_FRAMES} frames {HEIGHT}x{WIDTH} production: "
          f"{N_FRAMES / seconds:.2f} frames/s ({1000 * seconds / N_FRAMES:.3f} ms/frame), "
          f"launches {counts}, host reads convergence={reads[0]} band={reads[1]}, "
          f"rounds per level {rounds}, mean EPE {epe:.4f} px")

    with plain_versions():
        plain_flows, plain_rounds, plain_seconds = run_stream(a, b)
    if launch_counts() != counts:
        raise AssertionError("the plain run launched a kernel")
    if plain_rounds != rounds:
        raise AssertionError(f"rounds per level differ: kernels {rounds}, plain {plain_rounds}")
    diff = max(max(max_abs(u, pu), max_abs(v, pv))
               for (u, v), (pu, pv) in zip(flows, plain_flows))
    print(f"[main] plain versions on the card: {N_FRAMES / plain_seconds:.2f} frames/s, "
          f"same rounds on every frame, max |du|,|dv| vs kernels {diff:.3g} px, "
          f"mean EPE {mean_epe(plain_flows):.4f} px")
    if diff > STREAM_ATOL:
        raise AssertionError(f"stream differs from the plain path by {diff} px > {STREAM_ATOL}")
    if epe > 0.5:
        raise AssertionError(f"mean EPE {epe} px against the known {SHIFT_PX} px shift")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was enabled on the main path")

    # 5. profile
    profile_stream(a, b)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": counts[name],
         **readings[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
