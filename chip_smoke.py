#!/usr/bin/env python3
"""Smoke run of tpuflow_torch's main paths on one NVIDIA GPU.

Drives, with ``backend="cuda"`` on 8-bit 1080p frames, the streaming
pyramidal Lucas-Kanade path that serves frames
(``lucas_kanade_pyramidal_step``) with ``PYRAMID_CONFIGS["production"]``
(K1, K2, K3) and with ``PYRAMID_CONFIGS["default"]`` (K4, K5), and
single-scale flow (``lucas_kanade_single_scale``, K6, and with
``return_confidence``, K7); then the measurement entry points: the batched
kernel API with ``window_mxu`` (K10), the shift ablation (K8), the
warp-gather ablation (K9) and the stage profiler; then the 13-pattern
verifier gate (``tpuflow_torch.eval.verifier``) for every config with a
committed fast-path baseline. Each hand-written CUDA kernel is checked
against its plain PyTorch version. Phases, one line each or more (any
failure raises and the script exits non-zero):

1. device: the card (name and power limit from nvidia-smi), the TF32 flags;
2. build: nvcc builds every kernel from tpuflow_torch/csrc/ (and, where
   cuobjdump is present, counts the tensor-core mma instructions);
3. kernels: each kernel at the main paths' shapes against its plain version
   on the card, with its median device time and the plain version's (CUDA
   events); the warps (K1, K2, K4) at every level of both pyramids, on the
   plane and a B=2 batch, timed at each level beside the kernel's other
   block (forced), the walk ablation (``ablation.warp_walk``) at three
   walk lengths and an empty kernel's launch floor; K1-K7 also as batches
   of two 1080p planes (each element against the plain version and
   against the kernel's 2-D launch); K10 at
   windows 3/5/7, exact and relaxed Sobel, on a plane and a batch of two,
   timed at each window beside K6, K7 and K3, with the mma.sync count of
   a call from its grid; K8 in its four kinds and K9 in both modes, each
   timed beside an empty kernel's launch floor read in the same phase
   (their bounds lie below one launch), with the time above the floor;
4. main paths: each path run with the launch counts reset just before and
   read just after; the two streams (16 frames each) also run through the
   plain versions on the card and are compared frame by frame; the
   window_mxu kernel API on a 1080p batch; the two ablations' own
   measurements (their JSON and lines printed); the profiler's 1080p
   ``production`` report;
5. gate: the 13-pattern suite through both LK modes for each config with a
   committed Pallas baseline, within 10% of it (provenance guard included);
6. profile: device time by kernel and the device's busy share over 4 frames
   of each stream (torch.profiler).

Limits on the card: the warps (K1, K2, K4) bit-exact against their plain
versions at vertical bands 0/2/3/8/31 and at md = mdv = 0 and 31 (K4 with
clamp_flow on and off), each batch element equal to its 2-D launch; the refine steps
(K3, K5) u, v bit-identical (max |d| 0) and their sums to rtol 1e-5 (block
partials summed in another order); the single-scale solves (K6, K7) u, v
and |det| bit-identical; a batch element bit-identical to the kernel's 2-D
launch; K10
(tensor-core sums, which round otherwise than the plain version's
torch.matmul) u, v within 2e-3 / 2e-4 / 5e-5 px at windows 3 / 5 / 7
(widened, with the readings and the reason, at MXU_ATOL), and no further
from an f64 solve than its plain version, |det| within 2e-6 of the
plane's largest, sums to rtol 1e-5; K8 (also on a 2^+-20-spread input)
and K9 (also with offsets in +-200) bit-exact; each stream: the same
rounds per level on every frame, max |du|, |dv| <= 1e-3 px, mean EPE <
0.5 px against the 2 px shift; the gate:
every pattern within 10%, no_motion exactly 0 in both modes for the
configs without packed-u16 warps, and the production configs' no_motion
floor in (0, 1e-3) px.

Each kernel's time is printed beside its bound (``eval/bounds.py``: the
bytes one call must move over the card's 3.35 TB/s) and its share of it;
the build prints ptxas's registers, spills and shared memory of the LK
column-walk kernels, of each banded-warp instantiation and of each K10
instantiation, the HMMA instructions in each K10 instantiation, the
ablation instantiations' registers, spills and shared memory, their
shared loads (LDS) a thread and K9's select instructions a pixel. It
prints one JSON object of the kernels' readings on the line before the
last (time, plain version's time, bytes, bound,
share, launches on the main path and per stream frame, and a one-call
PyTorch yardstick's time where one exists, else null with the reason),
and ``{"ok": true, "device": {...}}`` as the last line. Frames are
made from ``--seed`` with numpy and scipy; the suite is the committed
fixture. Needs one CUDA device; fails without one. Run:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as nd_shift

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step, lucas_kanade_single_scale
from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation, warp_walk
from tpuflow_torch.core import ops
from tpuflow_torch.eval import bounds, profile, verifier
from tpuflow_torch.eval.timing import card_label, device_ms
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import _build, lk, torch_ref, warp

HEIGHT, WIDTH = 1080, 1920
N_FRAMES = 16
SHIFT_PX = 2.0
STREAM_ATOL = 1e-3
SUM_RTOL = 1e-5
WARP_CU = "tpuflow_torch/csrc/warp.cu"
REFINE_CU = "tpuflow_torch/csrc/lk_refine.cu"
FUSED_CU = "tpuflow_torch/csrc/lk_fused.cu"
MXU_CU = "tpuflow_torch/csrc/lk_mxu.cu"
ABLATION_CU = "tpuflow_torch/csrc/ablation.cu"
KERNELS = {
    "warp_packed_u8": (WARP_CU, "tpuflow/kernels/pallas_warp.py:498"),
    "warp_packed_u16": (WARP_CU, "tpuflow/kernels/pallas_warp.py:498"),
    "warp_exact": (WARP_CU, "tpuflow/kernels/pallas_warp.py:498"),
    "lk_refine": (REFINE_CU, "tpuflow/kernels/pallas_lk.py:573"),
    "lk_refine_exact": (REFINE_CU, "tpuflow/kernels/pallas_lk.py:573"),
    "lk_fused": (FUSED_CU, "tpuflow/kernels/pallas_lk.py:460"),
    "lk_fused_conf": (FUSED_CU, "tpuflow/kernels/pallas_lk.py:460"),
    "lk_refine_mxu": (MXU_CU, "tpuflow/kernels/pallas_lk.py:139"),
    "lk_fused_mxu": (MXU_CU, "tpuflow/kernels/pallas_lk.py:139"),
    "lk_fused_conf_mxu": (MXU_CU, "tpuflow/kernels/pallas_lk.py:139"),
    "shift_ablation": (ABLATION_CU, "scripts/shift_ablation.py:82"),
    "warp_mxu_ablation": (ABLATION_CU, "scripts/warp_mxu_ablation.py:91"),
}
# The kernels each main path must launch, and no others.
# One PyTorch call that computes the same function as a kernel, where one
# exists: only the shift ablation's shifted adds, as one correlation (the
# slices' offsets as a sparse weight). The others have none: the LK solve
# (Sobel, five window sums, the gated solve, clip and latch), the banded
# warps (flow clip, column band clamp, packed corner decodes) and K9's
# 18-step candidate gather-accumulate are no single library call.
NO_LIBRARY_CALL = {
    "warp_packed_u8": "no single PyTorch call warps with the band clamps and the u8 corner decode",
    "warp_packed_u16": "no single PyTorch call warps with the band clamps and the 8.8 corner decode",
    "warp_exact": "grid_sample has neither the flow clip nor the column band clamp",
    "lk_refine": "no single PyTorch call computes the LK solve with its clip and latch",
    "lk_refine_exact": "no single PyTorch call computes the LK solve with its clip and latch",
    "lk_fused": "no single PyTorch call computes the LK solve",
    "lk_fused_conf": "no single PyTorch call computes the LK solve",
    "lk_refine_mxu": "no single PyTorch call computes the LK solve with its clip and latch",
    "lk_fused_mxu": "no single PyTorch call computes the LK solve",
    "lk_fused_conf_mxu": "no single PyTorch call computes the LK solve",
    "warp_mxu_ablation": "no single PyTorch call does the 18-step gather-accumulate",
}
PATH_KERNELS = {
    "production stream": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "default stream": {"warp_exact", "lk_refine_exact"},
    "single scale": {"lk_fused"},
    "single scale + confidence": {"lk_fused_conf"},
    "batched kernel API, window_mxu": {"lk_refine_mxu", "lk_fused_mxu", "lk_fused_conf_mxu"},
    "shift ablation": {"shift_ablation"},
    "warp gather ablation": {"warp_mxu_ablation"},
}
# K10's tensor-core sums against the plain version's torch.matmul, u, v in
# px by window. The first limits asked, 1e-4 / 1e-5 / 1e-5, hold on the
# 8-bit frames (max |d| 0) and in tests/test_torch_gpu.py, but not on the
# blurred float frames at 1080p, where the card read 6.4e-4 px (exact
# Sobel, pixel (495, 1474), det 13.4 against a median of 460) and 9.0e-4
# px (relaxed, (1069, 411), det 18.5) at window 3, 7.8e-5 px at window 5
# and 2.4e-5 px at window 7. Those are the plain version's own f32
# rounding at weakly conditioned windows: against an f64 solve K10 is the
# closer of the two (window 3: both 1.2e-3 px; window 5: 5.0e-5 against
# 6.1e-5; window 7: 1.3e-5 against 2.5e-5), which check_mxu re-checks. So
# each limit is about twice the plain version's own error against f64.
MXU_ATOL = {3: 2e-3, 5: 2e-4, 7: 5e-5}
MMA_FLOP = 2 * 16 * 8 * 8  # one m16n8k8 mma.sync
TF32_FLOPS = 495e12  # the H100 SXM's dense TF32 tensor-core rate (NVIDIA's data sheet)
DET_RTOL = 2e-6  # of the plane's largest |det|
# The warps' vertical bands (the adaptive ladder's 2/3/8, none, the widest).
WARP_BANDS = (0, 2, 3, 8, 31)
MAX_BAND = warp.MAX_BAND
_COUNTS = (warp.launch_counts, lk.launch_counts, shift_ablation.launch_counts,
           warp_mxu_ablation.launch_counts)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel, the ablations' included."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


def make_frames(seed: int, height: int = HEIGHT, width: int = WIDTH):
    """An 8-bit textured frame and the same frame shifted right by 2 px
    (gray-128 fill): integer gray levels, the production config's contract."""
    rng = np.random.default_rng(seed)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (height, width)), 2.0))
    b = nd_shift(a, (0.0, SHIFT_PX), order=1, mode="constant", cval=128.0)
    return a.astype(np.float32), b.astype(np.float32)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _flow(rng, shape, reach, dev):
    return [torch.from_numpy(rng.uniform(-reach, reach, shape).astype(np.float32)).to(dev)
            for _ in range(2)]


def _record(readings, name, ms, plain_ms, shape):
    if "ms" not in readings[name]:  # the largest shape on the path
        readings[name].update(ms=ms, plain_ms=plain_ms, shape=list(shape))


def _bound_note(name: str, shape, ms: float) -> str:
    """The kernel's bound at a (H, W) or (B, H, W) shape, and ms's share."""
    dims = (1, *shape) if len(shape) == 2 else tuple(shape)
    bound_ms, by = bounds.bound(name, *dims)
    return f"bound {bound_ms:.5f} ms ({by}), {100 * bound_ms / ms:.1f}% of it"


def check_warp(readings, name, curr, packing, max_disp, rng, dev):
    """K1, K2 or K4 at one pyramid level against the plain version, max |d|
    0: vertical bands 0/2/3/8/31 beside the config's horizontal one, and
    both bands 0 and 31; clamp_flow on (flows to 3 px past the band) and,
    for K4, off (40 px past it); the plane and a B=2 batch, each element
    also against its 2-D launch. Then its device time at band 8 beside the
    plain version's, its bound and its block. Returns that flow and the
    warp's keyword arguments."""
    shape = tuple(curr.shape)
    pair = torch.stack([curr, curr.flip(0)])
    bands = [(max_disp, mdv) for mdv in WARP_BANDS] + [(0, 0), (MAX_BAND, MAX_BAND)]
    for clamp in ((True, False) if packing == "exact" else (True,)):
        for md, mdv in bands:
            reach = max(md, mdv) + (3 if clamp else 40)
            for img in (curr, pair):
                flow = _flow(rng, tuple(img.shape), reach, dev)
                wkw = dict(max_disp=md, clamp_flow=clamp, max_disp_v=mdv, packing=packing)
                got = warp.warp_banded(img, *flow, **wkw)
                torch.cuda.synchronize()
                err = max_abs(got, warp.warp_banded_ref(img, *flow, **wkw))
                if err != 0.0:
                    raise AssertionError(f"{name} clamp_flow={clamp} bands ({md}, {mdv}) at "
                                         f"{tuple(img.shape)}: max |d| {err} != 0")
                if img.ndim == 3:
                    _equal_per_element(name, (got,), lambda i: (img[i], flow[0][i], flow[1][i]),
                                       warp.warp_banded, wkw)
    flow = _flow(rng, shape, 9.0, dev)
    wkw = dict(max_disp=max_disp, clamp_flow=True, max_disp_v=8, packing=packing)
    # The kernel, its other block (forced) and the walk ablation at 16, 32
    # and 64 rows a walk, each bit-exact first, then timed on the same
    # inputs: the reason for the block each plane gets, measured in this run.
    walk = warp_walk.measure(curr, *flow, max_disp, 8, packing)
    ms = walk["kernel_ms"]
    plain_ms = device_ms(lambda: warp.warp_banded_ref(curr, *flow, **wkw))
    geo = warp.tile_geometry(*shape, max_disp, 8)
    block = (f"staged {geo['tile_w']}x{geo['rows']} tiles, {geo['smem_bytes']} B of shared "
             "memory" if geo["staged"] else f"gathers in {geo['tile_w']}x{geo['rows']} blocks")
    walks = "/".join(f"{walk[f'walk_{n}_ms']:.4f}" for n in warp_walk.WALKS)
    print(f"[kernels] {name} {shape[0]}x{shape[1]}: bit-exact at (md, mdv) {bands}, clamp_flow "
          f"{'on and off' if packing == 'exact' else 'on'}, plane and B=2; {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms; {_bound_note(name, shape, ms)}); {block}, {geo['threads']} "
          f"threads; {'gathering' if geo['staged'] else 'staged'} instead "
          f"{walk['other_block_ms']:.4f} ms; walk ablation "
          f"{'/'.join(map(str, warp_walk.WALKS))} rows a walk {walks} ms; launch floor "
          f"{walk['launch_floor_ms']:.4f} ms")
    readings[name].setdefault("by_shape", {})[f"{shape[0]}x{shape[1]}"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds.bound(name, 1, *shape)[0],
        "other_block_ms": walk["other_block_ms"],
        "walk_ms": {n: walk[f"walk_{n}_ms"] for n in warp_walk.WALKS},
        "launch_floor_ms": walk["launch_floor_ms"], **geo}
    _record(readings, name, ms, plain_ms, shape)
    return flow, wkw


def check_refine(readings, name, rargs_base, rkw, dev, shape, windows):
    """The refine kernel against its plain version, converged or not, at each
    window; returns the max |du|, |dv| and the sums' max relative error."""
    err = sums_rel = 0.0
    for window in windows:
        for frozen in (False, True):
            conv = torch.tensor(frozen, device=dev)
            rargs = rargs_base(conv)
            got = lk.lucas_kanade_refine(*rargs, window_size=window, **rkw)
            want = lk.lucas_kanade_refine_ref(*rargs, window_size=window, **rkw)
            torch.cuda.synchronize()
            err = max(err, max_abs(got[0], want[0]), max_abs(got[1], want[1]))
            sums_rel = max(sums_rel, *(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                                       for g, w in zip(got[2:], want[2:])))
            if err != 0.0 or sums_rel > SUM_RTOL:
                raise AssertionError(f"{name} at {shape} window {window} converged={frozen}: "
                                     f"max |d| {err}, sums rel {sums_rel}")
    readings[name]["max_abs_err"] = max(readings[name]["max_abs_err"], err)
    return err, sums_rel


def check_kernels(dev, a, b, rng):
    """Phase 3: every kernel at the paths' shapes against its plain version."""
    readings = {name: {"max_abs_err": 0.0} for name in KERNELS}

    # K1, K2, K3 at the production pyramid's levels.
    cfg = PYRAMID_CONFIGS["production"]
    pyr_a = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    pyr_b = torch_ref.build_gaussian_pyramid(b, cfg.levels, cfg.scale_factor)
    for level in reversed(range(cfg.levels)):
        prev, curr = pyr_a[level], pyr_b[level]
        shape = tuple(prev.shape)
        packing = "u8" if level == cfg.levels - 1 else "u16"
        flow, wkw = check_warp(readings, f"warp_packed_{packing}", curr, packing, cfg.max_disp,
                               rng, dev)
        warped = warp.warp_banded(curr, *flow, **wkw)
        # The window repair (3, 7) is checked once, at the finest level.
        windows = (3, 5, 7) if level == cfg.levels - 1 else (5,)
        rkw = dict(det_threshold=cfg.det_threshold, max_disp=8.0, max_disp_v=3.0,
                   relaxed_order=True)
        err, sums_rel = check_refine(readings, "lk_refine",
                                     lambda conv: (prev, warped, *flow, conv), rkw, dev, shape,
                                     windows)
        rargs = (prev, warped, *flow, torch.tensor(False, device=dev))
        rkw["window_size"] = cfg.window_size
        ms = device_ms(lambda: lk.lucas_kanade_refine(*rargs, **rkw))
        plain_ms = device_ms(lambda: lk.lucas_kanade_refine_ref(*rargs, **rkw))
        print(f"[kernels] lk_refine {shape[0]}x{shape[1]} windows {windows}: max |d| {err:.3g} "
              f"px, sums rel {sums_rel:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms; "
              f"{_bound_note('lk_refine', shape, ms)})")
        _record(readings, "lk_refine", ms, plain_ms, shape)

    # K4, K5 at the default pyramid's levels (float gray levels).
    cfg = PYRAMID_CONFIGS["default"]
    pyr_a = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    pyr_b = torch_ref.build_gaussian_pyramid(b, cfg.levels, cfg.scale_factor)
    for level in reversed(range(cfg.levels)):
        prev, curr = pyr_a[level], pyr_b[level]
        shape = tuple(prev.shape)
        flow, wkw = check_warp(readings, "warp_exact", curr, "exact", cfg.max_disp, rng, dev)
        warped = warp.warp_banded(curr, *flow, **wkw)
        windows = (3, 5, 7) if level == cfg.levels - 1 else (5,)
        rkw = dict(det_threshold=cfg.det_threshold, max_disp=8.0, max_disp_v=8.0,
                   relaxed_order=False)
        err, sums_rel = check_refine(readings, "lk_refine_exact",
                                     lambda conv: (prev, warped, *flow, conv), rkw, dev, shape,
                                     windows)
        rargs = (prev, warped, *flow, torch.tensor(False, device=dev))
        rkw["window_size"] = cfg.window_size
        ms = device_ms(lambda: lk.lucas_kanade_refine(*rargs, **rkw))
        plain_ms = device_ms(lambda: lk.lucas_kanade_refine_ref(*rargs, **rkw))
        print(f"[kernels] lk_refine_exact {shape[0]}x{shape[1]} windows {windows}: max |d| "
              f"{err:.3g} px, sums rel {sums_rel:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms; "
              f"{_bound_note('lk_refine_exact', shape, ms)})")
        _record(readings, "lk_refine_exact", ms, plain_ms, shape)
    floor_ms = device_ms(_build.launch_empty)
    print(f"[kernels] launch floor: one empty kernel of the library {floor_ms:.4f} ms "
          "(device_ms, as every time here); no kernel time can fall below it")
    for name in ("warp_packed_u8", "warp_packed_u16", "warp_exact"):
        readings[name]["launch_floor_ms"] = floor_ms

    # K6, K7 at 1080p: exact and relaxed, windows 3/5/7, taps at window 5.
    shape = tuple(a.shape)
    for conf, name in ((False, "lk_fused"), (True, "lk_fused_conf")):
        err = 0.0
        for relaxed in (False, True):
            for window, taps in ((3, False), (5, False), (7, False), (5, True)):
                fkw = dict(window_size=window, gaussian_weights=taps, return_confidence=conf,
                           relaxed_order=relaxed)
                got = lk.lucas_kanade_fused(a, b, **fkw)
                want = lk.lucas_kanade_fused_ref(a, b, **fkw)
                torch.cuda.synchronize()
                err = max(err, *(max_abs(g, w) for g, w in zip(got, want)))
                if err != 0.0:
                    raise AssertionError(f"{name} window {window} taps={taps} "
                                         f"relaxed={relaxed}: max |d| {err}")
        readings[name]["max_abs_err"] = err
        fkw = dict(window_size=5, return_confidence=conf)
        ms = device_ms(lambda: lk.lucas_kanade_fused(a, b, **fkw))
        plain_ms = device_ms(lambda: lk.lucas_kanade_fused_ref(a, b, **fkw))
        print(f"[kernels] {name} {shape[0]}x{shape[1]}: exact and relaxed, windows 3/5/7, "
              f"taps at 5: max |d| {err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms; "
              f"{_bound_note(name, shape, ms)})")
        _record(readings, name, ms, plain_ms, shape)

    check_batched(dev, a, b, rng, readings)
    check_mxu(dev, a, b, rng, readings)
    check_ablations(dev, readings)
    return readings


def _equal_per_element(name, got, args_of, fn, kw):
    """Each batch element of a kernel's outputs equals its 2-D launch, the
    positional arguments of element b from ``args_of(b)``, the keywords
    ``kw``."""
    for b in range(got[0].shape[0]):
        single = fn(*args_of(b), **kw)
        single = single if isinstance(single, tuple) else (single,)
        for g, w in zip(got, single):
            if not torch.equal(g[b], w):
                raise AssertionError(f"{name}: batch element {b} differs from its 2-D launch")


def check_batched(dev, a, b, rng, readings):
    """Phase 3, batches: K1-K7 on two 1080p planes (the coarse level for
    K2), each element against the plain version and the kernel's own 2-D
    launch; the refine's B=2 time (its block partials summed per element)
    goes into its readings as ``batch2_ms``."""
    pair = torch.stack([a, b])
    swap = torch.stack([b, a])
    shape = tuple(pair.shape)
    cfg = PYRAMID_CONFIGS["production"]
    coarse = torch.stack([torch_ref.build_gaussian_pyramid(f, 2, cfg.scale_factor)[0]
                          for f in (a, b)])
    cases = [("warp_packed_u8", pair, dict(max_disp_v=3, packed_u8=True)),
             ("warp_packed_u16", coarse, dict(max_disp_v=3, packed_u16=True)),
             ("warp_exact", pair, dict(max_disp_v=8)),
             ("warp_exact", pair, dict(max_disp_v=3, clamp_flow=False))]
    for name, img, wkw in cases:
        wkw = dict(max_disp=8, clamp_flow=True) | wkw
        flow = [torch.from_numpy(rng.uniform(-12, 12, img.shape).astype(np.float32)).to(dev)
                for _ in range(2)]
        got = warp.warp_banded(img, *flow, **wkw)
        torch.cuda.synchronize()
        err = max_abs(got, warp.warp_banded_ref(img, *flow, **wkw))
        if err != 0.0:
            raise AssertionError(f"batched {name} {wkw}: max |d| {err} != 0")
        _equal_per_element(name, (got,), lambda i: (img[i], flow[0][i], flow[1][i]),
                           warp.warp_banded, wkw)
    ms = device_ms(lambda: warp.warp_banded(pair, *flow, **wkw))
    print(f"[kernels] batched warps, B=2: u8 and exact at {shape[1]}x{shape[2]}, u16 at "
          f"{coarse.shape[1]}x{coarse.shape[2]}: bit-exact, each element = its 2-D launch; "
          f"warp_exact B=2 {ms:.4f} ms")

    flow = _flow(rng, shape, 9.0, dev)
    conv = torch.tensor([False, True], device=dev)
    for relaxed, name in ((True, "lk_refine"), (False, "lk_refine_exact")):
        err = sums_rel = 0.0
        for window in (3, 5, 7):
            rkw = dict(window_size=window, max_disp=8.0, max_disp_v=3.0, relaxed_order=relaxed)
            got = lk.lucas_kanade_refine(pair, swap, *flow, conv, **rkw)
            want = lk.lucas_kanade_refine_ref(pair, swap, *flow, conv, **rkw)
            torch.cuda.synchronize()
            err = max(err, max_abs(got[0], want[0]), max_abs(got[1], want[1]))
            sums_rel = max(sums_rel, float(((got[2] - want[2]).abs() / want[2].abs()).max()),
                           float(((got[3] - want[3]).abs() / want[3].abs()).max()))
            if err != 0.0 or sums_rel > SUM_RTOL:
                raise AssertionError(f"batched {name} window {window}: max |d| {err}, "
                                     f"sums rel {sums_rel}")
            _equal_per_element(name, got, lambda i: (pair[i], swap[i], flow[0][i], flow[1][i],
                                                     conv[i:i + 1]),
                               lk.lucas_kanade_refine, rkw)
        rkw["window_size"] = 5
        ms = device_ms(lambda: lk.lucas_kanade_refine(pair, swap, *flow, conv, **rkw))
        readings[name]["batch2_ms"] = ms
        print(f"[kernels] batched {name}, B=2 at {shape[1]}x{shape[2]}, windows 3/5/7, one "
              f"element converged: max |d| {err:.3g} px, sums rel {sums_rel:.3g}, each element "
              f"= its 2-D launch; window 5 {ms:.4f} ms")

    for conf, name in ((False, "lk_fused"), (True, "lk_fused_conf")):
        err = 0.0
        for relaxed in (False, True):
            for window, taps in ((3, False), (5, False), (7, False), (5, True)):
                fkw = dict(window_size=window, gaussian_weights=taps, return_confidence=conf,
                           relaxed_order=relaxed)
                got = lk.lucas_kanade_fused(pair, swap, **fkw)
                want = lk.lucas_kanade_fused_ref(pair, swap, **fkw)
                torch.cuda.synchronize()
                err = max(err, *(max_abs(g, w) for g, w in zip(got, want)))
                if err != 0.0:
                    raise AssertionError(f"batched {name} window {window} taps={taps} "
                                         f"relaxed={relaxed}: max |d| {err}")
                _equal_per_element(name, got, lambda i: (pair[i], swap[i]),
                                   lk.lucas_kanade_fused, fkw)
        print(f"[kernels] batched {name}, B=2 at {shape[1]}x{shape[2]}, exact and relaxed, "
              f"windows 3/5/7, taps at 5: max |d| {err:.3g}, each element = its 2-D launch")


def _mxu_errors(got, want, window):
    """K10 against its plain version: the u, v error and its place, the
    |det| error relative to the plane's largest |det|, the sums' relative
    error; raises past the limits."""
    err, where = 0.0, None
    for g, w in zip(got[:2], want[:2]):
        d = (g - w).abs()
        if float(d.max()) > err:
            err = float(d.max())
            where = np.unravel_index(int(d.argmax()), tuple(d.shape))
    det_rel = sums_rel = 0.0
    if len(got) == 3:
        det_rel = max_abs(got[2], want[2]) / float(want[2].abs().max())
    if len(got) == 4:
        sums_rel = max(float(((g - w).abs() / w.abs()).max()) for g, w in zip(got[2:], want[2:]))
    if err > MXU_ATOL[window] or det_rel > DET_RTOL or sums_rel > SUM_RTOL:
        raise AssertionError(f"window {window}: max |du|,|dv| {err} at {where}, |det| rel "
                             f"{det_rel}, sums rel {sums_rel}")
    return err, det_rel, sums_rel


def check_mxu(dev, a, b, rng, readings):
    """Phase 3, K10: the window_mxu refine, fused and fused-with-|det|
    kernels at 1080p against their plain versions, on a plane and a batch of
    two, windows 3/5/7, exact and relaxed Sobel; timed beside K6 and K3.
    On the 8-bit frames every product is a multiple of 2^-8, and on these
    smooth frames the window sums stay small enough to be exact in f32, so
    any order of the adds gives the same sums; the same frames blurred
    (sigma 1, not rounded) make the tensor-core rounding show."""
    flow1 = _flow(rng, tuple(a.shape), 9.0, dev)
    flow2 = [torch.stack([f, f.flip(0)]) for f in flow1]
    inputs = []
    for frames, (fa, fb) in (("8-bit", (a, b)),
                             ("float", (ops.gaussian_filter(a, 1.0), ops.gaussian_filter(b, 1.0)))):
        inputs.append((frames, 1, fa, fb, flow1, torch.tensor(False, device=dev)))
        inputs.append((frames, 2, torch.stack([fa, fb]), torch.stack([fb, fa]), flow2,
                       torch.tensor([False, True], device=dev)))
    for name in ("lk_refine_mxu", "lk_fused_mxu", "lk_fused_conf_mxu"):
        worst = {frames: {3: 0.0, 5: 0.0, 7: 0.0} for frames in ("8-bit", "float")}
        det_rel = sums_rel = 0.0
        for frames, batch, p, c, flow, conv in inputs:
            for relaxed in (False, True):
                for window in (3, 5, 7):
                    kw = dict(window_size=window, relaxed_order=relaxed, window_mxu=True)
                    if name == "lk_refine_mxu":
                        kw.update(max_disp=8.0, max_disp_v=3.0)
                        got = lk.lucas_kanade_refine(p, c, *flow, conv, **kw)
                        want = lk.lucas_kanade_refine_ref(p, c, *flow, conv, **kw)
                    else:
                        kw["return_confidence"] = name == "lk_fused_conf_mxu"
                        got = lk.lucas_kanade_fused(p, c, **kw)
                        want = lk.lucas_kanade_fused_ref(p, c, **kw)
                    torch.cuda.synchronize()
                    try:
                        err, drel, srel = _mxu_errors(got, want, window)
                    except AssertionError as exc:
                        raise AssertionError(f"{name} {frames} frames B={batch} "
                                             f"relaxed={relaxed}: {exc}") from exc
                    worst[frames][window] = max(worst[frames][window], err)
                    det_rel, sums_rel = max(det_rel, drel), max(sums_rel, srel)
        readings[name]["max_abs_err"] = max(max(w.values()) for w in worst.values())
        readings[name]["max_abs_err_by_window"] = worst
        print(f"[kernels] {name} 1080x1920, plane and B=2, exact and relaxed: max |du|,|dv| "
              + "; ".join(f"{frames} frames {w[3]:.3g} / {w[5]:.3g} / {w[7]:.3g} px"
                          for frames, w in worst.items())
              + " at windows 3/5/7"
              + (f", |det| rel {det_rel:.3g}" if name == "lk_fused_conf_mxu" else "")
              + (f", sums rel {sums_rel:.3g}" if name == "lk_refine_mxu" else ""))

    # Accuracy against an f64 solve on the float frames: K10 no further from
    # it than its plain version (10% slack), K6 printed beside them.
    fa, fb = inputs[2][2], inputs[2][3]
    for relaxed in (False, True):
        errs = {}
        for window in (3, 5, 7):
            truth = lk.lucas_kanade_fused_ref(fa.double(), fb.double(), window,
                                              relaxed_order=relaxed)
            for label, out in (
                ("K10", lk.lucas_kanade_fused(fa, fb, window, relaxed_order=relaxed,
                                              window_mxu=True)),
                ("plain", lk.lucas_kanade_fused_ref(fa, fb, window, relaxed_order=relaxed,
                                                    window_mxu=True)),
                ("K6", lk.lucas_kanade_fused(fa, fb, window, relaxed_order=relaxed)),
            ):
                errs[label, window] = max(float((o.double() - t).abs().max())
                                          for o, t in zip(out, truth))
            if errs["K10", window] > 1.1 * errs["plain", window]:
                raise AssertionError(f"lk_fused_mxu relaxed={relaxed} window {window}: "
                                     f"{errs} against an f64 solve")
        print(f"[kernels] K10 against an f64 solve, float frames, relaxed={relaxed}: max "
              "|du|,|dv| at windows 3/5/7 " + "; ".join(
                  f"{label} " + " / ".join(f"{errs[label, w]:.3g}" for w in (3, 5, 7))
                  for label in ("K10", "plain", "K6")) + " px")

    # Device time at windows 3/5/7 beside the shift-sum kernels (the fused
    # solve in exact order, K6 and K7; the refine in relaxed order, K3) and
    # the plain version; window 5 is the kernel's reading.
    conv = torch.tensor(False, device=dev)
    pairs = {
        "lk_fused_mxu": ((a, b), {}, lk.lucas_kanade_fused, lk.lucas_kanade_fused_ref,
                         "lk_fused"),
        "lk_fused_conf_mxu": ((a, b), dict(return_confidence=True), lk.lucas_kanade_fused,
                              lk.lucas_kanade_fused_ref, "lk_fused_conf"),
        "lk_refine_mxu": ((a, b, *flow1, conv), dict(max_disp_v=3.0, relaxed_order=True),
                          lk.lucas_kanade_refine, lk.lucas_kanade_refine_ref, "lk_refine"),
    }
    mma = _build.load().tpuflow_lk_mxu_mma(HEIGHT, WIDTH)
    for name, (args, kw, fn, ref, shift_name) in pairs.items():
        by_window = {}
        for window in (3, 5, 7):
            wkw = dict(kw, window_size=window)
            shift_ms = device_ms(lambda: fn(*args, **wkw))
            ms = device_ms(lambda: fn(*args, **wkw, window_mxu=True))
            plain_ms = device_ms(lambda: ref(*args, **wkw, window_mxu=True))
            again_shift = device_ms(lambda: fn(*args, **wkw))
            by_window[window] = dict(ms=ms, plain_ms=plain_ms, beside={shift_name: [shift_ms,
                                                                             again_shift]})
            print(f"[kernels] {name} 1080x1920 window {window}: {ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms; {_bound_note(name, (HEIGHT, WIDTH), ms)}); {shift_name} "
                  f"in the same call {shift_ms:.4f} and {again_shift:.4f} ms")
        readings[name].update(shape=[HEIGHT, WIDTH], mma=mma, by_window=by_window,
                              **{k: by_window[5][k] for k in ("ms", "plain_ms", "beside")})
    flop = mma * MMA_FLOP
    print(f"[kernels] K10 issues {mma} mma.sync m16n8k8 a 1080x1920 call at every window "
          f"(from its grid), {flop / 1e9:.2f} GFLOP: {flop / TF32_FLOPS * 1e3:.4f} ms at the "
          f"card's {TF32_FLOPS / 1e12:.0f} TFLOP/s dense TF32")


def shift_adds_conv(a: torch.Tensor, kind: str):
    """The shift ablation's function as one PyTorch call, a correlation
    (``F.conv2d``, cuDNN with TF32 off) whose weight counts the slices at
    each (row, column) offset; and its arguments, made once."""
    r, c = shift_ablation.offsets(kind)
    offs = [(r[i], c[0]) for i in range(len(r))] + [(r[0], c[i]) for i in range(1, len(c))]
    kh, kw = max(o[0] for o in offs) + 1, max(o[1] for o in offs) + 1
    weight = torch.zeros((1, 1, kh, kw), dtype=torch.float32, device=a.device)
    for i, j in offs:
        weight[0, 0, i, j] += 1.0
    x = a[None, None, : shift_ablation.OUT_R + kh - 1, : shift_ablation.OUT_C + kw - 1]
    return lambda: torch.nn.functional.conv2d(x, weight)[0, 0]


def _ratio(a: float, b: float) -> float:
    """a / b of two times above the launch floor; nan where b is not above it."""
    return a / b if b > 0 else float("nan")


def _above_floor(ms: float, floor_ms: float, bound_ms: float) -> str:
    return (f"{ms:.5f} ms, {ms - floor_ms:.5f} above the floor, {100 * bound_ms / ms:.1f}% of "
            f"its bound {bound_ms:.5f}")


def check_ablations(dev, readings):
    """Phase 3, K8 and K9: every kind and mode bit-exact against the plain
    versions (K8 also on an input where another add order rounds
    otherwise, K9 also with offsets far past the band), then each timed
    beside the plain version and an empty kernel's launch floor read in this
    phase, with the time above the floor and the share of the bound; K8's
    aligned kind also beside one correlation call that computes the same
    sums."""
    a = shift_ablation.make_input(dev)
    spread = shift_ablation.make_input(dev, 1, spread=True)
    for kind in shift_ablation.KINDS:
        for inp in (a, spread):
            got = shift_ablation.shift_adds(inp, kind)
            want = shift_ablation.shift_adds_ref(inp, kind)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"shift_ablation {kind}: max |d| {max_abs(got, want)} != 0")
    floor_ms = device_ms(_build.launch_empty, reps=200)
    out = (shift_ablation.OUT_R, shift_ablation.OUT_C)
    by_kind = {}
    for kind in shift_ablation.KINDS:
        ms = device_ms(lambda kind=kind: shift_ablation.shift_adds(a, kind), reps=200)
        bound_ms = bounds.bound_ms("shift_ablation", 1, *out, kind)
        by_kind[kind] = {"ms": ms, "above_floor_ms": ms - floor_ms, "bound_ms": bound_ms}
        print(f"[kernels] shift_ablation {kind}: {_above_floor(ms, floor_ms, bound_ms)}")
    plain_ms = device_ms(lambda: shift_ablation.shift_adds_ref(a, "aligned"))
    ops.pin_f32_matmul()
    conv = shift_adds_conv(a, "aligned")
    conv_err = max_abs(conv(), shift_ablation.shift_adds_ref(a, "aligned"))
    if conv_err > 1e-4:
        raise AssertionError(f"shift_ablation's correlation differs by {conv_err}")
    library_ms = device_ms(conv)
    base = by_kind["aligned"]
    ratios = {f"{kind}_over_aligned": (r["ms"] / base["ms"],
                                       _ratio(r["above_floor_ms"], base["above_floor_ms"]))
              for kind, r in by_kind.items() if kind != "aligned"}
    readings["shift_ablation"].update(
        ms=base["ms"], plain_ms=plain_ms, shape=list(a.shape), library_ms=library_ms,
        library="torch.nn.functional.conv2d, cuDNN, TF32 off, the slices' offsets as a "
                "sparse (121, 897) weight", launch_floor_ms=floor_ms, by_kind=by_kind)
    print(f"[kernels] shift_ablation {tuple(a.shape)} -> {out}: bit-exact in all four kinds "
          f"(uniform and 2^+-20-spread inputs); aligned {base['ms']:.5f} ms (plain "
          f"{plain_ms:.4f} ms; {_bound_note('shift_ablation', out, base['ms'])}); launch floor "
          f"{floor_ms:.5f} ms; one F.conv2d {library_ms:.4f} ms (max |d| {conv_err:.3g}); "
          "ratios to aligned, raw / above the floor: "
          + ", ".join(f"{k} {raw:.3f} / {above:.3f}" for k, (raw, above) in ratios.items()))

    x, off = warp_mxu_ablation.make_inputs(dev)
    far = torch.from_numpy(np.random.default_rng(2).integers(
        -200, 201, tuple(off.shape)).astype(np.int32)).to(dev)
    floor_ms = device_ms(_build.launch_empty, reps=200)
    times = {}
    for mode in warp_mxu_ablation.MODES:
        for offs in (off, far):
            got = warp_mxu_ablation.candidate_accumulate(x, offs, mode)
            want = warp_mxu_ablation.candidate_accumulate_ref(x, offs, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"warp_mxu_ablation {mode}: max |d| {max_abs(got, want)} != 0")
        times[mode] = (
            device_ms(lambda mode=mode: warp_mxu_ablation.candidate_accumulate(x, off, mode),
                      reps=200),
            device_ms(lambda mode=mode: warp_mxu_ablation.candidate_accumulate_ref(x, off, mode)))
        bound_ms = bounds.bound_ms("warp_mxu_ablation", 1, *off.shape, mode)
        note = _above_floor(times[mode][0], floor_ms, bound_ms)
        print(f"[kernels] warp_mxu_ablation {mode}: {note} (plain {times[mode][1]:.4f} ms)")
    # With every offset 0 a warp's gathers of one step read 32 consecutive
    # words: no bank conflicts, against the random offsets' ones.
    zero = torch.zeros_like(off)
    gather_zero_ms = device_ms(
        lambda: warp_mxu_ablation.candidate_accumulate(x, zero, "gather"), reps=200)
    shifts_bound_ms = bounds.bound_ms("warp_mxu_ablation", 1, *off.shape, "shifts")
    readings["warp_mxu_ablation"].update(ms=times["gather"][0], plain_ms=times["gather"][1],
                                         shifts_ms=times["shifts"][0],
                                         shifts_plain_ms=times["shifts"][1],
                                         shifts_bound_ms=shifts_bound_ms, shape=list(off.shape),
                                         launch_floor_ms=floor_ms,
                                         gather_zero_offsets_ms=gather_zero_ms)
    above = {mode: t[0] - floor_ms for mode, t in times.items()}
    print(f"[kernels] warp_mxu_ablation {tuple(off.shape)}: bit-exact in both modes (offsets "
          f"in +-{warp_mxu_ablation.MAXD} and in +-200); launch floor {floor_ms:.5f} ms; "
          f"shifts / gather {times['shifts'][0] / times['gather'][0]:.3f} raw, "
          f"{_ratio(above['shifts'], above['gather']):.3f} above the floor; gather with every "
          f"offset 0 (no bank conflicts) {gather_zero_ms:.5f} ms")


@contextmanager
def plain_versions():
    """Swap each kernel wrapper for its plain PyTorch version."""
    saved = warp.warp_banded, lk.lucas_kanade_refine
    warp.warp_banded, lk.lucas_kanade_refine = warp.warp_banded_ref, lk.lucas_kanade_refine_ref
    try:
        yield
    finally:
        warp.warp_banded, lk.lucas_kanade_refine = saved


def run_stream(a, b, config: str, n_frames: int = N_FRAMES):
    """Stream n frames (b, a, b, ...) through a config's fast path. Returns
    the flows, the rounds per level of each frame and the seconds taken."""
    cfg = PYRAMID_CONFIGS[config]
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


def counted(path: str, fn):
    """Run one main path with the launch counts reset just before and read
    just after; fail unless it launched exactly the path's kernels."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {name: n for name, n in launch_counts().items() if n}
    if set(counts) != PATH_KERNELS[path]:
        raise AssertionError(f"{path} launched {counts}; expected {sorted(PATH_KERNELS[path])}")
    return out, counts


def check_stream(a, b, config: str):
    """Phase 4, one stream: kernels, then plain versions, frame by frame."""
    run_stream(a, b, config, 2)  # warm-up: cuBLAS handles, operator blocks on the card
    pyramidal.counters.reset()
    (flows, rounds, seconds), counts = counted(f"{config} stream",
                                               lambda: run_stream(a, b, config))
    reads = (pyramidal.counters.convergence_reads, pyramidal.counters.band_reads)
    for u, v in flows:
        finite = bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())
        if u.shape != (HEIGHT, WIDTH) or not finite:
            raise AssertionError(f"{config} stream gave non-finite or misshapen flow")
    epe = mean_epe(flows)
    # Two more timed runs: the host clock spreads from run to run.
    again = [N_FRAMES / run_stream(a, b, config)[2] for _ in range(2)]
    print(f"[main] {N_FRAMES} frames {HEIGHT}x{WIDTH} {config}: "
          f"{N_FRAMES / seconds:.2f} frames/s ({1000 * seconds / N_FRAMES:.3f} ms/frame; "
          f"then {again[0]:.2f} and {again[1]:.2f} frames/s), launches {counts}, "
          f"host reads convergence={reads[0]} band={reads[1]}, rounds per level "
          f"(distinct over the frames) {sorted(set(map(tuple, rounds)))}, "
          f"mean EPE {epe:.4f} px")

    before = launch_counts()
    with plain_versions():
        plain_flows, plain_rounds, plain_seconds = run_stream(a, b, config)
    if launch_counts() != before:
        raise AssertionError("the plain run launched a kernel")
    if plain_rounds != rounds:
        raise AssertionError(f"{config}: rounds per level differ: kernels {rounds}, "
                             f"plain {plain_rounds}")
    diff = max(max(max_abs(u, pu), max_abs(v, pv))
               for (u, v), (pu, pv) in zip(flows, plain_flows))
    print(f"[main] {config} through the plain versions on the card: "
          f"{N_FRAMES / plain_seconds:.2f} frames/s, same rounds on every frame, "
          f"max |du|,|dv| vs kernels {diff:.3g} px, mean EPE {mean_epe(plain_flows):.4f} px")
    if diff > STREAM_ATOL:
        raise AssertionError(f"{config} stream differs from the plain path by {diff} px "
                             f"> {STREAM_ATOL}")
    if epe > 0.5:
        raise AssertionError(f"{config}: mean EPE {epe} px against the known {SHIFT_PX} px shift")
    return counts


def check_single_scale(a, b, confidence: bool):
    """Phase 4, single-scale flow at 1080p through K6 (K7 with confidence),
    against the plain version on the same frames."""
    path = "single scale + confidence" if confidence else "single scale"

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lucas_kanade_single_scale(a, b, 5, backend="cuda", return_confidence=confidence)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    lucas_kanade_single_scale(a, b, 5, backend="cuda", return_confidence=confidence)  # warm-up
    (out, seconds), counts = counted(path, run)
    want = lk.lucas_kanade_fused_ref(a, b, 5, return_confidence=confidence)
    err = max(max_abs(g, w) for g, w in zip(out, want))
    finite = all(bool(torch.isfinite(t).all()) and t.shape == (HEIGHT, WIDTH) for t in out)
    u = out[0][32:-32, 32:-32]
    print(f"[main] {path} {HEIGHT}x{WIDTH}: {1000 * seconds:.3f} ms (host clock), "
          f"launches {counts}, max |d| vs plain {err:.3g}, interior median u "
          f"{float(u.median()):.4f} px")
    if not finite or err != 0.0:
        raise AssertionError(f"{path}: non-finite or misshapen output, or max |d| {err}")
    return counts


def check_mxu_path(a, b):
    """Phase 4, the window_mxu kernel API a user calls: the refine step and
    the fused solve, with and without |det|, on a 1080p batch of two."""
    pair, swap = torch.stack([a, b]), torch.stack([b, a])
    zeros = torch.zeros_like(pair)
    conv = torch.zeros(2, dtype=torch.bool, device=a.device)

    def run():
        refine = lk.lucas_kanade_refine(pair, swap, zeros, zeros, conv, max_disp_v=3.0,
                                        relaxed_order=True, window_mxu=True)
        fused = lk.lucas_kanade_fused(pair, swap, window_mxu=True)
        conf = lk.lucas_kanade_fused(pair, swap, return_confidence=True, window_mxu=True)
        return refine, fused, conf

    (refine, fused, conf), counts = counted("batched kernel API, window_mxu", run)
    for out in (refine[:2], fused, conf):
        if not all(t.shape == pair.shape and bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError("window_mxu path gave non-finite or misshapen output")
    # a -> b moves +2 px, b -> a -2 px.
    med = [float(fused[0][i, 32:-32, 32:-32].median()) for i in range(2)]
    print(f"[main] batched kernel API, window_mxu, B=2 at {HEIGHT}x{WIDTH}: launches {counts}, "
          f"interior median u {med[0]:.4f} / {med[1]:.4f} px (a->b, b->a), sums |du| "
          f"{[round(float(t), 1) for t in refine[2]]}")
    if not (0.5 < med[0] < 3.0 and -3.0 < med[1] < -0.5):
        raise AssertionError(f"window_mxu flow medians {med}: not the +-{SHIFT_PX} px motion")
    return counts


def check_ablation_paths(dev):
    """Phase 4, the ablations' own measurements (their main()), printed as
    the TPU scripts print them."""
    doc, counts = counted("shift ablation",
                          lambda: shift_ablation.measure(shift_ablation.make_input(dev)))
    print(f"[main] shift ablation: launches {counts}")
    print(json.dumps(doc))
    all_counts = dict(counts)
    times, counts = counted("warp gather ablation",
                            lambda: warp_mxu_ablation.measure(*warp_mxu_ablation.make_inputs(dev)))
    print(f"[main] warp gather ablation: launches {counts}")
    for mode, us in times.items():
        print(f"{mode:7s}: {us:8.2f} us per {warp_mxu_ablation.ROWS}x{warp_mxu_ablation.WP} "
              f"tile ({warp_mxu_ablation.ITERS} candidate iterations)")
    all_counts.update(counts)
    return all_counts


def report_profile(label: str) -> None:
    """Phase 4, the stage profiler's 1080p production report."""
    rows = profile.profile_pipeline(HEIGHT, WIDTH, "production")
    for line in profile.format_report(rows, HEIGHT, WIDTH, label).splitlines():
        print(f"[profiler] {line}")


def run_gate():
    """Phase 5: the verifier's 13-pattern gate on the card, each config with
    a committed Pallas baseline."""
    exact_zero = ("default", "narrow_vertical", "adaptive_vertical", "relaxed_order")
    for config, baseline in verifier.PALLAS_BASELINES.items():
        t0 = time.perf_counter()
        reset_launch_counts()
        results = verifier.run_suite(pyramid_config_name=config, backend="cuda", verbose=False,
                                     device=torch.device("cuda", 0))
        seconds = time.perf_counter() - t0
        used = {name: n for name, n in launch_counts().items() if n}
        if not used.get("lk_fused"):
            raise AssertionError(f"gate {config}: single scale launched no kernel: {used}")
        ok = verifier.compare_against_baseline(
            results, verifier.BASELINE_DIR / baseline, 10.0, verbose=True, backend="cuda")
        nm = next(r for r in results if r["pattern_name"] == "no_motion")
        nm_single = nm["single_scale"]["metrics"]
        nm_pyr = nm["pyramidal"]["metrics"]
        base = json.loads((verifier.BASELINE_DIR / baseline).read_text())["patterns"]
        worst = max(
            abs(d["change_percent"])
            for r in results for mode in ("single_scale", "pyramidal")
            for d in verifier.compare_metrics(
                r[mode]["metrics"], base[r["pattern_name"]][mode]["metrics"]
            )["differences"].values()
        )
        print(f"[gate] {config}: {len(results)} patterns vs {baseline}: "
              f"{'PASS' if ok else 'FAIL'}, worst |change| {worst:.3f}%, no_motion single "
              f"epe {nm_single['epe']:.3g} pyramidal mae_u {nm_pyr['mae_u']:.3g} "
              f"mae_v {nm_pyr['mae_v']:.3g}, {seconds:.2f} s, launches {used}")
        if not ok:
            raise AssertionError(f"gate {config}: regression against {baseline}")
        if nm_single["epe"] != 0.0:
            raise AssertionError(f"gate {config}: no_motion single-scale flow is not 0")
        if config in exact_zero:
            if nm_pyr["mae_u"] != 0.0 or nm_pyr["mae_v"] != 0.0:
                raise AssertionError(f"gate {config}: no_motion pyramidal flow is not 0")
        elif not 0.0 < nm_pyr["mae_u"] < 1e-3:
            raise AssertionError(f"gate {config}: no_motion floor {nm_pyr['mae_u']} "
                                 "outside (0, 1e-3) px")


def profile_stream(a, b, config: str) -> None:
    """Device time by kernel and the device's busy share over a 4-frame
    stream (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_stream(a, b, config, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, seconds = run_stream(a, b, config, 4)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {config}, 4 frames under the profiler: wall "
          f"{1000 * seconds / 4:.3f} ms/frame, device busy {busy_us / 4000:.3f} ms/frame "
          f"({100 * busy_us / 1e6 / seconds:.1f}%)")
    print(f"[profile] {'device us/frame':>15} {'calls/frame':>11}  kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"[profile] {e.self_device_time_total / 4:15.1f} {e.count / 4:11.1f}  {e.key[:90]}")


_WALK_NAMES = {(0, 1): "K3", (0, 0): "K5", (1, 0): "K6", (1, 1): "K6 relaxed",
               (2, 0): "K7", (2, 1): "K7 relaxed"}
_MXU_NAMES = {0: "refine", 1: "fused", 2: "|det|"}
_MXU_ENTRY = r"\S*lk_mxu_kernelILi(\d)ELb(\d)ELi(\d)E"
_WARP_NAMES = {(8, 1): "K1", (16, 1): "K2", (0, 1): "K4", (0, 0): "K4 unclamped"}


def ptxas_usage(log: str, entry: str):
    """(template arguments, registers, spill-store bytes, static shared
    memory bytes) of each kernel whose mangled name matches ``entry``, from
    ptxas's report (``-Xptxas=-v``)."""
    cur = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '" + entry, line)
        if m:
            cur, spill = tuple(map(int, m.groups())), 0
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            yield cur, int(m.group(1)), spill, int(smem.group(1)) if smem else 0
            cur = None


def walk_ptxas(log: str) -> dict[int, list[str]]:
    """ptxas's registers, spill stores and shared memory of each LK
    column-walk instantiation, by window."""
    out: dict[int, list[str]] = {}
    for (window, relaxed, taps, mode), regs, spill, smem in ptxas_usage(
            log, r"_ZN10tpuflow_lk14lk_walk_kernelILi(\d)ELb(\d)ELi(\d)ELi(\d)E"):
        name = _WALK_NAMES[mode, relaxed] + (" taps" if taps else "")
        out.setdefault(window, []).append(f"{name} {regs} regs/{spill} B spilled/{smem} B smem")
    return out


def mxu_ptxas(log: str) -> dict[int, list[str]]:
    """ptxas's registers and spill stores of each K10 instantiation, by
    window, and its shared memory a block (static and dynamic)."""
    smem = _build.load().tpuflow_lk_mxu_smem
    out: dict[int, list[str]] = {}
    for (window, relaxed, mode), regs, spill, static in ptxas_usage(log, _MXU_ENTRY):
        out.setdefault(window, []).append(
            f"{_MXU_NAMES[mode]}{' relaxed' if relaxed else ''} {regs} regs/{spill} B spilled/"
            f"{static + smem(window)} B smem")
    return out


def mxu_hmma(sass: str) -> dict[str, int]:
    """HMMA instructions in each K10 instantiation's SASS (cuobjdump)."""
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(_MXU_ENTRY, m.group(1)) else None
        elif name and "HMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


_ABLATION_ENTRIES = {
    "K8": (r"_ZN16tpuflow_ablation21shift_ablation_kernelILi(\d)E", shift_ablation.KINDS),
    "K9": (r"_ZN16tpuflow_ablation27warp_gather_ablation_kernelILi(\d)E",
           warp_mxu_ablation.MODES),
}


def ablation_ptxas(log: str) -> list[str]:
    """ptxas's registers, spill stores and shared memory of each K8 kind's
    and each K9 mode's instantiation."""
    return [f"{k} {names[i]} {regs} regs/{spill} B spilled/{smem} B smem"
            for k, (entry, names) in _ABLATION_ENTRIES.items()
            for (i,), regs, spill, smem in ptxas_usage(log, entry)]


def ablation_sass(sass: str) -> list[str]:
    """Shared-memory loads (LDS) of each ablation instantiation's SASS, and
    the select instructions (SEL, FSEL) of K9's: a thread's counts, and for
    K9 shifts a pixel's (4 a thread)."""
    counts: dict[tuple[str, int], dict[str, int]] = {}
    key = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = next(((k, int(h.group(1))) for k, (entry, _) in _ABLATION_ENTRIES.items()
                        if (h := re.match(entry, m.group(1)))), None)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if key and op and "@!PT" not in line:  # @!PT: padding that never issues
            c = counts.setdefault(key, {"LDS": 0, "SEL": 0})
            name = op.group(1)
            c["LDS"] += name == "LDS"
            c["SEL"] += name in ("SEL", "FSEL")
    out = []
    for (k, i), c in sorted(counts.items()):
        names = _ABLATION_ENTRIES[k][1]
        line = f"{k} {names[i]} {c['LDS']} LDS"
        if k == "K9":
            line += f", {c['SEL']} SEL/FSEL"
        if (k, names[i]) == ("K9", "shifts"):
            line += f" a thread ({c['SEL'] / 4:g} selects a pixel; the chains as written: 360)"
        out.append(line if line.endswith(")") else line + " a thread")
    return out


def warp_ptxas(log: str) -> list[str]:
    """ptxas's registers and spill stores of each warp instantiation, the
    walk ablation's included (their shared memory is dynamic, sized by the
    band: see the [kernels] lines)."""
    tiles = [f"{_WARP_NAMES[packing, clamp]} {'staged' if staged else 'gather'} {tw}x{rows} "
             f"{threads} threads: {regs} regs/{spill} B spilled"
             for (packing, clamp, staged, tw, rows, threads), regs, spill, _ in ptxas_usage(
                 log, r"_ZN12tpuflow_warp16warp_tile_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)"
                      r"ELi(\d+)ELi(\d+)E")]
    walks = [f"{_WARP_NAMES[packing, clamp]} walk {tw}x{step} {threads} threads: {regs} regs/"
             f"{spill} B spilled"
             for (packing, clamp, tw, step, threads), regs, spill, _ in ptxas_usage(
                 log, r"_ZN12tpuflow_warp16warp_walk_kernelILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E")]
    return tiles + walks


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    dev = torch.device("cuda", 0)
    smi = card_label()
    ops.pin_f32_matmul()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    usage = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem", _build.build_log)
    print(f"[build] {_build.library_path().name} ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s; "
          f"at most {max((int(r) for r, _ in usage), default=0)} registers and "
          f"{max((int(s) for _, s in usage), default=0)} B of shared memory a block)")
    for window, entries in sorted(walk_ptxas(_build.build_log).items()):
        print(f"[build] LK column walk, window {window}: " + "; ".join(sorted(entries)))
    print("[build] banded warp: " + "; ".join(sorted(warp_ptxas(_build.build_log))))
    for window, entries in sorted(mxu_ptxas(_build.build_log).items()):
        print(f"[build] K10 window {window}: " + "; ".join(sorted(entries)))
    print("[build] ablations: " + "; ".join(ablation_ptxas(_build.build_log)))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        per = mxu_hmma(sass)
        print(f"[build] tensor-core mma (HMMA) instructions in the library: "
              f"{sass.count('HMMA')}; in each of the {len(per)} K10 instantiations "
              f"{min(per.values(), default=0)}-{max(per.values(), default=0)}")
        print("[build] ablation SASS: " + "; ".join(ablation_sass(sass)))
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"[build] tensor-core mma count not taken: {exc}")

    # 3. kernels
    fa, fb = make_frames(args.seed)
    a, b = torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev)
    rng = np.random.default_rng(args.seed + 1)
    readings = check_kernels(dev, a, b, rng)

    # 4. main paths
    counts = {}
    counts.update(check_stream(a, b, "production"))
    counts.update(check_stream(a, b, "default"))
    stream_counts = dict(counts)  # the two streams' kernels, N_FRAMES frames each
    counts.update(check_single_scale(a, b, confidence=False))
    counts.update(check_single_scale(a, b, confidence=True))
    counts.update(check_mxu_path(a, b))
    counts.update(check_ablation_paths(dev))
    report_profile(smi)
    missing = [name for name in KERNELS if not counts.get(name)]
    if missing:
        raise AssertionError(f"kernels launched on no main path: {missing}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was enabled on the main path")

    # 5. gate
    run_gate()

    # 6. profile
    profile_stream(a, b, "production")
    profile_stream(a, b, "default")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        r = readings[name]
        dims = ((1, shift_ablation.OUT_R, shift_ablation.OUT_C) if name == "shift_ablation"
                else (1, *r["shape"]))
        bound_ms, bound_by = bounds.bound(name, *dims)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "launches_per_frame": stream_counts.get(name, 0) / N_FRAMES,
            "library_ms": None, "library": NO_LIBRARY_CALL.get(name), **r,
            "bytes": bounds.call_bytes(name, *dims), "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / r["ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
