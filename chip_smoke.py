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
2. build: the host's C++ compiler builds the native frame IO
   (``tpuflow_torch/native/fastio.cpp``); nvcc builds every kernel from
   tpuflow_torch/csrc/ and prints
   ptxas's registers, spills and shared memory of each (where cuobjdump is
   present it also counts the tensor-core mma instructions);
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
   then K1-K5 as the device-controlled rounds launch them
   (``warp.warp_round``, ``lk.refine_round``) at every level of both
   pyramids: with the band index in device memory forced to each rung of
   the ladder (2, 3, 8), the warp (one launch sized for the widest band)
   and the refine bit-identical to the host-int band's calls and to the
   plain round versions, skipped rounds leaving their outputs bit-identical, the
   refine's in-kernel sums against torch.sum of its block partials and its
   latch as torch reads those sums; each timed beside its bound, the
   reference-signature entry's time and the launch floor;
4. main paths: each path run with the launch counts reset just before and
   read just after. Each stream (16 frames): an eager step under torch's
   sync debug mode "error"; the eager device-control stream (no host
   read); its refine rounds logged and checked; the same stream as one
   CUDA graph replay a frame (``flow.GraphedStream``), bit-identical to
   eager with the same rounds and launches; ms a frame eager and graphed
   (host clock, median and spread of 3 runs) and the graphed replay's
   device busy share; the plain versions' run on the card, frame by
   frame, with the same rounds; the window_mxu kernel API on a 1080p
   batch; the two ablations' own measurements (their JSON and lines
   printed); the profiler's 1080p ``production`` report (its stream
   graphed);
5. gate: the 13-pattern suite through both LK modes for each config with a
   committed Pallas baseline, within 10% of it (provenance guard included);
6. vo: the visual-odometry path (``tpuflow_torch.vo``): the grid-seed
   kernel (``kernels.seed``, the keyframe reseed's ``lax.cond`` on the
   card) at 1080p bit-identical to its plain version on the stream and the
   natural frame at margins 0 and 13, its device time beside its bound,
   the launch floor, the first design's time and the plain version's, and
   a call whose predicate is false beside the launch floor; a 1080p ``OdometrySession`` on the same a/b frames, grid
   step 16 (8,040 track slots), 16 frames through ``process_frames`` (each
   step one replay of the captured step), ``production`` (K1, K2, K3, the
   seed) and ``default`` with the forward-backward check (K4, K5, the
   seed), and ``production`` at keyframe stride 2 (odd steps skip the
   reseed on the device): two eager steps under sync debug "error"; the
   front end's ms a frame (median and spread of 3 runs), tracks alive,
   reseeds taken (the seed kernel's device counter), launches, host reads
   (the flow's counted reads and, under torch's sync debug mode, every
   synchronizing operation: none); the same session stepped eagerly
   (``process_frame``), its ObsRecords and reseeds bit-identical and its
   ms a frame; ``solve(ba_iterations=8)`` twice; the session through the
   plain versions, its ObsRecords bit-identical too; a torch.profiler pass
   of 4 frames; ``run_odometry_chunked`` on ``square_loop`` (17 frames)
   rendered at 1080p on the smoke's texture (fx = fy = 1800, depth 5),
   chunks of 6 under ``production`` (K1, K2, K3) with loop closure (loop
   edges under ``default``: K4, K5), twice: its seconds, each chunk's
   (flow + BA), the loop pairs and measured loop edges, the pose graph's
   nodes, edges and solve seconds, ATE and RPE against the truth; a
   1080p ``production`` session through 8 frames, ``compact(keep_last=4)``,
   ``checkpoint.save`` / ``load`` (seconds, bytes on disk), 8 more frames
   and ``solve(8)``, against the same session never interrupted;
   ``imu.preintegrate`` over ``swing_imu``'s 751 samples with and without
   bias Jacobians (the scan kernel, ``kernels.imu``), its host time
   beside the same call on the CPU, and the scan kernel against the plain
   loop on the card (device time beside the dependent-chain bound, the
   launch floor and the first design's time);
   ``vi_graph.solve_vi`` over its 16 keyframes beside the CPU; then the
   trajectory gate, all five
   sequences at 320x240 under ``backend="cuda"``, against the TPU's
   ``vo_pallas_baseline.json`` (the reference's cross-platform rule) and
   the card's ``tpuflow_torch/eval/data/vo_cuda_baseline.json`` (10%);
7. cli: the user-facing modules. The 16 alternating frames written as
   .bin files, through each of the two host-file readers, the native
   read-ahead thread (``io.stream.FrameStream`` over ``io.fastio``, built
   from ``tpuflow_torch/native/fastio.cpp`` in phase 2) and its plain
   version (``io.stream.read_frames_ref``, a Python thread over numpy
   reads), -> ``device_pairs`` (pinned buffers, side-stream copies; the
   native reader reads straight into the pinned buffers) ->
   ``flow.__main__.stream_flow`` under ``production`` (K1, K2, K3) and
   ``default`` (K4, K5), both bit for bit against the same frames uploaded
   plainly, with ms a frame through each reader beside the same loop on
   frames already on the card (host clock, 3 runs in turn, median and
   spread), and each reader alone and with ``prefetch_to_device``;
   ``python -m tpuflow_torch.flow DIR --sequence
   --pyramidal --pyramid-config production --backend cuda`` as a
   subprocess, its mean magnitude equal to the in-process one; the S8.7
   datapath (``kernels.fixed_point``) on the card bit-identical to the CPU
   on the 1080p pair and the committed 320x240 natural pair, the RTL
   testbench criteria, the int32 shift's wraps and its device time; the
   flow CLI's pair modes (``--backend cuda`` single scale (K6) and
   ``--pyramidal`` (K4, K5), ``--backend rtl``) on the committed suite's
   translate_medium against the same runs on the CPU; the verifier's
   ``--suite-dir``; the plots where matplotlib imports (else the skip is
   printed); ``eval.profile_vo``'s six rows at 1080p ``production``, each
   in device ms, the flow step and the full VO step as graph replays
   (the eager bodies' device and host ms beside them); then (``[gen]``
   lines) the suite generator (``eval.patterns``) with its warps on the
   card: the 13 patterns at 320x240 bit for bit the committed fixture and
   ``generate_full_suite``'s tree ``write_suite``'s, at 1920x1080 the
   card's frames bit for bit the CPU's with the seconds of each, and the
   ``production`` verifier (K1, K2, K3, K6) over the 1080p suite written
   to disk, each pattern's mean EPE printed, not gated (no baseline
   exists at that size);
8. mesh: the tiled flow of ``tpuflow_torch.sharding`` at 1080p under
   ``production_fullband`` and ``default``: (a) NCCL at world size 1 in this
   process, mesh 1x1x1, ``tiled_lucas_kanade_pyramidal`` against the
   untiled ``rtl_clamp`` path and ``tiled_lucas_kanade_single_scale``
   against ``lucas_kanade_single_scale(backend="torch")``; (b) 4 gloo ranks
   as processes sharing the card (NCCL takes one rank per card) at meshes
   1x2x2 and 1x4x1, each against the untiled card result, each kernel
   launch on a tile (K1, K2, K4, K6, and K3 / K5 on 1x4x1's replicated
   coarsest level) against its plain version on that tile, launches a
   frame pair per rank, halo and gather bytes, host-clock ms a frame pair
   and each rank's device busy ms (torch.profiler, also on (a) and (e))
   beside the untiled path's; (c) the mesh-tiled VO session (1x2x2,
   ``default``, grid step 16, 8 frames) against an untiled ``rtl_clamp``
   session; (d)
   ``ba.solve(8)`` over the ``[vo]`` phase's 1080p problem in 4
   observation shards against the unsharded solve, twice; (e) NCCL with
   one rank per card where the machine has two cards or more;
9. profile: device time by kernel and the device's busy share over 4 frames
   of each stream (torch.profiler);
10. 4k (``[4k]`` lines): the port above 1080p, on ``--seed`` frames at
   3840x2160. K1-K5 as the rounds launch them at every level of both 4K
   pyramids (K1 2160x3840; K2 1080x1920, on the staged tile, and 540x960;
   K3 at all three levels; K4, K5), as in phase 3, each timed beside its
   bound and the plain round; the ``production``, ``production_fullband``
   and ``default`` streams: a frame pair with every kernel launch held
   bit for bit against its plain version on the same inputs, then each
   stream as phase 4 checks its streams (eager and graphed bit-identical,
   the rounds' sums at every level, the plain versions' stream, ms a frame
   and the graph's busy share); the eager ``production`` frame's device
   time by kernel; the 4K accuracy gate (``eval.check_4k``: the subset
   generated on the card, the ``production`` verifier with the dense
   ground truth, every launch held against its plain version, each
   pattern's pyramidal dense EPE against the committed capture by
   check_4k.sh's rule); the stage profiler at 4K under ``production``
   (the benign row included) and ``production_fullband``; one
   ``production`` and one ``default`` pair at 5120x2880 and 7680x4320,
   every launch bit-exact to its plain version, the step captured as a
   graph and replayed bit-identical, the peak device memory and the
   banded operators' first-use host seconds; and README's resolution
   grid, graphed ms a frame of ``default``, ``narrow_vertical`` and
   ``production`` at 640x480, 1280x720, 1920x1080 and 3840x2160.

Limits on the card: the warps (K1, K2, K4) bit-exact against their plain
versions at vertical bands 0/2/3/8/31 and at md = mdv = 0 and 31 (K4 with
clamp_flow on and off), each batch element equal to its 2-D launch; the refine steps
(K3, K5) u, v bit-identical (max |d| 0) and their sums to rtol 1e-5 (block
partials summed in another order); the rounds (K1-K5 under device
control) bit-identical to the host-int band's calls and the plain round
versions at each band and when skipped, the in-kernel sums within 1e-6
relative of torch.sum of the same partials (above 1080p 1e-6 scaled by the
sum's depth over 1080p's) and within the float32 bound of their depth of
the partials' float64 sum, the latch and round count as
torch reads those sums, on every round of both streams too; the single-scale solves (K6, K7) u, v
and |det| bit-identical; a batch element bit-identical to the kernel's 2-D
launch; each stream and VO step free of synchronizing operations and host
reads, the graphed streams' flows and rounds and the graphed VO sessions'
ObsRecords bit-identical to the eager steps'; K10
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
floor in (0, 1e-3) px; VO: the grid-seed kernel bit-exact against its
plain version (positions and alive flags), a false predicate leaving every
cell dead; the step's own synchronizing operations 0, at least half the
track slots alive, reseeds taken between 1 and the steps / stride, two
solves bit-identical with a mean reprojection error under 1 px, the
graphed, eager and plain-version sessions' ObsRecords and reseeds
identical; the
chunked square loop finite, with at least one measured loop edge and two
runs bit-identical; the resumed session's poses, landmarks, keyframes and
track table bit-identical; preintegration within 5e-6 of the CPU's and
faster than it, the scan kernel within 2e-6 of the plain loop in r and
1e-5 of the largest entry in v, p and each Jacobian, and solve_vi within
1e-5 (poses, velocities; scale 1e-5 relative, RMS 1e-7), the limits of
tests/test_torch_vo_graph.py; every sequence inside the
absolute bounds and both baselines' rules, TF32 off; the CLI streams
bit-identical to the plain upload through both readers, the suite
generated on the card bit for bit the fixture at 320x240 and the CPU's at
1080p, every ``profile_vo`` row in device time, the S8.7 datapath and the ``rtl`` CLI
run identical on the card and the CPU, the CLI's single scale within
1.1e-5 px of the CPU run and its pyramidal run within 0.05 px of it
(p99.9 0.02 px), its mae_u, mae_v and EPE within 1e-3 relative
(``CLI_SINGLE_ATOL``, ``CLI_PYRAMIDAL_*``); the tiled flow within p99.9 2e-3
px and max 0.05 px of the untiled card result and its mean EPE within 1e-3
relative, tiled single scale within 1e-4 px, every tile-shape kernel launch
bit-exact against its plain version, every rank holding the same result,
the tiled VO session's alive flags identical on 99.9% of the slot records,
its landmark ids identical and its live tracks within 1e-3 px on 99.9% of them and 0.05 px on all,
the sharded solve's mean reprojection error within 1e-4 px of the
unsharded one's and two sharded solves bit-identical (``MESH_*``).

Each kernel's time is printed beside its bound (``eval/bounds.py``: the
bytes one call must move over the card's 3.35 TB/s) and its share of it;
the build prints ptxas's registers, spills and shared memory of the LK
column-walk kernels, of each banded-warp instantiation and of each K10
instantiation, the HMMA instructions in each K10 instantiation, the
ablation instantiations' registers, spills and shared memory, their
shared loads (LDS) a thread and K9's select instructions a pixel. It
prints one JSON object of the kernels' readings on the line before the
last (time, plain version's time, bytes, bound,
share, launches on the main path and per stream frame, the launches of
phase 10's eager runs at 4K and at 5K and 8K, and a one-call PyTorch
yardstick's time where one exists, else null with the reason),
and ``{"ok": true, "device": {...}}`` as the last line. Frames are
made from ``--seed`` with numpy and scipy; the suite is the committed
fixture. Needs one CUDA device; fails without one. Run:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as nd_shift

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step, lucas_kanade_single_scale
from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation, warp_walk
from tpuflow_torch.core import ops
from tpuflow_torch.eval import (bounds, check_4k, natural, patterns, profile, verifier,
                                vo_verifier)
from tpuflow_torch.eval import profile_vo as vo_profiler
from tpuflow_torch.eval.metrics import compute_all_metrics
from tpuflow_torch.eval.timing import card_label, device_ms
from tpuflow_torch.flow import GraphedStream, pyramidal
from tpuflow_torch.flow.__main__ import main as flow_cli
from tpuflow_torch.flow.__main__ import mean_magnitude, stream_flow
from tpuflow_torch.io import fastio
from tpuflow_torch.io.frames import have_native_io, load_flow_text, load_frame_bin, save_frame_bin
from tpuflow_torch.io.stream import FrameStream, prefetch_to_device, read_frames_ref
from tpuflow_torch.kernels import _build, fixed_point, lk, seed, torch_ref, warp
from tpuflow_torch.kernels import imu as imu_kernel
from tpuflow_torch.sharding import (initialize_multihost, make_flow_mesh,
                                    tiled_lucas_kanade_pyramidal, tiled_lucas_kanade_single_scale)
from tpuflow_torch.sharding.mesh import counters as mesh_counters
from tpuflow_torch.eval.vo_metrics import trajectory_metrics
from tpuflow_torch.vo import (ba, checkpoint, device_loop, imu, loop_closure, pipeline,
                              pose_graph, se3, vi_graph)
from tpuflow_torch.vo.pipeline import OdometrySession

HEIGHT, WIDTH = 1080, 1920
N_FRAMES = 16
SHIFT_PX = 2.0
STREAM_ATOL = 1e-3
SUM_RTOL = 1e-5
# The refine round's in-kernel sums against torch.sum of the same block
# partials: non-negative terms added in two fixed orders of depth ~12 at
# 1080p, so each side within ~12 ulp (7e-7) of the exact sum. The depth
# grows with the partials (kernels.lk.round_sum_depth: 13 at 1080x1920,
# 27 at 2160x3840, 86 at 4320x7680), so above 1080p the limit scales with
# it (round_sum_limits), and the in-kernel sum is also held to its own
# rounding bound against the float64 sum of the partials.
ROUND_SUM_RTOL = 1e-6
F32_UNIT = 2.0 ** -24  # float32's unit roundoff
LADDER = (2, 3, 8)  # production's adaptive band ladder
STREAM_RUNS = 3
WARP_CU = "tpuflow_torch/csrc/warp.cu"
REFINE_CU = "tpuflow_torch/csrc/lk_refine.cu"
FUSED_CU = "tpuflow_torch/csrc/lk_fused.cu"
MXU_CU = "tpuflow_torch/csrc/lk_mxu.cu"
ABLATION_CU = "tpuflow_torch/csrc/ablation.cu"
SEED_CU = "tpuflow_torch/csrc/seed.cu"
IMU_CU = "tpuflow_torch/csrc/imu_scan.cu"
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
# The port's kernels with no Pallas counterpart, the reference's lax.cond
# (the keyframe reseed) and lax.scan (IMU preintegration) on the card:
# source, the reference's construct, and why no single PyTorch call
# computes the same function.
PORT_KERNELS = {
    "seed_grid": (SEED_CU, "tpuflow/vo/device_loop.py:294",
                  "no PyTorch call gates on a device predicate, and none computes the "
                  "Shi-Tomasi response with its per-cell argmax"),
    "imu_preintegrate": (IMU_CU, "tpuflow/vo/imu.py:140",
                         "no PyTorch call runs a sequential scan of 3x3 products"),
}
PATH_KERNELS = {
    "production stream": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "default stream": {"warp_exact", "lk_refine_exact"},
    # The same streams, each step one CUDA graph replay (flow.graphed).
    "production stream graphed": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "default stream graphed": {"warp_exact", "lk_refine_exact"},
    # Phase 10 (4K): production_fullband's streams, the 4K gate (the
    # verifier's two modes), 5K and 8K pairs.
    "production_fullband stream": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "production_fullband stream graphed": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "4k gate": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "lk_fused"},
    "5K production pair": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "5K default pair": {"warp_exact", "lk_refine_exact"},
    "8K production pair": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "8K default pair": {"warp_exact", "lk_refine_exact"},
    "single scale": {"lk_fused"},
    "single scale + confidence": {"lk_fused_conf"},
    "batched kernel API, window_mxu": {"lk_refine_mxu", "lk_fused_mxu", "lk_fused_conf_mxu"},
    "shift ablation": {"shift_ablation"},
    "warp gather ablation": {"warp_mxu_ablation"},
    # The VO sessions: the flow's kernels and the gated seed.
    "vo production": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "seed_grid"},
    "vo default": {"warp_exact", "lk_refine_exact", "seed_grid"},
    "vo production stride 2": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "seed_grid"},
    "vo imu": {"imu_preintegrate"},
    # swing_imu's chunked pipeline preintegrates its IMU stream.
    "vo gate": {"warp_exact", "lk_refine_exact", "seed_grid", "imu_preintegrate"},
    # Chunks under `production` (K1-K3), loop edges under `default` (K4, K5).
    "vo chunked": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "warp_exact",
                   "lk_refine_exact", "seed_grid"},
    # The flow CLI's paths (phase 7): streams from .bin files, pair modes.
    "cli production stream": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "cli default stream": {"warp_exact", "lk_refine_exact"},
    "cli single scale": {"lk_fused"},
    "cli pyramidal": {"warp_exact", "lk_refine_exact"},
    "cli rtl": set(),  # the S8.7 datapath is torch int32 ops, no kernel
    "profile_vo": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "seed_grid"},
    # Phase 7b: the production verifier over the suite generated at 1080p.
    "gen verifier": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "lk_fused"},
    # Phase 8, the tiled paths, counted on each rank: every level tiled
    # (K6 on each tile) except at 1x4x1, whose coarsest level runs
    # replicated (K3 / K5); tiled single scale is plain torch ops.
    "mesh 1x1x1 production_fullband": {"warp_packed_u8", "warp_packed_u16", "lk_fused"},
    "mesh 1x1x1 default": {"warp_exact", "lk_fused"},
    "mesh 1x1x1 single scale": set(),
    "mesh 1x2x2 production_fullband": {"warp_packed_u8", "warp_packed_u16", "lk_fused"},
    "mesh 1x2x2 default": {"warp_exact", "lk_fused"},
    "mesh 1x1x2 production_fullband": {"warp_packed_u8", "warp_packed_u16", "lk_fused"},
    "mesh 1x1x2 default": {"warp_exact", "lk_fused"},
    "mesh 1x4x1 production_fullband": {"warp_packed_u8", "warp_packed_u16", "lk_fused",
                                       "lk_refine"},
    "mesh 1x4x1 default": {"warp_exact", "lk_fused", "lk_refine_exact"},
    "mesh vo": {"warp_exact", "lk_fused", "seed_grid"},
}
# Phase 7, the CLI pair modes on the card against --device cpu: the S8.7
# mode identical; single scale (K6) within its CPU-test limit at window 5
# (tests/test_torch_kernels.py, 1e-5 px) plus the dump's 6-decimal
# rounding. Pyramidal (K4/K5): the card and the CPU build their pyramids
# with different GEMMs (cuBLAS, the CPU's BLAS), and the solve amplifies
# those one-ulp differences at weakly textured pixels, so the limits are
# set from the card's readings (NVIDIA H100 80GB HBM3, 700.00 W) with
# headroom: max |d| 0.0186 px against 0.05, p99.9 0.0054 px against 0.02,
# and mae_u, mae_v, EPE about 1e-5 apart relative against 1e-3.
# tests/test_torch_pyramidal.py's 2e-3 holds slices started from the same
# pyramids.
CLI_SINGLE_ATOL = 1e-5 + 1e-6
CLI_PYRAMIDAL_MAX = 0.05
CLI_PYRAMIDAL_P999 = 0.02
CLI_PYRAMIDAL_RTOL = 1e-3
CLI_RUNS = 3
# The two host-file readers phase 7 compares (``_reader``).
READERS = ("native", "plain")
# The VO sessions at 1080p, by name: (config, forward-backward threshold,
# keyframe stride). Grid step 16 (8,040 track slots), N_FRAMES frames
# through process_frames after start; `default` with the forward-backward
# check (a backward flow each frame); `production` also at keyframe
# stride 2, whose odd steps skip the reseed on the device.
VO_SESSIONS = {"production": ("production", None, 1), "default": ("default", 1.0, 1),
               "production stride 2": ("production", None, 2)}
# Kernel launches of a session's start, outside its steps: the first
# frame's grid seed (FrontEnd.init).
VO_START_LAUNCHES = {"seed_grid": 1}
VO_GRID = 16
VO_RUNS = 3
VO_BA_ITERATIONS = 8
# The chunked square loop at 1080p: the gate's 320-px field of view scaled
# (fx = 300 * 1920 / 320), the plane at depth 5, the smoke's texture.
VO_1080_INTR = (1800.0, 1800.0, WIDTH / 2.0, HEIGHT / 2.0)
VO_DEPTH = 5.0
VO_CHUNK_SIZE = 6
# The limits of tests/test_torch_vo_graph.py (the port against JAX on the
# CPU), here the card against the CPU: preintegration 5e-6 a field;
# solve_vi poses and velocities 1e-5, scale 1e-5 relative, residual RMS
# 1e-7.
IMU_ATOL = 5e-6
# The scan kernel against the plain loop on the card (tests/test_torch_gpu.py):
# r within 2e-6; v, p and each Jacobian within 1e-5 of its largest entry
# (3-term dot products summed left to right against cuBLAS's order).
IMU_SCAN_R_ATOL = 2e-6
IMU_SCAN_RTOL = 1e-5
# The first designs' device ms (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W:
# the seed one product column a thread and a barrier a row, the scan one
# lane), printed beside this run's: the seed at 1080p, grid 16, margin 13,
# taken and with a false predicate; the scan over swing_imu's 751 samples by
# bias_jacobians.
SEED_FIRST_MS = {"taken": (0.02534, 0.02548), "skipped": (0.00295, 0.00317)}
IMU_FIRST_MS = {False: (0.0594, 0.0675), True: (0.2180, 0.2478)}
VI_ATOL = {"poses_r": 1e-5, "poses_t": 1e-5, "velocities": 1e-5}

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
# Phase 8, the tiled flow over a process mesh at 1080p. The tiled and the
# untiled card results build their pyramids from different GEMMs (per-rank
# operator slices against banded blocks, divergence f) and the tiled levels
# solve with K6 where the untiled path runs K3 / K5, so the pixel limits are
# the port's own: p99.9 2e-3 px (a finest pyramid level between the
# packages, ROADMAP.md section 3) and max 0.05 px (phase 7's card pyramidal
# check); the mean EPE against the 2 px shift within 1e-3 relative. The
# reference's tiled envelope, 1e-3 px (divergence g), is reported for
# `default`. Tiled single scale: plain torch ops on both sides, 1e-4 px.
# The sharded solve's mean reprojection error within 1e-4 px of the
# unsharded one's.
MESH_CONFIGS = ("production_fullband", "default")
MESH_SHAPES = ((1, 2, 2), (1, 4, 1))
MESH_RANKS = 4
MESH_RUNS = 3
MESH_VO_FRAMES = 8
MESH_P999 = 2e-3
MESH_MAX = 0.05
MESH_EPE_RTOL = 1e-3
MESH_ENVELOPE = 1e-3
MESH_SINGLE_ATOL = 1e-4
MESH_BA_ATOL = 1e-4
MESH_WALL_S = 300.0  # each group of rank processes, start-up included
# The warps' vertical bands (the adaptive ladder's 2/3/8, none, the widest).
WARP_BANDS = (0, 2, 3, 8, 31)
MAX_BAND = warp.MAX_BAND
_COUNTS = (warp.launch_counts, lk.launch_counts, seed.launch_counts, imu_kernel.launch_counts,
           shift_ablation.launch_counts, warp_mxu_ablation.launch_counts)


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


def _band_indices(dev) -> list[torch.Tensor]:
    return [torch.tensor(i, dtype=torch.int32, device=dev) for i in range(len(LADDER))]


def round_sum_limits(shape, window: int = 5) -> tuple[int, float, float]:
    """A plane's round-sum depth and its two limits: against torch.sum of
    the partials, ROUND_SUM_RTOL scaled by the depth over the 1080p finest
    level's (never below ROUND_SUM_RTOL); against the float64 sum, the
    float32 bound gamma_depth = depth u / (1 - depth u)."""
    depth = lk.round_sum_depth(*shape, window)
    ref = lk.round_sum_depth(HEIGHT, WIDTH, window)
    return (depth, ROUND_SUM_RTOL * max(1.0, depth / ref),
            depth * F32_UNIT / (1.0 - depth * F32_UNIT))


def check_round_warp(readings, name, curr, packing, max_disp, rng, dev, floor_ms,
                     tag: str = "kernels"):
    """(c), (e): the warp as one round under device control (warp.warp_round)
    at one pyramid level: with the band index in device memory forced to
    each rung of LADDER it is bit-identical to the host-int band's
    warp_banded and to the plain round version, and a skipped round leaves
    ``out`` bit-identical. Then device times at bands 8 and 2, a skipped
    round and the plain round version, beside the reference-signature
    entry, the bound and the launch floor."""
    shape = tuple(curr.shape)
    u, v = _flow(rng, shape, 9.0, dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    idx = _band_indices(dev)
    fill = _flow(rng, shape, 100.0, dev)[0]
    for i, band in enumerate(LADDER):
        kw = dict(max_disp=max_disp, ladder=LADDER, band=idx[i], packing=packing)
        got = warp.warp_round(curr, u, v, torch.empty_like(curr), zero, **kw)
        want = warp.warp_banded(curr, u, v, max_disp=max_disp, clamp_flow=True,
                                max_disp_v=band, packing=packing)
        plain = warp.warp_round_ref(curr, u, v, fill.clone(), zero, **kw)
        skipped = warp.warp_round(curr, u, v, fill.clone(), one, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, plain)
                and torch.equal(skipped, fill)):
            raise AssertionError(f"{name} round at {shape}, band {band}: max |d| vs host-int "
                                 f"band {max_abs(got, want)}, vs plain {max_abs(got, plain)}, "
                                 f"skipped changed {max_abs(skipped, fill)}")
    out = torch.empty_like(curr)

    def rnd(i: int, latch=zero):
        return lambda: warp.warp_round(curr, u, v, out, latch, max_disp=max_disp, ladder=LADDER,
                                       band=idx[i], packing=packing)

    t = {f"band_{LADDER[i]}": device_ms(rnd(i)) for i in (2, 0)}
    t["skipped"] = device_ms(rnd(2, one))
    entry_ms = device_ms(lambda: warp.warp_banded(curr, u, v, max_disp=max_disp, clamp_flow=True,
                                                  max_disp_v=8, packing=packing))
    plain_ms = device_ms(lambda: warp.warp_round_ref(curr, u, v, out, zero, max_disp=max_disp,
                                                     ladder=LADDER, band=idx[2],
                                                     packing=packing))
    ms = t["band_8"]
    print(f"[{tag}] {name} round {shape[0]}x{shape[1]}: bit-exact to the host-int band and the "
          f"plain round at bands {LADDER}, skipped rounds untouched; {ms:.4f} ms at band 8 "
          f"({_bound_note(name, shape, ms)}), {t['band_2']:.4f} at 2; skipped "
          f"{t['skipped']:.4f}; entry warp_banded {entry_ms:.4f}; plain round {plain_ms:.4f}; "
          f"launch floor {floor_ms:.4f} ms")
    readings[name].setdefault("by_shape", {}).setdefault(f"{shape[0]}x{shape[1]}", {}).update(
        round_ms=t, entry_ms=entry_ms, round_plain_ms=plain_ms)
    # The largest shape of phase 3, as _record (phase 10 keeps its shapes only).
    if "round_ms" not in readings[name] and "ms" in readings[name]:
        readings[name].update(round_ms=t, entry_ms=readings[name]["ms"], ms=ms,
                              plain_ms=plain_ms)


def check_round_refine(readings, name, prev, warped, flow, relaxed, dev, floor_ms,
                       tag: str = "kernels"):
    """(c), (d), (e): the refine as one round under device control
    (lk.refine_round) at one level: with the band index forced to each rung
    of LADDER, u, v bit-identical to the host-int band's
    lucas_kanade_refine and to the plain round version, the control rows
    as the plain version leaves them, the sums within SUM_RTOL of the plain
    version's and within the plane's limits (round_sum_limits) of torch.sum
    and the float64 sum of the kernel's own block partials, the latch as
    torch evaluates sdu / n_px < thr on those
    sums (at thresholds either side of them); a skipped round passes u, v
    through bit for bit with sums 0 and the control unchanged. Then device
    times: a running round, a skipped one, the plain round, the entry."""
    shape = tuple(prev.shape)
    n_px = shape[0] * shape[1]
    idx = _band_indices(dev)
    kw0 = dict(ladder=tuple(map(float, LADDER)), window_size=5, det_threshold=1e-4,
               max_disp=8.0, relaxed_order=relaxed)
    parts = torch.empty((2, 1, lk.refine_blocks(*shape, 5)), device=dev)
    depth, sum_rtol, exact_rtol = round_sum_limits(shape)
    worst_sum = worst_exact = 0.0
    for i, band in enumerate(LADDER):
        _, _, sdu, sdv = lk.lucas_kanade_refine(prev, warped, *flow,
                                                torch.tensor(False, device=dev),
                                                max_disp_v=float(band), relaxed_order=relaxed)
        mean = max(float(sdu), float(sdv)) / n_px
        for thr in (0.999 * mean, 1.001 * mean):
            kw = dict(kw0, band=idx[i], convergence_threshold=thr)
            ctrl = torch.zeros(3, dtype=torch.int32, device=dev)
            ctrl_ref = ctrl.clone()
            got = lk.refine_round(prev, warped, *flow, ctrl, parts=parts, **kw)
            want = lk.refine_round_ref(prev, warped, *flow, ctrl_ref, **kw)
            host = lk.lucas_kanade_refine(prev, warped, *flow, torch.tensor(False, device=dev),
                                          max_disp_v=float(band), relaxed_order=relaxed)
            torch.cuda.synchronize()
            sums = [float(x) for x in got[2]]
            part_sums = [float(x) for x in parts.sum(dim=(1, 2))]
            exact_sums = [float(x) for x in parts.double().sum(dim=(1, 2))]
            latch = int(sums[0] / n_px < thr and sums[1] / n_px < thr)  # f64 here: margin 1e-3
            rel = max(abs(g - w) / w for g, w in zip(sums, part_sums))
            rel_exact = max(abs(g - w) / w for g, w in zip(sums, exact_sums))
            rel_plain = max(abs(g - float(w)) / float(w) for g, w in zip(sums, want[2]))
            worst_sum = max(worst_sum, rel)
            worst_exact = max(worst_exact, rel_exact)
            ok = (torch.equal(got[0], host[0]) and torch.equal(got[1], host[1])
                  and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                  and torch.equal(ctrl, ctrl_ref) and ctrl.tolist() == [latch, 0, 1]
                  and rel <= sum_rtol and rel_exact <= exact_rtol and rel_plain <= SUM_RTOL)
            if not ok:
                raise AssertionError(f"{name} round at {shape}, band {band}, thr {thr}: u, v vs "
                                     f"host-int band {max_abs(got[0], host[0])}, "
                                     f"{max_abs(got[1], host[1])}; ctrl {ctrl.tolist()} vs "
                                     f"plain {ctrl_ref.tolist()} (latch {latch}); sums rel "
                                     f"{rel} vs partials (limit {sum_rtol:.3g}), {rel_exact} vs "
                                     f"their f64 sum (limit {exact_rtol:.3g}), {rel_plain} vs "
                                     "plain")
        skip = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
        got = lk.refine_round(prev, warped, *flow, skip, **dict(kw0, band=idx[i]))
        torch.cuda.synchronize()
        if not (torch.equal(got[0], flow[0]) and torch.equal(got[1], flow[1])
                and not got[2].any() and skip.tolist() == [1, 0, 0]):
            raise AssertionError(f"{name} skipped round at {shape}, band {band}: not a "
                                 "pass-through")
    readings[name]["max_round_sum_rel"] = max(readings[name].get("max_round_sum_rel", 0.0),
                                              worst_sum)
    readings[name]["max_round_sum_rel_f64"] = max(
        readings[name].get("max_round_sum_rel_f64", 0.0), worst_exact)
    running = torch.zeros(3, dtype=torch.int32, device=dev)
    skipped = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
    # A threshold no sum meets keeps every timed round running.
    kw = dict(kw0, band=idx[2], convergence_threshold=-1.0)
    ms = device_ms(lambda: lk.refine_round(prev, warped, *flow, running, **kw))
    skip_ms = device_ms(lambda: lk.refine_round(prev, warped, *flow, skipped, **kw))
    plain_ms = device_ms(lambda: lk.refine_round_ref(prev, warped, *flow, running.clone(), **kw))
    frozen = torch.tensor(False, device=dev)  # made once: a host copy would sync each call
    entry_ms = device_ms(lambda: lk.lucas_kanade_refine(prev, warped, *flow, frozen,
                                                        max_disp_v=8.0, relaxed_order=relaxed))
    print(f"[{tag}] {name} round {shape[0]}x{shape[1]}: bit-exact to the host-int band and "
          f"the plain round at bands {LADDER}, latch and rounds as torch reads the sums, "
          f"in-kernel sums ({parts.shape[-1]} partials, depth {depth}) within {worst_sum:.3g} "
          f"of torch.sum of the partials (limit {sum_rtol:.3g}) and {worst_exact:.3g} of their "
          f"f64 sum (limit {exact_rtol:.3g}), skipped rounds "
          f"pass through; {ms:.4f} ms ({_bound_note(name, shape, ms)}); skipped {skip_ms:.4f}; "
          f"entry lucas_kanade_refine + torch.sum {entry_ms:.4f}; plain round {plain_ms:.4f}; "
          f"launch floor {floor_ms:.4f} ms")
    by_shape = readings[name].setdefault("by_shape", {})
    by_shape[f"{shape[0]}x{shape[1]}"] = {"ms": ms, "skipped_ms": skip_ms,
                                          "entry_ms": entry_ms, "plain_ms": plain_ms,
                                          "partials": parts.shape[-1], "sum_depth": depth,
                                          "sum_rel": worst_sum, "sum_rel_f64": worst_exact}
    # The largest shape of phase 3 first (phase 10 keeps its shapes only).
    if "entry_ms" not in readings[name] and "ms" in readings[name]:
        readings[name].update(entry_ms=readings[name]["ms"], ms=ms, plain_ms=plain_ms,
                              skipped_ms=skip_ms, launch_floor_ms=floor_ms)


def check_rounds(readings, dev, a, b, rng, floor_ms, tag: str = "kernels"):
    """Phase 3 (and 10 at 4K), the kernels as the device-controlled rounds
    launch them: K1, K2, K3 at the production pyramid's levels, K4, K5 at
    the default pyramid's, finest first."""
    for config, refine in (("production", "lk_refine"), ("default", "lk_refine_exact")):
        cfg = PYRAMID_CONFIGS[config]
        pyr_a = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
        pyr_b = torch_ref.build_gaussian_pyramid(b, cfg.levels, cfg.scale_factor)
        for level in reversed(range(cfg.levels)):
            finest = level == cfg.levels - 1
            packing = pyramidal._warp_packing(cfg, finest)
            name = {"u8": "warp_packed_u8", "u16": "warp_packed_u16", "exact": "warp_exact"}[
                packing]
            prev, curr = pyr_a[level], pyr_b[level]
            check_round_warp(readings, name, curr, packing, cfg.max_disp, rng, dev, floor_ms,
                             tag)
            flow = _flow(rng, tuple(prev.shape), 9.0, dev)
            warped = warp.warp_banded(curr, *flow, max_disp=8, clamp_flow=True, max_disp_v=8,
                                      packing=packing)
            check_round_refine(readings, refine, prev, warped, flow, cfg.relaxed_order, dev,
                               floor_ms, tag)


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
    check_rounds(readings, dev, a, b, rng, floor_ms)

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


_WRAPPERS = ((warp, ("warp_banded", "warp_round")), (lk, ("lucas_kanade_refine", "refine_round")),
             (seed, ("seed_grid",)), (imu_kernel, ("preintegrate_scan",)))


@contextmanager
def plain_versions():
    """Swap each kernel wrapper for its plain PyTorch version (a captured
    VO step is captured again where the wrappers differ from its own)."""
    saved = [(mod, name, getattr(mod, name)) for mod, names in _WRAPPERS for name in names]
    for mod, name, _ in saved:
        setattr(mod, name, getattr(mod, name + "_ref"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_stream(a, b, config: str, n_frames: int = N_FRAMES):
    """Stream n frames (b, a, b, ...) through a config's fast path, eager
    (every launch from Python, no host read). Returns the flows, the rounds
    per level of each frame (a (frames, levels) device tensor: the frames'
    own control rows, read after the run) and the seconds taken."""
    cfg = PYRAMID_CONFIGS[config]
    carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    flows, rounds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        u, v, carry = lucas_kanade_pyramidal_step(carry, b if i % 2 == 0 else a, cfg,
                                                  backend="cuda")
        flows.append((u, v))
        rounds.append(pyramidal.counters.level_rounds)
    torch.cuda.synchronize()
    return flows, torch.stack(rounds), time.perf_counter() - t0


def run_graphed(stream: GraphedStream, a, b, n_frames: int = N_FRAMES, rounds: bool = True):
    """The same stream through a captured step (flow.graphed), the carry
    reseeded with a's pyramid first: one graph replay a frame. Returns the
    flows, the rounds per level of each frame (copied after each replay;
    None with ``rounds=False``, as the timed runs do) and the seconds."""
    cfg = stream.cfg
    stream.reset(torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor))
    flows, counts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        flows.append(stream.step(b if i % 2 == 0 else a))
        if rounds:
            counts.append(stream.level_rounds.clone())
    torch.cuda.synchronize()
    return flows, torch.stack(counts) if rounds else None, time.perf_counter() - t0


@contextmanager
def no_sync():
    """torch's sync debug mode at "error": any synchronizing operation raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextmanager
def logged_rounds(log: list):
    """Record every refine round: its control before and after, its sums and
    the kernel's block partials (all on the card; checked after the run)."""
    real = lk.refine_round

    def logged(prev, warped, u, v, ctrl, **kw):
        parts = torch.empty((2, 1, lk.refine_blocks(*prev.shape, kw["window_size"])),
                            device=prev.device)
        before = ctrl.clone()
        out = real(prev, warped, u, v, ctrl, parts=parts, **kw)
        log.append((before, ctrl.clone(), out[2], parts, tuple(prev.shape),
                    kw["convergence_threshold"]))
        return out

    lk.refine_round = logged
    try:
        yield log
    finally:
        lk.refine_round = real


def check_logged_rounds(config: str, log: list, tag: str = "main") -> float:
    """(d): each round's in-kernel sums within its plane's limits
    (round_sum_limits) of torch.sum and of the float64 sum of its block
    partials, and its latch and round count as torch reads those sums (f32,
    as the reference's sdu / n_px < thr); a skipped round leaves the
    control as it was with sums 0. Returns the worst relative difference
    from torch.sum."""
    worst, worst_exact, latched = 0.0, 0.0, 0
    limits = {}
    for k, (before, after, sums, parts, shape, thr) in enumerate(log):
        ran = int(before[0]) == 0
        if ran:
            if shape not in limits:
                limits[shape] = round_sum_limits(shape)
            _, sum_rtol, exact_rtol = limits[shape]
            part = parts.sum(dim=(1, 2))
            exact = parts.double().sum(dim=(1, 2))
            rel = float(((sums - part).abs() / part).max())
            rel_exact = float(((sums.double() - exact).abs() / exact).max())
            now = int(bool(((sums / (shape[0] * shape[1])) < thr).all()))
            latched += now
            worst = max(worst, rel)
            worst_exact = max(worst_exact, rel_exact)
            ok = rel <= sum_rtol and rel_exact <= exact_rtol and after.tolist() == [
                now, 0, int(before[2]) + 1]
        else:
            ok = torch.equal(after, before) and not sums.any()
        if not ok:
            raise AssertionError(f"{config} round {k}: control {before.tolist()} -> "
                                 f"{after.tolist()}, sums {sums.tolist()}, partials "
                                 f"{parts.sum(dim=(1, 2)).tolist()}")
    depths = ", ".join(f"{h}x{w} depth {d} limits {lt:.3g} / {le:.3g}"
                       for (h, w), (d, lt, le) in sorted(limits.items(), reverse=True))
    print(f"[{tag}] {config}: {len(log)} refine rounds logged, in-kernel sums within {worst:.3g} "
          f"of torch.sum of their partials and {worst_exact:.3g} of their f64 sum ({depths}), "
          f"latch as torch reads the sums on every round ({latched} latched)")
    return worst


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


def check_stream(a, b, config: str, smi: str, tag: str = "main"):
    """Phase 4 (and 10 at 4K), one stream: (a) an eager step under sync debug "error"; the
    eager device-control stream (counted: no host read, the path's
    kernels); (d) its refine rounds logged; (b) the same stream graphed,
    bit-identical to eager with the same rounds, and the plain versions'
    run on the card with the same rounds, within STREAM_ATOL; (f) ms a
    frame by host clock, eager and graphed, median and spread of
    STREAM_RUNS runs, and the graphed replay's device busy share."""
    cfg = PYRAMID_CONFIGS[config]
    height, width = a.shape
    run_stream(a, b, config, 2)  # warm-up: cuBLAS handles, operator blocks on the card
    carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    torch.cuda.synchronize()
    with no_sync():
        lucas_kanade_pyramidal_step(carry, b, cfg, backend="cuda")
    torch.cuda.synchronize()
    print(f"[{tag}] {config}: an eager step under torch's sync debug mode \"error\": no "
          "synchronizing operation")
    pyramidal.counters.reset()
    (flows, rounds, seconds), counts = counted(f"{config} stream",
                                               lambda: run_stream(a, b, config))
    reads = (pyramidal.counters.convergence_reads, pyramidal.counters.band_reads)
    if reads != (0, 0):
        raise AssertionError(f"{config} stream read {reads} flags to the host")
    for u, v in flows:
        finite = bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())
        if u.shape != (height, width) or not finite:
            raise AssertionError(f"{config} stream gave non-finite or misshapen flow")
    epe = mean_epe(flows)
    eager_ms = [1000 * seconds / N_FRAMES] + [1000 * run_stream(a, b, config)[2] / N_FRAMES
                                              for _ in range(STREAM_RUNS - 1)]
    rounds_seen = sorted(set(map(tuple, rounds.tolist())))
    print(f"[{tag}] {N_FRAMES} frames {height}x{width} {config} eager: {_spread(eager_ms)}, "
          f"launches {counts}, host reads convergence={reads[0]} band={reads[1]}, rounds per "
          f"level (distinct over the frames) {rounds_seen}, mean EPE {epe:.4f} px ({smi})")
    with logged_rounds([]) as log:
        run_stream(a, b, config)
    check_logged_rounds(config, log, tag)
    del log

    t0 = time.perf_counter()
    stream = GraphedStream(carry, cfg)
    capture_s = time.perf_counter() - t0
    (g_flows, g_rounds, _), _ = counted(f"{config} stream graphed",
                                        lambda: run_graphed(stream, a, b))
    same = all(torch.equal(u, gu) and torch.equal(v, gv)
               for (u, v), (gu, gv) in zip(flows, g_flows))
    if not same or not torch.equal(g_rounds, rounds):
        raise AssertionError(f"{config}: graphed stream bit-identical {same}, rounds "
                             f"{sorted(set(map(tuple, g_rounds.tolist())))}")
    graphed_ms = [1000 * run_graphed(stream, a, b, rounds=False)[2] / N_FRAMES
                  for _ in range(STREAM_RUNS)]
    # The same N_FRAMES-frame run under torch.profiler: device busy ms a
    # frame, against the unprofiled runs' host ms a frame, and the port's
    # kernels the device ran, against the capture's and the eager run's.
    events = device_events(lambda: run_graphed(stream, a, b, rounds=False))
    busy = [t / N_FRAMES for t in busy_of(events)]
    traced = traced_launches(events)
    captured = {name: n * N_FRAMES for name, n in stream.launches.items()}
    if not traced == captured == counts:
        raise AssertionError(f"{config}: the graphed run's trace holds {traced} launches of the "
                             f"port's kernels; the capture recorded {stream.launches} a replay, "
                             f"the eager run launched {counts}")
    print(f"[{tag}] {config} graphed (captured in {capture_s:.3f} s, {sum(stream.launches.values())}"
          f" kernel launches a replay): {_spread(graphed_ms)}, flows bit-identical to eager, same "
          f"rounds; its trace holds {traced} launches of the port's kernels, as eager; under "
          f"torch.profiler {N_FRAMES} frames busy {busy[0]:.3f} ms/frame, {busy[1]:.3f} in the "
          f"port's kernels, {busy[2]:.3f} in Memcpy/Memset: busy share "
          f"{100 * busy[0] / float(np.median(graphed_ms)):.1f}% of the graphed host ms a frame "
          f"({smi})")
    del stream

    before = launch_counts()
    with plain_versions():
        plain_flows, plain_rounds, plain_seconds = run_stream(a, b, config)
    if launch_counts() != before:
        raise AssertionError("the plain run launched a kernel")
    if not torch.equal(plain_rounds, rounds):
        raise AssertionError(f"{config}: rounds per level differ: kernels "
                             f"{rounds.tolist()}, plain {plain_rounds.tolist()}")
    diff = max(max(max_abs(u, pu), max_abs(v, pv))
               for (u, v), (pu, pv) in zip(flows, plain_flows))
    print(f"[{tag}] {config} through the plain versions on the card: "
          f"{1000 * plain_seconds / N_FRAMES:.3f} ms/frame, same rounds on every frame, "
          f"max |du|,|dv| vs kernels and graphed {diff:.3g} px, mean EPE "
          f"{mean_epe(plain_flows):.4f} px")
    if diff > STREAM_ATOL:
        raise AssertionError(f"{config} stream differs from the plain path by {diff} px "
                             f"> {STREAM_ATOL}")
    if epe > 0.5:
        raise AssertionError(f"{config}: mean EPE {epe} px against the known {SHIFT_PX} px shift")
    return counts, float(np.median(eager_ms)), float(np.median(graphed_ms))


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


def vo_chunk(a, b):
    """The session's frames after the first (a): b, a, b, ... on the card."""
    return torch.stack([b if i % 2 == 0 else a for i in range(N_FRAMES)])


def vo_session(a, chunk, name: str, eager: bool = False):
    """The 1080p OdometrySession ``name`` (VO_SESSIONS) on the card: start
    on a, then the chunk through process_frames (each step one replay of
    the captured step), or with ``eager`` frame by frame through
    process_frame (each step eager). Returns it and the chunk's seconds
    (host clock to a synchronize)."""
    config, fb, stride = VO_SESSIONS[name]
    fx = fy = 0.8 * WIDTH
    sess = OdometrySession((fx, fy, WIDTH / 2.0, HEIGHT / 2.0), keyframe_stride=stride,
                           grid_step=VO_GRID, backend="cuda", pyramid_config=config,
                           fb_check_threshold=fb, device=a.device)
    sess.start(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if eager:
        for frame in chunk:
            sess.process_frame(frame)
    else:
        sess.process_frames(chunk)
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0


def host_syncs(fn):
    """Run fn under torch's sync debug mode; return its result and the
    synchronizing operations it made, as 'file:line' of the Python line."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def _records(sess):
    return sess.obs_uv, sess.obs_lm, sess.obs_valid, sess.n_landmarks


def _same_records(x, y) -> bool:
    return all(len(f) == len(g) and all(np.array_equal(u, v) for u, v in zip(f, g))
               for f, g in zip(x[:3], y[:3])) and x[3] == y[3]


def check_vo_session(a, b, chunk, name: str, smi: str):
    """Phase 6, one 1080p session (VO_SESSIONS): (a) two eager steps under
    sync debug "error"; the graphed session's launches, host reads, reseeds
    taken and time a frame; (g) the same session stepped eagerly, its
    ObsRecords and reseeds identical to the graphed ones, and its time a
    frame; then solve(ba_iterations=8) twice (identical bits) and the same
    session through the plain versions, its ObsRecords identical too."""
    config, fb, stride = VO_SESSIONS[name]
    dev = a.device
    vo_session(a, chunk, name)  # warm-up, and the step's capture
    vo_session(a, chunk[:2], name, eager=True)
    probe = vo_session(a, chunk[:0], name)[0]
    torch.cuda.synchronize()
    with no_sync():
        probe.process_frame(chunk[0])
        probe.process_frame(chunk[1])
    torch.cuda.synchronize()
    pyramidal.counters.reset()
    ((sess, _), syncs), counts = counted(
        f"vo {name}", lambda: host_syncs(lambda: vo_session(a, chunk, name)))
    reads = (pyramidal.counters.convergence_reads, pyramidal.counters.band_reads)
    reseeds = int(pyramidal.counters.reseeds(dev))
    seconds = sorted(vo_session(a, chunk, name)[1] for _ in range(VO_RUNS))
    ms = [1000 * s / N_FRAMES for s in seconds]
    alive = int(sess._dev.alive.sum())
    print(f"[vo] {name} session {HEIGHT}x{WIDTH}, grid {VO_GRID} "
          f"({sess._dev.alive.numel()} slots), keyframe stride {stride}, {N_FRAMES} frames "
          f"through process_frames{', fb check 1.0 px' if fb else ''}, each step a graph "
          f"replay: front end {_spread(ms)} ({smi}), tracks alive {alive}, landmarks "
          f"{sess.n_landmarks}, reseeds taken {reseeds} of {N_FRAMES} steps (the seed kernel's "
          f"device counter), launches {counts}, host reads convergence {reads[0]} band "
          f"{reads[1]} (the capture's launches, added a replay), synchronizing operations "
          f"{len(syncs)}; two eager steps under sync debug "
          f"\"error\": none")
    if syncs or sum(reads):
        raise AssertionError(f"vo {name}: {len(syncs)} synchronizing operations "
                             f"{sorted(set(syncs))}, flow reads {reads}")
    if alive < 0.5 * sess._dev.alive.numel():
        raise AssertionError(f"vo {name}: only {alive} tracks alive")
    if not 0 < reseeds <= N_FRAMES // stride:
        raise AssertionError(f"vo {name}: {reseeds} reseeds taken in {N_FRAMES} steps at "
                             f"stride {stride}")

    pyramidal.counters.reset()
    first, e_counts = counted(f"vo {name}", lambda: vo_session(a, chunk, name, eager=True))
    e_reseeds = int(pyramidal.counters.reseeds(dev))
    e_runs = [first] + [vo_session(a, chunk, name, eager=True) for _ in range(VO_RUNS - 1)]
    eager = e_runs[0][0]
    e_ms = [1000 * s / N_FRAMES for _, s in e_runs]
    got, want = _records(sess), _records(eager)
    same = _same_records(got, want) and e_reseeds == reseeds
    print(f"[vo] {name} the same session stepped eagerly (process_frame): {_spread(e_ms)}, "
          f"launches {e_counts}, reseeds taken {e_reseeds}; {len(got[0])} ObsRecords "
          f"{'bit-identical' if same else 'DIFFER'} to the graphed session's")
    if not same:
        raise AssertionError(f"vo {name}: graphed and eager ObsRecords or reseeds differ")

    results, solve_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(sess.solve(ba_iterations=VO_BA_ITERATIONS))
        solve_s.append(time.perf_counter() - t0)
    r0, r1 = results
    same = all(np.array_equal(getattr(r0, f), getattr(r1, f))
               for f in ("poses_r", "poses_t", "landmarks"))
    finite = all(np.isfinite(getattr(r0, f)).all() for f in ("poses_r", "poses_t", "landmarks"))
    print(f"[vo] {name} solve(ba_iterations={VO_BA_ITERATIONS}) over {len(sess.keyframes)} "
          f"keyframes, {sum(int(v.sum()) for v in sess.obs_valid)} valid observations: "
          f"{solve_s[0]:.3f} s, then {solve_s[1]:.3f} s; mean reprojection error "
          f"{r0.mean_reprojection_error:.4f} px; two solves {'bit-identical' if same else 'DIFFER'}")
    if not (same and finite and r0.mean_reprojection_error < 1.0):
        raise AssertionError(f"vo {name} solve: identical {same}, finite {finite}, mean "
                             f"reprojection error {r0.mean_reprojection_error}")

    before = launch_counts()
    pyramidal.counters.reset()
    with plain_versions():
        plain, plain_s = vo_session(a, chunk, name, eager=True)
    if launch_counts() != before:
        raise AssertionError("the plain VO session launched a kernel")
    p_reseeds = int(pyramidal.counters.reseeds(dev))
    uv, _, ok, _ = _records(sess)
    puv = _records(plain)[0]
    xy = max(float(np.abs(x - y)[v].max(initial=0.0)) for x, y, v in zip(uv, puv, ok))
    same = _same_records(_records(sess), _records(plain)) and p_reseeds == reseeds
    print(f"[vo] {name} session through the plain versions on the card: "
          f"{1000 * plain_s / N_FRAMES:.3f} ms/frame, reseeds taken {p_reseeds}; ObsRecords "
          f"{'bit-identical' if same else 'DIFFER'} to the graphed session's (max |dxy| of "
          f"live tracks {xy:.3g} px)")
    if not same:
        raise AssertionError(f"vo {name}: the plain session differs (max |dxy| {xy}, reseeds "
                             f"{p_reseeds} against {reseeds})")
    return float(np.median(ms)), e_counts


def _span(times: tuple[float, float]) -> str:
    return f"{times[0]:.5f}-{times[1]:.5f}"


def check_seed_kernel(a) -> dict:
    """Phase 6: the grid seed kernel at 1080p, bit for bit against its plain
    version on the stream frame and the natural frame at margins 0 and the
    sessions' seed margin; its device time beside its bound and the plain
    version's (the masked reseed every step paid before the gate); a call
    whose predicate is false beside the launch floor."""
    dev = a.device
    natural = profile.natural_pair(device=dev)[0].contiguous()
    margin = device_loop.FrontEnd(grid_step=VO_GRID).margin_for(HEIGHT, WIDTH, for_cull=False)
    worst = 0.0
    for label, frame in (("stream", a), ("natural", natural)):
        for m in (0, margin):
            xy, alive = seed.seed_grid(frame, VO_GRID, margin=m)
            want_xy, want_alive = seed.seed_grid_ref(frame, VO_GRID, margin=m)
            err = max_abs(xy, want_xy)
            flips = int((alive != want_alive).sum())
            worst = max(worst, err)
            print(f"[vo] seed kernel, {label} frame {HEIGHT}x{WIDTH}, grid {VO_GRID}, margin {m}: "
                  f"{alive.numel()} cells, {int(alive.sum())} alive; max |dxy| {err} and "
                  f"{flips} alive flags against the plain version")
            if err or flips:
                raise AssertionError(f"seed kernel differs from its plain version ({label}, "
                                     f"margin {m}): max |dxy| {err}, {flips} alive flags")
    ms = device_ms(lambda: seed.seed_grid(a, VO_GRID, margin=margin))
    plain_ms = device_ms(lambda: seed.seed_grid_ref(a, VO_GRID, margin=margin))
    off = torch.zeros((), dtype=torch.bool, device=dev)
    off_ms = device_ms(lambda: seed.seed_grid(a, VO_GRID, margin=margin, predicate=off))
    _, off_alive = seed.seed_grid(a, VO_GRID, margin=margin, predicate=off)
    if bool(off_alive.any()):
        raise AssertionError("a seed call with a false predicate left a cell alive")
    floor_ms = device_ms(_build.launch_empty)
    bound_ms, by = bounds.seed_bound(HEIGHT, WIDTH, VO_GRID)
    print(f"[vo] seed kernel at {HEIGHT}x{WIDTH}, grid {VO_GRID}, margin {margin}: device "
          f"{ms:.5f} ms a call (first design: {_span(SEED_FIRST_MS['taken'])}), bound "
          f"{bound_ms:.5f} ms ({by}), {100 * bound_ms / ms:.1f}% of it, launch floor "
          f"{floor_ms:.5f} ms; plain "
          f"version (the masked reseed paid every step before the gate) {plain_ms:.4f} ms; "
          f"predicate false {off_ms:.5f} ms (first design: {_span(SEED_FIRST_MS['skipped'])}), "
          f"{1000 * (off_ms - floor_ms):.2f} us over the floor")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "shape": [HEIGHT, WIDTH],
            "grid_step": VO_GRID, "margin": margin, "skipped_ms": off_ms,
            "launch_floor_ms": floor_ms, "bytes": bounds.seed_bytes(HEIGHT, WIDTH, VO_GRID),
            "bound_ms": bound_ms, "bound_by": by}


def profiled(run):
    """Run ``run`` (it returns its seconds) once to warm up, then under
    torch.profiler; return the seconds and the device's events by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seconds = run()
    return seconds, [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_events(run) -> list:
    """One ``run()`` under torch.profiler: the device's events by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def busy_of(events) -> tuple[float, ...]:
    """This process's device busy ms in ``events``, and the parts of it in
    the port's own kernels (namespaces ``tpuflow_*``), in copies and fills
    (``Memcpy`` / ``Memset``) and in NCCL's kernels (which hold the card
    while they wait for a peer)."""
    return tuple(sum(e.self_device_time_total for e in events if part(e.key)) / 1000
                 for part in (lambda k: True, lambda k: "tpuflow_" in k,
                              lambda k: k.startswith("Mem"), lambda k: "nccl" in k.lower()))


def busy_ms(run) -> tuple[float, ...]:
    """``busy_of`` one ``run()`` under torch.profiler."""
    return busy_of(device_events(run))


# The round kernels' names in a trace -> their launch counters: the warp's
# first template argument is its packing, the column walk's second its
# order (true: relaxed, K3) and its fourth its mode (0: refine).
_TRACED_KERNELS = (
    (re.compile(r"tpuflow_warp::warp_tile_kernel<(\d+),"),
     {"0": "warp_exact", "8": "warp_packed_u8", "16": "warp_packed_u16"}),
    (re.compile(r"tpuflow_lk::lk_walk_kernel<\d+, (true|false), \d+, 0>"),
     {"true": "lk_refine", "false": "lk_refine_exact"}),
    (re.compile(r"tpuflow_seed::(seed)_grid_kernel"), {"seed": "seed_grid"}),
)


def traced_launches(events) -> dict[str, int]:
    """The port's kernel launches that the device ran in ``events`` (a
    trace, not the wrappers' counters), by launch counter; a kernel of the
    port's that no counter names is kept under its own name."""
    out: dict[str, int] = {}
    for e in events:
        if "tpuflow_" not in e.key:
            continue
        name = e.key
        for pattern, names in _TRACED_KERNELS:
            m = pattern.search(e.key)
            if m:
                name = names[m.group(1)]
                break
        out[name] = out.get(name, 0) + e.count
    return out


def profile_vo(a, chunk, name: str, eager_counts: dict) -> None:
    """Phase 6: device time by kernel and the device's busy share over 4
    graphed frames of a VO session (torch.profiler), the session started
    before the trace; the port's kernels in the trace must be the eager
    session's step launches (``eager_counts`` less its start's, over
    N_FRAMES frames) for 4 frames."""
    sess = vo_session(a, chunk[:0], name)[0]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.process_frames(chunk[:4])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seconds, kernels = profiled(run)
    busy_us = sum(e.self_device_time_total for e in kernels)
    calls = sum(e.count for e in kernels)
    traced = traced_launches(kernels)
    steps = {k: n - VO_START_LAUNCHES.get(k, 0) for k, n in eager_counts.items()}
    want = {k: n * 4 // N_FRAMES for k, n in steps.items()}
    if traced != want or any(n * 4 % N_FRAMES for n in steps.values()):
        raise AssertionError(f"vo {name}: the graphed session's trace holds {traced} launches "
                             f"of the port's kernels in 4 frames; the eager session launched "
                             f"{eager_counts} in its start and {N_FRAMES} frames")
    print(f"[vo] profile {name}: the trace holds {traced} launches of the port's kernels in 4 "
          f"graphed frames, as the eager session's steps")
    print(f"[vo] profile {name} session, 4 frames under the profiler: wall "
          f"{1000 * seconds / 4:.3f} ms/frame, device busy {busy_us / 4000:.3f} ms/frame "
          f"({100 * busy_us / 1e6 / seconds:.1f}%), {calls / 4:.0f} device calls a frame")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[vo] profile {e.self_device_time_total / 4:9.1f} us {e.count / 4:7.1f} calls  "
              f"{e.key[:80]}")


def render_square_1080p(texture: np.ndarray):
    """square_loop (17 frames) at 1080x1920 on the smoke's texture, rounded
    to the 8-bit gray levels the production config reads. Returns the
    frames and the ground-truth poses."""
    gt_r, gt_t = vo_verifier.SEQUENCES["square_loop"](vo_verifier.SEQUENCE_LENGTHS["square_loop"])
    frames = vo_verifier.render_sequence(gt_r, gt_t, WIDTH, HEIGHT, VO_DEPTH, base=texture,
                                         intr=VO_1080_INTR)
    return [np.round(f).astype(np.float32) for f in frames], gt_r, gt_t


@contextmanager
def chunked_probes(log):
    """Time each chunk (flow + BA) and the pose-graph solve, and count loop
    pairs and measured loop edges, by wrapping the functions
    run_odometry_chunked calls; each timed call ends in a synchronize."""
    saved = (pipeline.run_odometry, loop_closure.detect_loops, loop_closure.loop_edge,
             pose_graph.solve)

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log[key].append(time.perf_counter() - t0)
            return out
        return run

    def detect(*a, **k):
        log["pairs"] = saved[1](*a, **k)
        return log["pairs"]

    def edge(*a, **k):
        out = saved[2](*a, **k)
        log["measured"] += out is not None
        return out

    def solve(g, *a, **k):
        log["graph"] = (g.poses_r.shape[0], g.edge_i.shape[0])
        return timed("solve_s", saved[3])(g, *a, **k)

    pipeline.run_odometry = timed("chunk_s", saved[0])
    loop_closure.detect_loops, loop_closure.loop_edge, pose_graph.solve = detect, edge, solve
    try:
        yield log
    finally:
        (pipeline.run_odometry, loop_closure.detect_loops, loop_closure.loop_edge,
         pose_graph.solve) = saved


def run_chunked_1080p(frames):
    log = {"chunk_s": [], "solve_s": [], "pairs": [], "measured": 0, "graph": None}
    with chunked_probes(log):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.run_odometry_chunked(
            frames, VO_1080_INTR, chunk_size=VO_CHUNK_SIZE, init_depth=VO_DEPTH,
            grid_step=VO_GRID, backend="cuda", pyramid_config="production", loop_closure=True,
        )
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, log


def check_vo_chunked(frames, gt_r, gt_t):
    """Phase 6: run_odometry_chunked on the 1080p square loop, twice, with
    loop closure: the chunks' and the pose graph's times, the loops, the
    trajectory against the truth, launches K1-K5, two runs bit-identical."""
    (res, seconds, log), counts = counted("vo chunked", lambda: run_chunked_1080p(frames))
    again, seconds2, log2 = run_chunked_1080p(frames)
    same = all(np.array_equal(getattr(res, f), getattr(again, f))
               for f in ("poses_r", "poses_t", "landmarks")) \
        and res.keyframe_indices == again.keyframe_indices
    finite = all(np.isfinite(getattr(res, f)).all() for f in ("poses_r", "poses_t"))
    kf = res.keyframe_indices
    m = trajectory_metrics(res.poses_r, res.poses_t, gt_r[kf], gt_t[kf])
    nodes, edges = log["graph"]

    def ms(values):
        return ", ".join(f"{1000 * v:.1f}" for v in values)

    print(f"[vo] chunked square loop {HEIGHT}x{WIDTH}, {len(frames)} frames, chunk "
          f"{VO_CHUNK_SIZE}, production, grid {VO_GRID}, loop closure: {seconds:.3f} s, then "
          f"{seconds2:.3f} s; chunks (flow + BA) {ms(log['chunk_s'])} ms, then "
          f"{ms(log2['chunk_s'])} ms; loop pairs detected "
          f"{[(i, j) for i, j, _ in log['pairs']]}, loop edges measured {log['measured']}; "
          f"pose graph {nodes} nodes, {edges} edges, solve {ms(log['solve_s'])} ms, then "
          f"{ms(log2['solve_s'])} ms; ATE {m['ate_rmse']:.5f} RPE {m['rpe_trans']:.5f} / "
          f"{m['rpe_rot_deg']:.4f} deg (scale {m['scale']:.3f}); launches {counts}; two runs "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not (same and finite and log["measured"] >= 1):
        raise AssertionError(f"vo chunked: identical {same}, finite {finite}, loop edges "
                             f"{log['measured']}")


def check_vo_resume(frames):
    """Phase 6: a 1080p production session, 8 frames, compact(keep_last=4),
    checkpoint.save, load, 8 more frames, solve(8), against the same
    session never interrupted: bit-identical."""
    def session():
        return OdometrySession(VO_1080_INTR, grid_step=VO_GRID, init_depth=VO_DEPTH,
                               backend="cuda", pyramid_config="production")

    straight, first = session(), session()
    for f in frames[:8]:
        straight.process_frame(f)
        first.process_frame(f)
    straight.compact(keep_last=4)
    first.compact(keep_last=4)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(first, tmp)
        save_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in Path(tmp).iterdir())
        t0 = time.perf_counter()
        resumed = checkpoint.load(tmp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for f in frames[8:16]:
        straight.process_frame(f)
        resumed.process_frame(f)
    a, b = straight.solve(VO_BA_ITERATIONS), resumed.solve(VO_BA_ITERATIONS)
    same = (a.keyframe_indices == b.keyframe_indices
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("poses_r", "poses_t", "landmarks"))
            and all(torch.equal(getattr(straight._dev, f), getattr(resumed._dev, f))
                    for f in ("xy", "start_xy", "age", "alive", "track_lm", "n_landmarks")))
    print(f"[vo] 1080p production session: 8 frames, compact(keep_last=4), save "
          f"{1000 * save_s:.1f} ms, {size} bytes on disk, load {1000 * load_s:.1f} ms, 8 more "
          f"frames, solve({VO_BA_ITERATIONS}) over {len(a.keyframe_indices)} keyframes "
          f"({len(straight.frozen_kf)} frozen): poses, landmarks, keyframes and track table "
          f"{'bit-identical' if same else 'DIFFER'} against the uninterrupted session")
    if not same:
        raise AssertionError("vo resume: the resumed session differs")


def _host_runs(fn, runs: int = 3):
    """Host-clock seconds of each of ``runs`` calls of fn() to a
    synchronize, and the last result."""
    times, out = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def _host_seconds(fn, runs: int = 3):
    """Median host-clock seconds of fn() to a synchronize, and its result."""
    times, out = _host_runs(fn, runs)
    return float(np.median(times)), out


def _scan_inputs(gyro, accel, dts, jac: bool, dev) -> list:
    """The scan's per-sample inputs, as ``imu.preintegrate`` makes them."""
    g, acc, h = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in (gyro, accel, dts))
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), acc, h]
    if jac:
        args += [se3.so3_right_jacobian(wh), se3.hat(acc)]
    return args


def check_vo_imu(dev) -> tuple[dict, dict]:
    """Phase 6: preintegration of swing_imu's samples on the card (the
    scan kernel) beside the same call on the CPU, the kernel against the
    plain loop on the card, and solve_vi on the card beside the CPU. Returns
    the main path's launches and the scan's readings."""
    n = vo_verifier.SEQUENCE_LENGTHS["swing_imu"]
    ts, gyro, accel, frame_times = vo_verifier._imu_swing(n)
    dts = np.append(np.diff(ts), np.median(np.diff(ts)))
    _, counts = counted("vo imu", lambda: [imu.preintegrate(gyro, accel, dts, bias_jacobians=jac)
                                           for jac in (False, True)])
    readings = {}
    for jac in (False, True):
        sec, got = _host_seconds(lambda: imu.preintegrate(gyro, accel, dts, bias_jacobians=jac))
        cpu_sec, want = _host_seconds(lambda: imu.preintegrate(
            gyro, accel, dts, bias_jacobians=jac, device="cpu"), runs=1)
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)
                  if isinstance(b, torch.Tensor))
        args = _scan_inputs(gyro, accel, dts, jac, dev)
        k_out = imu_kernel.preintegrate_scan(*args)
        plain_sec, p_out = _host_seconds(lambda: imu_kernel.preintegrate_scan_ref(*args), runs=1)
        r_err = max_abs(k_out[0], p_out[0])
        rel = max(max_abs(x, y) / float(y.abs().max()) for x, y in zip(k_out[1:], p_out[1:]))
        ms = device_ms(lambda: imu_kernel.preintegrate_scan(*args))
        floor_ms = device_ms(_build.launch_empty)
        bound_ms, by = bounds.imu_bound(len(ts), jac)
        chain_ms = bounds.imu_chain_ms(len(ts), jac)
        print(f"[vo] imu.preintegrate, {len(ts)} samples, bias_jacobians={jac}: card "
              f"{1000 * sec:.3f} ms (host clock, the scan one launch), CPU {1000 * cpu_sec:.1f} "
              f"ms; max |card - CPU| {err:.3g} (limit {IMU_ATOL}). Scan kernel {ms:.5f} ms "
              f"device a call against the plain loop on the card {1000 * plain_sec:.1f} ms "
              f"(host clock): max |dr| {r_err:.3g} (limit {IMU_SCAN_R_ATOL}), v, p and "
              f"Jacobians {rel:.3g} of their largest entry (limit {IMU_SCAN_RTOL}); the first "
              f"design {_span(IMU_FIRST_MS[jac])} ms; bound {bound_ms:.6f} ms ({by}), "
              f"dependent chain {chain_ms:.5f} ms ({100 * chain_ms / ms:.1f}% of the kernel's "
              f"time), launch floor {floor_ms:.5f} ms")
        if not err <= IMU_ATOL:
            raise AssertionError(f"imu.preintegrate differs from the CPU by {err}")
        if not (r_err <= IMU_SCAN_R_ATOL and rel <= IMU_SCAN_RTOL):
            raise AssertionError(f"the scan kernel differs from the plain loop: r {r_err}, "
                                 f"others {rel} relative")
        if not sec < cpu_sec:
            raise AssertionError(f"preintegrate on the card ({sec} s) is slower than on the CPU "
                                 f"({cpu_sec} s)")
        readings[jac] = {"max_abs_err": r_err, "max_rel_err": rel, "ms": ms,
                         "plain_ms": 1000 * plain_sec, "plain_clock": "host",
                         "preintegrate_ms": 1000 * sec, "cpu_ms": 1000 * cpu_sec,
                         "samples": len(ts), "bytes": bounds.imu_bytes(len(ts), jac),
                         "launch_floor_ms": floor_ms,
                         "bound_ms": bound_ms, "bound_by": by, "chain_bound_ms": chain_ms}
    # The swing as an up-to-scale vision trajectory (scale 2.5), increments
    # between its keyframes, gravity known.
    gt_r, gt_t = vo_verifier.SEQUENCES["swing_imu"](n)
    incs = imu.preintegrate_segments(ts, gyro, accel, frame_times)
    cpu_incs = imu.preintegrate_segments(ts, gyro, accel, frame_times, device="cpu")
    sec, got = _host_seconds(lambda: vi_graph.solve_vi(gt_r, gt_t / 2.5, incs,
                                                      vo_verifier.GRAVITY_W))
    cpu_sec, want = _host_seconds(lambda: vi_graph.solve_vi(
        gt_r, gt_t / 2.5, cpu_incs, vo_verifier.GRAVITY_W, device="cpu"), runs=1)
    errs = {f: float(np.abs(getattr(got, f) - getattr(want, f)).max()) for f in VI_ATOL}
    scale_err = abs(got.scale - want.scale) / want.scale
    rms_err = abs(got.residual_rms - want.residual_rms)
    print(f"[vo] vi_graph.solve_vi, {n} keyframes, 12 iterations: card {1000 * sec:.1f} ms, "
          f"CPU {1000 * cpu_sec:.1f} ms; scale {got.scale:.4f} (truth 2.5), residual rms "
          f"{got.residual_rms:.3g}; max |card - CPU| " + ", ".join(
              f"{f} {e:.3g}" for f, e in errs.items())
          + f", scale {scale_err:.3g} relative, rms {rms_err:.3g}")
    if any(errs[f] > VI_ATOL[f] for f in VI_ATOL) or scale_err > 1e-5 or rms_err > 1e-7:
        raise AssertionError(f"solve_vi differs from the CPU: {errs}, {scale_err}, {rms_err}")
    return counts, readings


def run_vo_gate(dev):
    """Phase 6, the trajectory gate: the five sequences at 320x240 under
    backend="cuda", against the TPU's committed fast-path baseline
    (cross-platform rule, absolute bounds) and, where committed, the card's
    own (10%, dust floor)."""
    t0 = time.perf_counter()
    results, counts = counted("vo gate", lambda: vo_verifier.run_suite(
        backend="cuda", verbose=False, device=dev))
    for r in results:
        m = r["metrics"]
        print(f"[vo] gate {r['sequence']}: ate_rmse {m['ate_rmse']:.5f} rpe_trans "
              f"{m['rpe_trans']:.5f} rpe_rot {m['rpe_rot_deg']:.4f} deg scale {m['scale']:.3f} "
              f"reprojection {m['mean_reprojection_error']:.3f} px tracks {r['track_count']} "
              f"metric {m['metric_poses']}")
    baselines = [vo_verifier.VO_PALLAS_BASELINE]
    if vo_verifier.VO_CUDA_BASELINE.exists():
        baselines.append(vo_verifier.VO_CUDA_BASELINE)
    for path in baselines:
        thr, floor = vo_verifier.default_threshold("cuda", "gpu", path)
        ok = vo_verifier.gate(results, path, "cuda", "gpu")
        print(f"[vo] gate against {path.name}: threshold {thr}% floors {floor}: "
              f"{'PASS' if ok else 'FAIL'}, launches {counts}")
        if not ok:
            raise AssertionError(f"vo gate: regression against {path.name}")
    print(f"[vo] gate: {len(results)} sequences in {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"vo_gate": results}))


def _spread(runs: list[float]) -> str:
    return f"median {np.median(runs):.3f} ms/frame (runs {', '.join(f'{t:.3f}' for t in runs)})"


def _reader(name: str, paths: list[Path]):
    """The frames of ``paths`` through one of the two readers: the native
    read-ahead thread (``FrameStream``) or its plain version, a Python
    thread over numpy reads (``read_frames_ref``)."""
    if name == "native":
        return FrameStream(paths, WIDTH, HEIGHT)
    return read_frames_ref(paths, WIDTH, HEIGHT)


def _host_ms_runs(fns: dict, per: int) -> dict[str, list[float]]:
    """Host ms per item (to a synchronize) of each callable, CLI_RUNS runs
    each, the callables taken in turn within a run."""
    runs = {name: [] for name in fns}
    for _ in range(CLI_RUNS):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e3 / per)
    return runs


def check_cli_streams(fa, fb, a, frame_dir: Path) -> None:
    """Phase 7, step 1: the 16 alternating frames as .bin files through
    each reader (the native FrameStream and its plain Python-thread
    version) -> device_pairs -> stream_flow under `production` and
    `default`, both bit for bit against the same frames uploaded plainly;
    ms a frame from host files through each reader beside the same loop on
    frames already on the card; each reader alone and with the uploads;
    then the flow CLI's --sequence run as a subprocess."""
    paths = [frame_dir / f"frame_{i:02d}.bin" for i in range(N_FRAMES)]
    for i, path in enumerate(paths):
        save_frame_bin(path, fa if i % 2 == 0 else fb)
    dev = a.device
    on_card = [torch.from_numpy(load_frame_bin(path, WIDTH, HEIGHT)).to(dev) for path in paths]
    pairs = len(paths) - 1
    in_process = {}
    for config in ("production", "default"):
        cfg = PYRAMID_CONFIGS[config]

        def from_files(reader):
            return list(stream_flow(_reader(reader, paths), cfg, "cuda", dev))

        def from_card():
            carry = torch_ref.build_gaussian_pyramid(on_card[0], cfg.levels, cfg.scale_factor)
            out = []
            for frame in on_card[1:]:
                u, v, carry = lucas_kanade_pyramidal_step(carry, frame, cfg, backend="cuda")
                out.append((u, v))
            return out

        plain = from_card()
        for reader in READERS:
            flows, counts = counted(f"cli {config} stream", lambda: from_files(reader))
            same = all(torch.equal(u, pu) and torch.equal(v, pv)
                       for (u, v), (pu, pv) in zip(flows, plain))
            if len(flows) != pairs or not same:
                raise AssertionError(f"cli {config} stream, {reader} reader: {len(flows)} pairs, "
                                     f"bit-identical to the plain upload: {same}")
        in_process[config] = mean_magnitude([torch.sqrt(u * u + v * v).mean() for u, v in flows])
        timed = _host_ms_runs({"native": lambda: from_files("native"),
                               "plain": lambda: from_files("plain"),
                               "card": from_card}, pairs)
        print(f"[cli] {config} stream, {pairs} pairs {HEIGHT}x{WIDTH} (host clock to a "
              f"synchronize, {CLI_RUNS} runs in turn): from host files through the native "
              f"FrameStream and the prefetching upload {_spread(timed['native'])}; through the "
              f"plain Python reader {_spread(timed['plain'])}; on frames already on the card "
              f"{_spread(timed['card'])}; launches {counts}; both readers bit-identical to the "
              f"plain upload; mean magnitude {in_process[config]:.3f} px")

    # Where the host-file stream's time goes: each reader alone (read and
    # widen to f32), then with the uploads (the native reader reads into
    # the pinned buffers; the plain one's frames are copied there).
    def read_only(reader):
        for _ in _reader(reader, paths):
            pass

    def read_upload(reader):
        for _ in prefetch_to_device(_reader(reader, paths), device=dev):
            pass

    parts = _host_ms_runs({f"{kind} {reader}": (lambda k=kind, r=reader: (
        read_only if k == "read" else read_upload)(r))
        for kind in ("read", "read+upload") for reader in READERS}, len(paths))
    for reader in READERS:
        print(f"[cli] the host-file stream without the flow, {len(paths)} frames, {reader} "
              f"reader: alone {_spread(parts['read ' + reader])}; with prefetch_to_device "
              f"{_spread(parts['read+upload ' + reader])}")

    cmd = [sys.executable, "-m", "tpuflow_torch.flow", str(frame_dir), "--sequence",
           "--pyramidal", "--pyramid-config", "production", "--backend", "cuda",
           "--width", str(WIDTH), "--height", str(HEIGHT)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"flow CLI exited {done.returncode}: {done.stderr[-2000:]}")
    for line in done.stdout.splitlines():
        print(f"[cli] python -m tpuflow_torch.flow: {line}")
    printed = done.stdout.split("mean flow magnitude:")[1].split("px")[0].strip()
    if printed != f"{in_process['production']:.3f}":
        raise AssertionError(f"flow CLI's mean magnitude {printed} != the in-process "
                             f"{in_process['production']:.3f}")
    print(f"[cli] the CLI's --sequence run took {seconds:.1f} s (process start, library load, "
          f"{pairs} pairs); its mean magnitude equals the in-process figure")


def check_s87(fa, fb, dev) -> None:
    """Phase 7, step 2: the S8.7 datapath on the card, bit-identical to the
    CPU on the 1080p a/b pair and the committed 320x240 natural pair; the
    RTL testbench criteria on the card; the int32 shift's wraps; its
    device time at 1080p."""
    # The int32 shift's wrap count and the int64 variant, from the tests'
    # helper (tests/s87_witness.py), loaded by path.
    spec = importlib.util.spec_from_file_location(
        "s87_witness", Path(__file__).resolve().parent / "tests" / "s87_witness.py")
    witness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(witness)
    n0, n1 = natural.committed_pair()
    cases = {"1080p a/b": (fa.astype(np.uint8), fb.astype(np.uint8)), "natural 320x240": (n0, n1)}
    for name, (f0, f1) in cases.items():
        c0, c1 = torch.from_numpy(f0), torch.from_numpy(f1)
        d0, d1 = c0.to(dev), c1.to(dev)
        (u, v), counts = counted("cli rtl", lambda: fixed_point.lucas_kanade_s87(d0, d1))
        cu, cv = fixed_point.lucas_kanade_s87(c0, c1)
        box = fixed_point.box_downsample_2x(d0).cpu()
        same = (torch.equal(u.cpu(), cu) and torch.equal(v.cpu(), cv)
                and torch.equal(box, fixed_point.box_downsample_2x(c0)))
        wraps = witness.shift_wraps(d0, d1)
        wu, wv = witness.lucas_kanade_s87_widened(d0, d1)
        widened = int(((wu != u) | (wv != v)).sum())
        line = (f"[cli] S8.7 {name}: card == CPU bit for bit (flow and box downsample): {same}; "
                f"int32 shift wraps at {wraps} pixels, an int64 shift would change "
                f"{widened}; launches {counts}")
        if name == "1080p a/b":
            ms = device_ms(lambda: fixed_point.lucas_kanade_s87(d0, d1))
            line += f"; {ms:.4f} ms a call (device time)"
        else:
            region = (slice(105, 135), slice(55, 85))
            mean_u, mean_v = float(u[region].mean()), float(v[region].mean())
            line += f"; testbench region mean u {mean_u:.4f} v {mean_v:.4f} px"
            if not (np.hypot(mean_u, mean_v) >= 0.5 and abs(mean_v) < 0.5):
                raise AssertionError(f"S8.7 on the card fails the RTL testbench criteria: "
                                     f"mean u {mean_u}, v {mean_v}")
        print(line)
        if not same:
            raise AssertionError(f"S8.7 {name}: the card differs from the CPU")


def _run_cli(argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        flow_cli(argv)
    return out.getvalue()


def check_cli_pairs(work: Path) -> None:
    """Phase 7, step 3: the flow CLI's pair modes on the committed suite's
    translate_medium (320x240), each beside the same run on the CPU."""
    data = patterns.load_suite()["translate_medium"]
    pattern_dir = work / "translate_medium"
    pattern_dir.mkdir()
    save_frame_bin(pattern_dir / "frame_00.bin", data["frame_prev"])
    save_frame_bin(pattern_dir / "frame_01.bin", data["frame_curr"])
    modes = {"cli single scale": ["--backend", "cuda"],
             "cli pyramidal": ["--backend", "cuda", "--pyramidal"],
             "cli rtl": ["--backend", "rtl"]}
    for path, flags in modes.items():
        dumps = {}
        for device in ("cuda", "cpu"):
            dumps[device] = work / f"{path.replace(' ', '_')}_{device}.txt"
            argv = [str(pattern_dir), *flags, "--device", device, "--export", str(dumps[device])]
            if device == "cuda":
                out, counts = counted(path, lambda: _run_cli(argv))
            else:
                out = _run_cli(argv)
        (u, v), (cu, cv) = (load_flow_text(dumps[d]) for d in ("cuda", "cpu"))
        diff = np.maximum(np.abs(u - cu), np.abs(v - cv))
        mean_u = float(out.split("mean_u")[1].split()[0])
        mask = verifier.get_test_region_mask(u.shape, "translate_medium")
        card, cpu = (compute_all_metrics(fu, fv, 2.0, 0.0, mask) for fu, fv in ((u, v), (cu, cv)))
        change = max(abs(card[m] - cpu[m]) / cpu[m] for m in ("mae_u", "mae_v", "epe"))
        print(f"[cli] python -m tpuflow_torch.flow {' '.join(flags)}: launches {counts}, "
              f"region mean_u {mean_u:.4f} px (CPU run), card vs CPU max |d| {diff.max():.3g} "
              f"p99.9 {np.percentile(diff, 99.9):.3g} px, mae_u/mae_v/epe "
              f"{card['mae_u']:.5f}/{card['mae_v']:.5f}/{card['epe']:.5f} against the CPU's "
              f"{cpu['mae_u']:.5f}/{cpu['mae_v']:.5f}/{cpu['epe']:.5f} ({change:.3g} apart)")
        if path == "cli rtl" and diff.max() != 0.0:
            raise AssertionError("the S8.7 CLI run differs between the card and the CPU")
        if path == "cli single scale" and diff.max() > CLI_SINGLE_ATOL:
            raise AssertionError(f"single-scale CLI card vs CPU {diff.max()} > {CLI_SINGLE_ATOL}")
        if path == "cli pyramidal" and (diff.max() > CLI_PYRAMIDAL_MAX
                                        or np.percentile(diff, 99.9) > CLI_PYRAMIDAL_P999
                                        or change > CLI_PYRAMIDAL_RTOL):
            raise AssertionError(f"pyramidal CLI card vs CPU: max |d| {diff.max()} (limit "
                                 f"{CLI_PYRAMIDAL_MAX}), p99.9 {np.percentile(diff, 99.9)} "
                                 f"(limit {CLI_PYRAMIDAL_P999}), metrics {change:.3g} apart "
                                 f"(limit {CLI_PYRAMIDAL_RTOL})")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        verifier.main(["--suite-dir", str(work / "suite"), "--pattern", "translate_medium",
                       "no_motion", "--backend", "cuda", "--no-visualizations",
                       "--output-dir", str(work / "verify"), "--compare-baseline", "--baseline",
                       str(verifier.BASELINE_DIR / verifier.PALLAS_BASELINES["default"])])
    print(f"[cli] verifier --suite-dir (the committed suite written in the reference's layout) "
          f"on the card: {out.getvalue().strip().splitlines()[-1]}")
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        print(f"[cli] --plot and the verifier's plots not run: matplotlib does not import "
              f"here ({exc})")
        return
    _run_cli([str(pattern_dir), "--backend", "cuda", "--device", "cuda", "--pyramidal",
              "--plot", str(work / "quiver.png"), "--per-level-plots", str(work / "levels")])
    with contextlib.redirect_stdout(io.StringIO()):
        verifier.main(["--pattern", "translate_medium", "--backend", "cuda",
                       "--output-dir", str(work / "plots")])
    written = sorted(p.name for p in (work / "plots").rglob("*.png"))
    print(f"[cli] --plot, --per-level-plots and the verifier's plots written: {written}")


def check_cli(fa, fb, a, label: str) -> None:
    """Phase 7: the user-facing CLIs and modules on the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpuflow_cli_") as tmp:
        work = Path(tmp)
        (work / "frames").mkdir()
        check_cli_streams(fa, fb, a, work / "frames")
        check_s87(fa, fb, a.device)
        check_cli_pairs(work)
    rows, counts = counted("profile_vo", lambda: vo_profiler.profile_vo(
        HEIGHT, WIDTH, "production", device=a.device))
    print(f"[cli] profile_vo @ {WIDTH}x{HEIGHT} config=production on {label}: launches {counts}; "
          f"every row device ms (CUDA events), the flow step and the full step as graph replays")
    for line in vo_profiler.format_rows(rows):
        print(f"[cli] {line}")
    if len(rows) != 6 or any(r["clock"] != vo_profiler.DEVICE_CLOCK or not np.isfinite(r["ms"])
                             for r in rows):
        raise AssertionError(f"profile_vo: rows without device time: {rows}")
    print(f"[cli] phase took {time.perf_counter() - t0:.1f} s")


# -- phase 7b: the suite generator on the card ---------------------------------------------


def _tree_equal(a: Path, b: Path) -> bool:
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    return files_a == files_b and all((a / f).read_bytes() == (b / f).read_bytes()
                                      for f in files_a)


def check_gen(dev) -> None:
    """Phase 7b (`[gen]` lines): ``eval.patterns``' generator with its warps
    on the card. The 13 patterns at 320x240 bit for bit the committed
    fixture, and ``generate_full_suite`` there the tree ``write_suite``
    writes from it; at 1920x1080 the card's frames bit for bit the CPU's,
    with the seconds each takes; the 1080p suite written, then the
    ``production`` verifier over it on the card, each pattern's mean EPE
    printed (no baseline exists at that size, so nothing is gated)."""
    t_phase = time.perf_counter()
    with np.load(patterns.SUITE_FIXTURE) as data:
        fixture = {k: data[k] for k in data.files}
    base = patterns.load_base_texture(320, 240)
    same = [name for name, p in patterns.TEST_PATTERNS.items()
            if np.array_equal(patterns.apply_motion(base, p, dev), fixture[name])]
    with tempfile.TemporaryDirectory(prefix="tpuflow_gen_") as tmp:
        work = Path(tmp)
        tree = _tree_equal(patterns.generate_full_suite(320, 240, work / "gen", device=dev),
                           patterns.write_suite(work / "fixture"))
        print(f"[gen] 320x240 on the card: {len(same)} of {len(patterns.TEST_PATTERNS)} "
              f"patterns and the base bit for bit the committed fixture "
              f"({np.array_equal(base, fixture['base'])}); generate_full_suite's tree equals "
              f"write_suite's, file for file: {tree}")
        if len(same) != len(patterns.TEST_PATTERNS) or not tree \
                or not np.array_equal(base, fixture["base"]):
            raise AssertionError("the suite generated on the card is not the committed fixture")

        t0 = time.perf_counter()
        big = patterns.load_base_texture(WIDTH, HEIGHT)
        resize_s = time.perf_counter() - t0
        timed = {}
        frames = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            frames[key] = {n: patterns.apply_motion(big, p, where)
                           for n, p in patterns.TEST_PATTERNS.items()}
            timed[key] = time.perf_counter() - t0
        differ = [n for n in patterns.TEST_PATTERNS
                  if not np.array_equal(frames["card"][n], frames["cpu"][n])]
        t0 = time.perf_counter()
        suite = patterns.generate_full_suite(WIDTH, HEIGHT, work / "gen1080", device=dev)
        write_s = time.perf_counter() - t0
        print(f"[gen] {WIDTH}x{HEIGHT}: the base (integer resize, host) {resize_s:.3f} s; the 13 "
              f"warps on the card {timed['card']:.3f} s, on the CPU {timed['cpu']:.3f} s (host "
              f"clock, frames back in host memory); card == CPU bit for bit on "
              f"{len(patterns.TEST_PATTERNS) - len(differ)} of 13 patterns; "
              f"generate_full_suite (warps on the card, .bin, .mem and metadata written) "
              f"{write_s:.2f} s")
        if differ:
            raise AssertionError(f"the card's 1080p frames differ from the CPU's: {differ}")

        t0 = time.perf_counter()
        results, counts = counted("gen verifier", lambda: verifier.run_suite(
            pyramid_config_name="production", backend="cuda", verbose=False, device=dev,
            suite_dir=suite))
        seconds = time.perf_counter() - t0
    epe = {r["pattern_name"]: (r["single_scale"]["metrics"]["epe"],
                               r["pyramidal"]["metrics"]["epe"]) for r in results}
    print(f"[gen] production verifier on the generated {WIDTH}x{HEIGHT} suite, on the card "
          f"({seconds:.1f} s, launches {counts}); mean EPE px single / pyramidal (no baseline "
          f"at this size, not gated): " + "; ".join(
              f"{n} {s:.4f} / {p:.4f}" for n, (s, p) in epe.items()))
    if len(results) != 13 or not all(np.isfinite(v).all() for v in epe.values()):
        raise AssertionError(f"the 1080p suite's verifier run: {epe}")
    print(f"[gen] phase took {time.perf_counter() - t_phase:.1f} s")


# -- phase 8: the tiled flow over a process mesh ---------------------------------------------


def _p999_max(got_u, got_v, want_u, want_v) -> tuple[float, float]:
    """p99.9 and max of |d| over both flow planes."""
    d = torch.cat([(got_u - want_u).abs().flatten(), (got_v - want_v).abs().flatten()])
    return float(torch.quantile(d, 0.999)), float(d.max())


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


@contextmanager
def checked_kernels(found: dict):
    """Every kernel launch of the path held against its plain version on
    the same inputs: ``found[name][shape]`` is the max |d| over all the
    launches of that kernel and shape (for the rounds, of u, v; inf where
    a refine round's sums are not within SUM_RTOL of the plain round's or
    its control differs)."""
    saved = warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round, lk.refine_round

    def launch(kernel, image, *args, **kw):
        """The kernel's output and its name, read from the counter it bumped."""
        before = launch_counts()
        out = kernel(image, *args, **kw)
        name = next(n for n, c in launch_counts().items() if c != before.get(n, 0))
        return out, name

    def note(name, image, err):
        by = found.setdefault(name, {})
        by[tuple(image.shape)] = max(by.get(tuple(image.shape), 0.0), err)

    def warp_checked(image, *args, **kw):
        out, name = launch(saved[0], image, *args, **kw)
        note(name, image, max_abs(out, warp.warp_banded_ref(image, *args, **kw)))
        return out

    def fused_checked(prev, *args, **kw):
        out, name = launch(saved[1], prev, *args, **kw)
        want = lk.lucas_kanade_fused_ref(prev, *args, **kw)
        note(name, prev, max(max_abs(g, w) for g, w in zip(out, want)))
        return out

    def warp_round_checked(image, u, v, out, latch, **kw):
        want = warp.warp_round_ref(image, u, v, out.clone(), latch.clone(), **kw)
        _, name = launch(saved[2], image, u, v, out, latch, **kw)
        note(name, image, max_abs(out, want))
        return out

    def refine_round_checked(prev, warped, u, v, ctrl, **kw):
        ctrl_ref = ctrl.clone()
        want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
        out, name = launch(saved[3], prev, warped, u, v, ctrl, **kw)
        err = max(max_abs(out[0], want[0]), max_abs(out[1], want[1]))
        sums_ok = bool(((out[2] - want[2]).abs() <= SUM_RTOL * want[2].abs()).all())
        note(name, prev, err if sums_ok and torch.equal(ctrl, ctrl_ref) else float("inf"))
        return out

    (warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round,
     lk.refine_round) = (warp_checked, fused_checked, warp_round_checked, refine_round_checked)
    try:
        yield
    finally:
        warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round, lk.refine_round = saved


def _mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def _session_1080(a, config: str, mesh=None, rtl_clamp: bool = False):
    """A 1080p session started on ``a``. ``rtl_clamp`` gives an untiled
    session the saturation of the tiled flow's, its counterpart."""
    fx = fy = 0.8 * WIDTH
    sess = OdometrySession((fx, fy, WIDTH / 2.0, HEIGHT / 2.0), grid_step=VO_GRID,
                           backend="cuda", pyramid_config=config, mesh=mesh, device=a.device)
    if rtl_clamp:
        sess._fe = device_loop.FrontEnd(grid_step=VO_GRID, keyframe_stride=sess.keyframe_stride,
                                        backend="cuda", config=PYRAMID_CONFIGS[config],
                                        rtl_clamp=True)
    sess.start(a)
    return sess


def mesh_rank(rank: int, work: str, device: str) -> None:
    """One of MESH_RANKS gloo ranks sharing the card (phase 8 b-d): the tiled
    flow at each mesh and config, the mesh-tiled VO session and the
    observation-sharded solve; results into ``work``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ops.pin_f32_matmul()
    initialize_multihost(f"file://{work}/store", MESH_RANKS, rank, backend="gloo")
    frames = np.load(f"{work}/frames.npz")
    a, b = torch.from_numpy(frames["a"]).to(dev), torch.from_numpy(frames["b"]).to(dev)
    report, arrays = {"flow": {}}, {}
    found: dict = {}
    vo_mesh = None
    for shape in MESH_SHAPES:
        mesh = make_flow_mesh(*shape, device=dev)
        vo_mesh = vo_mesh or mesh
        for config in MESH_CONFIGS:
            cfg = PYRAMID_CONFIGS[config]
            key = f"{_mesh_name(shape)} {config}"

            def run():
                return tiled_lucas_kanade_pyramidal(a[None], b[None], mesh, config=cfg,
                                                    backend="cuda")

            run()  # warm-up: operator slices, groups' buffers
            mesh_counters.reset()
            with checked_kernels(found):
                (u, v), counts = counted(f"mesh {key}", run)
            traffic = dataclasses.asdict(mesh_counters)
            dist.barrier(mesh.group)
            report["flow"][key] = {"launches": counts, "traffic": traffic, "ms": _host_ms(run),
                                   "device_ms": busy_ms(run)}
            if rank == 0:
                arrays[f"{key}/u"], arrays[f"{key}/v"] = u[0].cpu().numpy(), v[0].cpu().numpy()
            report["flow"][key]["digest"] = _digest(u.cpu().numpy(), v.cpu().numpy())
    report["kernels"] = {n: {"x".join(map(str, s)): e for s, e in shapes.items()}
                         for n, shapes in found.items()}

    # (c) the mesh-tiled VO session.
    chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
    sess = _session_1080(a, "default", vo_mesh)
    dist.barrier(vo_mesh.group)
    ms, counts = counted("mesh vo", lambda: _host_ms(lambda: sess.process_frames(chunk), 1))
    report["vo_ms"] = ms[0] / MESH_VO_FRAMES
    report["vo_launches"] = counts
    report["vo_digest"] = _digest(*(np.stack(x) for x in (sess.obs_uv, sess.obs_valid, sess.obs_lm)))
    if rank == 0:
        arrays["vo/uv"], arrays["vo/valid"], arrays["vo/lm"] = (
            np.stack(x) for x in (sess.obs_uv, sess.obs_valid, sess.obs_lm))

    # (d) bundle adjustment over MESH_RANKS observation shards.
    prob = np.load(f"{work}/ba.npz")
    full = ba.BAProblem(**{f: torch.from_numpy(prob[f]).to(dev) for f in ba.BAProblem._fields})
    n = full.obs_uv.shape[0]
    lo, hi = rank * n // MESH_RANKS, (rank + 1) * n // MESH_RANKS
    local = full._replace(obs_uv=full.obs_uv[lo:hi], obs_cam=full.obs_cam[lo:hi],
                          obs_lm=full.obs_lm[lo:hi], obs_valid=full.obs_valid[lo:hi])
    solves = []
    dist.barrier(vo_mesh.group)
    report["ba_s"] = _host_runs(lambda: solves.append(
        ba.solve(local, iterations=VO_BA_ITERATIONS, axis_name=vo_mesh.group)), 2)[0]
    report["ba_repeat"] = all(torch.equal(x, y) for x, y in zip(*solves))
    if rank == 0:
        for f in ("poses_r", "poses_t", "landmarks"):
            arrays[f"ba/{f}"] = getattr(solves[0], f).cpu().numpy()
    report["ba_digest"] = _digest(solves[0].poses_t.cpu().numpy())
    dist.barrier()
    np.savez(f"{work}/rank{rank}.npz", **arrays)
    with open(f"{work}/rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def nccl_rank(rank: int, world: int, work: str, shape) -> None:
    """One rank per card over NCCL (phase 8 e): the tiled flow under each
    config, its launches a frame pair and host-clock ms."""
    initialize_multihost(f"file://{work}/store_nccl", world, rank, backend="nccl")
    mesh = make_flow_mesh(*shape)
    ops.pin_f32_matmul()
    frames = np.load(f"{work}/frames.npz")
    a, b = (torch.from_numpy(frames[k]).to(mesh.device) for k in ("a", "b"))
    report, arrays = {}, {}
    for config in MESH_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]

        def run():
            return tiled_lucas_kanade_pyramidal(a[None], b[None], mesh, config=cfg,
                                                backend="cuda")

        run()
        mesh_counters.reset()
        (u, v), counts = counted(f"mesh {_mesh_name(shape)} {config}", run)
        traffic = dataclasses.asdict(mesh_counters)
        dist.barrier(mesh.group)
        report[config] = {"launches": counts, "traffic": traffic, "ms": _host_ms(run),
                          "device_ms": busy_ms(run),
                          "digest": _digest(u.cpu().numpy(), v.cpu().numpy())}
        if rank == 0:
            arrays[f"{config}/u"], arrays[f"{config}/v"] = u[0].cpu().numpy(), v[0].cpu().numpy()
    dist.barrier()
    np.savez(f"{work}/nccl{rank}.npz", **arrays)
    with open(f"{work}/nccl{rank}.json", "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def check_nccl_across_cards(dev, work: str, untiled: dict, untiled_dev: dict) -> None:
    """Phase 8 (e): NCCL with one rank per card, 1x2x2 on four cards or
    more, else 1x1x2, against the untiled result of card 0."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[mesh] nccl across cards: not run, {cards} card")
        return
    shape = (1, 2, 2) if cards >= 4 else (1, 1, 2)
    world = shape[1] * shape[2]
    t0 = time.perf_counter()
    _spawn(nccl_rank, lambda r: (r, world, work, shape), world, "nccl ranks")
    reports = [json.load(open(f"{work}/nccl{r}.json")) for r in range(world)]
    got = np.load(f"{work}/nccl0.npz")
    print(f"[mesh] (e) NCCL across {world} of {cards} cards, one rank each, mesh "
          f"{_mesh_name(shape)}: ran in {time.perf_counter() - t0:.1f} s (start-up included)")
    for config, rep0 in reports[0].items():
        if any(r[config]["digest"] != rep0["digest"] for r in reports):
            raise AssertionError(f"mesh nccl {config}: the ranks hold different flows")
        u, v = (torch.from_numpy(got[f"{config}/{c}"]).to(dev) for c in "uv")
        p999, mx = _p999_max(u, v, *untiled[config])
        ms = sorted(rep0["ms"])
        traffic = rep0["traffic"]
        print(f"[mesh] (e) {_mesh_name(shape)} {config} over NCCL: {ms[len(ms) // 2]:.3f} ms a "
              f"frame pair (host clock, median of {len(ms)}, spread {ms[0]:.3f}-{ms[-1]:.3f}); "
              f"p99.9 |d| {p999:.3g} px, max {mx:.3g} px against the untiled card result "
              f"(limits {MESH_P999}, {MESH_MAX}); rank 0 launches a pair {rep0['launches']}; halo "
              f"{traffic['halo_bytes']} B in {traffic['halo_exchanges']} exchanges, gathers "
              f"{traffic['gather_bytes']} B, {traffic['all_reduces']} sums; "
              f"{_device_note([r[config]['device_ms'] for r in reports], untiled_dev[config])}")
        if not (p999 <= MESH_P999 and mx <= MESH_MAX):
            raise AssertionError(f"mesh nccl {config}: p99.9 {p999}, max {mx}")


def _device_note(per_rank: list, untiled) -> str:
    """Each rank's device busy ms a frame pair, with its parts in the port's
    kernels, in copies and in NCCL's kernels (torch.profiler, one run),
    beside the untiled path's."""
    def one(ms):
        return f"{ms[0]:.3f} ({ms[1]:.3f}, {ms[2]:.3f}, {ms[3]:.3f})"

    return (f"device busy ms a pair by rank (in the port's kernels, in copies, in NCCL) "
            f"{', '.join(one(ms) for ms in per_rank)}, one profiled run each; "
            f"untiled {one(untiled)}")


def _spawn(target, args_of, n: int, what: str) -> None:
    """Start n processes of ``target`` and wait for all, each within the
    phase's wall limit; any failure or hang fails the phase."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_WALL_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"[mesh] {what}: exit codes {codes}, "
                             f"{len(hung)} killed at the {MESH_WALL_S} s limit")


def check_mesh(a, b, fa, fb, smi: str) -> dict:
    """Phase 8 (a-e). Returns each kernel's launches a frame pair per rank on
    each tiled path."""
    t_phase = time.perf_counter()
    dev = a.device
    work = tempfile.mkdtemp(prefix="tpuflow_mesh_")
    try:
        return _check_mesh(a, b, fa, fb, smi, dev, work, t_phase)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _untiled(a, b, config):
    cfg = PYRAMID_CONFIGS[config]
    return pyramidal.lucas_kanade_pyramidal(a, b, config=cfg, backend="cuda", rtl_clamp=True)


def _host_ms(fn, runs: int = MESH_RUNS) -> list[float]:
    return [1000 * t for t in _host_runs(fn, runs)[0]]


def _check_mesh(a, b, fa, fb, smi, dev, work, t_phase) -> dict:
    np.savez(f"{work}/frames.npz", a=fa, b=fb)
    tiled_launches: dict = {}
    untiled = {c: _untiled(a, b, c) for c in MESH_CONFIGS}
    untiled_ms = {c: _host_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
    untiled_dev = {c: busy_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
    epe_untiled = {c: mean_epe([untiled[c]]) for c in MESH_CONFIGS}

    # (a) NCCL at world size 1, mesh (1, 1, 1), in this process.
    initialize_multihost(f"file://{work}/store_a", 1, 0, backend="nccl")
    mesh = make_flow_mesh(1, 1, 1, device=dev)
    for config in MESH_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]
        tiled_lucas_kanade_pyramidal(a[None], b[None], mesh, config=cfg, backend="cuda")
        (u, v), counts = counted(f"mesh 1x1x1 {config}", lambda: tiled_lucas_kanade_pyramidal(
            a[None], b[None], mesh, config=cfg, backend="cuda"))
        tiled_launches[f"1x1x1 {config}"] = counts
        p999, mx = _p999_max(u[0], v[0], *untiled[config])
        dev_ms = busy_ms(lambda: tiled_lucas_kanade_pyramidal(
            a[None], b[None], mesh, config=cfg, backend="cuda"))
        print(f"[mesh] (a) NCCL world 1, mesh 1x1x1, {config}: tiled against untiled "
              f"(rtl_clamp, same card) p99.9 |d| {p999:.3g} px, max {mx:.3g} px (limits "
              f"{MESH_P999}, {MESH_MAX}); launches {counts}; "
              f"{_device_note([dev_ms], untiled_dev[config])}")
        if not (p999 <= MESH_P999 and mx <= MESH_MAX):
            raise AssertionError(f"mesh 1x1x1 {config}: p99.9 {p999}, max {mx}")
    (su, sv), counts = counted("mesh 1x1x1 single scale", lambda: tiled_lucas_kanade_single_scale(
        a[None], b[None], mesh))
    wu, wv = lucas_kanade_single_scale(a, b, backend="torch")
    err = max(max_abs(su[0], wu), max_abs(sv[0], wv))
    print(f"[mesh] (a) NCCL world 1, tiled single scale against lucas_kanade_single_scale("
          f"backend='torch') on the card: max |d| {err:.3g} px (limit {MESH_SINGLE_ATOL}; "
          f"plain torch ops on both sides, as the reference's tiled body is jnp)")
    if err > MESH_SINGLE_ATOL:
        raise AssertionError(f"mesh 1x1x1 single scale: max |d| {err}")
    dist.destroy_process_group()

    # (d)'s problem: the [vo] phase's 1080p production session, 17 keyframes.
    captured = {}
    solve = ba.solve

    def capture(p, *args, **kw):
        captured.setdefault("problem", p)
        return solve(p, *args, **kw)

    sess = _session_1080(a, "production")
    sess.process_frames(vo_chunk(a, b))
    ba.solve = capture
    try:
        sess.solve(ba_iterations=VO_BA_ITERATIONS)
    finally:
        ba.solve = solve
    problem = captured["problem"]
    np.savez(f"{work}/ba.npz", **{f: getattr(problem, f).cpu().numpy()
                                 for f in ba.BAProblem._fields})
    single = ba.solve(problem, iterations=VO_BA_ITERATIONS)
    ref_sess = _session_1080(a, "default", rtl_clamp=True)
    # Stepped eagerly, as the mesh-tiled session steps (no capture timed).
    ref_vo_ms = _host_ms(lambda: [ref_sess.process_frame(f)
                                  for f in vo_chunk(a, b)[:MESH_VO_FRAMES]], 1)[0] / MESH_VO_FRAMES
    del sess

    # (b)-(d): MESH_RANKS gloo ranks sharing the card.
    t0 = time.perf_counter()
    _spawn(mesh_rank, lambda r: (r, work, str(dev)), MESH_RANKS, "gloo ranks")
    reports = [json.load(open(f"{work}/rank{r}.json")) for r in range(MESH_RANKS)]
    got = np.load(f"{work}/rank0.npz")
    print(f"[mesh] (b-d) {MESH_RANKS} gloo ranks on the one card ({smi}) ran in "
          f"{time.perf_counter() - t0:.1f} s (start-up included). The {MESH_RANKS} ranks share "
          f"one card and gloo stages every strip and sum through host memory: the ms below are "
          f"no scaling figures")
    for key, rep0 in reports[0]["flow"].items():
        shape, config = key.split()
        if any(r["flow"][key]["digest"] != rep0["digest"] for r in reports):
            raise AssertionError(f"mesh {key}: the ranks hold different flows")
        u, v = (torch.from_numpy(got[f"{key}/{c}"]).to(dev) for c in "uv")
        p999, mx = _p999_max(u, v, *untiled[config])
        epe = mean_epe([(u, v)])
        rel = abs(epe - epe_untiled[config]) / epe_untiled[config]
        ms = sorted(rep0["ms"])
        tiled_launches[key] = rep0["launches"]
        traffic = rep0["traffic"]
        envelope = (f", reference envelope {MESH_ENVELOPE} px (divergence g) "
                    f"{'held' if p999 <= MESH_ENVELOPE else 'exceeded'}"
                    if config == "default" else "")
        print(f"[mesh] (b) {key}: {ms[len(ms) // 2]:.3f} ms a frame pair (host clock, median of "
              f"{MESH_RUNS}, spread {ms[0]:.3f}-{ms[-1]:.3f}) against the untiled path's "
              f"{sorted(untiled_ms[config])[len(ms) // 2]:.3f} ms on the card alone; p99.9 |d| "
              f"{p999:.3g} px, max {mx:.3g} px against the untiled card result (limits "
              f"{MESH_P999}, {MESH_MAX}){envelope}; mean EPE {epe:.5f} against {epe_untiled[config]:.5f} "
              f"px ({rel:.2e} relative, limit {MESH_EPE_RTOL}); rank 0 launches a pair "
              f"{rep0['launches']}; halo {traffic['halo_bytes']} B in {traffic['halo_exchanges']} "
              f"exchanges, gathers {traffic['gather_bytes']} B ({traffic['level_gathers']} "
              f"level), {traffic['all_reduces']} sums; "
              f"{_device_note([r['flow'][key]['device_ms'] for r in reports], untiled_dev[config])}")
        if not (p999 <= MESH_P999 and mx <= MESH_MAX and rel <= MESH_EPE_RTOL):
            raise AssertionError(f"mesh {key}: p99.9 {p999}, max {mx}, EPE {rel} relative")
    for name, shapes in sorted(reports[0]["kernels"].items()):
        worst = max(shapes.values())
        print(f"[mesh] (b) {name} on tile shapes {sorted(shapes)}: max |d| against the plain "
              f"version {worst:.3g}")
        if worst != 0.0:
            raise AssertionError(f"mesh: {name} differs from its plain version on a tile")
    want = {"warp_packed_u8", "warp_packed_u16", "warp_exact", "lk_fused", "lk_refine",
            "lk_refine_exact"}
    if set(reports[0]["kernels"]) != want:
        raise AssertionError(f"mesh: kernels checked on tiles {sorted(reports[0]['kernels'])}")

    # (c) the VO session against the untiled one.
    if any(r["vo_digest"] != reports[0]["vo_digest"] for r in reports):
        raise AssertionError("mesh vo: the ranks hold different tracks")
    if any(r["ba_digest"] != reports[0]["ba_digest"] for r in reports):
        raise AssertionError("mesh: the ranks' sharded solves differ")
    tiled_launches["1x2x2 vo default, a frame"] = {
        k: n / MESH_VO_FRAMES for k, n in reports[0]["vo_launches"].items()}
    ref_uv, ref_ok = np.stack(ref_sess.obs_uv), np.stack(ref_sess.obs_valid)
    same = got["vo/valid"] == ref_ok
    both = got["vo/valid"] & ref_ok
    same_lm = bool(np.array_equal(got["vo/lm"], np.stack(ref_sess.obs_lm)))
    d = np.abs(got["vo/uv"] - ref_uv)[both].max(axis=1)
    close = int((d <= 1e-3).sum())
    print(f"[mesh] (c) VO session {HEIGHT}x{WIDTH} default, grid {VO_GRID}, {MESH_VO_FRAMES} "
          f"frames on the 1x2x2 gloo mesh: {reports[0]['vo_ms']:.3f} ms/frame against the untiled "
          f"rtl_clamp session's {ref_vo_ms:.3f}; alive flags identical on {int(same.sum())} of "
          f"{same.size} slot records; landmark ids {'identical' if same_lm else 'DIFFER'}; of "
          f"{both.sum()} tracks alive in both, {close} within 1e-3 px, max "
          f"{float(d.max(initial=0.0)):.3g} px")
    if (same.mean() < 0.999 or not same_lm or close < 0.999 * both.sum()
            or d.max(initial=0.0) > MESH_MAX):
        raise AssertionError("mesh vo: the tiled session differs from the untiled one")

    # (d) the sharded solve.
    valid = problem.obs_valid
    tiled = problem._replace(**{f: torch.from_numpy(got[f"ba/{f}"]).to(dev)
                                for f in ("poses_r", "poses_t", "landmarks")})
    e_t = float(ba.reprojection_errors(tiled)[valid].mean())
    e_s = float(ba.reprojection_errors(single)[valid].mean())
    repeat = all(r["ba_repeat"] for r in reports)
    print(f"[mesh] (d) solve({VO_BA_ITERATIONS}) over {problem.obs_uv.shape[0]} observations in "
          f"{MESH_RANKS} shards: {min(reports[0]['ba_s']):.3f} s, then {max(reports[0]['ba_s']):.3f} "
          f"s; mean reprojection error {e_t:.6f} px against the unsharded {e_s:.6f} px "
          f"(limit {MESH_BA_ATOL}); two sharded solves {'bit-identical' if repeat else 'DIFFER'}")
    if abs(e_t - e_s) > MESH_BA_ATOL or not repeat:
        raise AssertionError("mesh: the sharded solve differs")

    # (e) NCCL, one rank per card.
    check_nccl_across_cards(dev, work, untiled, untiled_dev)
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s")
    return tiled_launches


def profile_stream(a, b, config: str, tag: str = "profile") -> None:
    """Device time by kernel and the device's busy share over a 4-frame
    eager stream (torch.profiler)."""
    seconds, kernels = profiled(lambda: run_stream(a, b, config, 4)[2])
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[{tag}] {config} {a.shape[0]}x{a.shape[1]}, 4 frames under the profiler: wall "
          f"{1000 * seconds / 4:.3f} ms/frame, device busy {busy_us / 4000:.3f} ms/frame "
          f"({100 * busy_us / 1e6 / seconds:.1f}%)")
    print(f"[{tag}] {'device us/frame':>15} {'calls/frame':>11}  kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"[{tag}] {e.self_device_time_total / 4:15.1f} {e.count / 4:11.1f}  {e.key[:90]}")


# -- phase 10: frame sizes above 1080p ----------------------------------------------------------

UHD = (2160, 3840)  # 4K, the reference's largest served size
UHD_CONFIGS = ("production", "production_fullband", "default")
# Sizes the reference cannot run (its 40-row refine tile fails to compile
# there), held to the port's plain versions: one pair a config each.
BEYOND_UHD = {"5K": (2880, 5120), "8K": (4320, 7680)}
BEYOND_UHD_CONFIGS = ("production", "default")
# README.md's resolution grid, graphed ms a frame on this card.
GRID_SIZES = ((480, 640), (720, 1280), (1080, 1920), (2160, 3840))
GRID_CONFIGS = ("default", "narrow_vertical", "production")
_LEVEL_KERNELS = {"production": ("warp_packed_u8", "warp_packed_u16", "lk_refine"),
                  "production_fullband": ("warp_packed_u8", "warp_packed_u16", "lk_refine"),
                  "default": ("warp_exact", "warp_exact", "lk_refine_exact")}


def _expected_launch_shapes(config: str, carry) -> dict[str, set]:
    """The (kernel, plane shape) pairs a config's step launches on the
    carry's levels (coarse to fine): the finest level's warp, the coarse
    levels' warp, the refine at every level."""
    finest, coarse, refine = _LEVEL_KERNELS[config]
    shapes = [tuple(level.shape) for level in carry]
    out: dict[str, set] = {}
    out.setdefault(finest, set()).add(shapes[-1])
    out.setdefault(coarse, set()).update(shapes[:-1])
    out.setdefault(refine, set()).update(shapes)
    return out


def every_launch_checked(config: str, carry, frames, what: str) -> tuple:
    """The step's every kernel launch held against its plain version on the
    same inputs (``checked_kernels``), over ``frames`` eagerly: each must
    be bit-exact (the refine's sums within SUM_RTOL and its control as the
    plain round's), and every (kernel, shape) the config launches must be
    seen. Returns the flows, the carry and what was checked."""
    cfg = PYRAMID_CONFIGS[config]
    carry_in = carry
    found: dict = {}
    flows = []
    with checked_kernels(found):
        for frame in frames:
            u, v, carry = lucas_kanade_pyramidal_step(carry, frame, cfg, backend="cuda")
            flows.append((u, v))
    torch.cuda.synchronize()
    want = _expected_launch_shapes(config, carry_in)
    seen = {name: set(by) for name, by in found.items()}
    bad = {name: {s: e for s, e in by.items() if e != 0.0} for name, by in found.items()}
    if seen != want or any(bad.values()):
        raise AssertionError(f"{what}: launches checked {seen}, expected {want}; not bit-exact "
                             f"to the plain versions: {bad}")
    return flows, carry, found


@contextmanager
def operator_builds(log: list):
    """Every first use of a banded pyramid operator (``ops._operator_blocks``,
    a cache miss: the dense f64 operator built on the host, cut into
    blocks and uploaded) appended to ``log`` as (builder, args, seconds)."""
    real = ops._operator_blocks

    def timed(builder, args, device):
        misses = real.cache_info().misses
        t0 = time.perf_counter()
        out = real(builder, args, device)
        if real.cache_info().misses != misses:
            log.append((builder.__name__, args, time.perf_counter() - t0))
        return out

    ops._operator_blocks = timed
    try:
        yield log
    finally:
        ops._operator_blocks = real


def check_4k_gate(dev, work: Path) -> dict:
    """(a) ``eval.check_4k``'s three steps on the card: the subset generated
    at 3840x2160, the ``production`` verifier with the dense ground truth
    (every kernel launch held against its plain version),
    each pattern's pyramidal dense EPE gated against the committed capture
    by check_4k.sh's rule. Returns the path's launches."""
    t0 = time.perf_counter()
    suite = check_4k.generate_subset(work / "suite_4k", device=dev)
    gen_s = time.perf_counter() - t0
    found: dict = {}
    t0 = time.perf_counter()
    with checked_kernels(found):
        results, counts = counted("4k gate", lambda: check_4k.verify(suite, device=dev,
                                                                    verbose=False))
    verify_s = time.perf_counter() - t0
    bad = {name: {s: e for s, e in by.items() if e != 0.0} for name, by in found.items()}
    rows = check_4k.gate(verifier.results_document(results),
                         json.loads(check_4k.CAPTURE.read_text()))
    print(f"[4k] gate: the subset generated on the card at {check_4k.WIDTH}x{check_4k.HEIGHT} in "
          f"{gen_s:.1f} s, verified in {verify_s:.1f} s (launches {counts}; each kernel and "
          f"shape held against its plain version: "
          + ", ".join(f"{n} {sorted(by)}" for n, by in found.items()) + ")")
    for line in check_4k.report(rows):
        print(f"[4k] gate: {line}")
    failures = [pattern for pattern, _, _, ok in rows if not ok]
    if failures or any(bad.values()):
        raise AssertionError(f"4K gate: regression on {failures}; launches not bit-exact {bad}")
    return counts


def check_4k_profile(label: str) -> None:
    """(c) The stage profiler at 3840x2160 under ``production`` (with the
    benign row) and ``production_fullband``: every row present."""
    h, w = UHD
    for config in ("production", "production_fullband"):
        rows = profile.profile_pipeline(h, w, config)
        stages = [r["stage"] for r in rows]
        for line in profile.format_report(rows, h, w, label).splitlines():
            print(f"[4k] profiler {config}: {line}")
        benign = "pyramidal total (benign)" in stages
        if benign != (PYRAMID_CONFIGS[config].adaptive_v_bands is not None) \
                or "pyramidal total (fast)" not in stages \
                or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
            raise AssertionError(f"4K profile {config}: rows {stages}")


def check_beyond_uhd(seed_: int, smi: str) -> dict:
    """(d) 5K and 8K, where the reference cannot run: one pair a config,
    every kernel launch bit-exact to its plain version, the flow finite and
    near the 2 px shift, the step captured as a graph and replayed
    bit-identical to the eager step; peak device memory and the banded
    operators' first-use host seconds. Returns the paths' launches."""
    counts: dict = {}
    for label, (h, w) in BEYOND_UHD.items():
        fa, fb = make_frames(seed_, h, w)
        a, b = torch.from_numpy(fa).cuda(), torch.from_numpy(fb).cuda()
        del fa, fb
        for config in BEYOND_UHD_CONFIGS:
            cfg = PYRAMID_CONFIGS[config]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with operator_builds([]) as built:
                t0 = time.perf_counter()
                carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
                (flows, _, found), path_counts = counted(
                    f"{label} {config} pair",
                    lambda: every_launch_checked(config, carry, [b], f"{label} {config}"))
                first_s = time.perf_counter() - t0
            for name, n in path_counts.items():
                counts[name] = counts.get(name, 0) + n
            u, v = flows[0]
            finite = bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())
            epe = mean_epe(flows)
            t0 = time.perf_counter()
            stream = GraphedStream(carry, cfg)
            capture_s = time.perf_counter() - t0
            gu, gv = stream.step(b)
            torch.cuda.synchronize()
            same = torch.equal(gu, u) and torch.equal(gv, v)
            peak = torch.cuda.max_memory_allocated() / 2**30
            del stream, carry, flows, gu, gv, u, v
            ops_s = sum(t for _, _, t in built)
            worst = max(built, key=lambda r: r[2], default=("none", (), 0.0))
            print(f"[4k] {label} {h}x{w} {config} pair: every launch bit-exact to its plain version "
                  f"({', '.join(f'{n} {sorted(s)}' for n, s in found.items())}); launches "
                  f"{path_counts}; flow finite {finite}, mean EPE {epe:.4f} px against the "
                  f"{SHIFT_PX} px shift; graph captured in {capture_s:.2f} s, its replay "
                  f"bit-identical to the eager step: {same}; peak device memory {peak:.2f} GiB; "
                  f"first step {first_s:.2f} s host, of it {len(built)} banded operators built "
                  f"in {ops_s:.2f} s (largest {worst[0]}{worst[1]} {worst[2]:.2f} s) ({smi})")
            if not (finite and same) or epe > 0.5:
                raise AssertionError(f"{label} {config}: finite {finite}, graph bit-identical "
                                     f"{same}, mean EPE {epe}")
        del a, b
        torch.cuda.empty_cache()
    return counts


def check_grid(seed_: int, smi: str) -> None:
    """(e) README.md's resolution grid on this card: graphed ms a frame of
    ``default``, ``narrow_vertical`` and ``production`` at 640x480,
    1280x720, 1920x1080 and 3840x2160, median and spread of STREAM_RUNS
    runs of N_FRAMES frames after one run to warm up. Timing only: the
    kernels of these paths are checked, and their launches counted, in
    the eager runs of phases 4 and 10."""
    table = {}
    for h, w in GRID_SIZES:
        fa, fb = make_frames(seed_, h, w)
        a, b = torch.from_numpy(fa).cuda(), torch.from_numpy(fb).cuda()
        for config in GRID_CONFIGS:
            cfg = PYRAMID_CONFIGS[config]
            stream = GraphedStream(torch_ref.build_gaussian_pyramid(a, cfg.levels,
                                                                    cfg.scale_factor), cfg)
            run_graphed(stream, a, b, rounds=False)
            runs = [1000 * run_graphed(stream, a, b, rounds=False)[2] / N_FRAMES
                    for _ in range(STREAM_RUNS)]
            table[(h, w, config)] = runs
            del stream
        print(f"[4k] grid {w}x{h} graphed ms a frame: " + "; ".join(
            f"{c} {_spread(table[(h, w, c)])} ({1000 / np.median(table[(h, w, c)]):.0f} fps)"
            for c in GRID_CONFIGS) + f" ({smi})")


def check_uhd(seed_: int, smi: str) -> tuple[dict, dict]:
    """Phase 10 (`[4k]` lines): the port above 1080p. At 3840x2160: K1-K5 as
    the rounds launch them at every level of both pyramids (check_rounds:
    bit-exact, timed beside the bound and the plain round); the
    ``production``, ``production_fullband`` and ``default`` streams, first
    a pair with every launch held against its plain version, then as phase
    4 checks its streams (eager and graphed, bit-identical; the rounds'
    sums; the plain versions' stream); the eager ``production`` frame's
    device time by kernel; (a) the 4K gate; (c) the 4K stage profiles; (d)
    5K and 8K; (e) the resolution grid. Returns the launches of the eager
    runs, each counted from a reset just before it, summed at 4K (the
    streams and the gate) and at 5K and 8K (the pairs), and the 4K kernel
    readings."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    fa, fb = make_frames(seed_, *UHD)
    a, b = torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev)
    rng = np.random.default_rng(seed_ + 4)
    floor_ms = device_ms(_build.launch_empty)
    readings = {name: {} for name in ("warp_packed_u8", "warp_packed_u16", "warp_exact",
                                      "lk_refine", "lk_refine_exact")}
    check_rounds(readings, dev, a, b, rng, floor_ms, tag="4k")
    counts: dict = {}
    per_frame = {}
    for config in UHD_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]
        carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
        _, _, found = every_launch_checked(config, carry, [b, a], f"4K {config}")
        print(f"[4k] {config} {UHD[0]}x{UHD[1]}: a frame pair with every launch bit-exact to "
              f"its plain version: " + ", ".join(f"{n} {sorted(s)}" for n, s in found.items()))
        path_counts, _, _ = check_stream(a, b, config, smi, tag="4k")
        per_frame[config] = {name: n / N_FRAMES for name, n in path_counts.items()}
        for name, n in path_counts.items():
            counts[name] = counts.get(name, 0) + n
    profile_stream(a, b, "production", tag="4k")
    del a, b
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="tpuflow_4k_") as tmp:
        for name, n in check_4k_gate(dev, Path(tmp)).items():
            counts[name] = counts.get(name, 0) + n
    check_4k_profile(smi)
    beyond_counts = check_beyond_uhd(seed_, smi)
    check_grid(seed_, smi)
    for name, r in readings.items():
        r["launches_per_frame"] = {c: f[name] for c, f in per_frame.items() if name in f}
        for key, by in r["by_shape"].items():
            h, w = map(int, key.split("x"))
            ms = by["round_ms"]["band_8"] if "round_ms" in by else by["ms"]
            plain = by.get("round_plain_ms", by.get("plain_ms"))
            by.update(bound_ms=bounds.bound(name, 1, h, w)[0])
            by["bound_share"] = by["bound_ms"] / ms
            print(f"[4k] kernels {name} {key} round: {ms:.5f} ms, bound {by['bound_ms']:.5f} ms "
                  f"({100 * by['bound_share']:.1f}%), plain round {plain:.4f} ms; launches a 4K "
                  f"frame {r['launches_per_frame']} ({smi})")
    print(f"[4k] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"4K": counts, "5K/8K": beyond_counts}, readings


_WALK_NAMES = {(0, 1): "K3", (0, 0): "K5", (1, 0): "K6", (1, 1): "K6 relaxed",
               (2, 0): "K7", (2, 1): "K7 relaxed"}
_MXU_NAMES = {0: "refine", 1: "fused", 2: "|det|"}
_MXU_ENTRY = r"\S*lk_mxu_kernelILi(\d)ELb(\d)ELi(\d)E"
_WARP_NAMES = {(8, 1): "K1", (16, 1): "K2", (0, 1): "K4", (0, 0): "K4 unclamped"}


def ptxas_usage(log: str, entry: str):
    """(template arguments, registers, spill-store bytes, static shared
    memory bytes, stack-frame bytes) of each kernel whose mangled name
    matches ``entry``, from ptxas's report (``-Xptxas=-v``)."""
    cur = spill = stack = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '" + entry, line)
        if m:
            cur, spill, stack = tuple(map(int, m.groups())), 0, 0
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            yield cur, int(m.group(1)), spill, int(smem.group(1)) if smem else 0, stack
            cur = None


def walk_ptxas(log: str) -> dict[int, list[str]]:
    """ptxas's registers, spill stores and shared memory of each LK
    column-walk instantiation, by window."""
    out: dict[int, list[str]] = {}
    for (window, relaxed, taps, mode), regs, spill, smem, stack in ptxas_usage(
            log, r"_ZN10tpuflow_lk14lk_walk_kernelILi(\d)ELb(\d)ELi(\d)ELi(\d)E"):
        name = _WALK_NAMES[mode, relaxed] + (" taps" if taps else "")
        out.setdefault(window, []).append(
            f"{name} {regs} regs/{spill} B spilled/{smem} B smem/{stack} B stack")
    return out


def mxu_ptxas(log: str) -> dict[int, list[str]]:
    """ptxas's registers and spill stores of each K10 instantiation, by
    window, and its shared memory a block (static and dynamic)."""
    smem = _build.load().tpuflow_lk_mxu_smem
    out: dict[int, list[str]] = {}
    for (window, relaxed, mode), regs, spill, static, _ in ptxas_usage(log, _MXU_ENTRY):
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
            for (i,), regs, spill, smem, _ in ptxas_usage(log, entry)]


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


def port_ptxas(log: str) -> list[str]:
    """ptxas's registers, spill stores, static shared memory and stack of
    the seed kernel and each scan instantiation (the seed's shared memory is
    dynamic, sized by the grid step)."""
    seeds = [f"seed_grid {regs} regs/{spill} B spilled/{stack} B stack"
             for _, regs, spill, _, stack in ptxas_usage(
                 log, r"_ZN12tpuflow_seed16seed_grid_kernelE")]
    scans = [f"imu_scan{' bias Jacobians' if jac else ''} {regs} regs/{spill} B spilled/"
             f"{smem} B smem/{stack} B stack"
             for (jac,), regs, spill, smem, stack in ptxas_usage(
                 log, r"_ZN11tpuflow_imu15imu_scan_kernelILb(\d)E")]
    return seeds + scans


def warp_ptxas(log: str) -> list[str]:
    """ptxas's registers and spill stores of each warp instantiation, the
    walk ablation's included (their shared memory is dynamic, sized by the
    band: see the [kernels] lines)."""
    tiles = [f"{_WARP_NAMES[packing, clamp]} {'staged' if staged else 'gather'} {tw}x{rows} "
             f"{threads} threads: {regs} regs/{spill} B spilled/{stack} B stack"
             for (packing, clamp, staged, tw, rows, threads), regs, spill, _, stack in ptxas_usage(
                 log, r"_ZN12tpuflow_warp16warp_tile_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)"
                      r"ELi(\d+)ELi(\d+)E")]
    walks = [f"{_WARP_NAMES[packing, clamp]} walk {tw}x{step} {threads} threads: {regs} regs/"
             f"{spill} B spilled"
             for (packing, clamp, tw, step, threads), regs, spill, _, _ in ptxas_usage(
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
    if not have_native_io():
        raise AssertionError("the native frame IO did not load")
    print(f"[build] native frame IO {fastio.library_path().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (c++ {' '.join(fastio.CXX_FLAGS)}, at first use)")
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
    print("[build] seed and IMU scan: " + "; ".join(port_ptxas(_build.build_log)))
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
    stream_ms = {}
    for config in ("production", "default"):
        path_counts, _, stream_ms[config] = check_stream(a, b, config, smi)
        counts.update(path_counts)
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

    # 6. vo
    t0 = time.perf_counter()
    port_readings = {"seed_grid": check_seed_kernel(a)}
    chunk = vo_chunk(a, b)
    for name, (config, _, _) in VO_SESSIONS.items():
        vo_ms, vo_counts = check_vo_session(a, b, chunk, name, smi)
        print(f"[vo] {name}: front end {vo_ms:.3f} ms/frame against the flow stream's "
              f"{stream_ms[config]:.3f} ms/frame (phase 4)")
        profile_vo(a, chunk, name, vo_counts)
        if name == "production":
            counts["seed_grid"] = vo_counts["seed_grid"]
    del chunk
    t1 = time.perf_counter()
    square, gt_r, gt_t = render_square_1080p(fa)
    print(f"[vo] rendered square_loop at {HEIGHT}x{WIDTH} in {time.perf_counter() - t1:.1f} s")
    check_vo_chunked(square, gt_r, gt_t)
    check_vo_resume(square)
    del square
    imu_counts, imu_readings = check_vo_imu(dev)
    counts.update(imu_counts)
    port_readings["imu_preintegrate"] = {**imu_readings[False], "bias_jacobians": imu_readings[True]}
    run_vo_gate(dev)
    missing = [name for name in PORT_KERNELS if not counts.get(name)]
    if missing:
        raise AssertionError(f"kernels launched on no main path: {missing}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was enabled on the VO path")
    print(f"[vo] phase took {time.perf_counter() - t0:.1f} s")

    # 7. cli
    check_cli(fa, fb, a, smi)
    check_gen(dev)

    # 8. mesh
    tiled_launches = check_mesh(a, b, fa, fb, smi)

    # 9. profile
    profile_stream(a, b, "production")
    profile_stream(a, b, "default")

    # 10. 4k
    del a, b
    torch.cuda.empty_cache()
    uhd_counts, uhd_readings = check_uhd(args.seed, smi)

    kernels = []
    for name, (src, rep) in KERNELS.items():
        r = readings[name]
        dims = ((1, shift_ablation.OUT_R, shift_ablation.OUT_C) if name == "shift_ablation"
                else (1, *r["shape"]))
        bound_ms, bound_by = bounds.bound(name, *dims)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "launches_per_frame": stream_counts.get(name, 0) / N_FRAMES,
            "tiled_launches_per_pair": {path: c[name] for path, c in tiled_launches.items()
                                        if name in c},
            "library_ms": None, "library": NO_LIBRARY_CALL.get(name), **r,
            "bytes": bounds.call_bytes(name, *dims), "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / r["ms"],
            "launches_4k": uhd_counts["4K"].get(name, 0),
            "launches_5k_8k": uhd_counts["5K/8K"].get(name, 0), "uhd": uhd_readings.get(name)})
    for name, (src, replaces, why) in PORT_KERNELS.items():
        r = port_readings[name]
        # The seed launches once a VO step; the scan once a preintegrated segment.
        per_frame = (counts[name] - VO_START_LAUNCHES.get(name, 0)) / N_FRAMES \
            if name == "seed_grid" else None
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "launches_per_frame": per_frame, "library_ms": None,
            "library": why, **r, "bound_share": r["bound_ms"] / r["ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
