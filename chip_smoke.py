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
   reference-signature entry's time and the launch floor, the warps' rounds
   also as a breakdown (an empty kernel on the body's grid, skipped, band 8
   on zero and on random flow, band 2, the entry);
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
4b. batch (``[batch]`` lines): B independent 1080p streams in one graph
   replay (the reference's ``jax.vmap`` over the pyramidal flow,
   BASELINE.json config 4), on the suite's patterns made on the card by
   ``eval.patterns`` (B=4: translate_medium, translate_vertical,
   rotate_small, no_motion; B=16: the 13 patterns and ``natural_pair``
   at 1, 2 and 3 px): K1-K5's rounds on B=4 with one band index a plane
   (mixed), running, partly and all skipped, bit for bit their plain
   versions and each plane's 2-D round, timed beside their bound; for
   ``production`` and ``default`` at B=4 and B=16 an eager batched step
   under sync debug "error", the batched ``GraphedStream`` over 8 steps
   (counted) and every element bit for bit its own 2-D graphed stream
   (flows, rounds a level, band indices); graphed ms a step and a stream
   at B=1, 4 and 16 (median and spread of 3), the port's launches a replay
   (equal at every B), the trace's kernels and copies a replay, device
   busy share and peak memory;
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
   ``production_fullband`` and ``default``, under device control (the
   reference's ``lax.while_loop`` and ``lax.psum`` early exit on the card:
   every round launched, K6's tile round ``lk.fused_tile_round`` skipping
   on the latch): (a) NCCL at world size 1 in this process, mesh 1x1x1:
   the eager step under sync debug "error" (host reads 0, counted), bit
   for bit its host-steered twin, rounds run and skipped a level, a still
   pair (a, a) that latches at every level's first round; every launch
   against its plain version (K6's tile round running and skipped, its
   sums against du.abs().sum() and the float64 sum within their depth's
   bound); the step as ``flow.TiledGraphedStream`` replays over 8
   alternating pairs and the still pair, bit for bit the eager steps; ms
   a pair eager and graphed (host clock, median and spread of 3), device
   busy of each and its parts, the replay's device launches
   (torch.profiler); against the untiled ``rtl_clamp`` path; K6's tile
   round timed at each extended-tile shape, running and skipped, beside
   its bound, its plain version, an empty kernel on its grid and the
   launch floor;
   ``tiled_lucas_kanade_single_scale`` against
   ``lucas_kanade_single_scale(backend="torch")``; the mesh-tiled VO
   session graphed and eager at world 1 (identical records) against an
   untiled ``rtl_clamp`` session; (b) 4 gloo ranks
   as processes sharing the card (NCCL takes one rank per card) at meshes
   1x2x2 and 1x4x1, each against the untiled card result, each kernel
   launch on a tile (K1, K2, K4, K6's tile round, and K3 / K5 on 1x4x1's
   replicated coarsest level) against its plain version on that tile, host
   reads (0) and rounds a level per rank, launches a
   frame pair per rank, halo and gather bytes, host-clock ms a frame pair
   and each rank's device busy ms (torch.profiler, also on (a) and (e))
   beside the untiled path's; (c) the mesh-tiled VO session (1x2x2,
   ``default``, grid step 16, 8 frames) against an untiled ``rtl_clamp``
   session; (d)
   ``ba.solve(8)`` over the ``[vo]`` phase's 1080p problem in 4
   observation shards against the unsharded solve, twice; (e) NCCL with
   one rank per card where the machine has two cards or more, eager and
   graphed (a refused capture printed; the replay's device busy and
   launches), every launch of one eager step a config held against its
   plain version on every rank (``--mesh-cards-only`` runs (e) and phase
   10's four-card parts alone, after ``[dp]``: bench_scaling's
   data-parallel design point on a 4x1x1 mesh, one rank a card, each
   rank's slice of a B=4 and a B=8 batch of 1080p streams in one batched
   ``GraphedStream`` under ``default``, the slices all-gathered and held
   element by element against one card's batch, graphed ms a step by rank
   beside one card's; then three meshes in that NCCL world with live
   ``TiledGraphedStream``s released by ``sharding.release_mesh`` and the
   world destroyed, each rank under a watchdog);
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
   check_4k.sh's rule); the tiled path at 4K, the reference's design
   point (``[mesh4k]`` lines): (a) NCCL world 1 in this process, every
   level tiled (extended tiles 2166x3846, 1086x1926, 546x966), checked as
   phase 8 (a) checks 1080p (host reads 0 under sync debug "error", the
   host-steered twin, the still pair, every launch against its plain
   version, the graphed stream, ms and busy, the untiled ``rtl_clamp``
   result, K6's tile round timed at each 4K tile) with its peak device
   memory; (b-c) on four cards only (``--mesh-cards-only``; the one-card
   run prints that they did not run): one NCCL rank a card at 1x2x2, 1x4x1
   and 2x1x2 (two streams, a -> b and b -> a, one a batch slice), both
   configs eager and graphed, every launch on every rank against its plain
   version, the assembled flow of each element against the untiled card
   result, rounds, launches, halo and gather bytes, each rank's busy beside
   world 1's; the tiled VO session on 1x2x2 (``default``, grid 16, 8
   frames) graphed on every rank against its eager twin and an untiled
   ``rtl_clamp`` session, and ``ba.solve(8)`` over its observations in
   one shard a card over NCCL against the unsharded solve; the VO path at
   4K (``[vo4k]`` lines): the grid seed kernel at 2160x3840 (32,400 cells)
   as phase 6 checks it at 1080p, and an untiled ``OdometrySession`` at
   3840x2160, fx = fy = 1920, grid 16, 8 frames, under ``production`` and
   ``default`` with the forward-backward check, as phase 6 checks its
   sessions (graphed, eager and plain-version records identical, host
   reads 0, two ``solve(8)`` with the same bits, ms a frame, peak device
   memory); the stage profiler at 4K under ``production``
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
bit-exact against its plain version (K6's tile round's sums within
gamma_depth of their float64 sum and 2 gamma_depth of du.abs().sum(),
``tile_sum_limits``), the device-controlled step bit for bit its
host-steered twin and its graph replays, no host read, every rank holding
the same result and running the same rounds,
the tiled VO session's alive flags identical on 99.9% of the slot records,
its landmark ids identical and its live tracks within 1e-3 px on 99.9% of them and 0.05 px on all,
the sharded solve's mean reprojection error within 1e-4 px of the
unsharded one's and two sharded solves bit-identical (``MESH_*``); at
4K the same limits, every level tiled, and on four cards the sharded
solve's camera translations within 2e-2 of the unsharded solve's
(``BA_POSES_ATOL``, the reference's limit).

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
phase 4b's batched streams, of phase 10's eager runs at 4K and at 5K and 8K, and a one-call PyTorch
yardstick's time where one exists, else null with the reason),
and ``{"ok": true, "device": {...}}`` as the last line. Frames are
made from ``--seed`` with numpy and scipy; the suite is the committed
fixture. Needs one CUDA device; fails without one. Run:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
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
from tpuflow_torch.flow import GraphedStream, TiledGraphedStream, pyramidal
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
    # K6's round form on the tiled path's halo-extended tiles (the same
    # Pallas call, reached by tpuflow/sharding/tiled_pyramidal.py:198).
    "lk_fused_tile_round": (FUSED_CU, "tpuflow/kernels/pallas_lk.py:460"),
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
    "lk_fused_tile_round": "no single PyTorch call computes the LK solve, its crop, mask and "
                           "in-place add under a latch",
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
    # Phase 4b: B independent streams in one graph replay (each counted
    # run also steps every element's own 2-D stream).
    "batch production": {"warp_packed_u8", "warp_packed_u16", "lk_refine"},
    "batch default": {"warp_exact", "lk_refine_exact"},
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
    # Phase 8, the tiled paths under device control, counted on each rank:
    # every level tiled (K6's tile round on each tile) except at 1x4x1,
    # whose coarsest level runs replicated (K3 / K5); eager and, over NCCL,
    # graphed; tiled single scale is plain torch ops.
    "mesh 1x1x1 production_fullband": {"warp_packed_u8", "warp_packed_u16",
                                       "lk_fused_tile_round"},
    "mesh 1x1x1 default": {"warp_exact", "lk_fused_tile_round"},
    "mesh 1x1x1 production_fullband graphed": {"warp_packed_u8", "warp_packed_u16",
                                               "lk_fused_tile_round"},
    "mesh 1x1x1 default graphed": {"warp_exact", "lk_fused_tile_round"},
    "mesh 1x1x1 single scale": set(),
    "mesh 1x1x1 vo graphed": {"warp_exact", "lk_fused_tile_round", "seed_grid"},
    "mesh 1x2x2 production_fullband": {"warp_packed_u8", "warp_packed_u16",
                                       "lk_fused_tile_round"},
    "mesh 1x2x2 default": {"warp_exact", "lk_fused_tile_round"},
    "mesh 1x1x2 production_fullband": {"warp_packed_u8", "warp_packed_u16",
                                       "lk_fused_tile_round"},
    "mesh 1x1x2 default": {"warp_exact", "lk_fused_tile_round"},
    "mesh 1x4x1 production_fullband": {"warp_packed_u8", "warp_packed_u16",
                                       "lk_fused_tile_round", "lk_refine"},
    "mesh 1x4x1 default": {"warp_exact", "lk_fused_tile_round", "lk_refine_exact"},
    "mesh vo": {"warp_exact", "lk_fused_tile_round", "seed_grid"},
    # Phase 10, the tiled path at 4K: every level tiled on every mesh (no
    # replicated level, so no K3 / K5), at NCCL world 1 and, with
    # --mesh-cards-only, one rank a card on four cards.
    **{f"mesh4k {mesh} production_fullband{g}": {"warp_packed_u8", "warp_packed_u16",
                                                  "lk_fused_tile_round"}
       for mesh in ("1x1x1", "1x2x2", "1x4x1", "2x1x2") for g in ("", " graphed")},
    **{f"mesh4k {mesh} default{g}": {"warp_exact", "lk_fused_tile_round"}
       for mesh in ("1x1x1", "1x2x2", "1x4x1", "2x1x2") for g in ("", " graphed")},
    "mesh4k vo graphed": {"warp_exact", "lk_fused_tile_round", "seed_grid"},
}
# The kernels whose main paths are phase 8's (the tiled flow), held to the
# launch check after it rather than after phase 4.
MESH_PATH_KERNELS = {"lk_fused_tile_round"}
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
# fx = fy as a fraction of the frame's width (1080p: 1536 px).
VO_FOCAL = 0.8
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
# Phase 8 (a): each tiled step timed as a stream of MESH_PAIRS pairs (b, a,
# b, ...), eager and graphed, MESH_RUNS times.
MESH_PAIRS = 8
# K6's tile round: its sums are added in the kernel from its block
# partials, in an order whose depth (kernels.lk.tile_round_depth: a lane's
# adds down its walk, the warp's butterfly, the block's warps, then in the
# last block a thread's strided run of partials, the butterfly and the
# warps) bounds them within gamma_depth = depth u / (1 - depth u) of the
# exact (float64) sum of the same |du|. torch's own sum of the same du (the
# plain version's du.abs().sum()) adds ~n / threads terms a thread and
# then trees, so the two lie within 2 gamma_depth of each other.
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
    # The breakdown: the grid alone, the control words (skipped), the
    # corners' spread (zero against random flow), the band (8 against 2),
    # the round form (against the entry).
    still = torch.zeros_like(u)
    t["zero_flow"] = device_ms(lambda: warp.warp_round(curr, still, still, out, zero,
                                                       max_disp=max_disp, ladder=LADDER,
                                                       band=idx[2], packing=packing))
    geo = warp.tile_geometry(*shape, max_disp, 8)
    t["empty_grid"] = device_ms(lambda: warp.launch_empty_on_grid(*shape, 1, geo))
    entry_ms = device_ms(lambda: warp.warp_banded(curr, u, v, max_disp=max_disp, clamp_flow=True,
                                                  max_disp_v=8, packing=packing))
    plain_ms = device_ms(lambda: warp.warp_round_ref(curr, u, v, out, zero, max_disp=max_disp,
                                                     ladder=LADDER, band=idx[2],
                                                     packing=packing))
    ms = t["band_8"]
    block = (f"staged {geo['tile_w']}x{geo['rows']}" if geo["staged"] else
             f"gathers {geo['tile_w']}x{geo['rows']}, {geo['cols']} column"
             f"{'s' if geo['cols'] > 1 else ''} a thread")
    print(f"[{tag}] {name} round {shape[0]}x{shape[1]}: bit-exact to the host-int band and the "
          f"plain round at bands {LADDER}, skipped rounds untouched; {ms:.4f} ms at band 8 "
          f"({_bound_note(name, shape, ms)}), {t['band_2']:.4f} at 2; skipped "
          f"{t['skipped']:.4f}; entry warp_banded {entry_ms:.4f}; plain round {plain_ms:.4f}; "
          f"launch floor {floor_ms:.4f} ms; breakdown ({block}, {geo['threads']} threads): "
          f"an empty kernel on its grid {t['empty_grid']:.4f}, skipped +"
          f"{t['skipped'] - t['empty_grid']:.4f} over it, zero flow {t['zero_flow']:.4f} "
          f"(random +{ms - t['zero_flow']:.4f}), band 2 {ms - t['band_2']:+.4f} below band 8, "
          f"the round {ms - entry_ms:+.4f} over the entry")
    readings[name].setdefault("by_shape", {}).setdefault(f"{shape[0]}x{shape[1]}", {}).update(
        round_ms=t, entry_ms=entry_ms, round_plain_ms=plain_ms, block=geo)
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


# -- phase 4b: batched streams -------------------------------------------------------------

# B independent 1080p streams in one graph replay (the reference's jax.vmap
# over the pyramidal flow, BASELINE.json config 4): B=4 mixes bands and
# latches; B=16 is 13 patterns and 3 natural_pair shifts.
BATCH_PATTERNS = ("translate_medium", "translate_vertical", "rotate_small", "no_motion")
BATCH_NATURAL_DX = (1.0, 2.0, 3.0)
BATCH_SIZES = (1, 4, 16)
BATCH_FRAMES = 8  # steps a timed run (frame 1, frame 0, ...)
BATCH_CONFIGS = ("production", "default")
BATCH_BANDS = (0, 2, 1, 2)  # one band index a plane of the B=4 round check


def batch_frames(dev, batch: int):
    """The batch's first frames (the suite's base frame, each element) and
    next frames, at 1080p on the card: B=4 ``BATCH_PATTERNS``' frame 1;
    B=16 the 13 patterns' and ``natural_pair`` at ``BATCH_NATURAL_DX``
    (whose frame 0 is the same base); B=1 the first pattern."""
    base = patterns.load_base_texture(WIDTH, HEIGHT)
    names = list(BATCH_PATTERNS) if batch <= 4 else list(patterns.TEST_PATTERNS)
    nxt = [patterns.apply_motion(base, patterns.TEST_PATTERNS[n], dev) for n in names[:batch]]
    labels = names[:batch]
    if batch == 16:
        for dx in BATCH_NATURAL_DX:
            nxt.append(profile.natural_pair(HEIGHT, WIDTH, dx, device=dev)[1].cpu().numpy())
            labels.append(f"natural_pair dx={dx:g}")
    first = torch.from_numpy(np.stack([base] * batch).astype(np.float32)).to(dev)
    return first, torch.from_numpy(np.stack(nxt).astype(np.float32)).to(dev), labels


@contextmanager
def logged_bands(log: list):
    """Record every band index the driver picks (device tensors)."""
    real = pyramidal._select_band_index

    def logged(*args, **kw):
        idx = real(*args, **kw)
        log.append(idx)
        return idx

    pyramidal._select_band_index = logged
    try:
        yield log
    finally:
        pyramidal._select_band_index = real


def run_batch(stream: GraphedStream, first, nxt, steps: int = BATCH_FRAMES, keep: bool = True):
    """``steps`` replays of a (batched) graphed stream from ``first``'s
    pyramid: frames nxt, first, nxt, ... Returns the flows and rounds of
    each step (empty with ``keep=False``) and the seconds."""
    cfg = stream.cfg
    stream.reset(torch_ref.build_gaussian_pyramid(first, cfg.levels, cfg.scale_factor))
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        u, v = stream.step(nxt if i % 2 == 0 else first)
        if keep:
            out.append((u, v, stream.level_rounds.clone()))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_batch_rounds(dev, first, nxt, floor_ms: float) -> None:
    """K1-K5's rounds on a B=4 batch with one band index a plane
    (``BATCH_BANDS``), at the levels of the batch's pyramid: running,
    partly and all skipped, each bit for bit its plain version and each
    plane's own 2-D round; one launch a round, timed beside its bound (B
    planes' bytes) and the plain version."""
    rng = np.random.default_rng(41)
    band = torch.tensor(BATCH_BANDS, dtype=torch.int32, device=dev)
    pyr_a = torch_ref.build_gaussian_pyramid(first, 3, 0.5)
    pyr_b = torch_ref.build_gaussian_pyramid(nxt, 3, 0.5)
    cases = [("warp_packed_u8", pyr_b[2], "u8"), ("warp_exact", pyr_b[2], "exact"),
             ("warp_packed_u16", pyr_b[1], "u16"), ("warp_packed_u16", pyr_b[0], "u16"),
             ("lk_refine", pyr_b[2], True), ("lk_refine_exact", pyr_b[2], False),
             ("lk_refine", pyr_b[1], True)]
    lines = []
    for name, img, how in cases:
        shape = tuple(img.shape)
        u, v = _flow(rng, shape, 9.0, dev)
        ms = None
        for latch in ((0, 0, 0, 0), (0, 1, 0, 1), (1, 1, 1, 1)):
            flag = torch.tensor(latch, dtype=torch.int32, device=dev)
            if name.startswith("warp"):
                fill = _flow(rng, shape, 100.0, dev)[0]
                kw = dict(max_disp=8, ladder=LADDER, band=band, packing=how)
                got = warp.warp_round(img, u, v, fill.clone(), flag, **kw)
                want = warp.warp_round_ref(img, u, v, fill.clone(), flag, **kw)
                ones = [fill[b] if latch[b] else warp.warp_round(
                    img[b], u[b], v[b], fill[b].clone(), flag[b:b + 1],
                    **dict(kw, band=band[b:b + 1])) for b in range(4)]
                same = torch.equal(got, want) and all(torch.equal(got[b], ones[b])
                                                      for b in range(4))
                if not any(latch):
                    out = torch.empty_like(img)
                    ms = device_ms(lambda: warp.warp_round(img, u, v, out, flag, **kw))
                    plain_ms = device_ms(lambda: warp.warp_round_ref(img, u, v, out, flag, **kw))
            else:
                prev = pyr_a[2] if shape == tuple(pyr_a[2].shape) else pyr_a[1]
                ctrl = torch.zeros((lk.CTRL_ROWS, 4), dtype=torch.int32, device=dev)
                ctrl[0] = flag
                c0, c_ref = ctrl.clone(), ctrl.clone()
                kw = dict(ladder=tuple(map(float, LADDER)), band=band, relaxed_order=how)
                got = lk.refine_round(prev, img, u, v, ctrl, **kw)
                want = lk.refine_round_ref(prev, img, u, v, c_ref, **kw)
                same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                        and torch.equal(ctrl, c_ref))
                for b in range(4):
                    one_c = c0[:, b].clone()
                    one = lk.refine_round(prev[b], img[b], u[b], v[b], one_c,
                                          **dict(kw, band=band[b:b + 1]))
                    same = same and torch.equal(got[0][b], one[0]) and torch.equal(
                        got[1][b], one[1]) and torch.equal(ctrl[:, b], one_c)
                if not any(latch):
                    ms = device_ms(lambda: lk.refine_round(prev, img, u, v, c0.clone(), **kw))
                    plain_ms = device_ms(lambda: lk.refine_round_ref(prev, img, u, v, c0.clone(),
                                                                     **kw))
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"[batch] {name} B=4 round at {shape}, bands {BATCH_BANDS}, "
                                     f"latches {latch}: not bit for bit its plain version and "
                                     f"its planes' 2-D rounds")
        bound_ms = bounds.bound_ms(name, *shape)
        lines.append(f"{name} {shape[0]}x{shape[1]}x{shape[2]} {ms:.4f} ms (bound "
                     f"{bound_ms:.5f}, {100 * bound_ms / ms:.1f}%; plain {plain_ms:.4f})")
    print(f"[batch] K1-K5 rounds on B=4 with bands {[LADDER[i] for i in BATCH_BANDS]} a plane, "
          f"running, partly and all skipped: bit for bit their plain versions and each plane's "
          f"own 2-D round; one launch a round: " + "; ".join(lines)
          + f"; launch floor {floor_ms:.4f} ms")


def check_batch_stream(config: str, first, nxt, labels, smi: str) -> dict:
    """One config's batched stream against each element's 2-D graphed
    stream, bit for bit (flows, rounds and bands), with the eager batched
    step under sync debug "error" and counted; returns the launches of the
    batched graphed run."""
    cfg = PYRAMID_CONFIGS[config]
    batch = first.shape[0]
    carry = torch_ref.build_gaussian_pyramid(first, cfg.levels, cfg.scale_factor)
    lucas_kanade_pyramidal_step(carry, nxt, cfg, backend="cuda")  # warm-up
    torch.cuda.synchronize()
    with no_sync():
        lucas_kanade_pyramidal_step(carry, nxt, cfg, backend="cuda")
    torch.cuda.synchronize()
    stream = GraphedStream(first, cfg)
    (flows, _), counts = counted(f"batch {config}", lambda: run_batch(stream, first, nxt))
    with logged_bands([]) as bands:
        lucas_kanade_pyramidal_step(carry, nxt, cfg, backend="cuda")
    single = GraphedStream(first[0], cfg)
    single_bands = []
    for b in range(batch):
        (one, _), _ = counted(f"batch {config}", lambda: run_batch(single, first[b], nxt[b]))
        for (u, v, r), (ou, ov, orr) in zip(flows, one):
            if not (torch.equal(u[b], ou) and torch.equal(v[b], ov) and torch.equal(r[b], orr)):
                raise AssertionError(f"[batch] {config} B={batch} element {b} ({labels[b]}) is "
                                     f"not its own 2-D stream: max |du| {max_abs(u[b], ou)}, "
                                     f"rounds {r[b].tolist()} / {orr.tolist()}")
        with logged_bands([]) as one_bands:
            lucas_kanade_pyramidal_step([c[b] for c in carry], nxt[b], cfg, backend="cuda")
        if [int(x[b]) for x in bands] != [int(x) for x in one_bands]:
            raise AssertionError(f"[batch] {config} element {b}: bands "
                                 f"{[int(x[b]) for x in bands]} against its own {one_bands}")
        single_bands.append([int(x) for x in one_bands])
    rounds = flows[0][2].tolist()
    if any(not torch.isfinite(u).all() or not torch.isfinite(v).all() for u, v, _ in flows):
        raise AssertionError(f"[batch] {config} B={batch}: non-finite flow")
    print(f"[batch] {config} B={batch} at {HEIGHT}x{WIDTH} ({', '.join(labels)}): every element "
          f"bit for bit its own 2-D graphed stream over {BATCH_FRAMES} steps (flows, rounds, "
          f"bands); an eager batched step under sync debug \"error\": no synchronizing "
          f"operation; first step's rounds a level by element {rounds}, band index a level by "
          f"element {single_bands}; launches {counts} ({smi})")
    del stream, single
    return counts


def time_batch(config: str, smi: str) -> dict:
    """Graphed ms a step and a stream at each of BATCH_SIZES (median and
    spread of STREAM_RUNS runs of BATCH_FRAMES steps, host clock), launches
    a replay (the capture's, and the trace's kernels), device busy share
    (torch.profiler) and peak device memory."""
    cfg = PYRAMID_CONFIGS[config]
    dev = torch.device("cuda", 0)
    out = {}
    for batch in BATCH_SIZES:
        first, nxt, _ = batch_frames(dev, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        stream = GraphedStream(first, cfg)
        run_batch(stream, first, nxt, 2, keep=False)
        step_ms = [1000 * run_batch(stream, first, nxt, keep=False)[1] / BATCH_FRAMES
                   for _ in range(STREAM_RUNS)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        events = device_events(lambda: run_batch(stream, first, nxt, keep=False))
        busy, in_port = (t / BATCH_FRAMES for t in busy_of(events)[:2])
        gemm = sum(e.self_device_time_total for e in events
                   if "gemm" in e.key.lower()) / 1000 / BATCH_FRAMES
        kernels, copies = device_launches(events)
        port = sum(stream.launches.values())
        med = float(np.median(step_ms))
        out[batch] = {"step_ms": step_ms, "stream_ms": [t / batch for t in step_ms],
                      "busy_ms": busy, "busy_share": busy / med, "port_ms": in_port,
                      "gemm_ms": gemm, "port_launches": port,
                      "traced_kernels": kernels / BATCH_FRAMES,
                      "traced_copies": copies / BATCH_FRAMES, "peak_gib": peak}
        print(f"[batch] {config} B={batch} graphed: {med:.3f} ms a step (runs "
              f"{', '.join(f'{t:.3f}' for t in step_ms)}), {med / batch:.4f} ms a stream; "
              f"{port} launches of the port's kernels a replay ({stream.launches}); the trace's "
              f"kernels a replay {kernels / BATCH_FRAMES:.0f}, copies {copies / BATCH_FRAMES:.0f};"
              f" busy {busy:.3f} ms a step ({in_port:.3f} in the port's kernels, {gemm:.3f} in "
              f"GEMMs), {100 * busy / med:.1f}% of the host ms; peak "
              f"{peak:.2f} GiB ({smi})")
        del stream, first, nxt
        torch.cuda.empty_cache()
    launches = {b: out[b]["port_launches"] for b in BATCH_SIZES}
    if len(set(launches.values())) != 1:
        raise AssertionError(f"[batch] {config}: the port's launches a replay grow with B: "
                             f"{launches}")
    return out


def check_batch(smi: str, floor_ms: float) -> tuple[dict, dict]:
    """Phase 4b (``[batch]`` lines): B independent 1080p streams in one
    graph replay. Returns the batched runs' launches and the timings."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    first, nxt, labels = batch_frames(dev, 4)
    check_batch_rounds(dev, first, nxt, floor_ms)
    counts, timings = {}, {}
    for batch in (4, 16):
        if batch == 16:
            first, nxt, labels = batch_frames(dev, 16)
        for config in BATCH_CONFIGS:
            for name, n in check_batch_stream(config, first, nxt, labels, smi).items():
                counts[name] = counts.get(name, 0) + n
    del first, nxt
    torch.cuda.empty_cache()
    for config in BATCH_CONFIGS:
        timings[config] = time_batch(config, smi)
    print(f"[batch] phase took {time.perf_counter() - t0:.1f} s")
    return counts, timings


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


def vo_session(a, chunk, name: str, eager: bool = False, focal: float = VO_FOCAL):
    """The OdometrySession ``name`` (VO_SESSIONS) on the card at a's size,
    fx = fy = ``focal`` times its width: start on a, then the chunk through
    process_frames (each step one replay of the captured step), or with
    ``eager`` frame by frame through process_frame (each step eager).
    Returns it and the chunk's seconds (host clock to a synchronize)."""
    config, fb, stride = VO_SESSIONS[name]
    h, w = a.shape
    fx = fy = focal * w
    sess = OdometrySession((fx, fy, w / 2.0, h / 2.0), keyframe_stride=stride,
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


def check_vo_session(a, b, chunk, name: str, smi: str, focal: float = VO_FOCAL,
                     tag: str = "vo"):
    """Phase 6 at 1080p (and phase 10 at 4K), one session (VO_SESSIONS) at
    a's size over the chunk: (a) two eager steps under sync debug "error";
    the graphed session's launches, host reads, reseeds taken, time a
    frame and peak device memory; (g) the same session stepped eagerly, its
    ObsRecords and reseeds identical to the graphed ones, and its time a
    frame; then solve(ba_iterations=8) twice (identical bits) and the same
    session through the plain versions, its ObsRecords identical too."""
    config, fb, stride = VO_SESSIONS[name]
    dev = a.device
    h, w = a.shape
    n = len(chunk)

    def session(frames, eager=False):
        return vo_session(a, frames, name, eager=eager, focal=focal)

    session(chunk)  # warm-up, and the step's capture
    session(chunk[:2], eager=True)
    probe = session(chunk[:0])[0]
    torch.cuda.synchronize()
    with no_sync():
        probe.process_frame(chunk[0])
        probe.process_frame(chunk[1])
    torch.cuda.synchronize()
    pyramidal.counters.reset()
    torch.cuda.reset_peak_memory_stats()
    ((sess, _), syncs), counts = counted(
        f"vo {name}", lambda: host_syncs(lambda: session(chunk)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    reads = (pyramidal.counters.convergence_reads, pyramidal.counters.band_reads)
    reseeds = int(pyramidal.counters.reseeds(dev))
    seconds = sorted(session(chunk)[1] for _ in range(VO_RUNS))
    ms = [1000 * s / n for s in seconds]
    alive = int(sess._dev.alive.sum())
    print(f"[{tag}] {name} session {h}x{w}, fx = fy = {focal * w:g}, grid {VO_GRID} "
          f"({sess._dev.alive.numel()} slots), keyframe stride {stride}, {n} frames "
          f"through process_frames{', fb check 1.0 px' if fb else ''}, each step a graph "
          f"replay: front end {_spread(ms)} ({smi}), tracks alive {alive}, landmarks "
          f"{sess.n_landmarks}, reseeds taken {reseeds} of {n} steps (the seed kernel's "
          f"device counter), launches {counts}, host reads convergence {reads[0]} band "
          f"{reads[1]} (the capture's launches, added a replay), synchronizing operations "
          f"{len(syncs)}; two eager steps under sync debug "
          f"\"error\": none; peak device memory {peak:.2f} GiB")
    if syncs or sum(reads):
        raise AssertionError(f"vo {name}: {len(syncs)} synchronizing operations "
                             f"{sorted(set(syncs))}, flow reads {reads}")
    if alive < 0.5 * sess._dev.alive.numel():
        raise AssertionError(f"vo {name}: only {alive} tracks alive")
    if not 0 < reseeds <= n // stride:
        raise AssertionError(f"vo {name}: {reseeds} reseeds taken in {n} steps at "
                             f"stride {stride}")

    pyramidal.counters.reset()
    first, e_counts = counted(f"vo {name}", lambda: session(chunk, eager=True))
    e_reseeds = int(pyramidal.counters.reseeds(dev))
    e_runs = [first] + [session(chunk, eager=True) for _ in range(VO_RUNS - 1)]
    eager = e_runs[0][0]
    e_ms = [1000 * s / n for _, s in e_runs]
    got, want = _records(sess), _records(eager)
    same = _same_records(got, want) and e_reseeds == reseeds
    print(f"[{tag}] {name} the same session stepped eagerly (process_frame): {_spread(e_ms)}, "
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
    print(f"[{tag}] {name} solve(ba_iterations={VO_BA_ITERATIONS}) over {len(sess.keyframes)} "
          f"keyframes, {sum(int(v.sum()) for v in sess.obs_valid)} valid observations: "
          f"{solve_s[0]:.3f} s, then {solve_s[1]:.3f} s; mean reprojection error "
          f"{r0.mean_reprojection_error:.4f} px; two solves {'bit-identical' if same else 'DIFFER'}")
    if not (same and finite and r0.mean_reprojection_error < 1.0):
        raise AssertionError(f"vo {name} solve: identical {same}, finite {finite}, mean "
                             f"reprojection error {r0.mean_reprojection_error}")

    before = launch_counts()
    pyramidal.counters.reset()
    with plain_versions():
        plain, plain_s = session(chunk, eager=True)
    if launch_counts() != before:
        raise AssertionError("the plain VO session launched a kernel")
    p_reseeds = int(pyramidal.counters.reseeds(dev))
    uv, _, ok, _ = _records(sess)
    puv = _records(plain)[0]
    xy = max(float(np.abs(x - y)[v].max(initial=0.0)) for x, y, v in zip(uv, puv, ok))
    same = _same_records(_records(sess), _records(plain)) and p_reseeds == reseeds
    print(f"[{tag}] {name} session through the plain versions on the card: "
          f"{1000 * plain_s / n:.3f} ms/frame, reseeds taken {p_reseeds}; ObsRecords "
          f"{'bit-identical' if same else 'DIFFER'} to the graphed session's (max |dxy| of "
          f"live tracks {xy:.3g} px)")
    if not same:
        raise AssertionError(f"vo {name}: the plain session differs (max |dxy| {xy}, reseeds "
                             f"{p_reseeds} against {reseeds})")
    return float(np.median(ms)), e_counts


def _span(times: tuple[float, float]) -> str:
    return f"{times[0]:.5f}-{times[1]:.5f}"


def check_seed_kernel(a, smi: str, tag: str = "vo") -> dict:
    """Phase 6 at 1080p (and phase 10 at 4K): the grid seed kernel at a's
    size, bit for bit against its plain version on the stream frame and the
    natural frame at margins 0 and the sessions' seed margin, taken and with
    its predicate false; its device time beside its bound and the plain
    version's (the masked reseed every step paid before the gate); a call
    whose predicate is false beside the launch floor."""
    dev = a.device
    h, w = a.shape
    natural = profile.natural_pair(h, w, device=dev)[0].contiguous()
    margin = device_loop.FrontEnd(grid_step=VO_GRID).margin_for(h, w, for_cull=False)
    worst = 0.0
    for label, frame in (("stream", a), ("natural", natural)):
        for m in (0, margin):
            xy, alive = seed.seed_grid(frame, VO_GRID, margin=m)
            want_xy, want_alive = seed.seed_grid_ref(frame, VO_GRID, margin=m)
            err = max_abs(xy, want_xy)
            flips = int((alive != want_alive).sum())
            worst = max(worst, err)
            off = torch.zeros((), dtype=torch.bool, device=dev)
            _, off_alive = seed.seed_grid(frame, VO_GRID, margin=m, predicate=off)
            want_off = seed.seed_grid_ref(frame, VO_GRID, margin=m, predicate=off)
            off_same = torch.equal(off_alive, want_off[1]) and not bool(off_alive.any())
            print(f"[{tag}] seed kernel, {label} frame {h}x{w}, grid {VO_GRID}, margin {m}: "
                  f"{alive.numel()} cells, {int(alive.sum())} alive; max |dxy| {err} and "
                  f"{flips} alive flags against the plain version; predicate false: every cell "
                  f"dead as the plain version's: {off_same}")
            if err or flips or not off_same:
                raise AssertionError(f"seed kernel differs from its plain version ({label}, "
                                     f"margin {m}): max |dxy| {err}, {flips} alive flags, "
                                     f"predicate false alike {off_same}")
    ms = device_ms(lambda: seed.seed_grid(a, VO_GRID, margin=margin))
    plain_ms = device_ms(lambda: seed.seed_grid_ref(a, VO_GRID, margin=margin))
    off = torch.zeros((), dtype=torch.bool, device=dev)
    off_ms = device_ms(lambda: seed.seed_grid(a, VO_GRID, margin=margin, predicate=off))
    _, off_alive = seed.seed_grid(a, VO_GRID, margin=margin, predicate=off)
    if bool(off_alive.any()):
        raise AssertionError("a seed call with a false predicate left a cell alive")
    floor_ms = device_ms(_build.launch_empty)
    bound_ms, by = bounds.seed_bound(h, w, VO_GRID)
    first = {k: f" (first design at 1080p: {_span(t)})" if (h, w) == (HEIGHT, WIDTH) else ""
             for k, t in SEED_FIRST_MS.items()}
    print(f"[{tag}] seed kernel at {h}x{w}, grid {VO_GRID}, margin {margin}: device "
          f"{ms:.5f} ms a call{first['taken']}, bound "
          f"{bound_ms:.5f} ms ({by}), {100 * bound_ms / ms:.1f}% of it, launch floor "
          f"{floor_ms:.5f} ms; plain "
          f"version (the masked reseed paid every step before the gate) {plain_ms:.4f} ms; "
          f"predicate false {off_ms:.5f} ms{first['skipped']}, "
          f"{1000 * (off_ms - floor_ms):.2f} us over the floor; {smi}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "shape": [h, w],
            "grid_step": VO_GRID, "margin": margin, "skipped_ms": off_ms,
            "launch_floor_ms": floor_ms, "bytes": bounds.seed_bytes(h, w, VO_GRID),
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


def device_launches(events) -> tuple[int, int]:
    """The kernels, and the copies and fills, that the device ran in
    ``events``."""
    kernels = sum(e.count for e in events if not e.key.startswith("Mem"))
    return kernels, sum(e.count for e in events) - kernels


# The round kernels' names in a trace -> their launch counters: the warp's
# first template argument (staged tile or gathers) is its packing, the
# column walk's second its order (true: relaxed, K3) and its fourth its
# mode (0: refine).
_TRACED_KERNELS = (
    (re.compile(r"tpuflow_warp::warp_(?:tile|gather)_kernel<(\d+),"),
     {"0": "warp_exact", "8": "warp_packed_u8", "16": "warp_packed_u16"}),
    (re.compile(r"tpuflow_lk::lk_walk_kernel<\d+, (true|false), \d+, 0>"),
     {"true": "lk_refine", "false": "lk_refine_exact"}),
    (re.compile(r"tpuflow_lk::lk_walk_kernel<\d+, false, \d+, (3)>"),
     {"3": "lk_fused_tile_round"}),
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


def tile_sum_limits(shape, window: int = 5) -> tuple[int, float]:
    """K6's tile round on a (H, W) extended tile: its sums' depth and the
    float32 bound gamma_depth."""
    depth = lk.tile_round_depth(*shape, window)
    return depth, depth * F32_UNIT / (1.0 - depth * F32_UNIT)


@contextmanager
def checked_kernels(found: dict, tiles: dict | None = None):
    """Every kernel launch of the path held against its plain version on
    the same inputs: ``found[name][shape]`` is the max |d| over all the
    launches of that kernel and shape (for the rounds, of u, v; inf where
    a refine round's sums are not within SUM_RTOL of the plain round's or
    its control differs, or a running tile round's sums not within its
    limits (``tile_sum_limits``) of du.abs().sum() and of the float64 sum).
    ``tiles``, if given, gets each tile-round shape's running and skipped
    launches, its worst sum distances and the first launch's inputs."""
    saved = (warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round, lk.refine_round,
             lk.fused_tile_round)

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

    def tile_round_checked(prev_ext, warped_ext, u, v, ctrl, **kw):
        ref = [t.clone() for t in (u, v, ctrl)]
        plain = {k: x for k, x in kw.items() if k != "parts"}
        want = lk.fused_tile_round_ref(prev_ext, warped_ext, *ref, **plain)
        skipped = bool(ctrl[0] != 0)
        inputs = [t.clone() for t in (prev_ext, warped_ext, u, v)]
        sums, name = launch(saved[4], prev_ext, warped_ext, u, v, ctrl, **kw)
        err = max(max_abs(u, ref[0]), max_abs(v, ref[1]))
        shape = tuple(prev_ext.shape)
        rel = rel64 = 0.0
        depth, gamma = tile_sum_limits(shape, kw.get("window_size", 5))
        if not skipped:
            du, dv = lk.tile_round_delta_ref(prev_ext, warped_ext, **{
                k: x for k, x in plain.items() if k in ("gy0", "gx0", "gh", "gw", "window_size",
                                                        "det_threshold", "relaxed_order")})
            exact = [float(d.double().abs().sum()) for d in (du, dv)]
            got = [float(x) for x in sums]
            rel = max(abs(g - float(w)) / max(float(w), 1e-30) for g, w in zip(got, want))
            rel64 = max(abs(g - e) / max(e, 1e-30) for g, e in zip(got, exact))
        ok = torch.equal(ctrl, ref[2]) and rel <= 2 * gamma and rel64 <= gamma
        note(name, prev_ext, err if ok else float("inf"))
        if tiles is not None:
            t = tiles.setdefault(shape, {"running": 0, "skipped": 0, "sum_rel": 0.0,
                                         "sum_rel_f64": 0.0, "depth": depth, "gamma": gamma})
            t["skipped" if skipped else "running"] += 1
            t["sum_rel"], t["sum_rel_f64"] = max(t["sum_rel"], rel), max(t["sum_rel_f64"], rel64)
            if not skipped:
                t.setdefault("inputs", (inputs, kw))
        return sums

    (warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round, lk.refine_round,
     lk.fused_tile_round) = (warp_checked, fused_checked, warp_round_checked,
                             refine_round_checked, tile_round_checked)
    try:
        yield
    finally:
        (warp.warp_banded, lk.lucas_kanade_fused, warp.warp_round, lk.refine_round,
         lk.fused_tile_round) = saved


def _mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def _tracked_session(a, config: str, mesh=None, rtl_clamp: bool = False,
                     focal: float = VO_FOCAL):
    """A session at a's size started on ``a``, fx = fy = ``focal`` times
    its width. ``rtl_clamp`` gives an untiled session the saturation of
    the tiled flow's, its counterpart."""
    h, w = a.shape
    fx = fy = focal * w
    sess = OdometrySession((fx, fy, w / 2.0, h / 2.0), grid_step=VO_GRID,
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
    tiles: dict = {}
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
            with checked_kernels(found, tiles):
                (u, v), counts = counted(f"mesh {key}", run)
            traffic = mesh_counters.traffic()
            rounds = mesh_counters.level_rounds[0].tolist()
            dist.barrier(mesh.group)
            report["flow"][key] = {"launches": counts, "traffic": traffic, "ms": _host_ms(run),
                                   "device_ms": busy_ms(run), "rounds": rounds}
            if rank == 0:
                arrays[f"{key}/u"], arrays[f"{key}/v"] = u[0].cpu().numpy(), v[0].cpu().numpy()
            report["flow"][key]["digest"] = _digest(u.cpu().numpy(), v.cpu().numpy())
    report["kernels"] = {n: {"x".join(map(str, s)): e for s, e in shapes.items()}
                         for n, shapes in found.items()}
    report["tile_sums"] = {"x".join(map(str, s)): {k: t[k] for k in (
        "running", "skipped", "sum_rel", "sum_rel_f64", "gamma")} for s, t in tiles.items()}

    # (c) the mesh-tiled VO session.
    chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
    sess = _tracked_session(a, "default", vo_mesh)
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


def _nccl_flow(mesh, prev, curr, config: str, path: str, found: dict, tiles: dict,
               note=lambda what: None):
    """One config's tiled step over an NCCL mesh on global (B, H, W)
    frames: its launches a pair (counted as ``path``), traffic, this rank's
    rounds a level, host-clock ms and device busy; the step graphed on every
    rank (a refused capture recorded, not hidden), its first replay against
    the eager step, ms a pair over MESH_PAIRS alternating pairs, busy and
    launches of a replay; then one eager step with every kernel launch held
    against its plain version (``checked_kernels``); ``note`` hears each
    stage's end. Returns the report and the eager flow."""
    cfg = PYRAMID_CONFIGS[config]

    def run():
        return tiled_lucas_kanade_pyramidal(prev, curr, mesh, config=cfg, backend="cuda")

    run()  # warm-up: operator slices, NCCL buffers
    mesh_counters.reset()
    (u, v), counts = counted(path, run)
    traffic = mesh_counters.traffic()
    rounds = mesh_counters.level_rounds.tolist()
    dist.barrier(mesh.group)
    report = {"launches": counts, "traffic": traffic, "rounds": rounds, "ms": _host_ms(run),
              "device_ms": busy_ms(run), "digest": _digest(u.cpu().numpy(), v.cpu().numpy())}
    note("eager")
    # The step graphed on every rank, its halo exchanges (NCCL point to
    # point) captured too; a refused capture is recorded, not hidden.
    try:
        stream = TiledGraphedStream(prev, cfg, mesh)
        gu, gv = stream.step(curr)
        report["graphed_same"] = bool(torch.equal(gu, u) and torch.equal(gv, v))
        report["graphed_ms"] = [t / MESH_PAIRS for t in _host_ms(
            lambda: [stream.step(c) for _, c in _alternating(prev, curr)])]
        events = device_events(lambda: stream.step(curr))
        report["graphed_device_ms"] = busy_of(events)
        report["graphed_launches"] = device_launches(events)
        del stream
    except Exception as exc:  # noqa: BLE001 - the refusal is the reading
        report["graphed_error"] = f"{type(exc).__name__}: {exc}"[:2000]
    note("graphed")
    with checked_kernels(found, tiles):
        run()
    dist.barrier(mesh.group)
    return report, u, v


def _checked_report(found: dict, tiles: dict) -> tuple[dict, dict]:
    """``checked_kernels``' findings as JSON: each kernel's worst |d| by
    tile shape, and the tile round's launches and sum distances by shape."""
    return ({n: {"x".join(map(str, s)): e for s, e in shapes.items()}
             for n, shapes in found.items()},
            {"x".join(map(str, s)): {k: t[k] for k in (
                "running", "skipped", "sum_rel", "sum_rel_f64", "gamma")}
             for s, t in tiles.items()})


def nccl_rank(rank: int, world: int, work: str, shape) -> None:
    """One rank per card over NCCL (phase 8 e): the tiled flow under each
    config at 1080p (``_nccl_flow``)."""
    initialize_multihost(f"file://{work}/store_nccl", world, rank, backend="nccl")
    mesh = make_flow_mesh(*shape)
    ops.pin_f32_matmul()
    frames = np.load(f"{work}/frames.npz")
    a, b = (torch.from_numpy(frames[k]).to(mesh.device) for k in ("a", "b"))
    report, arrays = {}, {}
    found: dict = {}
    tiles: dict = {}
    for config in MESH_CONFIGS:
        report[config], u, v = _nccl_flow(mesh, a[None], b[None], config,
                                          f"mesh {_mesh_name(shape)} {config}", found, tiles)
        if rank == 0:
            arrays[f"{config}/u"], arrays[f"{config}/v"] = u[0].cpu().numpy(), v[0].cpu().numpy()
    report["kernels"], report["tile_sums"] = _checked_report(found, tiles)
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
    for config in MESH_CONFIGS:
        rep0 = reports[0][config]
        if any(r[config]["digest"] != rep0["digest"] for r in reports):
            raise AssertionError(f"mesh nccl {config}: the ranks hold different flows")
        if "graphed_error" in rep0:
            print(f"[mesh] (e) {_mesh_name(shape)} {config} graphed over NCCL: capture REFUSED "
                  f"on rank 0: {rep0['graphed_error']}")
        else:
            gms = sorted(rep0["graphed_ms"])
            kernels, copies = rep0["graphed_launches"]
            busy = _device_note([r[config]["graphed_device_ms"] for r in reports],
                                untiled_dev[config])
            print(f"[mesh] (e) {_mesh_name(shape)} {config} graphed over NCCL "
                  f"(TiledGraphedStream on every rank): first replay bit for bit the eager "
                  f"step on every rank: {all(r[config]['graphed_same'] for r in reports)}; "
                  f"{gms[len(gms) // 2]:.3f} ms a pair (host clock, median of {len(gms)} "
                  f"streams of {MESH_PAIRS}, spread {gms[0]:.3f}-{gms[-1]:.3f}); rank 0's "
                  f"device launches a replay {kernels} kernels, {copies} copies and fills; "
                  f"graphed {busy}")
            if not all(r[config]["graphed_same"] for r in reports):
                raise AssertionError(f"mesh nccl {config}: graphed differs from eager")
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
    for shape_key, t in sorted(reports[0]["tile_sums"].items()):
        print(f"[mesh] (e) lk_fused_tile_round on {shape_key} extended tiles: {t['running']} "
              f"running, {t['skipped']} skipped launches a rank 0; sums within {t['sum_rel']:.3g} "
              f"of du.abs().sum() (limit {2 * t['gamma']:.3g}), {t['sum_rel_f64']:.3g} of the "
              f"float64 sum (limit {t['gamma']:.3g})")
    for name in sorted(reports[0]["kernels"]):
        worst = max(max(r["kernels"][name].values()) for r in reports)
        print(f"[mesh] (e) {name} on tile shapes {sorted(reports[0]['kernels'][name])}, every "
              f"rank: max |d| against the plain version {worst:.3g}")
        if worst != 0.0:
            raise AssertionError(f"mesh nccl: {name} differs from its plain version on a tile")
    if "lk_fused_tile_round" not in reports[0]["kernels"]:
        raise AssertionError("mesh nccl: no tile round was checked")


def _device_note(per_rank: list, untiled) -> str:
    """Each rank's device busy ms a frame pair, with its parts in the port's
    kernels, in copies and in NCCL's kernels (torch.profiler, one run),
    beside the untiled path's."""
    return (f"device busy ms a pair by rank (in the port's kernels, in copies, in NCCL) "
            f"{', '.join(_busy(ms) for ms in per_rank)}, one profiled run each; "
            f"untiled {_busy(untiled)}")


def session_problem(sess) -> "ba.BAProblem":
    """The bundle-adjustment problem ``sess.solve`` builds from its
    keyframes (the solve run once to build it)."""
    captured = {}
    solve = ba.solve

    def capture(p, *args, **kw):
        captured.setdefault("problem", p)
        return solve(p, *args, **kw)

    ba.solve = capture
    try:
        sess.solve(ba_iterations=VO_BA_ITERATIONS)
    finally:
        ba.solve = solve
    return captured["problem"]


def _busy(ms) -> str:
    """A ``busy_of`` reading: busy ms (in the port's kernels, copies, NCCL)."""
    return f"{ms[0]:.3f} ({ms[1]:.3f}, {ms[2]:.3f}, {ms[3]:.3f})"


def _spawn(target, args_of, n: int, what: str, wall: float = MESH_WALL_S) -> None:
    """Start n processes of ``target`` and wait for all, each within the
    wall limit; any failure or hang fails the phase."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + wall
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
                             f"{len(hung)} killed at the {wall} s limit")


def _tile_step(mesh, cfg):
    """The eager device-controlled tiled step of one (prev, curr) pair."""
    def step(prev, curr):
        return tiled_lucas_kanade_pyramidal(prev[None], curr[None], mesh, config=cfg,
                                            backend="cuda")
    return step


def _alternating(a, b, n: int = MESH_PAIRS):
    """The pairs of a stream b, a, b, ... after a: (a, b), (b, a), ..."""
    return [(a, b) if i % 2 == 0 else (b, a) for i in range(n)]


def shard_plan(shape, ty: int, tx: int, cfg) -> list[bool]:
    """Which levels of a (..., H, W) frame the tiled path runs tiled on a
    mesh of ty x tx tiles (coarse to fine), as ``tiled_pyramidal`` plans
    them."""
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    dims = tp._level_shapes(*shape[-2:], cfg.levels, cfg.scale_factor)
    return tp._shard_plan(dims, ty, tx, cfg.max_disp + 1)


def time_tile_round(tiles: dict, smi: str, tag: str = "[mesh] (a)") -> dict:
    """Phase 8 (a) (and 10 at 4K): K6's tile round at each extended-tile
    shape the world-1 step gave it (the first running launch's inputs): a skipped
    call (latch set) bit-exact to the plain version (u, v and the control
    untouched); device ms running and skipped beside the bound, the plain
    version's, an empty kernel on the round's grid and the one-block launch
    floor. Returns the kernel's reading (the finest shape's)."""
    reading: dict = {"max_abs_err": 0.0, "by_shape": {}}
    floor_ms = device_ms(_build.launch_empty)
    for shape in sorted(tiles, reverse=True):
        (prev_ext, warped_ext, u, v), kw = tiles[shape]["inputs"]
        kw = {k: x for k, x in kw.items() if k != "parts"}
        dev = u.device
        skip = torch.tensor([1, 0, 5], dtype=torch.int32, device=dev)
        us, vs, skip_ref = u.clone(), v.clone(), skip.clone()
        lk.fused_tile_round(prev_ext, warped_ext, us, vs, skip, **kw)
        lk.fused_tile_round_ref(prev_ext, warped_ext, u.clone(), v.clone(), skip_ref, **kw)
        if not (torch.equal(us, u) and torch.equal(vs, v) and torch.equal(skip, skip_ref)
                and skip.tolist() == [1, 0, 5]):
            raise AssertionError(f"lk_fused_tile_round skipped at {shape}: not a no-op")
        run = torch.zeros(3, dtype=torch.int32, device=dev)
        ms = device_ms(lambda: lk.fused_tile_round(prev_ext, warped_ext, us, vs, run, **kw))
        skip_ms = device_ms(lambda: lk.fused_tile_round(prev_ext, warped_ext, us, vs, skip,
                                                        **kw))
        plain_ms = device_ms(lambda: lk.fused_tile_round_ref(prev_ext, warped_ext, us, vs, run,
                                                             **kw))
        window = kw.get("window_size", 5)
        empty_ms = device_ms(lambda: lk.launch_tile_round_empty(*shape, window))
        rows = _build.load().tpuflow_lk_tile_round_rows(*shape, window)
        t = tiles[shape]
        print(f"{tag} lk_fused_tile_round {shape[0]}x{shape[1]} extended tile: "
              f"{t['running']} running and {t['skipped']} skipped launches bit-exact to the "
              f"plain version, sums within {t['sum_rel']:.3g} of du.abs().sum() (limit "
              f"{2 * t['gamma']:.3g}) and {t['sum_rel_f64']:.3g} of the float64 sum (limit "
              f"{t['gamma']:.3g}, depth {t['depth']}); a skipped call a no-op; {ms:.4f} ms "
              f"({_bound_note('lk_fused_tile_round', shape, ms)}); {rows} rows a block, "
              f"{lk.tile_round_blocks(*shape, window)} blocks; skipped {skip_ms:.4f}; an empty "
              f"kernel on its grid {empty_ms:.4f}; launch floor {floor_ms:.4f}; plain "
              f"{plain_ms:.4f} ms; {smi}")
        reading["by_shape"][f"{shape[0]}x{shape[1]}"] = {
            "ms": ms, "skipped_ms": skip_ms, "empty_grid_ms": empty_ms,
            "launch_floor_ms": floor_ms, "plain_ms": plain_ms, "walk_rows": rows,
            "running_launches": t["running"], "skipped_launches": t["skipped"],
            "sum_rel": t["sum_rel"], "sum_rel_f64": t["sum_rel_f64"], "sum_depth": t["depth"]}
        if "ms" not in reading:  # the finest level's tile, the largest
            reading.update(ms=ms, plain_ms=plain_ms, skipped_ms=skip_ms, shape=list(shape))
    return reading


def check_world_one(a, b, mesh, untiled, untiled_dev, smi, tag: str = "[mesh] (a)",
                    path: str = "mesh", max_px: dict | None = None) -> tuple[dict, dict]:
    """Phase 8 (a) at 1080p (and 10 at 4K, ``tag`` "[mesh4k] (a)", ``path``
    "mesh4k"), NCCL at world 1, mesh 1x1x1, each of MESH_CONFIGS: the
    device-controlled step eager under sync debug "error" (host reads 0,
    counted), bit for bit its host-steered twin (``_tiled_solve(...,
    device_control=False)``, the early exit read to the host), the rounds
    run and skipped a level, and a still pair (a, a) that latches at every
    level's first round; every kernel launch of both pairs against its
    plain version; the step captured as ``TiledGraphedStream`` and replayed
    over MESH_PAIRS alternating pairs, bit for bit the eager steps, rounds
    included; ms a pair eager and graphed (host clock, median and spread of
    MESH_RUNS streams), device busy of each; the limits against the
    untiled card result (the max |d| ``max_px[config]`` where given, else
    MESH_MAX). Returns the launches a pair by path and K6's tile round's
    reading."""
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    tiles: dict = {}
    found: dict = {}
    counts_by_path: dict = {}
    for config in MESH_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]
        plan = shard_plan(a.shape, mesh.ty, mesh.tx, cfg)
        step = _tile_step(mesh, cfg)
        step(a, b)  # warm-up: operator slices, NCCL buffers
        mesh_counters.reset()
        with no_sync():
            (u, v), counts = counted(f"{path} 1x1x1 {config}", lambda: step(a, b))
        reads = mesh_counters.convergence_reads
        rounds = mesh_counters.level_rounds[0].tolist()
        counts_by_path[f"1x1x1 {config}"] = counts
        hu, hv = tp._tiled_solve(a[None], b[None], mesh, cfg, "cuda", device_control=False)
        twin = torch.equal(u, hu) and torch.equal(v, hv)
        zu, zv = step(a, a)
        still_rounds = mesh_counters.level_rounds[0].tolist()
        hzu, hzv = tp._tiled_solve(a[None], a[None], mesh, cfg, "cuda", device_control=False)
        still_twin = torch.equal(zu, hzu) and torch.equal(zv, hzv)
        back = step(b, a)
        with checked_kernels(found, tiles):
            step(a, b)
            step(a, a)
        p999, mx = _p999_max(u[0], v[0], *untiled[config])
        limit = (max_px or {}).get(config, MESH_MAX)

        t0 = time.perf_counter()
        stream = TiledGraphedStream(a[None], cfg, mesh)
        capture_s = time.perf_counter() - t0
        want = [(u, v), back]

        def graphed_stream():
            stream.reset(a[None])
            return [stream.step(c[None]) for _, c in _alternating(a, b)]

        flows, g_counts = counted(f"{path} 1x1x1 {config} graphed", graphed_stream)
        same = all(torch.equal(f[0], want[i % 2][0]) and torch.equal(f[1], want[i % 2][1])
                   for i, f in enumerate(flows))
        g_rounds = stream.level_rounds[0].tolist()
        stream.reset(a[None])
        gz = stream.step(a[None])
        same_still = (torch.equal(gz[0], zu) and torch.equal(gz[1], zv)
                      and stream.level_rounds[0].tolist() == still_rounds)
        eager_ms = [t / MESH_PAIRS for t in _host_ms(
            lambda: [step(p, c) for p, c in _alternating(a, b)])]
        graphed_ms = [t / MESH_PAIRS for t in _host_ms(graphed_stream)]
        dev_eager = busy_ms(lambda: step(a, b))
        graphed_events = device_events(lambda: stream.step(b[None]))
        dev_graphed = busy_of(graphed_events)
        g_kernels, g_copies = device_launches(graphed_events)
        its = cfg.iterations
        eager_sorted, graphed_sorted = sorted(eager_ms), sorted(graphed_ms)
        per_pair = {k: n / MESH_PAIRS for k, n in g_counts.items()}
        print(f"{tag} NCCL world 1, mesh 1x1x1, {config} {a.shape[0]}x{a.shape[1]}, under device "
              f"control: shard plan by level (coarse to fine) {plan}; host reads "
              f"a pair {reads} (counter; the step ran under sync debug \"error\"); rounds run "
              f"a level {rounds}, skipped {[its - r for r in rounds]}; bit for bit the "
              f"host-steered loop: {'yes' if twin else 'NO'}; still pair (a, a): rounds "
              f"{still_rounds}, skipped {[its - r for r in still_rounds]}, bit for bit the "
              f"host-steered loop: {'yes' if still_twin else 'NO'}; tiled against untiled "
              f"(rtl_clamp, same card) p99.9 |d| {p999:.3g} px, max {mx:.3g} px (limits "
              f"{MESH_P999}, {limit}); launches a pair {counts}; {smi}")
        print(f"{tag} {config} graphed (TiledGraphedStream, captured in {capture_s:.3f} s): "
              f"{MESH_PAIRS} alternating pairs bit for bit the eager steps: "
              f"{'yes' if same else 'NO'}; rounds {g_rounds}; still pair bit for bit: "
              f"{'yes' if same_still else 'NO'}; launches a pair {per_pair}; device launches "
              f"a replay (torch.profiler) {g_kernels} kernels, {g_copies} copies and fills; ms "
              f"a pair, host "
              f"clock, median of {MESH_RUNS} streams of {MESH_PAIRS}: eager "
              f"{eager_sorted[len(eager_ms) // 2]:.3f} (spread {eager_sorted[0]:.3f}-"
              f"{eager_sorted[-1]:.3f}), graphed {graphed_sorted[len(graphed_ms) // 2]:.3f} "
              f"(spread {graphed_sorted[0]:.3f}-{graphed_sorted[-1]:.3f}); eager "
              f"{_device_note([dev_eager], untiled_dev[config])}; graphed "
              f"{_device_note([dev_graphed], untiled_dev[config])}; {smi}")
        if not (reads == 0 and twin and still_twin and same and same_still
                and still_rounds == [1] * cfg.levels and p999 <= MESH_P999 and mx <= limit):
            raise AssertionError(f"{path} 1x1x1 {config}: reads {reads}, twin {twin}, still "
                                 f"{still_twin} {still_rounds}, graphed {same} {same_still}, "
                                 f"p99.9 {p999}, max {mx}")
        top = sorted(graphed_events, key=lambda e: -e.self_device_time_total)[:6]
        print(f"{tag} {config} graphed replay's largest device times (us, calls): " + "; ".join(
            f"{e.self_device_time_total:.1f}, {e.count} {e.key[:60]}" for e in top))
        if per_pair != {k: float(n) for k, n in counts.items()}:
            raise AssertionError(f"{path} 1x1x1 {config}: graphed launches {per_pair} against "
                                 f"eager {counts}")
        del stream
    for name, shapes in sorted(found.items()):
        worst = max(shapes.values())
        print(f"{tag} {name} on extended tile shapes {sorted(shapes)}: max |d| against the "
              f"plain version {worst:.3g}")
        if worst != 0.0:
            raise AssertionError(f"{path} 1x1x1: {name} differs from its plain version")
    if set(found) != {"warp_packed_u8", "warp_packed_u16", "warp_exact", "lk_fused_tile_round"}:
        raise AssertionError(f"{path} 1x1x1: kernels checked {sorted(found)}")
    if not any(t["skipped"] for t in tiles.values()):
        raise AssertionError(f"{path} 1x1x1: no skipped tile round was checked")
    return counts_by_path, time_tile_round(tiles, smi, tag)


def check_world_one_vo(a, b, mesh, ref_sess) -> None:
    """Phase 8 (a): the mesh-tiled VO session (``default``, grid VO_GRID) at
    NCCL world 1 through two chunks of MESH_VO_FRAMES frames, graphed
    (``process_frames``: the first chunk captures the step, the second is
    timed, a replay a frame) and stepped eagerly: records identical; the
    first chunk's against the untiled rtl_clamp session by (c)'s limits."""
    chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
    graphed_sess = _tracked_session(a, "default", mesh)
    if not graphed_sess._fe.graphed(chunk):
        raise AssertionError("mesh vo: an NCCL world-1 session is not graphed")
    _, counts = counted("mesh 1x1x1 vo graphed", lambda: graphed_sess.process_frames(chunk))
    ms = _host_ms(lambda: graphed_sess.process_frames(chunk), 1)
    eager_sess = _tracked_session(a, "default", mesh)
    eager_ms = _host_ms(lambda: [eager_sess.process_frame(f) for f in chunk], 2)

    def rec(sess, field, n=None):
        return np.stack(getattr(sess, field)[:n])

    same = all(np.array_equal(rec(graphed_sess, f), rec(eager_sess, f))
               for f in ("obs_uv", "obs_valid", "obs_lm"))
    n = len(ref_sess.obs_uv)
    ok_g, ok_r = rec(graphed_sess, "obs_valid", n), rec(ref_sess, "obs_valid")
    alike = ok_g == ok_r
    both = ok_g & ok_r
    same_lm = bool(np.array_equal(rec(graphed_sess, "obs_lm", n), rec(ref_sess, "obs_lm")))
    d = np.abs(rec(graphed_sess, "obs_uv", n) - rec(ref_sess, "obs_uv"))[both].max(axis=1)
    close = int((d <= 1e-3).sum())
    print(f"[mesh] (a) VO session {HEIGHT}x{WIDTH} default, grid {VO_GRID}, at NCCL world 1, "
          f"2 x {MESH_VO_FRAMES} frames: graphed {ms[0] / MESH_VO_FRAMES:.3f} ms/frame (the "
          f"second chunk), eager {min(eager_ms) / MESH_VO_FRAMES:.3f} (the faster of two "
          f"chunks); graphed and eager records {'identical' if same else 'DIFFER'}; launches "
          f"of the first chunk (capture included) {counts}; its {n} records against the "
          f"untiled rtl_clamp session: alive flags identical on {int(alike.sum())} of "
          f"{alike.size}, landmark ids {'identical' if same_lm else 'DIFFER'}, of "
          f"{both.sum()} tracks alive in both {close} within 1e-3 px, max "
          f"{float(d.max(initial=0.0)):.3g} px")
    if not same or (alike.mean() < 0.999 or not same_lm or close < 0.999 * both.sum()
                    or d.max(initial=0.0) > MESH_MAX):
        raise AssertionError("mesh vo at world 1: graphed, eager and untiled sessions differ")


def check_mesh(a, b, fa, fb, smi: str) -> tuple[dict, dict]:
    """Phase 8 (a-e). Returns each kernel's launches a frame pair per rank on
    each tiled path, and K6's tile round's launches on the world-1 main
    paths (eager) with its reading."""
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


def _check_mesh(a, b, fa, fb, smi, dev, work, t_phase) -> tuple[dict, dict]:
    np.savez(f"{work}/frames.npz", a=fa, b=fb)
    tiled_launches: dict = {}
    untiled = {c: _untiled(a, b, c) for c in MESH_CONFIGS}
    untiled_ms = {c: _host_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
    untiled_dev = {c: busy_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
    epe_untiled = {c: mean_epe([untiled[c]]) for c in MESH_CONFIGS}
    # (c)'s reference: the untiled rtl_clamp session, stepped eagerly as the
    # gloo ranks' mesh-tiled session steps (no capture timed).
    ref_sess = _tracked_session(a, "default", rtl_clamp=True)
    ref_vo_ms = _host_ms(lambda: [ref_sess.process_frame(f)
                                  for f in vo_chunk(a, b)[:MESH_VO_FRAMES]], 1)[0] / MESH_VO_FRAMES

    # (a) NCCL at world size 1, mesh (1, 1, 1), in this process.
    initialize_multihost(f"file://{work}/store_a", 1, 0, backend="nccl")
    mesh = make_flow_mesh(1, 1, 1, device=dev)
    counts, tile_reading = check_world_one(a, b, mesh, untiled, untiled_dev, smi)
    tiled_launches.update(counts)
    main_counts = {"lk_fused_tile_round": sum(c.get("lk_fused_tile_round", 0)
                                              for c in counts.values())}
    (su, sv), counts = counted("mesh 1x1x1 single scale", lambda: tiled_lucas_kanade_single_scale(
        a[None], b[None], mesh))
    wu, wv = lucas_kanade_single_scale(a, b, backend="torch")
    err = max(max_abs(su[0], wu), max_abs(sv[0], wv))
    print(f"[mesh] (a) NCCL world 1, tiled single scale against lucas_kanade_single_scale("
          f"backend='torch') on the card: max |d| {err:.3g} px (limit {MESH_SINGLE_ATOL}; "
          f"plain torch ops on both sides, as the reference's tiled body is jnp)")
    if err > MESH_SINGLE_ATOL:
        raise AssertionError(f"mesh 1x1x1 single scale: max |d| {err}")
    check_world_one_vo(a, b, mesh, ref_sess)
    dist.destroy_process_group()

    # (d)'s problem: the [vo] phase's 1080p production session, 17 keyframes.
    sess = _tracked_session(a, "production")
    sess.process_frames(vo_chunk(a, b))
    problem = session_problem(sess)
    np.savez(f"{work}/ba.npz", **{f: getattr(problem, f).cpu().numpy()
                                 for f in ba.BAProblem._fields})
    single = ba.solve(problem, iterations=VO_BA_ITERATIONS)
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
              f"level), {traffic['all_reduces']} sums; host reads {traffic['convergence_reads']}, "
              f"rounds run a level {rep0['rounds']} (device control); "
              f"{_device_note([r['flow'][key]['device_ms'] for r in reports], untiled_dev[config])}")
        if not (p999 <= MESH_P999 and mx <= MESH_MAX and rel <= MESH_EPE_RTOL):
            raise AssertionError(f"mesh {key}: p99.9 {p999}, max {mx}, EPE {rel} relative")
        if any(r["flow"][key]["traffic"]["convergence_reads"] for r in reports) or any(
                r["flow"][key]["rounds"] != rep0["rounds"] for r in reports):
            raise AssertionError(f"mesh {key}: a host read, or ranks that ran other rounds")
    for shape_key, t in sorted(reports[0]["tile_sums"].items()):
        print(f"[mesh] (b) lk_fused_tile_round on {shape_key} extended tiles: {t['running']} "
              f"running, {t['skipped']} skipped launches a rank 0; sums within {t['sum_rel']:.3g} "
              f"of du.abs().sum() (limit {2 * t['gamma']:.3g}), {t['sum_rel_f64']:.3g} of the "
              f"float64 sum (limit {t['gamma']:.3g})")
    for name, shapes in sorted(reports[0]["kernels"].items()):
        worst = max(shapes.values())
        print(f"[mesh] (b) {name} on tile shapes {sorted(shapes)}: max |d| against the plain "
              f"version {worst:.3g}")
        if worst != 0.0:
            raise AssertionError(f"mesh: {name} differs from its plain version on a tile")
    want = {"warp_packed_u8", "warp_packed_u16", "warp_exact", "lk_fused_tile_round", "lk_refine",
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
    return tiled_launches, {**main_counts, "reading": tile_reading}


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


def check_uhd_fused(a, b, smi: str) -> dict:
    """Phase 10: K6 at 3840x2160 in the exact Sobel order (the 4K gate's
    single scale, ``lucas_kanade_single_scale``'s default), bit-exact to
    its plain version, its device ms beside the plain version's."""
    got = lk.lucas_kanade_fused(a, b)
    want = lk.lucas_kanade_fused_ref(a, b)
    err = max(max_abs(g, w) for g, w in zip(got, want))
    if err != 0.0:
        raise AssertionError(f"lk_fused at 4K: max |d| {err} against its plain version")
    ms = device_ms(lambda: lk.lucas_kanade_fused(a, b))
    plain_ms = device_ms(lambda: lk.lucas_kanade_fused_ref(a, b))
    print(f"[4k] lk_fused (K6) {UHD[0]}x{UHD[1]}: bit-exact to its plain version; {ms:.5f} ms "
          f"({_bound_note('lk_fused', UHD, ms)}); plain {plain_ms:.4f} ms; {smi}")
    return {"by_shape": {f"{UHD[0]}x{UHD[1]}": {"ms": ms, "plain_ms": plain_ms}}}


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
    readings["lk_fused"] = check_uhd_fused(a, b, smi)
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
    tiled_counts, readings["lk_fused_tile_round"], warps = check_world_one_uhd(a, b, smi)
    for name, r in warps.items():
        readings[name]["tiles"] = r["by_shape"]
        for key, by in r["by_shape"].items():
            h, w = map(int, key.split("x"))
            by["bound_ms"] = bounds.bound(name, 1, h, w)[0]
    readings["lk_fused_tile_round"]["launches_per_pair"] = {
        path: c["lk_fused_tile_round"] for path, c in tiled_counts.items()}
    vo_counts, seed_reading = check_vo_uhd(a, b, smi)
    for path_counts in (*tiled_counts.values(), vo_counts):
        for name, n in path_counts.items():
            counts[name] = counts.get(name, 0) + n
    check_cards_uhd(seed_, smi)
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
            launches = (f"launches a 4K frame {r['launches_per_frame']}" if r["launches_per_frame"]
                        else f"launches a 4K pair {r.get('launches_per_pair')}")
            print(f"[4k] kernels {name} {key} round: {ms:.5f} ms, bound {by['bound_ms']:.5f} ms "
                  f"({100 * by['bound_share']:.1f}%), plain round {plain:.4f} ms; {launches} "
                  f"({smi})")
    readings["seed_grid"] = seed_reading
    print(f"[4k] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"4K": counts, "5K/8K": beyond_counts}, readings


# -- phase 10: the tiled path and VO at 4K ------------------------------------------------------

# The reference's tiled design point (tpuflow/sharding/tiled_pyramidal.py:
# "at 4K up to (4, 4), every level shards"): on one card NCCL world 1, and
# on four cards one rank a card at these meshes, every level tiled on each.
# 2x1x2 carries two streams, one a batch slice of two ranks.
UHD_MESHES = ((1, 2, 2), (1, 4, 1), (2, 1, 2))
# The tiled 4K flow against the untiled card result: p99.9 MESH_P999 and max
# MESH_MAX, but for production_fullband, whose coarse levels warp with K2's
# 8.8 fixed-point corners, max 0.1 px. The tiled and untiled pyramids
# differ by ~1 ulp (per-rank operator products against banded blocks,
# divergence f), and a 1-ulp change can move a coarse pixel's 8.8 value by
# 1/256, which the solve carries to the flow. At 4K NCCL world 1 read max
# 0.0552 px at one pixel of 16.6M, 8 px from the border, p99.9 6.4e-4;
# the untiled solve on the tiled path's own pyramid read 0.0558 from the
# untiled result, and the tiled flow 0.0023 from that solve (NVIDIA H100
# 80GB HBM3, 700.00 W); `default` read 0.0046. The limit is twice the
# worst reading. [mesh4k] (a) holds the tiled flow to MESH_MAX against the
# untiled solve on the tiled path's own pyramid, where no such flip occurs.
UHD_MESH_MAX = {"production_fullband": 0.1, "default": MESH_MAX}
# The 4K VO sessions: fx = fy = width / 2, grid 16 (32,400 track slots),
# MESH_VO_FRAMES frames.
UHD_VO_FOCAL = 0.5
UHD_VO_SESSIONS = ("production", "default")
# Sharded BA on four cards against the unsharded solve: camera translations
# within 2e-2, the reference's limit (tests/test_vo.py): the shards' partial
# sums add in another order, and LM's accept / reject decisions can part
# there, so the mean reprojection errors are printed, not held to (d)'s
# 1e-4 px.
BA_POSES_ATOL = 2e-2
# Each group of four-card ranks at 4K (one mesh, or the VO session and BA),
# start-up included.
UHD_CARDS_WALL_S = 150.0


def _uhd_streams(a, b, batch: int):
    """The (prev, curr) global batches of ``batch`` streams: element 0
    a -> b, element 1 b -> a."""
    return torch.stack([a, b][:batch]), torch.stack([b, a][:batch])


def check_world_one_uhd(a, b, smi: str) -> tuple[dict, dict, dict]:
    """Phase 10 (``[mesh4k] (a)``): the tiled path at 3840x2160 over NCCL at
    world 1, as phase 8 (a) checks it at 1080p (``check_world_one``), with
    the peak device memory, the tiled flow on its own pyramid
    (``check_same_pyramid``) and the warps on the 4K extended tiles
    (``time_tile_warps``). Returns the launches a pair by path, K6's tile
    round's reading at the 4K tiles and the warps' readings there."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="tpuflow_mesh4k_")
    try:
        untiled = {c: _untiled(a, b, c) for c in MESH_CONFIGS}
        untiled_dev = {c: busy_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
        initialize_multihost(f"file://{work}/store", 1, 0, backend="nccl")
        try:
            mesh = make_flow_mesh(1, 1, 1, device=a.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts, reading = check_world_one(a, b, mesh, untiled, untiled_dev, smi,
                                              tag="[mesh4k] (a)", path="mesh4k",
                                              max_px=UHD_MESH_MAX)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_same_pyramid(a, b, mesh, untiled)
            warps = time_tile_warps(a.shape, a.device, smi)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[mesh4k] (a) NCCL world 1 at {a.shape[0]}x{a.shape[1]}: peak device memory "
          f"{peak:.2f} GiB (both configs, eager, graphed and the plain versions' checks); "
          f"took {time.perf_counter() - t0:.1f} s; {smi}")
    return counts, reading, warps


def time_tile_warps(shape, dev, smi: str) -> dict:
    """[mesh4k] (a): K1, K2 and K4 as rounds (``check_round_warp``) on the
    warp-extended tiles the 4K tiled step at world 1 gives them (each
    level plus the warp halo, max_disp + 1 px a side; K1 on the finest
    tile under ``production_fullband``, K2 on its coarse tiles, K4 on every
    tile under ``default``): bit-exact, timed running and skipped beside
    the bound, the plain round and the launch floor. Returns the
    readings by kernel."""
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    rng = np.random.default_rng(20)
    floor_ms = device_ms(_build.launch_empty)
    readings: dict = {}
    seen = set()
    for config in MESH_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]
        halo = cfg.max_disp + 1
        dims = tp._level_shapes(*shape, cfg.levels, cfg.scale_factor)
        for lvl in reversed(range(cfg.levels)):
            packing = pyramidal._warp_packing(cfg, lvl == cfg.levels - 1)
            name = {"u8": "warp_packed_u8", "u16": "warp_packed_u16", "exact": "warp_exact"}[
                packing]
            h, w = dims[lvl][0] + 2 * halo, dims[lvl][1] + 2 * halo
            if (name, h, w) in seen:
                continue
            seen.add((name, h, w))
            readings.setdefault(name, {"max_abs_err": 0.0})
            curr = torch.from_numpy(make_frames(lvl, h, w)[0]).to(dev)
            check_round_warp(readings, name, curr, packing, cfg.max_disp, rng, dev, floor_ms,
                             tag="mesh4k")
    print(f"[mesh4k] (a) the warps on the 4K extended tiles: {sorted(seen)}; {smi}")
    return readings


def check_same_pyramid(a, b, mesh, untiled) -> None:
    """[mesh4k] (a): at NCCL world 1 the tiled step against the untiled
    device-controlled solve (``lucas_kanade_pyramidal_from_pyramids``) on
    the pyramid the tiled path builds (``dist_pyramid.sharded_downsample``),
    held to MESH_P999 and MESH_MAX: the tiled solve alone, without the
    pyramids' rounding (divergence f) and what K2's packing makes of it;
    beside it the two untiled solves' own distance."""
    from tpuflow_torch.sharding import dist_pyramid
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    for config in MESH_CONFIGS:
        cfg = PYRAMID_CONFIGS[config]
        dims = tp._level_shapes(*a.shape, cfg.levels, cfg.scale_factor)
        pyramids = []
        for frame in (a, b):
            levels = [frame]
            for lvl in range(cfg.levels - 1, 0, -1):
                levels.insert(0, dist_pyramid.sharded_downsample(
                    levels[0], dims[lvl], dims[lvl - 1], 1.0 / cfg.scale_factor, mesh=mesh))
            pyramids.append(levels)
        su, sv = pyramidal.lucas_kanade_pyramidal_from_pyramids(*pyramids, cfg, backend="cuda",
                                                                rtl_clamp=True)
        tu, tv = _tile_step(mesh, cfg)(a, b)
        p999, mx = _p999_max(tu[0], tv[0], su, sv)
        own = _p999_max(su, sv, *untiled[config])
        print(f"[mesh4k] (a) {config}: tiled against the untiled solve on the tiled path's own "
              f"pyramid p99.9 |d| {p999:.3g} px, max {mx:.3g} px (limits {MESH_P999}, "
              f"{MESH_MAX}); that untiled solve against the untiled result p99.9 {own[0]:.3g} "
              f"px, max {own[1]:.3g} px (the pyramids' rounding alone)")
        if p999 > MESH_P999 or mx > MESH_MAX:
            raise AssertionError(f"mesh4k {config}: the tiled solve on its own pyramid p99.9 "
                                 f"{p999}, max {mx}")


def check_vo_uhd(a, b, smi: str) -> tuple[dict, dict]:
    """Phase 10 (``[vo4k]`` lines): the grid seed kernel at 2160x3840
    (``check_seed_kernel``) and an untiled OdometrySession at 3840x2160 for
    each of UHD_VO_SESSIONS, fx = fy = width / 2, grid VO_GRID, over
    MESH_VO_FRAMES frames, as phase 6 checks its 1080p sessions
    (``check_vo_session``). Returns the sessions' eager launches and the
    seed kernel's reading."""
    t0 = time.perf_counter()
    seed_reading = check_seed_kernel(a, smi, tag="vo4k")
    chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
    counts: dict = {}
    for name in UHD_VO_SESSIONS:
        ms, path_counts = check_vo_session(a, b, chunk, name, smi, focal=UHD_VO_FOCAL,
                                           tag="vo4k")
        print(f"[vo4k] {name}: front end {ms:.3f} ms/frame, median of {VO_RUNS} runs")
        for k, n in path_counts.items():
            counts[k] = counts.get(k, 0) + n
    print(f"[vo4k] took {time.perf_counter() - t0:.1f} s")
    return counts, seed_reading


def _progress(rank: int, t0: float, what: str) -> None:
    """A four-card rank's progress line (its stage and host seconds), so
    that a rank that stops shows where."""
    print(f"[mesh4k] rank {rank}: {what} at {time.perf_counter() - t0:.1f} s", flush=True)


def nccl_rank_uhd(rank: int, world: int, work: str, shape) -> None:
    """One rank per card over NCCL at 3840x2160 (``--mesh-cards-only``), in
    a process group of its own for each mesh: (b) the tiled flow on mesh
    ``shape`` under each config (``_nccl_flow``); or, where ``shape`` is
    None, (c) the mesh-tiled VO session on 1x2x2, ``default``, graphed
    (its ``scan_steps`` replayed) and stepped eagerly, then bundle
    adjustment over its observations: unsharded, and in one observation
    shard a rank over NCCL, twice."""
    t0 = time.perf_counter()
    name = _mesh_name(shape) if shape else "vo"
    initialize_multihost(f"file://{work}/store_{name}", world, rank, backend="nccl")
    ops.pin_f32_matmul()
    mesh = make_flow_mesh(*(shape or (1, 2, 2)))
    _progress(rank, t0, f"mesh {_mesh_name(shape or (1, 2, 2))} made")
    frames = np.load(f"{work}/frames.npz")
    a, b = (torch.from_numpy(frames[k]).to(mesh.device) for k in ("a", "b"))
    report: dict = {}
    arrays = {}
    if shape:
        prev, curr = _uhd_streams(a, b, shape[0])
        found: dict = {}
        tiles: dict = {}
        report["flow"] = {}
        for config in MESH_CONFIGS:
            key = f"{name} {config}"
            report["flow"][key], u, v = _nccl_flow(
                mesh, prev, curr, config, f"mesh4k {key}", found, tiles,
                note=lambda what: _progress(rank, t0, f"{key} {what}"))
            _progress(rank, t0, f"{key} checked")
            if rank == 0:
                arrays[f"{key}/u"], arrays[f"{key}/v"] = u.cpu().numpy(), v.cpu().numpy()
        report["kernels"], report["tile_sums"] = _checked_report(found, tiles)
    else:
        report["vo"], report["ba"], arrays = _cards_vo(rank, world, mesh, a, b, t0)
    dist.barrier()
    np.savez(f"{work}/uhd_{name}_{rank}.npz", **arrays)
    with open(f"{work}/uhd_{name}_{rank}.json", "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def _cards_vo(rank: int, world: int, mesh, a, b, t0: float) -> tuple[dict, dict, dict]:
    """(c) on one rank: the tiled VO session graphed and eager, BA over its
    observations unsharded and sharded over ``mesh.group``."""
    chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
    sess = _tracked_session(a, "default", mesh, focal=UHD_VO_FOCAL)
    graphed = sess._fe.graphed(chunk)
    eager = _tracked_session(a, "default", mesh, focal=UHD_VO_FOCAL)
    dist.barrier(mesh.group)
    eager_ms = _host_ms(lambda: [eager.process_frame(f) for f in chunk], 1)[0] / len(chunk)
    _progress(rank, t0, "eager VO session done")
    dist.barrier(mesh.group)
    _, counts = counted("mesh4k vo graphed", lambda: sess.process_frames(chunk))
    _progress(rank, t0, "graphed VO session done")
    records = [np.stack(x) for x in (sess.obs_uv, sess.obs_valid, sess.obs_lm)]
    vo = {"graphed": bool(graphed), "launches": counts, "eager_ms": eager_ms,
          "same": _same_records(_records(sess), _records(eager)),
          "digest": _digest(*records), "alive": int(sess._dev.alive.sum()),
          "slots": int(sess._dev.alive.numel())}
    arrays = {}
    if rank == 0:
        arrays["vo/uv"], arrays["vo/valid"], arrays["vo/lm"] = records
    problem = session_problem(sess)
    single_s, single = _host_runs(lambda: ba.solve(problem, iterations=VO_BA_ITERATIONS), 1)
    n = problem.obs_uv.shape[0]
    lo, hi = rank * n // world, (rank + 1) * n // world
    local = problem._replace(obs_uv=problem.obs_uv[lo:hi], obs_cam=problem.obs_cam[lo:hi],
                             obs_lm=problem.obs_lm[lo:hi], obs_valid=problem.obs_valid[lo:hi])
    solves = []
    dist.barrier(mesh.group)
    sharded_s = _host_runs(lambda: solves.append(
        ba.solve(local, iterations=VO_BA_ITERATIONS, axis_name=mesh.group)), 2)[0]
    _progress(rank, t0, "BA done")
    got = solves[0]
    valid = problem.obs_valid
    ba_report = {
        "observations": n, "valid": int(valid.sum()), "shard": hi - lo, "single_s": single_s[0],
        "sharded_s": sharded_s,
        "repeat": all(torch.equal(x, y) for x, y in zip(*solves)),
        "poses_t_max": float((got.poses_t - single.poses_t).abs().max()),
        "error": float(ba.reprojection_errors(problem._replace(
            poses_r=got.poses_r, poses_t=got.poses_t, landmarks=got.landmarks))[valid].mean()),
        "error_single": float(ba.reprojection_errors(problem._replace(
            poses_r=single.poses_r, poses_t=single.poses_t,
            landmarks=single.landmarks))[valid].mean()),
        "digest": _digest(got.poses_t.cpu().numpy())}
    # The graphed session's time a frame: a second chunk, a replay a frame.
    dist.barrier(mesh.group)
    vo["graphed_ms"] = _host_ms(lambda: sess.process_frames(chunk), 1)[0] / len(chunk)
    return vo, ba_report, arrays


def _world_one_uhd(a, b, work: str) -> dict:
    """The 4K tiled step at NCCL world 1 on card 0 (before the four-card
    ranks start), each config: eager and graphed device busy ms a pair and
    graphed host-clock ms, the four-card readings' baseline."""
    out = {}
    initialize_multihost(f"file://{work}/store_w1", 1, 0, backend="nccl")
    try:
        mesh = make_flow_mesh(1, 1, 1, device=a.device)
        for config in MESH_CONFIGS:
            cfg = PYRAMID_CONFIGS[config]
            step = _tile_step(mesh, cfg)
            step(a, b)
            stream = TiledGraphedStream(a[None], cfg, mesh)
            stream.step(b[None])
            out[config] = {"device_ms": busy_ms(lambda: step(a, b)),
                           "graphed_device_ms": busy_ms(lambda: stream.step(b[None])),
                           "graphed_ms": [t / MESH_PAIRS for t in _host_ms(
                               lambda: [stream.step(c[None]) for _, c in _alternating(a, b)])]}
            del stream
    finally:
        dist.destroy_process_group()
    return out


def check_cards_uhd(seed_: int, smi: str) -> None:
    """The tiled path at 3840x2160 with one NCCL rank a card on four cards
    (``--mesh-cards-only``; a printed line where the machine has fewer):
    (b) each of UHD_MESHES under each config, every level tiled, against
    the untiled card result of each element (``MESH_P999``, ``UHD_MESH_MAX``),
    every rank's every launch bit-exact to its plain version, the graphed
    step bit for bit the eager one, busy beside world 1's; (c) the 1x2x2
    VO session graphed against its eager twin and against an untiled
    rtl_clamp session, BA sharded over NCCL against the unsharded solve."""
    cards = torch.cuda.device_count()
    if cards < MESH_RANKS:
        print(f"[mesh4k] (b-c) four cards, one NCCL rank each (meshes "
              f"{', '.join(_mesh_name(s) for s in UHD_MESHES)}, the tiled VO session, BA over "
              f"NCCL): not run, {cards} card; `python3 chip_smoke.py --mesh-cards-only` on four "
              f"cards runs them")
        return
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    fa, fb = make_frames(seed_, *UHD)
    a, b = torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev)
    work = tempfile.mkdtemp(prefix="tpuflow_mesh4k_")
    try:
        np.savez(f"{work}/frames.npz", a=fa, b=fb)
        untiled = {(c, i): _untiled(*pair, c) for c in MESH_CONFIGS
                   for i, pair in enumerate(((a, b), (b, a)))}
        world_one = _world_one_uhd(a, b, work)
        chunk = vo_chunk(a, b)[:MESH_VO_FRAMES]
        ref_sess = _tracked_session(a, "default", rtl_clamp=True, focal=UHD_VO_FOCAL)
        for f in chunk:
            ref_sess.process_frame(f)
        for shape in (*UHD_MESHES, None):
            name = _mesh_name(shape) if shape else "vo"
            t0 = time.perf_counter()
            _spawn(nccl_rank_uhd, lambda r: (r, MESH_RANKS, work, shape), MESH_RANKS,
                   f"4K nccl ranks, {name}", wall=UHD_CARDS_WALL_S)
            reports = [json.load(open(f"{work}/uhd_{name}_{r}.json")) for r in range(MESH_RANKS)]
            got = np.load(f"{work}/uhd_{name}_0.npz")
            print(f"[mesh4k] (b-c) NCCL across {MESH_RANKS} of {cards} cards, one rank each, at "
                  f"{UHD[1]}x{UHD[0]}, {name}: ran in {time.perf_counter() - t0:.1f} s "
                  f"(start-up included); {smi}")
            if shape:
                _report_cards_flow(shape, reports, got, untiled, world_one, dev)
            else:
                _report_cards_vo(reports, got, ref_sess)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[mesh4k] four cards took {time.perf_counter() - t_phase:.1f} s")


def _report_cards_flow(shape, reports, got, untiled, world_one, dev) -> None:
    """(b): one mesh's lines and limits, each config."""
    name = _mesh_name(shape)
    per = shape[1] * shape[2]
    for config in MESH_CONFIGS:
        key = f"{name} {config}"
        reps = [r["flow"][key] for r in reports]
        rep0 = reps[0]
        plan = shard_plan(UHD, shape[1], shape[2], PYRAMID_CONFIGS[config])
        if any(r["digest"] != rep0["digest"] for r in reps):
            raise AssertionError(f"mesh4k {key}: the ranks hold different flows")
        errs = []
        for i in range(shape[0]):
            u, v = (torch.from_numpy(got[f"{key}/{c}"][i]).to(dev) for c in "uv")
            errs.append(_p999_max(u, v, *untiled[(config, i)]))
        ms = sorted(rep0["ms"])
        w1 = world_one[config]
        traffic = rep0["traffic"]
        if "graphed_error" in rep0:
            graphed = f"graphed: capture REFUSED on rank 0: {rep0['graphed_error']}"
        else:
            gms = sorted(rep0["graphed_ms"])
            g1 = sorted(w1["graphed_ms"])
            kernels, copies = rep0["graphed_launches"]
            graphed = (f"graphed (TiledGraphedStream on every rank): first replay bit for bit "
                       f"the eager step on every rank: "
                       f"{all(r['graphed_same'] for r in reps)}; {gms[len(gms) // 2]:.3f} ms a "
                       f"pair (host clock, median of {len(gms)} streams of {MESH_PAIRS}, spread "
                       f"{gms[0]:.3f}-{gms[-1]:.3f}; world 1 {g1[len(g1) // 2]:.3f}); rank 0's "
                       f"device launches a replay {kernels} kernels, {copies} copies and "
                       f"fills; graphed busy ms a pair by rank (in the port's kernels, in "
                       f"copies, in NCCL) "
                       f"{', '.join(_busy(r['graphed_device_ms']) for r in reps)}; world 1 "
                       f"{_busy(w1['graphed_device_ms'])}")
        print(f"[mesh4k] (b) {key} over NCCL: shard plan by level {plan}; eager "
              f"{ms[len(ms) // 2]:.3f} ms a pair (host clock, median of {len(ms)}, spread "
              f"{ms[0]:.3f}-{ms[-1]:.3f}); " + "; ".join(
                  f"element {i} ({'a->b' if i == 0 else 'b->a'}) p99.9 |d| {p:.3g} px, max "
                  f"{m:.3g} px" for i, (p, m) in enumerate(errs))
              + f" against the untiled card result (limits {MESH_P999}, "
              f"{UHD_MESH_MAX[config]}); rounds a "
              f"level by rank {[r['rounds'] for r in reps]}; host reads "
              f"{[r['traffic']['convergence_reads'] for r in reps]}; launches a pair by rank "
              f"{[r['launches'] for r in reps]}; rank 0: halo {traffic['halo_bytes']} B in "
              f"{traffic['halo_exchanges']} exchanges, gathers {traffic['gather_bytes']} B, "
              f"{traffic['all_reduces']} sums; eager busy ms a pair by rank "
              f"{', '.join(_busy(r['device_ms']) for r in reps)}; world 1 "
              f"{_busy(w1['device_ms'])}")
        print(f"[mesh4k] (b) {key} {graphed}")
        if not all(plan):
            raise AssertionError(f"mesh4k {key}: levels not tiled {plan}")
        if any(p > MESH_P999 or m > UHD_MESH_MAX[config] for p, m in errs):
            raise AssertionError(f"mesh4k {key}: against the untiled result {errs}")
        if any(r["traffic"]["convergence_reads"] for r in reps) or any(
                r["rounds"] != reps[i // per * per]["rounds"] for i, r in enumerate(reps)):
            raise AssertionError(f"mesh4k {key}: a host read, or ranks of a batch slice that "
                                 f"ran other rounds")
        if "graphed_error" not in rep0 and not all(r["graphed_same"] for r in reps):
            raise AssertionError(f"mesh4k {key}: graphed differs from eager")
    for shape_key, t in sorted(reports[0]["tile_sums"].items()):
        print(f"[mesh4k] (b) {name} lk_fused_tile_round on {shape_key} extended tiles: "
              f"{t['running']} running, {t['skipped']} skipped launches a rank 0; sums within "
              f"{t['sum_rel']:.3g} of du.abs().sum() (limit {2 * t['gamma']:.3g}), "
              f"{t['sum_rel_f64']:.3g} of the float64 sum (limit {t['gamma']:.3g})")
    kernels = reports[0]["kernels"]
    for kernel in sorted(kernels):
        worst = max(max(r["kernels"][kernel].values()) for r in reports)
        print(f"[mesh4k] (b) {name} {kernel} on tile shapes {sorted(kernels[kernel])}, every "
              f"rank: max |d| against the plain version {worst:.3g}")
        if worst != 0.0:
            raise AssertionError(f"mesh4k {name}: {kernel} differs from its plain version")
    if set(kernels) != {"warp_packed_u8", "warp_packed_u16", "warp_exact",
                        "lk_fused_tile_round"}:
        raise AssertionError(f"mesh4k {name}: kernels checked {sorted(kernels)}")


def _report_cards_vo(reports, got, ref_sess) -> None:
    """(c): the tiled 4K VO session and BA sharded over NCCL."""
    vo = [r["vo"] for r in reports]
    if any(r["digest"] != vo[0]["digest"] for r in vo):
        raise AssertionError("mesh4k vo: the ranks hold different tracks")
    ref = {f: np.stack(getattr(ref_sess, f"obs_{f}")) for f in ("uv", "valid", "lm")}
    same = got["vo/valid"] == ref["valid"]
    both = got["vo/valid"] & ref["valid"]
    same_lm = bool(np.array_equal(got["vo/lm"], ref["lm"]))
    d = np.abs(got["vo/uv"] - ref["uv"])[both].max(axis=1)
    close = int((d <= 1e-3).sum())
    print(f"[mesh4k] (c) VO session {UHD[0]}x{UHD[1]} default, fx = fy = "
          f"{UHD_VO_FOCAL * UHD[1]:g}, grid {VO_GRID} ({vo[0]['slots']} slots), "
          f"{MESH_VO_FRAMES} frames on 1x2x2 over NCCL: scan_steps graphed on every rank "
          f"{all(r['graphed'] for r in vo)}; graphed {vo[0]['graphed_ms']:.3f} ms/frame (a "
          f"second chunk), eager {vo[0]['eager_ms']:.3f}; graphed and eager records "
          f"{'identical' if all(r['same'] for r in vo) else 'DIFFER'} on every rank; launches "
          f"of the first chunk (capture included) {vo[0]['launches']}; tracks alive "
          f"{vo[0]['alive']}; against the untiled rtl_clamp session: alive flags identical on "
          f"{int(same.sum())} of {same.size}, landmark ids "
          f"{'identical' if same_lm else 'DIFFER'}, of {both.sum()} tracks alive in both "
          f"{close} within 1e-3 px, max {float(d.max(initial=0.0)):.3g} px")
    if not (all(r["graphed"] and r["same"] for r in vo) and same.mean() >= 0.999 and same_lm
            and close >= 0.999 * both.sum() and d.max(initial=0.0) <= MESH_MAX):
        raise AssertionError("mesh4k vo: graphed, eager and untiled sessions differ")
    bas = [r["ba"] for r in reports]
    b0 = bas[0]
    print(f"[mesh4k] (c) BA over the session's {b0['observations']} observations "
          f"({b0['valid']} valid), one shard of ~{b0['shard']} a card over NCCL: "
          f"solve({VO_BA_ITERATIONS}, axis_name=group) {b0['sharded_s'][0]:.3f} s, then "
          f"{b0['sharded_s'][1]:.3f} s, against the unsharded solve's {b0['single_s']:.3f} s on "
          f"one card; camera translations within {b0['poses_t_max']:.3g} of the unsharded "
          f"solve's (limit {BA_POSES_ATOL}); mean reprojection error {b0['error']:.6f} px "
          f"against {b0['error_single']:.6f} px; two sharded solves "
          f"{'bit-identical' if all(r['repeat'] for r in bas) else 'DIFFER'}, every rank the "
          f"same: {all(r['digest'] == b0['digest'] for r in bas)}")
    if (b0["poses_t_max"] > BA_POSES_ATOL or not all(r["repeat"] for r in bas)
            or any(r["digest"] != b0["digest"] for r in bas)):
        raise AssertionError("mesh4k: the sharded solve differs")


_WALK_NAMES = {(0, 1): "K3", (0, 0): "K5", (1, 0): "K6", (1, 1): "K6 relaxed",
               (2, 0): "K7", (2, 1): "K7 relaxed", (3, 0): "K6 tile round",
               (3, 1): "K6 tile round relaxed"}
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
    tiles = [f"{_WARP_NAMES[packing, clamp]} staged {tw}x{rows} {threads} threads: {regs} regs/"
             f"{spill} B spilled/{stack} B stack"
             for (packing, clamp, tw, rows, threads), regs, spill, _, stack in ptxas_usage(
                 log, r"_ZN12tpuflow_warp16warp_tile_kernelILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E")]
    gathers = [f"{_WARP_NAMES[packing, clamp]} gather {tx * cols}x{ty * passes} {tx * ty} "
               f"threads, {cols} column{'s' if cols > 1 else ''} a thread, flow "
               f"{'with the control words' if first else 'after the latch'}: {regs} regs/"
               f"{spill} B spilled/{stack} B stack"
               for (packing, clamp, cols, tx, ty, passes, first), regs, spill, _, stack
               in ptxas_usage(log, r"_ZN12tpuflow_warp18warp_gather_kernelILi(\d+)ELb(\d)"
                                   r"ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E")]
    walks = [f"{_WARP_NAMES[packing, clamp]} walk {tw}x{step} {threads} threads: {regs} regs/"
             f"{spill} B spilled"
             for (packing, clamp, tw, step, threads), regs, spill, _, _ in ptxas_usage(
                 log, r"_ZN12tpuflow_warp16warp_walk_kernelILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E")]
    return tiles + gathers + walks


# bench_scaling.py's data-parallel design point (measure_dp): a ("batch",)
# mesh, 4x1x1, one rank a card, each rank's slice of a batch of 1080p
# streams in one batched GraphedStream under `default`; the slices gathered
# over the mesh's group and held element by element against one card's
# whole batch. Then the teardown (sharding.mesh's order): three meshes in
# the one NCCL world, each with a live TiledGraphedStream, released
# (release_mesh), then the world destroyed, under a watchdog a rank.
DP_BATCHES = (4, 8)
DP_CONFIG = "default"
DP_WATCHDOG_S = 180.0
DP_TEARDOWN_MESHES = ((1, 2, 2), (1, 4, 1))  # beside the 4x1x1 mesh
DP_TEARDOWN_SHAPE = (240, 320)


def dp_rank(rank: int, world: int, work: str) -> None:
    """One rank of the data-parallel check and the released teardown."""
    import faulthandler

    from tpuflow_torch.sharding import mesh as mesh_module
    from tpuflow_torch.sharding import release_mesh

    stacks = open(f"{work}/dp_{rank}_stacks.txt", "w")  # noqa: SIM115
    faulthandler.dump_traceback_later(DP_WATCHDOG_S, exit=True, file=stacks)
    t0 = time.perf_counter()
    initialize_multihost(f"file://{work}/store_dp", world, rank, backend="nccl")
    ops.pin_f32_matmul()
    dev = torch.device("cuda", rank)
    mesh = make_flow_mesh(world, 1, 1, device=dev)
    cfg = PYRAMID_CONFIGS[DP_CONFIG]
    report: dict = {"batches": {}}
    for batch in DP_BATCHES:
        first, nxt, labels = batch_frames(dev, batch)
        per = batch // world
        mine = slice(rank * per, (rank + 1) * per)
        local = GraphedStream(first[mine].contiguous(), cfg)
        whole = GraphedStream(first, cfg)
        dist.barrier(mesh.group)
        flows, _ = run_batch(local, first[mine].contiguous(), nxt[mine].contiguous(), 2)
        whole_flows, _ = run_batch(whole, first, nxt, 2)
        equal = []
        for (u, v, r), (wu, wv, wr) in zip(flows, whole_flows):
            gathered = [torch.cat(mesh_module.all_gather(t.contiguous(), mesh.group))
                        for t in (u, v, r)]
            equal.append([bool(torch.equal(gathered[0][b], wu[b])
                               and torch.equal(gathered[1][b], wv[b])
                               and torch.equal(gathered[2][b], wr[b])) for b in range(batch)])
        dist.barrier(mesh.group)
        local_ms = [1000 * run_batch(local, first[mine].contiguous(), nxt[mine].contiguous(),
                                     keep=False)[1] / BATCH_FRAMES for _ in range(STREAM_RUNS)]
        whole_ms = [1000 * run_batch(whole, first, nxt, keep=False)[1] / BATCH_FRAMES
                    for _ in range(STREAM_RUNS)]
        report["batches"][batch] = {"equal": equal, "labels": labels, "local_ms": local_ms,
                                    "whole_ms": whole_ms}
        del local, whole, first, nxt
    # The teardown: two more meshes in this world, a live tiled graph on each.
    a, b = (t[:1, :DP_TEARDOWN_SHAPE[0], :DP_TEARDOWN_SHAPE[1]].contiguous()
            for t in batch_frames(dev, 1)[:2])
    meshes, streams = [mesh], []
    for shape in DP_TEARDOWN_MESHES:
        m = make_flow_mesh(*shape, device=dev)
        stream = TiledGraphedStream(a, cfg, m)
        stream.step(b)
        meshes.append(m)
        streams.append(stream)
    torch.cuda.synchronize(dev)
    live = sum(len(mesh_module._GRAPHS.get(m, ())) for m in meshes)
    with open(f"{work}/dp_{rank}.json", "w") as fh:
        json.dump(report, fh)
    t1 = time.perf_counter()
    for m in meshes:
        release_mesh(m)
    t2 = time.perf_counter()
    dist.destroy_process_group()
    t3 = time.perf_counter()
    faulthandler.cancel_dump_traceback_later()
    with open(f"{work}/dp_{rank}_teardown.json", "w") as fh:
        json.dump({"live_graphs": live, "closed": all(s._graph is None for s in streams),
                   "release_s": t2 - t1, "destroy_s": t3 - t2,
                   "rank_s": t3 - t0}, fh)


def check_data_parallel(smi: str) -> None:
    """``[dp]`` lines (``--mesh-cards-only``): bench_scaling's data-parallel
    design point on a 4x1x1 mesh (``dp_rank``) and the released teardown;
    each rank within DP_WATCHDOG_S."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    if world < 4:
        print(f"[dp] 4x1x1 data-parallel mesh: not run, {world} card")
        return
    world = 4
    work = tempfile.mkdtemp(prefix="tpuflow_dp_")
    try:
        _spawn(dp_rank, lambda r: (r, world, work), world, "dp 4x1x1",
               wall=DP_WATCHDOG_S + 30.0)
        reports = [json.load(open(f"{work}/dp_{r}.json")) for r in range(world)]
        teardowns = [json.load(open(f"{work}/dp_{r}_teardown.json")) for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for batch in map(str, DP_BATCHES):
        equal = [r["batches"][batch]["equal"] for r in reports]
        if not all(all(all(step) for step in e) for e in equal):
            raise AssertionError(f"[dp] B={batch}: gathered slices against one card's batch, "
                                 f"by rank and step: {equal}")
        local = [float(np.median(r["batches"][batch]["local_ms"])) for r in reports]
        whole = reports[0]["batches"][batch]["whole_ms"]
        print(f"[dp] 4x1x1 ({DP_CONFIG}, {HEIGHT}x{WIDTH}), B={batch} "
              f"({', '.join(reports[0]['batches'][batch]['labels'])}): {int(batch) // world} "
              f"stream(s) a card; every element of every rank's gathered slice bit for bit one "
              f"card's batched result, 2 steps, on all 4 ranks; graphed ms a step of the local "
              f"slice by rank (median of {STREAM_RUNS}) {', '.join(f'{t:.3f}' for t in local)}; "
              f"one card's whole batch {_spread(whole)} ({smi})")
    if not all(t["closed"] and t["live_graphs"] == len(DP_TEARDOWN_MESHES) for t in teardowns):
        raise AssertionError(f"[dp] teardown: {teardowns}")
    release = ", ".join(f"{t['release_s']:.2f}" for t in teardowns)
    destroy = ", ".join(f"{t['destroy_s']:.2f}" for t in teardowns)
    print(f"[dp] teardown: 3 meshes (4x1x1 and {', '.join(map(_mesh_name, DP_TEARDOWN_MESHES))}) "
          f"in one NCCL world with {teardowns[0]['live_graphs']} live TiledGraphedStreams a rank, "
          f"released (release_mesh: graphs closed, then groups) in {release} s, then "
          f"destroy_process_group returned in {destroy} s by rank (watchdog "
          f"{DP_WATCHDOG_S:.0f} s); phase {time.perf_counter() - t0:.1f} s")


def run_mesh_cards_only(seed: int, smi: str) -> None:
    """The data-parallel 4x1x1 mesh and the released teardown
    (``check_data_parallel``), then phase 8 (e) and phase 10's four-card
    parts alone (``--mesh-cards-only``): the tiled step over NCCL with one
    rank per
    card, eager and graphed, against the untiled result of card 0, at 1080p
    (``check_nccl_across_cards``), then at 3840x2160 on UHD_MESHES with the
    tiled VO session and BA sharded over NCCL (``check_cards_uhd``). For a
    machine with several cards, where nothing else of the smoke needs
    them."""
    dev = torch.device("cuda", 0)
    _build.load()
    check_data_parallel(smi)
    fa, fb = make_frames(seed)
    a, b = torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev)
    work = tempfile.mkdtemp(prefix="tpuflow_mesh_")
    try:
        np.savez(f"{work}/frames.npz", a=fa, b=fb)
        untiled = {c: _untiled(a, b, c) for c in MESH_CONFIGS}
        untiled_dev = {c: busy_ms(lambda: _untiled(a, b, c)) for c in MESH_CONFIGS}
        print(f"[mesh] (e) alone on {torch.cuda.device_count()} cards ({smi})")
        check_nccl_across_cards(dev, work, untiled, untiled_dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del a, b, untiled
    torch.cuda.empty_cache()
    check_cards_uhd(seed, smi)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh-cards-only", action="store_true",
                        help="run phase 8 (e) and the 4K four-card parts of phase 10 alone: "
                             "NCCL across the machine's cards")
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
    if args.mesh_cards_only:
        run_mesh_cards_only(args.seed, smi)
        return

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

    # 4b. batched streams
    batch_counts, _ = check_batch(smi, device_ms(_build.launch_empty))
    missing = [name for name in set().union(PATH_KERNELS["batch production"],
                                            PATH_KERNELS["batch default"])
               if not batch_counts.get(name)]
    if missing:
        raise AssertionError(f"kernels launched on no batched stream: {missing}")
    counts.update(check_single_scale(a, b, confidence=False))
    counts.update(check_single_scale(a, b, confidence=True))
    counts.update(check_mxu_path(a, b))
    counts.update(check_ablation_paths(dev))
    report_profile(smi)
    missing = [name for name in KERNELS if not counts.get(name) and name not in MESH_PATH_KERNELS]
    if missing:
        raise AssertionError(f"kernels launched on no main path: {missing}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was enabled on the main path")

    # 5. gate
    run_gate()

    # 6. vo
    t0 = time.perf_counter()
    port_readings = {"seed_grid": check_seed_kernel(a, smi)}
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
    tiled_launches, mesh_main = check_mesh(a, b, fa, fb, smi)
    readings["lk_fused_tile_round"].update(mesh_main.pop("reading"))
    counts.update(mesh_main)
    missing = [name for name in MESH_PATH_KERNELS if not counts.get(name)]
    if missing:
        raise AssertionError(f"kernels launched on no main path: {missing}")

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
            "launches_batch": batch_counts.get(name, 0),
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
            "library": why, **r, "bound_share": r["bound_ms"] / r["ms"],
            "launches_4k": uhd_counts["4K"].get(name, 0), "uhd": uhd_readings.get(name)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
