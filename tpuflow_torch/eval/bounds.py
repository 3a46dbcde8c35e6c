"""The least device time each kernel of the port could take on one H100.

A kernel's bound is the larger of two times: the bytes one call must move
(each input read once, each output written once) over the card's memory
rate, ``profile.HBM_GBPS``, and the f32 operations it does over the card's
f32 rate outside the tensor cores. Every kernel here is bound by bytes:
the LK solve does at most ~100 f32 operations a pixel against its 16-24
bytes, a warp about 20 against 16.

Bytes per call, by kernel name (``chip_smoke.KERNELS``):

- warps (K1, K2, K4): 16 B a pixel: the image, u and v in, the warped
  image out;
- refine (K3, K5, K10 refine): 24 B a pixel: prev, warped, u and v in, u
  and v out (the per-block partial sums, ~5 KB at 1080p, and the converged
  flag are left out);
- fused (K6, K10 fused): 16 B a pixel: prev and curr in, u and v out;
  with |det| (K7, K10 fused with |det|): 20 B;
- K6's tile round (``lk_fused_tile_round``), (height, width) the
  halo-extended tile, extended by ``window // 2 + 1`` px a side (window 5
  unless ``variant`` names another): 8 B a pixel of the extended tile
  (prev and the warped frame in) and 16 B a pixel of its crop (u and v
  read and written in place); the block partials (~2.6 KB at 1080p) and
  the latch are left out;
- shift ablation (K8), at its script's shape only, by kind: the elements of
  the (256, 2048) input that the kind's 31 slices cover, each read once,
  and the (64, 1024) output written once ("aligned", the kind the smoke
  times, covers rows 0-183 of columns 0-1023 and rows 0-63 of columns
  1024-1919: 1,245,184 B in all);
- warp-gather ablation (K9), (height, width) = (rows, wp), by mode: the
  (rows, wp) int32 offsets in and the (rows, wp) output out, and of the
  (rows, wp + 256) band what the mode reads: "gather" the wp columns
  x[:, 128:128 + wp] (each lane's 18 steps always reach its own column, so
  every one is read), "shifts" the wp + 2 * maxd + 2 columns its selects
  can pick for offsets in [-maxd, maxd].

For example the refine at 1080x1920 moves 24 * 2,073,600 = 49,766,400 B,
0.014855 ms at 3.35 TB/s. No timing here: these are the counts a chip
run's times are divided by.

A batch of B planes (the batched kernel API, and one round of B
independent streams, each plane at its own band) moves B times a plane's
bytes and does B times its operations, so every bound here is B times the
plane's (``batch``): the warps' band does not enter their counts.

The port's two kernels with no Pallas counterpart (``PORT_KERNELS``), the
reference's ``lax.cond`` and ``lax.scan`` on the card, have bounds of their
own shapes:

- the grid seed (``seed_bound``): the f32 frame read once and 9 B a cell
  written (xy and alive), against ``SEED_OPS_PER_PIXEL`` f32 operations a
  pixel; bound by bytes (at 1080p grid 16: 8,366,760 B, 2.50 us). A call
  whose predicate is false writes alive alone, 1 B a cell;
- IMU preintegration (``imu_bound``): 52 B a sample in (Exp(w h), accel,
  dt), 124 with the bias Jacobians' inputs, and 60 or 240 B out, against
  ``IMU_OPS_PER_SAMPLE``: bytes and operations both take well under a
  microsecond. What bounds it is latency (``imu_chain_ms``): each sample
  waits on the last through r (a multiply and two fused multiply-adds, 3
  dependent f32 operations) or, with the Jacobians, j_r (4), each at least
  ``F32_LATENCY_CYCLES`` cycles at the SM's clock.
"""

from __future__ import annotations

import numpy as np

from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation
from tpuflow_torch.eval.profile import HBM_GBPS

# f32 operations a second outside the tensor cores, NVIDIA H100 SXM at its
# 700 W limit (NVIDIA's data sheet, dense). The rate counts a fused
# multiply-add as two operations. The kernels are built with -fmad=false
# and so issue at most half of it; the bound is the card's for the
# function, not for one build, and at half the rate every kernel's
# operations still take less time than its bytes.
F32_TFLOPS = 67.0

BYTES_PER_PIXEL = {
    "warp_packed_u8": 16,
    "warp_packed_u16": 16,
    "warp_exact": 16,
    "lk_refine": 24,
    "lk_refine_exact": 24,
    "lk_fused": 16,
    "lk_fused_conf": 20,
    "lk_refine_mxu": 24,
    "lk_fused_mxu": 16,
    "lk_fused_conf_mxu": 20,
}

# f32 operations a pixel (an upper count at window 7: avg, it, Sobel, five
# products, 2 x 5 x 6 window adds, the solve and the epilogue; a warp's
# clip, source column, four corner reads' weights and two lerps). Tensor-
# core operations of K10 are not counted: they only exist in its design.
OPS_PER_PIXEL = {
    "warp_packed_u8": 20,
    "warp_packed_u16": 20,
    "warp_exact": 20,
    "lk_refine": 100,
    "lk_refine_exact": 100,
    "lk_fused": 95,
    "lk_fused_conf": 96,
    "lk_refine_mxu": 100,
    "lk_fused_mxu": 95,
    "lk_fused_conf_mxu": 96,
}

KERNELS = (*BYTES_PER_PIXEL, "lk_fused_tile_round", "shift_ablation", "warp_mxu_ablation")
# K6's tile round: the solve's operations a pixel of the extended tile (as
# K6) and the add and its |du| a pixel of the crop, per plane.
TILE_ROUND_OPS = (95, 4)


def _crop(height: int, width: int, variant) -> tuple[int, int]:
    """The crop of a tile round's (height, width) extended tile."""
    ext = int(variant or 5) // 2 + 1
    return height - 2 * ext, width - 2 * ext


def _shift_ablation_elements(kind: str) -> int:
    """Input elements the 31 slices of one kind cover, each counted once."""
    rows, cols = shift_ablation.offsets(kind)
    covered = np.zeros((shift_ablation.ROWS, shift_ablation.COLS), dtype=bool)
    for r, c in [(r, cols[0]) for r in rows] + [(rows[0], c) for c in cols]:
        covered[r : r + shift_ablation.OUT_R, c : c + shift_ablation.OUT_C] = True
    return int(covered.sum())


def call_bytes(name: str, batch: int, height: int, width: int,
               variant: str | None = None) -> int:
    """Bytes one call of kernel ``name`` must move on a (batch, height,
    width) input (for the ablations, their own shapes as described above;
    ``variant`` is K8's kind, default "aligned", or K9's mode, default
    "gather")."""
    if name in BYTES_PER_PIXEL:
        return BYTES_PER_PIXEL[name] * batch * height * width
    if name == "lk_fused_tile_round":
        ch, cw = _crop(height, width, variant)
        return batch * (8 * height * width + 16 * ch * cw)
    if name == "shift_ablation":
        if (batch, height, width) != (1, shift_ablation.OUT_R, shift_ablation.OUT_C):
            raise ValueError("shift_ablation has one shape: batch 1, "
                             f"({shift_ablation.OUT_R}, {shift_ablation.OUT_C}) out")
        return 4 * (_shift_ablation_elements(variant or "aligned") + height * width)
    if name == "warp_mxu_ablation":
        mode = variant or "gather"
        if mode not in warp_mxu_ablation.MODES:
            raise ValueError(f"mode must be one of {warp_mxu_ablation.MODES}, got {mode!r}")
        band = width if mode == "gather" else width + 2 * warp_mxu_ablation.MAXD + 2
        return 4 * batch * height * (band + 2 * width)
    raise KeyError(f"no byte count for kernel {name!r}")


def call_ops(name: str, batch: int, height: int, width: int,
             variant: str | None = None) -> int:
    """f32 operations one call does (the ablations: their adds and
    multiplies)."""
    if name in OPS_PER_PIXEL:
        return OPS_PER_PIXEL[name] * batch * height * width
    if name == "lk_fused_tile_round":
        ch, cw = _crop(height, width, variant)
        return batch * (TILE_ROUND_OPS[0] * height * width + TILE_ROUND_OPS[1] * ch * cw)
    if name == "shift_ablation":
        return 2 * (shift_ablation.N_SHIFTS - 1) * height * width
    if name == "warp_mxu_ablation":
        return 2 * warp_mxu_ablation.ITERS * batch * height * width
    raise KeyError(f"no operation count for kernel {name!r}")


def bound(name: str, batch: int, height: int, width: int,
          variant: str | None = None) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations"): the larger of the two times."""
    bytes_ms = call_bytes(name, batch, height, width, variant) / (HBM_GBPS * 1e9) * 1e3
    ops_ms = call_ops(name, batch, height, width, variant) / (F32_TFLOPS * 1e12) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bound_ms(name: str, batch: int, height: int, width: int,
             variant: str | None = None) -> float:
    """The least time in ms one call could take on the card."""
    return bound(name, batch, height, width, variant)[0]


# The port's kernels with no Pallas counterpart.
PORT_KERNELS = ("seed_grid", "imu_preintegrate")

# f32 operations a pixel of the grid seed: the average (2), Sobel's two
# sums of six taps (22), three products, 2 x 3 x 4 window adds, the
# eigenvalue (9) and the cell compare.
SEED_OPS_PER_PIXEL = 61
# f32 operations a sample of the scan: a_world (15), p (18), v (6), r step
# (45); with the bias Jacobians also r a^ and (r a^) j_r (90), j_r (63)
# and the four other Jacobians' updates (126).
IMU_OPS_PER_SAMPLE = {False: 84, True: 363}
IMU_BYTES_PER_SAMPLE = {False: 4 * 13, True: 4 * 31}
IMU_OUT_BYTES = {False: 4 * 15, True: 4 * 60}
# Dependent f32 operations a sample on the scan's longest chain: r's
# multiply and two fused multiply-adds, or j_r's and a subtract.
IMU_CHAIN_OPS = {False: 3, True: 4}
# Cycles from one f32 add, multiply or fused multiply-add to a dependent
# one on Volta through Hopper (published microbenchmarks), and the H100
# SXM's highest SM clock (NVIDIA's data sheet; nvidia-smi's clocks.max.sm
# reads 1980 MHz on the card).
F32_LATENCY_CYCLES = 4
SM_CLOCK_GHZ = 1.98


def _time(nbytes: int, ops: int) -> tuple[float, str]:
    bytes_ms = nbytes / (HBM_GBPS * 1e9) * 1e3
    ops_ms = ops / (F32_TFLOPS * 1e12) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def seed_bytes(height: int, width: int, grid_step: int, taken: bool = True) -> int:
    """Bytes one grid-seed call must move: the frame and xy and alive a
    cell where it seeds, alive alone where its predicate is false."""
    cells = (height // grid_step) * (width // grid_step)
    return 4 * height * width + 9 * cells if taken else cells


def seed_bound(height: int, width: int, grid_step: int, taken: bool = True
               ) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") of one grid-seed call."""
    ops = SEED_OPS_PER_PIXEL * height * width if taken else 0
    return _time(seed_bytes(height, width, grid_step, taken), ops)


def imu_bytes(n: int, bias_jacobians: bool) -> int:
    """Bytes one scan over ``n`` samples must move."""
    return IMU_BYTES_PER_SAMPLE[bias_jacobians] * n + IMU_OUT_BYTES[bias_jacobians]


def imu_bound(n: int, bias_jacobians: bool) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") of one scan over ``n``
    samples: the card's rates, which its dependent chain never reaches."""
    return _time(imu_bytes(n, bias_jacobians), IMU_OPS_PER_SAMPLE[bias_jacobians] * n)


def imu_chain_ms(n: int, bias_jacobians: bool) -> float:
    """The least time in ms of the scan's dependent chain over ``n``
    samples, at ``F32_LATENCY_CYCLES`` a dependent operation."""
    cycles = IMU_CHAIN_OPS[bias_jacobians] * n * F32_LATENCY_CYCLES
    return cycles / (SM_CLOCK_GHZ * 1e9) * 1e3
