// Lucas-Kanade tile kernel on Hopper (sm_90a), shared by the refine step
// (lk_refine.cu: K3 relaxed order, K5 exact order), the fused
// single-scale solve (lk_fused.cu: K6, K7 with the |det| plane) and K6's
// round on a halo-extended tile of the tiled pyramidal path (lk_fused.cu).
// The window_mxu variant (K10) keeps a staged body of its own, in
// lk_mxu.cu.
//
// Replaces tpuflow/kernels/pallas_lk.py::_lk_tile (:189-311) as reached by
// _lk_refine_kernel (:351), _lk_kernel (:314) and _lk_conf_kernel (:331).
//
// What it computes, per output pixel, on frames padded symmetric by 1 then
// with zeros (pallas_lk.py:433-435, :542-544):
//   avg = (p + c) * 0.5; it = p - c;
//   Sobel/8 of avg, in one of two f32 orders:
//     exact (kRelaxed = false, pallas_lk.py:235-249), direct 3x3:
//       ix = (((a[-1][-1] - a[-1][+1]) + 2*(a[0][-1] - a[0][+1]))
//             + (a[+1][-1] - a[+1][+1])) * 0.125, iy likewise down the rows;
//     relaxed (pallas_lk.py:221-233), separable: sv = (a[-1] + 2*a[0]) +
//       a[+1] and dv = a[-1] - a[+1] down the rows, then
//       ix = (sv[-1] - sv[+1]) * 0.125, iy = ((dv[-1] + 2*dv[0]) + dv[+1])
//       * 0.125 across the columns;
//   the five products ix*ix, iy*iy, ix*iy, ix*it, iy*it summed over the
//   window, rows first, then columns, in one of three orders:
//     sequential ((((a0 + a1) + a2) + a3) + a4) (pallas_lk.py:262-268);
//     the shift tree of _sliding_sum_tree (pallas_lk.py:94-136), e.g.
//       ((a0 + a1) + (a2 + a3)) + a4 at window 5;
//     Gaussian taps, t0*a0 + t1*a1 + ... sequentially (pallas_lk.py:
//       269-277), whatever the Sobel order;
//   det = sxx*syy - sxy*sxy, inv = |det| > det_threshold ? 1/det : 0,
//   du = (syy*b0 - sxy*b1) * inv, dv = (sxx*b1 - sxy*b0) * inv with
//   b0 = -sxt, b1 = -syt (pallas_lk.py:288-292), zero outside the interior
//   (a window-half border, pallas_lk.py:296-304).
// Then, by mode:
//   refine: the carried flow clipped to +-max_disp / +-max_disp_v and
//     out = converged[b] ? clip : clip + d (pallas_lk.py:373-381), and one
//     partial sum of |du| and of |dv| per block, added in a fixed tree
//     order (no float atomics), so the early exit is reproducible;
//   fused: (du, dv) written as the flow;
//   fused with det: also |det| on the interior and 0 elsewhere
//     (pallas_lk.py:305-310);
//   tile round (the tiled path's round on a tile extended by `crop` =
//     window / 2 + 1 px, tpuflow/sharding/tiled_pyramidal.py:176-212 and
//     :309-310): K6's (du, dv) on the extended tile, kept on the crop
//     [crop, crop + tile_h) x [crop, crop + tile_w) only, zeroed outside
//     the global interior (the crop's global row gy0 + y and column
//     gx0 + x within window / 2 of the level's gh x gw border), added into
//     the tile's u, v in place, and sum|du|, sum|dv| over the crop: one
//     partial a block, which the element's last block adds into the two
//     sums as the refine round's are added. A set latch (ctrl row 0) skips
//     the round: no frame read, no partial or sum written, u and v
//     untouched. The latch is not set here: the tiled loop sums the sums
//     across the mesh's ranks first and latches on the device from the
//     reduced sums. A running round adds one to its element's round count
//     (ctrl row 2).
//
// Bound on this card: device memory. Each pixel's bytes, each input read
// once and each output written once: 24 B for the refine (prev, warped,
// u, v in; u, v out), 16 B fused (prev, curr in; u, v out), 20 B with
// |det|; at 1080p 0.0149, 0.0099 and 0.0124 ms at 3.35 TB/s. The tile
// round moves 8 B a pixel of the extended tile (prev, warped in) and 16 B
// a pixel of its crop (u, v in and out): 0.0149 ms on the 1080p tile
// extended to 1086x1926. The ~100 f32
// operations a pixel take a third of that at the card's f32 rate. What a
// design must avoid is on chip: staging whole tiles in shared memory and
// re-reading them per window tap spends ~130 shared-memory words an
// output.
//
// Design: a column walk. Each warp walks down a strip of 32 frame columns,
// one column a lane, and each lane keeps its column's state in registers:
//   - the frames arrive two rows a step by 4-byte cp.async (each lane its
//     own column, zero-filled outside the padded frame) into a per-warp
//     ring of kStages steps in shared memory, a step ahead of use; the
//     lane's padded source column is fixed for the walk and the source
//     row is one compare a row, so no element pays a division or a
//     padding branch; the refine's u, v ride in the same ring;
//   - avg is formed once a pixel and reaches the two neighbouring columns
//     by two warp shuffles; each lane keeps two rows of avg for its column
//     and both neighbours, and forms Sobel, it and the five products once a
//     gradient pixel, for two rows at a time (two independent chains);
//   - the products go into a register ring of w rows x 5 planes (the step
//     loop is unrolled by w, so every ring index is static); the vertical
//     window sum is formed from the ring in the order above;
//   - the horizontal window sum takes its neighbours' row sums by warp
//     shuffles (the shift tree shares its runs: 2/3/4 shuffles a plane at
//     windows 3/5/7, the other orders w - 1), then the solve and the
//     epilogue run in the lane.
// About 4 shared-memory words and 2 + 5(w - 1) shuffles (tree: 2 + 5 x
// 2/3/4) a row a lane, and no block barrier until the refine's partial
// sums. A strip's 32 columns give 30 gradient columns and 30 - 2*(w/2)
// outputs (28/26/24 at windows 3/5/7): adjacent strips re-read 2 + 2*(w/2)
// columns, from L1 or L2. A block is kStripWarps = 4 adjacent strips (128
// threads) by up to kMaxRows = 32 output rows, whose walk re-reads
// 2 + 2*(w/2) rows at its top (1.19x at window 5). A 1080p plane is ~650
// blocks, about 5 an SM: one wave at <= 102 registers a thread (window 7
// takes 4 an SM, 128 registers, or it spills). Smaller planes walk 16, 8
// or 4 rows a block (walk_rows), since a walk's steps are sequential and a
// coarse pyramid level would otherwise leave most SMs idle. Two ring slots
// read faster than four or eight on the card (a scratch sweep), likely
// because the ring's shared memory comes out of the L1 that catches the
// strips' overlap.
// Batches: blockIdx.z is the batch element (the TPU kernels' flattened
// (batch * row tiles) grid); each element reads its own planes, its own
// converged flag and writes its own block partials.
// A round under device control (refine, `ctrl` set: the pyramidal
// driver's round, in place of the reference's lax.while_loop body and
// lax.switch operand, tpuflow/flow/pyramidal.py:39-132, :169-199):
//   - each block reads its element's latch first; a set latch means the
//     level converged before this round, and the block copies u_in, v_in
//     to u_out, v_out bit for bit and returns (no re-clip: the
//     reference's loop never runs such a round). Its sums are 0;
//   - max_disp_v is ladder[band[z]], the element's index read from device
//     memory (one index for the whole batch, or one a plane: a batch of
//     independent streams);
//   - the block that finishes an element's round last (a ticket counter
//     in device memory) adds the element's block partials in a fixed
//     order (each thread a strided run, then the block's butterfly and its
//     warps in order), writes the two sums, ORs sdu / n_px < thr &
//     sdv / n_px < thr (f32, as the reference) into the latch, counts the
//     round and resets the ticket. No host read and no second launch.
// The tile round (K6's round on a halo-extended tile) keeps the walk and
// changes its own traffic and control:
//   - the crop's u, v ride in the ring a step ahead, as the refine's do,
//     at the crop's coordinates (zero-filled outside the crop), so the
//     in-place add reads them from shared memory and stores once: read
//     from device memory after the solve, they would be a load that every
//     output row's store waits on;
//   - the element's last block adds the block partials into its two sums
//     (finish_round, the ticket in ctrl row 1), so a round is one launch
//     and no reduction follows it; it does not latch;
//   - its walk rows come from tile_round_rows (two blocks an SM, not four:
//     longer walks on the coarse tiles, chosen by a sweep on the card,
//     ablation/tile_walk.py);
//   - a skipped round's blocks read the latch and return. An empty kernel
//     on the same grid takes ~0.0004 ms over the one-block launch floor at
//     the 1080p tile, the latch's read ~0.0002 more (H100 80GB HBM3,
//     700 W): what a skipped round costs over the floor is the grid's
//     launch, which the round's running form needs.
// Built with -fmad=false: no product is fused into an FMA, so each pixel
// is bit-identical to the plain PyTorch version in kernels/lk.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuflow_lk {

constexpr int kMaxWindow = 7;
constexpr int kMaxBatch = 65535;  // gridDim.z

enum Mode { kRefine = 0, kFused = 1, kFusedDet = 2, kTileRound = 3 };

struct Taps {
  float t[kMaxWindow];
};

// Longest band ladder a refine round takes.
constexpr int kMaxLadder = 8;

// ladder[i] with every index static: an index computed at run time into a
// kernel parameter's array makes the compiler copy the whole struct to
// local memory in every thread.
__device__ __forceinline__ float ladder_at(const float (&ladder)[kMaxLadder], int i) {
  float v = ladder[0];
#pragma unroll
  for (int k = 1; k < kMaxLadder; ++k) v = k == i ? ladder[k] : v;
  return v;
}

// Every plane pointer is to the first of `batch` contiguous (height, width)
// planes.
struct LkArgs {
  const float* prev;
  const float* curr;  // the warped frame for the refine step
  const float* u_in;  // refine only
  const float* v_in;
  const unsigned char* converged;  // refine only: one flag per element
  float* u_out;
  float* v_out;
  float* det_out;  // fused with det only
  float* part_du;  // refine and tile round: one partial sum per block, element-major
  float* part_dv;
  int height;
  int width;
  float det_threshold;
  float max_disp;
  float max_disp_v;
  Taps taps;
  // A refine round under device control (null: none): per element, an
  // int32 latch, a ticket counter and a round count, each `batch` long.
  int* ctrl;
  // Index into ladder (null: ladder[0]): element z's at band[band_stride
  // * z], one index for the batch (stride 0) or one a plane (stride 1).
  const int* band;
  int band_stride;
  float ladder[kMaxLadder];
  int n_ladder;
  float* sums;  // (2, batch): the element's sum|du|, then sum|dv|
  float thr;    // convergence threshold on the mean |du|, |dv|
  // A tile round (kTileRound): u_out, v_out are the tile's (tile_h,
  // tile_w) flow planes, updated in place; `ctrl` as above (rows 0 and 2
  // used); the crop's offset in the extended tile and its global origin
  // and the level's global shape.
  int crop;
  int tile_h;
  int tile_w;
  int gy0;
  int gx0;
  int gh;
  int gw;
};

// Shift-tree run of N = 2^k taps: run<2N>(a) = run<N>(a) + run<N>(a + N).
template <int N>
__device__ __forceinline__ float run_sum(const float* a) {
  if constexpr (N == 1) {
    return a[0];
  } else {
    return run_sum<N / 2>(a) + run_sum<N / 2>(a + N / 2);
  }
}

// The binary decomposition of the remaining Rem taps, largest run first,
// each added onto the running sum.
template <int P, int Rem>
__device__ __forceinline__ float tree_rest(float acc, const float* a) {
  if constexpr (P == 0) {
    return acc;
  } else if constexpr (Rem >= P) {
    return tree_rest<P / 2, Rem - P>(acc + run_sum<P>(a), a + P);
  } else {
    return tree_rest<P / 2, Rem>(acc, a);
  }
}

enum Order { kSequential = 0, kTree = 1, kWeighted = 2 };

// How the window is summed: uniform (sequential or shift tree, by the
// Sobel order) or with Gaussian taps. (K10's banded products on the tensor
// cores are lk_mxu.cu's own kernel.)
enum WindowSum { kUniform = 0, kGaussian = 1 };

template <int W, int kOrder>
__device__ __forceinline__ float window_sum(const float (&a)[W],
                                            const float* taps) {
  if constexpr (kOrder == kTree) {
    constexpr int P = W >= 4 ? 4 : 2;  // largest power of two <= W (W <= 7)
    return tree_rest<P / 2, W - P>(run_sum<P>(a), a + P);
  } else if constexpr (kOrder == kWeighted) {
    float s = taps[0] * a[0];
#pragma unroll
    for (int d = 1; d < W; ++d) s = s + taps[d] * a[d];
    return s;
  } else {
    float s = a[0];
#pragma unroll
    for (int d = 1; d < W; ++d) s = s + a[d];
    return s;
  }
}

// The solve of one pixel at (y, x) from its five window sums, then, if
// `store`, the mode's epilogue into u_dst, v_dst (and det_dst); the refine
// then adds |du|, |dv| to acc_u, acc_v. Only the stores and the adds are
// conditional, so a warp's lanes run the solve together.
template <int kHalf, int kMode>
__device__ __forceinline__ void solve_store(const LkArgs& args, const float (&s)[5],
                                            int y, int x, bool store, bool frozen,
                                            float max_disp_v, float u_in, float v_in,
                                            float* u_dst, float* v_dst, float* det_dst,
                                            float& acc_u, float& acc_v) {
  const int height = args.height, width = args.width;
  const float s_xx = s[0], s_yy = s[1], s_xy = s[2];
  const float b0 = -s[3], b1 = -s[4];
  const float det = s_xx * s_yy - s_xy * s_xy;
  const float inv = fabsf(det) > args.det_threshold ? 1.0f / det : 0.0f;
  float du = (s_yy * b0 - s_xy * b1) * inv;
  float dv = (s_xx * b1 - s_xy * b0) * inv;
  const bool interior =
      y >= kHalf && y < height - kHalf && x >= kHalf && x < width - kHalf;
  if (!interior) {
    du = 0.0f;
    dv = 0.0f;
  }
  if constexpr (kMode == kRefine) {
    const float uc = fminf(fmaxf(u_in, -args.max_disp), args.max_disp);
    const float vc = fminf(fmaxf(v_in, -max_disp_v), max_disp_v);
    const float u_next = frozen ? uc : uc + du;
    const float v_next = frozen ? vc : vc + dv;
    if (store) {
      *u_dst = u_next;
      *v_dst = v_next;
      acc_u += fabsf(du);
      acc_v += fabsf(dv);
    }
  } else if constexpr (kMode == kTileRound) {
    // (y, x) in the extended tile; the crop lies inside its interior.
    const int gy = y - args.crop + args.gy0, gx = x - args.crop + args.gx0;
    if (!(gy >= kHalf && gy < args.gh - kHalf && gx >= kHalf && gx < args.gw - kHalf)) {
      du = 0.0f;
      dv = 0.0f;
    }
    if (store) {
      *u_dst = u_in + du;
      *v_dst = v_in + dv;
      acc_u += fabsf(du);
      acc_v += fabsf(dv);
    }
  } else {
    const float det_out = interior ? fabsf(det) : 0.0f;
    if (store) {
      *u_dst = du;
      *v_dst = dv;
      if constexpr (kMode == kFusedDet) *det_dst = det_out;
    }
  }
}

// ---------------------------------------------------------------------------
// The column walk (K3, K5, K6, K7, K6's tile round).

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStripWarps = 4;                 // strips (warps) per block
constexpr int kWalkThreads = kStripWarps * kLanes;

// The end of a refine round under device control, or of a tile round,
// called by every thread of each block after the block's partials are
// written: the element's last block sums its partials, and (refine only)
// latches and counts the round, then resets the ticket (see the note
// above). `red` is the block's [2][kStripWarps] scratch, free again once
// thread 0 has written its partials.
template <int kMode>
__device__ __forceinline__ void finish_round(const LkArgs& args,
                                             float (&red)[2][kStripWarps]) {
  __shared__ bool last;
  const int z = blockIdx.z, batch = gridDim.z;
  const int n_blocks = gridDim.x * gridDim.y;
  unsigned* tickets = reinterpret_cast<unsigned*>(args.ctrl + batch);
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials before its ticket
    last = atomicAdd(&tickets[z], 1u) == (unsigned)(n_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pu = args.part_du + (size_t)z * n_blocks;
  const float* pv = args.part_dv + (size_t)z * n_blocks;
  float su = 0.0f, sv = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += kWalkThreads) {
    su += __ldcg(pu + i);  // other SMs' writes: from L2, not a stale L1
    sv += __ldcg(pv + i);
  }
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) {
    su += __shfl_xor_sync(kFull, su, m);
    sv += __shfl_xor_sync(kFull, sv, m);
  }
  if (lane == 0) {
    red[0][warp] = su;
    red[1][warp] = sv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    su = red[0][0];
    sv = red[1][0];
#pragma unroll
    for (int w = 1; w < kStripWarps; ++w) {
      su += red[0][w];
      sv += red[1][w];
    }
    args.sums[z] = su;
    args.sums[batch + z] = sv;
    if constexpr (kMode == kRefine) {
      const float n_px = (float)(args.height * args.width);
      if (su / n_px < args.thr && sv / n_px < args.thr) args.ctrl[z] = 1;
      args.ctrl[2 * batch + z] += 1;
    }
    tickets[z] = 0;
  }
}

constexpr int kMaxRows = 32;                   // output rows per block, at most
constexpr int kMinRows = 4;
constexpr int kFillBlocks = 512;               // ~4 blocks an SM of the H100's 132
constexpr int kStages = 2;                     // ring slots, a step (two frame rows) each
static_assert((kStages & (kStages - 1)) == 0, "a power of two");

// Output columns of one strip at a window.
__host__ __device__ constexpr int strip_width(int window) {
  return kLanes - 2 - 2 * (window / 2);
}

// 4-byte asynchronous copy global -> shared, or 4 zero bytes if !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Window sum across lanes: lane l gets the sum of lanes l .. l + W - 1 of
// v, in window_sum's order. The shift tree shares its runs between lanes
// (2/3/4 shuffles at windows 3/5/7, tree_rest's order); the sequential and
// weighted sums take each tap's lane (W - 1 shuffles).
template <int W, int kOrder>
__device__ __forceinline__ float lane_window_sum(float v, const float* taps) {
  if constexpr (kOrder == kTree) {
    const float r2 = v + __shfl_down_sync(kFull, v, 1);  // run of 2 at l
    if constexpr (W == 3) return r2 + __shfl_down_sync(kFull, v, 2);
    const float r4 = r2 + __shfl_down_sync(kFull, r2, 2);  // run of 4 at l
    if constexpr (W == 5) return r4 + __shfl_down_sync(kFull, v, 4);
    return (r4 + __shfl_down_sync(kFull, r2, 4)) + __shfl_down_sync(kFull, v, 6);
  } else {
    float a[W];
    a[0] = v;
#pragma unroll
    for (int d = 1; d < W; ++d) a[d] = __shfl_down_sync(kFull, v, d);
    return window_sum<W, kOrder>(a, taps);
  }
}

// Sobel/8 of avg at a lane's column from three avg rows (top, mid, bot) at
// its left (l), own (c) and right (r) columns, in the Sobel order.
template <bool kRelaxed>
__device__ __forceinline__ void sobel(float lt, float lm, float lb, float ct, float cb,
                                      float rt, float rm, float rb, float& gx, float& gy) {
  if constexpr (kRelaxed) {
    const float sv_m = (lt + 2.0f * lm) + lb;
    const float sv_p = (rt + 2.0f * rm) + rb;
    const float dv_m = lt - lb;
    const float dv_0 = ct - cb;
    const float dv_p = rt - rb;
    gx = (sv_m - sv_p) * 0.125f;
    gy = ((dv_m + 2.0f * dv_0) + dv_p) * 0.125f;
  } else {
    gx = (((lt - rt) + 2.0f * (lm - rm)) + (lb - rb)) * 0.125f;
    gy = (((lt - lb) + 2.0f * (ct - cb)) + (rt - rb)) * 0.125f;
  }
}

// Blocks an SM must hold at once, which caps the registers a thread: 5
// (102 registers) keeps a 1080p plane's blocks in one wave; window 7 needs
// ~120 registers without spilling, so 4.
template <int kWindow>
__host__ __device__ constexpr int walk_min_blocks() {
  return kWindow == 7 ? 4 : 5;
}

template <int kWindow, bool kRelaxed, int kSum, int kMode>
__global__ void __launch_bounds__(kWalkThreads, walk_min_blocks<kWindow>())
    lk_walk_kernel(const LkArgs args, int rows) {
  static_assert(kWindow == 3 || kWindow == 5 || kWindow == 7, "window 3/5/7");
  constexpr int kHalf = kWindow / 2;
  constexpr int kOutW = strip_width(kWindow);
  constexpr int kOrder =
      kSum == kGaussian ? kWeighted : (kRelaxed ? kTree : kSequential);
  // Per frame row of a ring slot: prev and curr, and for the refine and the
  // tile round the carried u and v at the output row of the same step.
  constexpr int kPlanes = kMode == kRefine || kMode == kTileRound ? 4 : 2;

  __shared__ float stage[kStripWarps][kStages][2][kPlanes][kLanes];
  __shared__ float red[2][kStripWarps];  // refine and tile round only

  const int height = args.height, width = args.width;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int x0 = (blockIdx.x * kStripWarps + warp) * kOutW;  // first output column
  const int r0 = blockIdx.y * rows;                           // first output row
  const float* taps = args.taps.t;
  const size_t plane = (size_t)blockIdx.z * height * width;

  // This lane's frame column (the avg column) and its source column in the
  // padded frame; lanes 1 .. kOutW write output column xo, whose window
  // spans lanes l .. l + 2*kHalf.
  const int x = x0 - kHalf - 1 + lane;
  const int xs = x == -1 ? 0 : x == width ? width - 1 : x;
  const bool col_ok = xs >= 0 && xs < width;
  const int xo = x + kHalf;
  const bool out_lane = lane >= 1 && lane <= kOutW && xo < width;
  // Per-lane bases; a row adds an unsigned 32-bit offset (a plane holds
  // fewer than 2^31 pixels: the wrappers check).
  const float* prev_c = args.prev + plane + (col_ok ? xs : 0);
  const float* curr_c = args.curr + plane + (col_ok ? xs : 0);
  const size_t out_c = plane + (out_lane ? xo : 0);
  const float* u_in_c = args.u_in + out_c;
  const float* v_in_c = args.v_in + out_c;
  float* u_out_c = args.u_out + out_c;
  float* v_out_c = args.v_out + out_c;
  float* det_out_c = kMode == kFusedDet ? args.det_out + out_c : u_out_c;  // else unused
  // A tile round's flow planes: (tile_h, tile_w) each, per element, updated
  // in place at the crop's coordinates (cy, cx) = (r0 + y, xo) - crop.
  const int cx = xo - args.crop;
  const bool crop_col = kMode == kTileRound && out_lane && (unsigned)cx < (unsigned)args.tile_w;
  const size_t crop_c =
      (size_t)blockIdx.z * args.tile_h * args.tile_w + (crop_col ? cx : 0);
  float* u_crop_c = args.u_out + crop_c;  // tile round only
  float* v_crop_c = args.v_out + crop_c;
  const uint32_t stage_lane =
      static_cast<uint32_t>(__cvta_generic_to_shared(&stage[warp][0][0][0][lane]));
  constexpr uint32_t kPlaneBytes = kLanes * sizeof(float);
  constexpr uint32_t kRowBytes = kPlanes * kPlaneBytes;

  // Frame row f (of r0 - kHalf - 1 + f) is read at step f / 2; gradient
  // row g is centred on frame row g + 1; output row r0 + y comes from
  // gradient rows y .. y + 2*kHalf. So step j reads frame rows 2j, 2j + 1,
  // forms gradient rows 2j - 2, 2j - 1 and outputs rows 2j - 2 - 2*kHalf
  // and 2j - 1 - 2*kHalf where they are in 0 .. n_out - 1.
  const int n_out = x0 < width ? min(rows, height - r0) : 0;
  const int n_frame = n_out + 2 * kHalf + 2;  // even iff n_out is
  const int n_steps = x0 < width ? (n_frame + 1) / 2 : 0;

  auto fetch_row = [&](int f, uint32_t dst) {
    const int r = r0 - kHalf - 1 + f;
    const int rs = r == -1 ? 0 : r == height ? height - 1 : r;
    const bool ok = col_ok && f < n_frame && (unsigned)rs < (unsigned)height;
    const unsigned off = ok ? (unsigned)(rs * width) : 0u;
    cp_async4(dst, prev_c + off, ok);
    cp_async4(dst + kPlaneBytes, curr_c + off, ok);
    if constexpr (kMode == kRefine) {
      const int y = f - 2 - 2 * kHalf;  // the output row formed at this row's step
      const bool uv_ok = out_lane && (unsigned)y < (unsigned)n_out;
      const unsigned uv_off = uv_ok ? (unsigned)((r0 + y) * width) : 0u;
      cp_async4(dst + 2 * kPlaneBytes, u_in_c + uv_off, uv_ok);
      cp_async4(dst + 3 * kPlaneBytes, v_in_c + uv_off, uv_ok);
    } else if constexpr (kMode == kTileRound) {
      // The crop's u, v at the output row formed at this row's step, zero
      // outside the crop.
      const int y = f - 2 - 2 * kHalf;
      const int cy = r0 + y - args.crop;
      const bool uv_ok = crop_col && (unsigned)y < (unsigned)n_out &&
                         (unsigned)cy < (unsigned)args.tile_h;
      const unsigned uv_off = uv_ok ? (unsigned)(cy * args.tile_w) : 0u;
      cp_async4(dst + 2 * kPlaneBytes, u_crop_c + uv_off, uv_ok);
      cp_async4(dst + 3 * kPlaneBytes, v_crop_c + uv_off, uv_ok);
    }
  };
  auto fetch = [&](int j) {
    const uint32_t slot = stage_lane + (j & (kStages - 1)) * 2 * kRowBytes;
    fetch_row(2 * j, slot);
    fetch_row(2 * j + 1, slot + kRowBytes);
    cp_async_commit();  // one group a step, empty past the end
  };

  bool frozen = false;
  float max_disp_v = args.max_disp_v;
  if constexpr (kMode == kRefine) {
    if (args.ctrl != nullptr) {
      // A round under device control: skipped after convergence (a copy),
      // else never frozen; the band from the ladder.
      if (args.ctrl[blockIdx.z] != 0) {
        // The copy, kCopyRows rows of both planes in flight at a time.
        constexpr int kCopyRows = 8;
        if (out_lane) {
          for (int y0 = 0; y0 < n_out; y0 += kCopyRows) {
            float cu[kCopyRows], cv[kCopyRows];
#pragma unroll
            for (int k = 0; k < kCopyRows; ++k) {
              const unsigned o = (unsigned)((r0 + min(y0 + k, n_out - 1)) * width);
              cu[k] = __ldg(u_in_c + o);
              cv[k] = __ldg(v_in_c + o);
            }
#pragma unroll
            for (int k = 0; k < kCopyRows; ++k) {
              if (y0 + k < n_out) {
                const unsigned o = (unsigned)((r0 + y0 + k) * width);
                u_out_c[o] = cu[k];
                v_out_c[o] = cv[k];
              }
            }
          }
        }
        if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
          args.sums[blockIdx.z] = 0.0f;
          args.sums[gridDim.z + blockIdx.z] = 0.0f;
        }
        return;
      }
      max_disp_v = ladder_at(
          args.ladder,
          args.band ? min(max(args.band[args.band_stride * blockIdx.z], 0), args.n_ladder - 1)
                    : 0);
    } else {
      frozen = args.converged[blockIdx.z] != 0;
    }
  }
  if constexpr (kMode == kTileRound) {
    // Skipped after convergence: nothing read or written. Else the round
    // is counted once (block 0 of the element).
    if (args.ctrl[blockIdx.z] != 0) return;
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) args.ctrl[2 * gridDim.z + blockIdx.z] += 1;
  }
  float acc_u = 0.0f, acc_v = 0.0f;

  // Window sums and the solve of output row y (if in range) from gradient
  // rows in ring slots g0 + 1 .. g0 + kWindow (mod kWindow), oldest first.
  float prod[5][kWindow];  // gradient row g in slot g % kWindow
  auto emit = [&](int g0, int y, const float* row) {
    float s[5];
#pragma unroll
    for (int pl = 0; pl < 5; ++pl) {
      float col[kWindow];
#pragma unroll
      for (int d = 0; d < kWindow; ++d) col[d] = prod[pl][(g0 + 1 + d) % kWindow];
      s[pl] = lane_window_sum<kWindow, kOrder>(window_sum<kWindow, kOrder>(col, taps), taps);
    }
    if constexpr (kMode == kTileRound) {
      const int cy = r0 + y - args.crop;
      const bool in_crop = crop_col && y < n_out && (unsigned)cy < (unsigned)args.tile_h;
      const unsigned t = in_crop ? (unsigned)(cy * args.tile_w) : 0u;
      solve_store<kHalf, kMode>(args, s, r0 + y, xo, in_crop, false, 0.0f, row[2 * kLanes],
                                row[3 * kLanes], u_crop_c + t, v_crop_c + t, nullptr, acc_u,
                                acc_v);
      return;
    }
    const unsigned o = (unsigned)((r0 + y) * width);
    float u_in = 0.0f, v_in = 0.0f;
    if constexpr (kMode == kRefine) {
      u_in = row[2 * kLanes];
      v_in = row[3 * kLanes];
    }
    solve_store<kHalf, kMode>(args, s, r0 + y, xo, out_lane && y < n_out, frozen, max_disp_v,
                              u_in, v_in, u_out_c + o, v_out_c + o, det_out_c + o, acc_u,
                              acc_v);
  };
  auto products = [&](int g, float gx, float gy, float gt) {
    prod[0][g] = gx * gx;
    prod[1][g] = gy * gy;
    prod[2][g] = gx * gy;
    prod[3][g] = gx * gt;
    prod[4][g] = gy * gt;
  };

  // avg of the last two frame rows (h2 older, h1 newer) at this lane's
  // column (c) and its neighbours (l, r); it of the newer.
  float l_h2 = 0.0f, l_h1 = 0.0f, c_h2 = 0.0f, c_h1 = 0.0f, r_h2 = 0.0f, r_h1 = 0.0f;
  float it_h1 = 0.0f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) fetch(j);

  for (int base = 0; base < n_steps; base += kWindow) {
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      const int j = base + k;
      if (j >= n_steps) break;
      fetch(j + kStages - 1);
      cp_async_wait<kStages - 1>();  // step j's group has landed
      const float* row_a = &stage[warp][j & (kStages - 1)][0][0][lane];
      const float* row_b = &stage[warp][j & (kStages - 1)][1][0][lane];
      const float pa = row_a[0], qa = row_a[kLanes];
      const float pb = row_b[0], qb = row_b[kLanes];
      const float a_c = (pa + qa) * 0.5f, b_c = (pb + qb) * 0.5f;
      const float a_l = __shfl_up_sync(kFull, a_c, 1);
      const float a_r = __shfl_down_sync(kFull, a_c, 1);
      const float b_l = __shfl_up_sync(kFull, b_c, 1);
      const float b_r = __shfl_down_sync(kFull, b_c, 1);
      const float it_a = pa - qa;
      if (j >= 1) {
        // Gradient rows 2j - 2 (centred on h1) and 2j - 1 (centred on a),
        // ring slots (2j - 2) % kWindow and (2j - 1) % kWindow, static.
        const int g1 = (2 * k + 2 * kWindow - 2) % kWindow;
        const int g2 = (2 * k + 2 * kWindow - 1) % kWindow;
        float gx1, gy1, gx2, gy2;
        sobel<kRelaxed>(l_h2, l_h1, a_l, c_h2, a_c, r_h2, r_h1, a_r, gx1, gy1);
        sobel<kRelaxed>(l_h1, a_l, b_l, c_h1, b_c, r_h1, a_r, b_r, gx2, gy2);
        // Row 2j - 1 takes the slot of row 2j - 2's oldest window row, so
        // row 2j - 2 is summed first.
        products(g1, gx1, gy1, it_h1);
        if (2 * j - 2 >= 2 * kHalf) emit(g1, 2 * j - 2 - 2 * kHalf, row_a);
        products(g2, gx2, gy2, it_a);
        if (2 * j - 1 >= 2 * kHalf) emit(g2, 2 * j - 1 - 2 * kHalf, row_b);
      }
      l_h2 = a_l; l_h1 = b_l;
      c_h2 = a_c; c_h1 = b_c;
      r_h2 = a_r; r_h1 = b_r;
      it_h1 = pb - qb;
    }
  }
  cp_async_wait<0>();

  if constexpr (kMode == kRefine || kMode == kTileRound) {
    // Lanes by a fixed butterfly, then the warps in order.
#pragma unroll
    for (int m = kLanes / 2; m > 0; m >>= 1) {
      acc_u += __shfl_xor_sync(kFull, acc_u, m);
      acc_v += __shfl_xor_sync(kFull, acc_v, m);
    }
    if (lane == 0) {
      red[0][warp] = acc_u;
      red[1][warp] = acc_v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float su = red[0][0], sv = red[1][0];
#pragma unroll
      for (int w = 1; w < kStripWarps; ++w) {
        su += red[0][w];
        sv += red[1][w];
      }
      const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      args.part_du[b] = su;
      args.part_dv[b] = sv;
    }
    if constexpr (kMode == kRefine) {
      if (args.ctrl != nullptr) finish_round<kMode>(args, red);
    } else {
      finish_round<kMode>(args, red);  // the tile round's sums, not its latch
    }
  }
}

// Output rows a block walks: kMaxRows, halved down to kMinRows while the
// plane would give fewer than kFillBlocks blocks. A walk's steps run one
// after another, so a small plane (a coarse pyramid level) needs more,
// shorter walks to keep the card busy. A function of the plane alone, so a
// batch element's partial sums are those of its 2-D launch.
inline int walk_rows(int height, int width, int window) {
  const int strips = (width + strip_width(window) - 1) / strip_width(window);
  const int cols = (strips + kStripWarps - 1) / kStripWarps;
  int rows = kMaxRows;
  while (rows > kMinRows && cols * ((height + rows - 1) / rows) < kFillBlocks) rows /= 2;
  return rows;
}

// Output rows a block of the tile round walks: kMaxRows, halved down to
// kMinRows while the tile would give fewer than kTileFillBlocks blocks (two
// an SM). That gives the coarse tiles fewer, longer walks than walk_rows
// does: at the 1080p world-1 tiles a sweep of 2-32 rows and 2/4/8 ring
// slots on the card (ablation/tile_walk.py) read each tile fastest at
// about two blocks an SM, and two slots fastest but on the finest tile's
// 32-row walks, where four read 1-3% faster. A walk re-reads 2 + 2*(w/2)
// frame rows at its top, so halving the rows past that buys more re-read
// rows than parallel walks. A function of the tile alone, as walk_rows.
constexpr int kTileFillBlocks = 264;
inline int tile_round_rows(int height, int width, int window) {
  const int strips = (width + strip_width(window) - 1) / strip_width(window);
  const int cols = (strips + kStripWarps - 1) / kStripWarps;
  int rows = kMaxRows;
  while (rows > kMinRows && cols * ((height + rows - 1) / rows) < kTileFillBlocks) rows /= 2;
  return rows;
}

// The walk's grid for a batch at `rows` output rows a block.
inline dim3 walk_grid(int height, int width, int window, int rows, int batch) {
  const int strips = (width + strip_width(window) - 1) / strip_width(window);
  return dim3((strips + kStripWarps - 1) / kStripWarps, (height + rows - 1) / rows, batch);
}

// Rows a block walks in a mode: the tile round's own rule, else walk_rows.
template <int kMode>
inline int mode_rows(int height, int width, int window) {
  if constexpr (kMode == kTileRound) return tile_round_rows(height, width, window);
  return walk_rows(height, width, window);
}

// Blocks per batch element (a mode's partial sums per element).
template <int kMode = kRefine>
inline int num_blocks(int height, int width, int window) {
  const dim3 g = walk_grid(height, width, window, mode_rows<kMode>(height, width, window), 1);
  return (int)(g.x * g.y);
}

template <int kWindow, bool kRelaxed, int kSum, int kMode>
int launch(const LkArgs& args, int batch, cudaStream_t stream) {
  const int rows = mode_rows<kMode>(args.height, args.width, kWindow);
  const dim3 grid = walk_grid(args.height, args.width, kWindow, rows, batch);
  lk_walk_kernel<kWindow, kRelaxed, kSum, kMode><<<grid, kWalkThreads, 0, stream>>>(args, rows);
  return (int)cudaGetLastError();
}

// Runtime window -> the kernel built for it.
template <bool kRelaxed, int kSum, int kMode>
int launch_window(int window, const LkArgs& args, int batch, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  switch (window) {
    case 3: return launch<3, kRelaxed, kSum, kMode>(args, batch, stream);
    case 5: return launch<5, kRelaxed, kSum, kMode>(args, batch, stream);
    case 7: return launch<7, kRelaxed, kSum, kMode>(args, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tpuflow_lk
