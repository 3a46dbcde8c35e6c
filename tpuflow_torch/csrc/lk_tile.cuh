// Lucas-Kanade tile kernel on Hopper (sm_90a), shared by the refine step
// (lk_refine.cu: K3 relaxed order, K5 exact order) and the fused
// single-scale solve (lk_fused.cu: K6, K7 with the |det| plane).
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
//   window, rows first, then columns, in one of four orders:
//     sequential ((((a0 + a1) + a2) + a3) + a4) (pallas_lk.py:262-268);
//     the shift tree of _sliding_sum_tree (pallas_lk.py:94-136), e.g.
//       ((a0 + a1) + (a2 + a3)) + a4 at window 5;
//     Gaussian taps, t0*a0 + t1*a1 + ... sequentially (pallas_lk.py:
//       269-277), whatever the Sobel order;
//     banded-ones matrix products on the tensor cores (K10, the
//       window_mxu branch, _wsum_mxu at pallas_lk.py:139-186), whatever
//       the Sobel order: see "Window sums on the tensor cores" below;
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
//     (pallas_lk.py:305-310).
//
// Bound: device memory, 16-24 B per pixel (two frames in, flow in and out)
// against about 200 flops per pixel. One block per 32x16 output tile; the
// tile and its halo (Sobel 1 + window half, up to 4 px at window 7) of both
// frames are staged once in shared memory, and every intermediate plane
// (avg, it, ix, iy, the five row-summed products) stays there, never in
// device memory: 28 KB of static shared memory at window 7. The TPU
// kernel's double-buffered slab DMA has no counterpart: many blocks per SM
// hide the load latency instead.
// Batches: blockIdx.z is the batch element (the TPU kernels' flattened
// (batch * row tiles) grid); each element reads its own planes, its own
// converged flag and writes its own block partials.
// Built with -fmad=false: no product is fused into an FMA, so each pixel
// is bit-identical to the plain PyTorch version in kernels/lk.py (the
// tensor-core order excepted: see below).
//
// Window sums on the tensor cores (kSum == kMxu). The TPU branch asked
// whether the matrix unit beats shifted adds for the window sums; on
// Hopper the same question is mma.sync against the shift tree. Each of
// the five planes P (gradient region, kGH x kGW) is summed as two banded
// products per 32x16 tile, both with m16n8k8 TF32 mma.sync:
//   rows = Wv @ P, Wv the (16, kGH) band Wv[i][k] = (i <= k < i + w):
//     M = 16, K = kGH <= 22 (3 k-steps), N = kGW <= 38 (5 n-tiles);
//   sums = rows @ Wh, Wh the (kGW, 32) band Wh[k][j] = (j <= k < j + w):
//     M = 16, K = kGW <= 38 (5 k-steps), N = 32 (4 n-tiles).
// The bands are generated in registers (0 or 1, exact in TF32). TF32
// keeps 10 mantissa bits, so every data operand x is split into three
// TF32 parts, hi = tf32(x), mid = tf32(x - hi), lo = x - hi - mid, whose
// sum is x exactly (each difference is exact in f32, and lo has at most
// two significant bits). Each part has its own f32 accumulator, and the
// three are added with IEEE adds at the end, (lo + mid) + hi. One shared
// accumulator would be simpler, but the tensor core aligns its addends to
// the largest exponent and truncates, so adding the small parts' products
// to the large running sum lost up to several ulp (measured on the card:
// 1.3e-3 px at window 3, >1e-5 px on 2% of 1080p pixels of float frames);
// a part's own sum of at most w 11-bit terms of like size seldom needs
// any. The
// products are exact; the sums still round otherwise than the plain
// version's (torch.matmul in true f32), so K10 is held to it within stated
// limits, not bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuflow_lk {

constexpr int kTW = 32;       // output tile width
constexpr int kTH = 16;       // output tile height
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 7;
constexpr int kMaxBatch = 65535;  // gridDim.z

enum Mode { kRefine = 0, kFused = 1, kFusedDet = 2 };

struct Taps {
  float t[kMaxWindow];
};

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
  float* part_du;  // refine only: one partial sum per block, element-major
  float* part_dv;
  int height;
  int width;
  float det_threshold;
  float max_disp;
  float max_disp_v;
  Taps taps;
};

// Padded-frame read: symmetric by one pixel, zeros beyond.
__device__ __forceinline__ float padded(const float* __restrict__ img, int r,
                                        int c, int height, int width) {
  if (r == -1) r = 0;
  else if (r == height) r = height - 1;
  if (c == -1) c = 0;
  else if (c == width) c = width - 1;
  if (r < 0 || r >= height || c < 0 || c >= width) return 0.0f;
  return __ldg(img + (size_t)r * width + c);
}

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
// Sobel order), Gaussian taps, or banded products on the tensor cores.
enum WindowSum { kUniform = 0, kGaussian = 1, kMxu = 2 };

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

// f32 -> TF32 (round to nearest, ties away), as a 32-bit operand.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Part 0 (hi), 1 (mid) or 2 (lo) of x's exact three-way TF32 split.
__device__ __forceinline__ uint32_t tf32_part(float x, int part) {
  const float hi = __uint_as_float(to_tf32(x));
  if (part == 0) return __float_as_uint(hi);
  const float r = x - hi;
  const float mid = __uint_as_float(to_tf32(r));
  if (part == 1) return __float_as_uint(mid);
  return __float_as_uint(r - mid);
}

constexpr uint32_t kOne = 0x3f800000u;  // 1.0f, exact in TF32

// d += a @ b, one m16n8k8 TF32 tile with an f32 accumulator. Fragments
// (g = lane / 4, t = lane % 4): a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g];
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Product plane q at gradient-region pixel (k, h).
template <int kGH, int kGW>
__device__ __forceinline__ float product(const float (&ix_s)[kGH][kGW],
                                         const float (&iy_s)[kGH][kGW],
                                         const float (&it_s)[kGH][kGW], int q,
                                         int k, int h) {
  const float gx = ix_s[k][h], gy = iy_s[k][h], gt = it_s[k][h];
  return q == 0 ? gx * gx : q == 1 ? gy * gy : q == 2 ? gx * gy
       : q == 3 ? gx * gt : gy * gt;
}

// d[part] += a @ b[part] for the three parts of a data operand b.
__device__ __forceinline__ void mma_parts(float (&d)[3][4], const uint32_t (&a)[4],
                                          const float (&b)[2]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t bp[2] = {tf32_part(b[0], part), tf32_part(b[1], part)};
    mma_tf32(d[part], a, bp);
  }
}

// d[part] += a[part] @ b for the three parts of a data operand a.
__device__ __forceinline__ void mma_parts(float (&d)[3][4], const float (&a)[4],
                                          const uint32_t (&b)[2]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t ap[4] = {tf32_part(a[0], part), tf32_part(a[1], part),
                            tf32_part(a[2], part), tf32_part(a[3], part)};
    mma_tf32(d[part], ap, b);
  }
}

// The three parts' sums, element i: (lo + mid) + hi.
__device__ __forceinline__ float combine(const float (&d)[3][4], int i) {
  return (d[2][i] + d[1][i]) + d[0][i];
}

// Vertical pass on the tensor cores: rows_s[q] = Wv @ P_q for the five
// planes, one warp per (plane, 8-column tile).
template <int kWindow, int kGH, int kGW>
__device__ __forceinline__ void mxu_rows(const float (&ix_s)[kGH][kGW],
                                         const float (&iy_s)[kGH][kGW],
                                         const float (&it_s)[kGH][kGW],
                                         float (&rows_s)[5][kTH][kGW]) {
  constexpr int kNT = (kGW + 7) / 8;
  constexpr int kKT = (kGH + 7) / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int task = threadIdx.x / 32; task < 5 * kNT; task += kWarps) {
    const int q = task / kNT, n0 = (task % kNT) * 8;
    const int h = n0 + g;  // this lane's B column
    float d[3][4] = {};
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      const int k0 = kt * 8 + t, k1 = k0 + 4;
      const uint32_t a[4] = {
          (k0 >= g && k0 < g + kWindow) ? kOne : 0u,
          (k0 >= g + 8 && k0 < g + 8 + kWindow) ? kOne : 0u,
          (k1 >= g && k1 < g + kWindow) ? kOne : 0u,
          (k1 >= g + 8 && k1 < g + 8 + kWindow) ? kOne : 0u,
      };
      const float b[2] = {
          (k0 < kGH && h < kGW) ? product(ix_s, iy_s, it_s, q, k0, h) : 0.0f,
          (k1 < kGH && h < kGW) ? product(ix_s, iy_s, it_s, q, k1, h) : 0.0f,
      };
      mma_parts(d, a, b);
    }
    const int c = n0 + 2 * t;
    if (c < kGW) {
      rows_s[q][g][c] = combine(d, 0);
      rows_s[q][g + 8][c] = combine(d, 2);
    }
    if (c + 1 < kGW) {
      rows_s[q][g][c + 1] = combine(d, 1);
      rows_s[q][g + 8][c + 1] = combine(d, 3);
    }
  }
}

// Horizontal pass on the tensor cores: sums_s[q] = rows_s[q] @ Wh, one
// warp per (plane, 8-column output tile).
template <int kWindow, int kGW>
__device__ __forceinline__ void mxu_cols(const float (&rows_s)[5][kTH][kGW],
                                         float (&sums_s)[5][kTH][kTW]) {
  constexpr int kNT = kTW / 8;
  constexpr int kKT = (kGW + 7) / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int task = threadIdx.x / 32; task < 5 * kNT; task += kWarps) {
    const int q = task / kNT, n0 = (task % kNT) * 8;
    const int j = n0 + g;  // this lane's B column
    float d[3][4] = {};
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      const int k0 = kt * 8 + t, k1 = k0 + 4;
      const float a[4] = {
          k0 < kGW ? rows_s[q][g][k0] : 0.0f,
          k0 < kGW ? rows_s[q][g + 8][k0] : 0.0f,
          k1 < kGW ? rows_s[q][g][k1] : 0.0f,
          k1 < kGW ? rows_s[q][g + 8][k1] : 0.0f,
      };
      const uint32_t b[2] = {
          (k0 >= j && k0 < j + kWindow) ? kOne : 0u,
          (k1 >= j && k1 < j + kWindow) ? kOne : 0u,
      };
      mma_parts(d, a, b);
    }
    const int c = n0 + 2 * t;
    sums_s[q][g][c] = combine(d, 0);
    sums_s[q][g][c + 1] = combine(d, 1);
    sums_s[q][g + 8][c] = combine(d, 2);
    sums_s[q][g + 8][c + 1] = combine(d, 3);
  }
}

template <int kWindow, bool kRelaxed, int kSum, int kMode>
__global__ void __launch_bounds__(kThreads) lk_tile_kernel(const LkArgs args) {
  static_assert(kWindow == 3 || kWindow == 5 || kWindow == 7, "window 3/5/7");
  constexpr int kHalf = kWindow / 2;
  constexpr int kR = kHalf + 1;          // halo: Sobel 1 + window half
  constexpr int kAW = kTW + 2 * kR;      // staged avg tile
  constexpr int kAH = kTH + 2 * kR;
  constexpr int kGW = kTW + 2 * kHalf;   // gradient region
  constexpr int kGH = kTH + 2 * kHalf;
  constexpr int kOrder =
      kSum == kGaussian ? kWeighted : (kRelaxed ? kTree : kSequential);

  __shared__ float avg_s[kAH][kAW];
  __shared__ float it_s[kGH][kGW];
  __shared__ float ix_s[kGH][kGW];
  __shared__ float iy_s[kGH][kGW];
  __shared__ float rows_s[5][kTH][kGW];
  // Tensor cores only: the window sums (one float otherwise).
  constexpr bool kTc = kSum == kMxu;
  __shared__ float sums_s[kTc ? 5 : 1][kTc ? kTH : 1][kTc ? kTW : 1];
  __shared__ float red_u[kThreads];  // refine only
  __shared__ float red_v[kThreads];

  const int height = args.height, width = args.width;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const float* taps = args.taps.t;
  const size_t plane = (size_t)blockIdx.z * height * width;
  const float* prev = args.prev + plane;
  const float* curr = args.curr + plane;

  // Stage the padded tile: avg over the whole halo, it over the gradient
  // region. avg_s[r][c] is image pixel (r0 + r - kR, c0 + c - kR).
  for (int k = tid; k < kAH * kAW; k += kThreads) {
    const int r = k / kAW, c = k % kAW;
    const float p = padded(prev, r0 + r - kR, c0 + c - kR, height, width);
    const float q = padded(curr, r0 + r - kR, c0 + c - kR, height, width);
    avg_s[r][c] = (p + q) * 0.5f;
    if (r >= 1 && r < kAH - 1 && c >= 1 && c < kAW - 1) it_s[r - 1][c - 1] = p - q;
  }
  __syncthreads();

  // Sobel over the gradient region; ix_s[g][h] is image pixel
  // (r0 + g - kHalf, c0 + h - kHalf), centred on avg_s[g + 1][h + 1].
  for (int k = tid; k < kGH * kGW; k += kThreads) {
    const int g = k / kGW, h = k % kGW;
    if constexpr (kRelaxed) {
      const float sv_m = (avg_s[g][h] + 2.0f * avg_s[g + 1][h]) + avg_s[g + 2][h];
      const float sv_p =
          (avg_s[g][h + 2] + 2.0f * avg_s[g + 1][h + 2]) + avg_s[g + 2][h + 2];
      const float dv_m = avg_s[g][h] - avg_s[g + 2][h];
      const float dv_0 = avg_s[g][h + 1] - avg_s[g + 2][h + 1];
      const float dv_p = avg_s[g][h + 2] - avg_s[g + 2][h + 2];
      ix_s[g][h] = (sv_m - sv_p) * 0.125f;
      iy_s[g][h] = ((dv_m + 2.0f * dv_0) + dv_p) * 0.125f;
    } else {
      // a(dy, dx) = avg at (g + 1 + dy, h + 1 + dx).
      const float mm = avg_s[g][h], m0 = avg_s[g][h + 1], mp = avg_s[g][h + 2];
      const float zm = avg_s[g + 1][h], zp = avg_s[g + 1][h + 2];
      const float pm = avg_s[g + 2][h], p0 = avg_s[g + 2][h + 1], pp = avg_s[g + 2][h + 2];
      ix_s[g][h] = (((mm - mp) + 2.0f * (zm - zp)) + (pm - pp)) * 0.125f;
      iy_s[g][h] = (((mm - pm) + 2.0f * (m0 - p0)) + (mp - pp)) * 0.125f;
    }
  }
  __syncthreads();

  if constexpr (kSum == kMxu) {
    // Both window passes as banded products on the tensor cores.
    mxu_rows<kWindow>(ix_s, iy_s, it_s, rows_s);
    __syncthreads();
    mxu_cols<kWindow>(rows_s, sums_s);
    __syncthreads();
  } else {
    // Window sums down the rows for the five product planes.
    for (int k = tid; k < 5 * kTH * kGW; k += kThreads) {
      const int q = k / (kTH * kGW);
      const int i = (k / kGW) % kTH;
      const int h = k % kGW;
      float a[kWindow];
#pragma unroll
      for (int d = 0; d < kWindow; ++d) a[d] = product(ix_s, iy_s, it_s, q, i + d, h);
      rows_s[q][i][h] = window_sum<kWindow, kOrder>(a, taps);
    }
    __syncthreads();
  }

  // Window sums across the columns (unless already summed), the solve, and
  // the mode's epilogue.
  bool frozen = false;
  if constexpr (kMode == kRefine) frozen = args.converged[blockIdx.z] != 0;
  float acc_u = 0.0f, acc_v = 0.0f;
  for (int k = tid; k < kTH * kTW; k += kThreads) {
    const int i = k / kTW, j = k % kTW;
    const int y = r0 + i, x = c0 + j;
    if (y >= height || x >= width) continue;
    float s[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      if constexpr (kSum == kMxu) {
        s[q] = sums_s[q][i][j];
      } else {
        float a[kWindow];
#pragma unroll
        for (int d = 0; d < kWindow; ++d) a[d] = rows_s[q][i][j + d];
        s[q] = window_sum<kWindow, kOrder>(a, taps);
      }
    }
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
    const size_t o = plane + (size_t)y * width + x;
    if constexpr (kMode == kRefine) {
      const float uc = fminf(fmaxf(args.u_in[o], -args.max_disp), args.max_disp);
      const float vc = fminf(fmaxf(args.v_in[o], -args.max_disp_v), args.max_disp_v);
      args.u_out[o] = frozen ? uc : uc + du;
      args.v_out[o] = frozen ? vc : vc + dv;
      acc_u += fabsf(du);
      acc_v += fabsf(dv);
    } else {
      args.u_out[o] = du;
      args.v_out[o] = dv;
      if constexpr (kMode == kFusedDet) args.det_out[o] = interior ? fabsf(det) : 0.0f;
    }
  }

  if constexpr (kMode == kRefine) {
    red_u[tid] = acc_u;
    red_v[tid] = acc_v;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (tid < stride) {
        red_u[tid] += red_u[tid + stride];
        red_v[tid] += red_v[tid + stride];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      args.part_du[b] = red_u[0];
      args.part_dv[b] = red_v[0];
    }
  }
}

// Blocks per batch element (the refine's partial sums per element).
inline int num_blocks(int height, int width) {
  return ((width + kTW - 1) / kTW) * ((height + kTH - 1) / kTH);
}

template <int kWindow, bool kRelaxed, int kSum, int kMode>
int launch(const LkArgs& args, int batch, cudaStream_t stream) {
  const dim3 grid((args.width + kTW - 1) / kTW, (args.height + kTH - 1) / kTH, batch);
  lk_tile_kernel<kWindow, kRelaxed, kSum, kMode><<<grid, kThreads, 0, stream>>>(args);
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
