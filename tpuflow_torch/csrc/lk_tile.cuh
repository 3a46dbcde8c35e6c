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
//     out = converged ? clip : clip + d (pallas_lk.py:373-381), and one
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
// Built with -fmad=false: no product is fused into an FMA, so each pixel
// is bit-identical to the plain PyTorch version in kernels/lk.py.

#pragma once

#include <cuda_runtime.h>

namespace tpuflow_lk {

constexpr int kTW = 32;       // output tile width
constexpr int kTH = 16;       // output tile height
constexpr int kThreads = 256;
constexpr int kMaxWindow = 7;

enum Mode { kRefine = 0, kFused = 1, kFusedDet = 2 };

struct Taps {
  float t[kMaxWindow];
};

struct LkArgs {
  const float* prev;
  const float* curr;  // the warped frame for the refine step
  const float* u_in;  // refine only
  const float* v_in;
  const unsigned char* converged;
  float* u_out;
  float* v_out;
  float* det_out;  // fused with det only
  float* part_du;  // refine only: one partial sum per block
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

template <int kWindow, bool kRelaxed, bool kTaps, int kMode>
__global__ void __launch_bounds__(kThreads) lk_tile_kernel(const LkArgs args) {
  static_assert(kWindow == 3 || kWindow == 5 || kWindow == 7, "window 3/5/7");
  constexpr int kHalf = kWindow / 2;
  constexpr int kR = kHalf + 1;          // halo: Sobel 1 + window half
  constexpr int kAW = kTW + 2 * kR;      // staged avg tile
  constexpr int kAH = kTH + 2 * kR;
  constexpr int kGW = kTW + 2 * kHalf;   // gradient region
  constexpr int kGH = kTH + 2 * kHalf;
  constexpr int kOrder = kTaps ? kWeighted : (kRelaxed ? kTree : kSequential);

  __shared__ float avg_s[kAH][kAW];
  __shared__ float it_s[kGH][kGW];
  __shared__ float ix_s[kGH][kGW];
  __shared__ float iy_s[kGH][kGW];
  __shared__ float rows_s[5][kTH][kGW];
  __shared__ float red_u[kThreads];  // refine only
  __shared__ float red_v[kThreads];

  const int height = args.height, width = args.width;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const float* taps = args.taps.t;

  // Stage the padded tile: avg over the whole halo, it over the gradient
  // region. avg_s[r][c] is image pixel (r0 + r - kR, c0 + c - kR).
  for (int k = tid; k < kAH * kAW; k += kThreads) {
    const int r = k / kAW, c = k % kAW;
    const float p = padded(args.prev, r0 + r - kR, c0 + c - kR, height, width);
    const float q = padded(args.curr, r0 + r - kR, c0 + c - kR, height, width);
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

  // Window sums down the rows for the five product planes.
  for (int k = tid; k < 5 * kTH * kGW; k += kThreads) {
    const int q = k / (kTH * kGW);
    const int i = (k / kGW) % kTH;
    const int h = k % kGW;
    float a[kWindow];
#pragma unroll
    for (int d = 0; d < kWindow; ++d) {
      const float gx = ix_s[i + d][h], gy = iy_s[i + d][h], gt = it_s[i + d][h];
      a[d] = q == 0 ? gx * gx : q == 1 ? gy * gy : q == 2 ? gx * gy
           : q == 3 ? gx * gt : gy * gt;
    }
    rows_s[q][i][h] = window_sum<kWindow, kOrder>(a, taps);
  }
  __syncthreads();

  // Window sums across the columns, the solve, and the mode's epilogue.
  bool frozen = false;
  if constexpr (kMode == kRefine) frozen = args.converged[0] != 0;
  float acc_u = 0.0f, acc_v = 0.0f;
  for (int k = tid; k < kTH * kTW; k += kThreads) {
    const int i = k / kTW, j = k % kTW;
    const int y = r0 + i, x = c0 + j;
    if (y >= height || x >= width) continue;
    float s[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float a[kWindow];
#pragma unroll
      for (int d = 0; d < kWindow; ++d) a[d] = rows_s[q][i][j + d];
      s[q] = window_sum<kWindow, kOrder>(a, taps);
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
    const size_t o = (size_t)y * width + x;
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
      const int b = blockIdx.y * gridDim.x + blockIdx.x;
      args.part_du[b] = red_u[0];
      args.part_dv[b] = red_v[0];
    }
  }
}

inline int num_blocks(int height, int width) {
  return ((width + kTW - 1) / kTW) * ((height + kTH - 1) / kTH);
}

template <int kWindow, bool kRelaxed, bool kTaps, int kMode>
int launch(const LkArgs& args, cudaStream_t stream) {
  const dim3 grid((args.width + kTW - 1) / kTW, (args.height + kTH - 1) / kTH);
  lk_tile_kernel<kWindow, kRelaxed, kTaps, kMode><<<grid, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// Runtime window -> the kernel built for it.
template <bool kRelaxed, bool kTaps, int kMode>
int launch_window(int window, const LkArgs& args, cudaStream_t stream) {
  switch (window) {
    case 3: return launch<3, kRelaxed, kTaps, kMode>(args, stream);
    case 5: return launch<5, kRelaxed, kTaps, kMode>(args, stream);
    case 7: return launch<7, kRelaxed, kTaps, kMode>(args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tpuflow_lk
