// Fused Lucas-Kanade refinement step on Hopper (sm_90a), relaxed order.
//
// Replaces tpuflow/kernels/pallas_lk.py::_refine_batched (pallas_call at
// :573) -> _lk_refine_kernel -> _lk_tile(relaxed_order=True), window 5.
//
// What it computes, per output pixel, on frames padded symmetric by 1 then
// with zeros (pallas_lk.py:542-544):
//   avg = (p + c) * 0.5; separable Sobel (pallas_lk.py:221-233):
//     sv = (avg[-1] + 2*avg[0]) + avg[+1] and dv = avg[-1] - avg[+1]
//     down the rows, then ix = (sv[-1] - sv[+1]) * 0.125 and
//     iy = ((dv[-1] + 2*dv[0]) + dv[+1]) * 0.125 across the columns;
//   it = p - c; the five products ix*ix, iy*iy, ix*iy, ix*it, iy*it;
//   5x5 window sums by the shift tree (_sliding_sum_tree, pallas_lk.py:
//     94-136), rows first, then columns, each as
//     ((a[i] + a[i+1]) + (a[i+2] + a[i+3])) + a[i+4];
//   det = sxx*syy - sxy*sxy, inv = |det| > det_threshold ? 1/det : 0,
//     du = (syy*b0 - sxy*b1) * inv, dv = (sxx*b1 - sxy*b0) * inv with
//     b0 = -sxt, b1 = -syt (pallas_lk.py:288-292), zero outside the
//     interior (2 px border);
//   the carried flow clipped to +-max_disp / +-max_disp_v, and
//     out = converged ? clip : clip + d (pallas_lk.py:373-381);
//   one partial sum of |du| and of |dv| per block.
// The block sums its partials in a fixed tree order (no float atomics), so
// the convergence test is reproducible from run to run; the wrapper adds
// the per-block partials with torch.sum, as XLA adds the TPU kernel's
// per-tile partials (pallas_lk.py:606-607).
//
// Bound: device memory, about 24 B per pixel (prev, warped, u, v in; u, v
// out) against about 200 flops per pixel. One block per 32x16 output tile;
// the tile and its 3-pixel halo of prev and warped are staged once in
// shared memory, and every intermediate plane (avg, it, ix, iy, the five
// row-summed products) stays in shared memory, never in device memory.
// The TPU kernel's double-buffered slab DMA has no counterpart here: many
// blocks per SM hide the load latency instead.
// Built with -fmad=false: no product is fused into an FMA, so each pixel
// is bit-identical to the plain PyTorch version in kernels/lk.py.

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                 // output tile width
constexpr int kTH = 16;                 // output tile height
constexpr int kHalf = 2;                // window 5
constexpr int kR = kHalf + 1;           // halo: Sobel 1 + window half
constexpr int kAW = kTW + 2 * kR;       // staged avg tile
constexpr int kAH = kTH + 2 * kR;
constexpr int kGW = kTW + 2 * kHalf;    // gradient region
constexpr int kGH = kTH + 2 * kHalf;
constexpr int kThreads = 256;

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

__device__ __forceinline__ float tree5(float a0, float a1, float a2, float a3,
                                       float a4) {
  return ((a0 + a1) + (a2 + a3)) + a4;
}

__global__ void __launch_bounds__(kThreads)
lk_refine_kernel(const float* __restrict__ prev, const float* __restrict__ warped,
                 const float* __restrict__ u_in, const float* __restrict__ v_in,
                 const unsigned char* __restrict__ converged,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 float* __restrict__ part_du, float* __restrict__ part_dv,
                 int height, int width, float det_threshold, float max_disp,
                 float max_disp_v) {
  __shared__ float avg_s[kAH][kAW];
  __shared__ float it_s[kGH][kGW];
  __shared__ float ix_s[kGH][kGW];
  __shared__ float iy_s[kGH][kGW];
  __shared__ float rows_s[5][kTH][kGW];
  __shared__ float red_u[kThreads];
  __shared__ float red_v[kThreads];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;

  // Stage the padded tile: avg over the whole halo, it over the gradient
  // region. avg_s[r][c] is image pixel (r0 + r - kR, c0 + c - kR).
  for (int k = tid; k < kAH * kAW; k += kThreads) {
    const int r = k / kAW, c = k % kAW;
    const float p = padded(prev, r0 + r - kR, c0 + c - kR, height, width);
    const float q = padded(warped, r0 + r - kR, c0 + c - kR, height, width);
    avg_s[r][c] = (p + q) * 0.5f;
    if (r >= 1 && r < kAH - 1 && c >= 1 && c < kAW - 1) it_s[r - 1][c - 1] = p - q;
  }
  __syncthreads();

  // Separable Sobel over the gradient region; ix_s[g][h] is image pixel
  // (r0 + g - kHalf, c0 + h - kHalf), centred on avg_s[g + 1][h + 1].
  for (int k = tid; k < kGH * kGW; k += kThreads) {
    const int g = k / kGW, h = k % kGW;
    const float sv_m = (avg_s[g][h] + 2.0f * avg_s[g + 1][h]) + avg_s[g + 2][h];
    const float sv_p =
        (avg_s[g][h + 2] + 2.0f * avg_s[g + 1][h + 2]) + avg_s[g + 2][h + 2];
    const float dv_m = avg_s[g][h] - avg_s[g + 2][h];
    const float dv_0 = avg_s[g][h + 1] - avg_s[g + 2][h + 1];
    const float dv_p = avg_s[g][h + 2] - avg_s[g + 2][h + 2];
    ix_s[g][h] = (sv_m - sv_p) * 0.125f;
    iy_s[g][h] = ((dv_m + 2.0f * dv_0) + dv_p) * 0.125f;
  }
  __syncthreads();

  // Window sums down the rows for the five product planes.
  for (int k = tid; k < 5 * kTH * kGW; k += kThreads) {
    const int q = k / (kTH * kGW);
    const int i = (k / kGW) % kTH;
    const int h = k % kGW;
    float a[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const float gx = ix_s[i + d][h], gy = iy_s[i + d][h], gt = it_s[i + d][h];
      a[d] = q == 0 ? gx * gx : q == 1 ? gy * gy : q == 2 ? gx * gy
           : q == 3 ? gx * gt : gy * gt;
    }
    rows_s[q][i][h] = tree5(a[0], a[1], a[2], a[3], a[4]);
  }
  __syncthreads();

  // Window sums across the columns, the solve, and the accumulate.
  const bool frozen = converged[0] != 0;
  float acc_u = 0.0f, acc_v = 0.0f;
  for (int k = tid; k < kTH * kTW; k += kThreads) {
    const int i = k / kTW, j = k % kTW;
    const int y = r0 + i, x = c0 + j;
    if (y >= height || x >= width) continue;
    float s[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      s[q] = tree5(rows_s[q][i][j], rows_s[q][i][j + 1], rows_s[q][i][j + 2],
                   rows_s[q][i][j + 3], rows_s[q][i][j + 4]);
    }
    const float s_xx = s[0], s_yy = s[1], s_xy = s[2];
    const float b0 = -s[3], b1 = -s[4];
    const float det = s_xx * s_yy - s_xy * s_xy;
    const float inv = fabsf(det) > det_threshold ? 1.0f / det : 0.0f;
    float du = (s_yy * b0 - s_xy * b1) * inv;
    float dv = (s_xx * b1 - s_xy * b0) * inv;
    const bool interior =
        y >= kHalf && y < height - kHalf && x >= kHalf && x < width - kHalf;
    if (!interior) {
      du = 0.0f;
      dv = 0.0f;
    }
    const size_t o = (size_t)y * width + x;
    const float uc = fminf(fmaxf(u_in[o], -max_disp), max_disp);
    const float vc = fminf(fmaxf(v_in[o], -max_disp_v), max_disp_v);
    u_out[o] = frozen ? uc : uc + du;
    v_out[o] = frozen ? vc : vc + dv;
    acc_u += fabsf(du);
    acc_v += fabsf(dv);
  }

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
    part_du[b] = red_u[0];
    part_dv[b] = red_v[0];
  }
}

}  // namespace

// Number of per-block partial sums (the length of part_du / part_dv).
extern "C" int tpuflow_lk_refine_blocks(int height, int width) {
  return ((width + kTW - 1) / kTW) * ((height + kTH - 1) / kTH);
}

extern "C" int tpuflow_lk_refine(const float* prev, const float* warped,
                                 const float* u_in, const float* v_in,
                                 const void* converged, float* u_out,
                                 float* v_out, float* part_du, float* part_dv,
                                 int height, int width, float det_threshold,
                                 float max_disp, float max_disp_v,
                                 void* stream) {
  const dim3 grid((width + kTW - 1) / kTW, (height + kTH - 1) / kTH);
  lk_refine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prev, warped, u_in, v_in, static_cast<const unsigned char*>(converged),
      u_out, v_out, part_du, part_dv, height, width, det_threshold, max_disp,
      max_disp_v);
  return (int)cudaGetLastError();
}
