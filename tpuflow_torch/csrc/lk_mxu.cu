// Lucas-Kanade with the window sums as banded-ones products on the tensor
// cores (K10), on Hopper (sm_90a): the refine step and the fused
// single-scale solve, with or without the |det| plane.
//
// Replaces tpuflow/kernels/pallas_lk.py::_wsum_mxu (:139-186), the
// window_mxu branch of _lk_tile (:258-259) as reached by _refine_batched
// (pallas_call at :573) and _fused_batched (pallas_call at :460). The
// Sobel form follows `relaxed`; the window is uniform (Gaussian taps take
// precedence over window_mxu, so the wrapper launches lk_fused.cu's
// kernel for them). What is computed, and the solve and epilogue, are
// lk_tile.cuh's; only the window sums differ. Bound, unlike K3/K6: shared
// memory, not DRAM; the question this kernel answers is whether mma.sync
// window sums beat shifted adds.
//
// Staged tile body. One block of 256 threads per 32x16 output tile; the
// tile and its halo (Sobel 1 + window half, up to 4 px at window 7) of
// both frames are staged once in shared memory, and every intermediate
// plane (avg, it, ix, iy, the five row-summed products) stays there, never
// in device memory: the mma operands are built from those planes. The
// column walk of lk_tile.cuh keeps no plane in shared memory, so K10 keeps
// this body of its own.
//
// Window sums on the tensor cores. The TPU branch asked whether the matrix
// unit beats shifted adds for the window sums; on Hopper the same question
// is mma.sync against the shift tree. Each of the five planes P (gradient
// region, kGH x kGW) is summed as two banded products per 32x16 tile, both
// with m16n8k8 TF32 mma.sync:
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
// any. The products are exact; the sums still round otherwise than the
// plain version's (torch.matmul in true f32), so K10 is held to it within
// stated limits, not bit for bit.

#include "lk_tile.cuh"

using namespace tpuflow_lk;

namespace {

constexpr int kTW = 32;  // output tile width
constexpr int kTH = 16;  // output tile height
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int kWindow, bool kRelaxed, int kMode>
__global__ void __launch_bounds__(kThreads) lk_mxu_kernel(const LkArgs args) {
  static_assert(kWindow == 3 || kWindow == 5 || kWindow == 7, "window 3/5/7");
  constexpr int kHalf = kWindow / 2;
  constexpr int kR = kHalf + 1;          // halo: Sobel 1 + window half
  constexpr int kAW = kTW + 2 * kR;      // staged avg tile
  constexpr int kAH = kTH + 2 * kR;
  constexpr int kGW = kTW + 2 * kHalf;   // gradient region
  constexpr int kGH = kTH + 2 * kHalf;

  __shared__ float avg_s[kAH][kAW];
  __shared__ float it_s[kGH][kGW];
  __shared__ float ix_s[kGH][kGW];
  __shared__ float iy_s[kGH][kGW];
  __shared__ float rows_s[5][kTH][kGW];
  __shared__ float sums_s[5][kTH][kTW];
  __shared__ float red_u[kThreads];  // refine only
  __shared__ float red_v[kThreads];

  const int height = args.height, width = args.width;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
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
  // (r0 + g - kHalf, c0 + h - kHalf), centred on avg_s[g + 1][h + 1]. The
  // walk's sobel() (lk_tile.cuh), so both kernels share one order.
  for (int k = tid; k < kGH * kGW; k += kThreads) {
    const int g = k / kGW, h = k % kGW;
    sobel<kRelaxed>(avg_s[g][h], avg_s[g + 1][h], avg_s[g + 2][h], avg_s[g][h + 1],
                    avg_s[g + 2][h + 1], avg_s[g][h + 2], avg_s[g + 1][h + 2],
                    avg_s[g + 2][h + 2], ix_s[g][h], iy_s[g][h]);
  }
  __syncthreads();

  // Both window passes as banded products on the tensor cores.
  mxu_rows<kWindow>(ix_s, iy_s, it_s, rows_s);
  __syncthreads();
  mxu_cols<kWindow>(rows_s, sums_s);
  __syncthreads();

  // The solve and the mode's epilogue.
  bool frozen = false;
  if constexpr (kMode == kRefine) frozen = args.converged[blockIdx.z] != 0;
  float acc_u = 0.0f, acc_v = 0.0f;
  for (int k = tid; k < kTH * kTW; k += kThreads) {
    const int i = k / kTW, j = k % kTW;
    const int y = r0 + i, x = c0 + j;
    if (y >= height || x >= width) continue;
    float s[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) s[q] = sums_s[q][i][j];
    const size_t o = plane + (size_t)y * width + x;
    float u_in = 0.0f, v_in = 0.0f;
    if constexpr (kMode == kRefine) {
      u_in = args.u_in[o];
      v_in = args.v_in[o];
    }
    solve_store<kHalf, kMode>(args, s, y, x, true, frozen, u_in, v_in, args.u_out + o,
                              args.v_out + o, args.det_out + o, acc_u, acc_v);
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

template <int kWindow, bool kRelaxed, int kMode>
int launch_mxu(const LkArgs& args, int batch, cudaStream_t stream) {
  const dim3 grid((args.width + kTW - 1) / kTW, (args.height + kTH - 1) / kTH, batch);
  lk_mxu_kernel<kWindow, kRelaxed, kMode><<<grid, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// Runtime window -> the kernel built for it.
template <bool kRelaxed, int kMode>
int launch_mxu_window(int window, const LkArgs& args, int batch, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  switch (window) {
    case 3: return launch_mxu<3, kRelaxed, kMode>(args, batch, stream);
    case 5: return launch_mxu<5, kRelaxed, kMode>(args, batch, stream);
    case 7: return launch_mxu<7, kRelaxed, kMode>(args, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of per-block partial sums of one batch element of the window_mxu
// refine (part_du and part_dv hold batch times as many).
extern "C" int tpuflow_lk_refine_mxu_blocks(int height, int width) {
  return ((width + kTW - 1) / kTW) * ((height + kTH - 1) / kTH);
}

// Same arguments as tpuflow_lk_refine (lk_refine.cu).
extern "C" int tpuflow_lk_refine_mxu(const float* prev, const float* warped,
                                     const float* u_in, const float* v_in,
                                     const void* converged, float* u_out,
                                     float* v_out, float* part_du,
                                     float* part_dv, int batch, int height,
                                     int width, int window, int relaxed,
                                     float det_threshold, float max_disp,
                                     float max_disp_v, void* stream) {
  LkArgs args{};
  args.prev = prev;
  args.curr = warped;
  args.u_in = u_in;
  args.v_in = v_in;
  args.converged = static_cast<const unsigned char*>(converged);
  args.u_out = u_out;
  args.v_out = v_out;
  args.part_du = part_du;
  args.part_dv = part_dv;
  args.height = height;
  args.width = width;
  args.det_threshold = det_threshold;
  args.max_disp = max_disp;
  args.max_disp_v = max_disp_v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relaxed) return launch_mxu_window<true, kRefine>(window, args, batch, s);
  return launch_mxu_window<false, kRefine>(window, args, batch, s);
}

// As tpuflow_lk_fused (lk_fused.cu) without taps. det_out: null unless the
// |det| plane is wanted.
extern "C" int tpuflow_lk_fused_mxu(const float* prev, const float* curr,
                                    float* u_out, float* v_out, float* det_out,
                                    int batch, int height, int width,
                                    int window, int relaxed,
                                    float det_threshold, void* stream) {
  LkArgs args{};
  args.prev = prev;
  args.curr = curr;
  args.u_out = u_out;
  args.v_out = v_out;
  args.det_out = det_out;
  args.height = height;
  args.width = width;
  args.det_threshold = det_threshold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (det_out != nullptr) {
    if (relaxed) return launch_mxu_window<true, kFusedDet>(window, args, batch, s);
    return launch_mxu_window<false, kFusedDet>(window, args, batch, s);
  }
  if (relaxed) return launch_mxu_window<true, kFused>(window, args, batch, s);
  return launch_mxu_window<false, kFused>(window, args, batch, s);
}
