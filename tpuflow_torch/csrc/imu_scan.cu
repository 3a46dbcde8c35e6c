// IMU preintegration's recursion over the samples as one launch.
//
// Replaces no Pallas kernel. The reference runs the recursion as a
// jax.lax.scan over the samples, one device program
// (tpuflow/vo/imu.py:101-122 and :130-140); this kernel is that scan on
// the card, in the reference's order. Each sample, with the 3x3 carries:
//
//   with bias Jacobians, first (the pre-update r, j_r and j_v*):
//     j_pg += j_vg h - 0.5 (r a^ j_r) h h;  j_pa += j_va h - 0.5 r h h
//     j_vg -= (r a^ j_r) h;  j_va -= r h;  j_r = step^T j_r - J_r h
//   a_world = r a;  p += v h + 0.5 a_world h h;  v += a_world h;  r = r step
//
// Work off the carry (Exp(w h), the right Jacobians J_r, hat(a), the bias
// subtraction) stays in torch and comes in per sample. Each 3-term dot
// product of a matrix product is accumulated left to right in fused
// multiply-adds (dot3), as the small float32 matmuls of the plain loop
// are; every elementwise update is rounded at each operation, as torch's
// separate operations are (-fmad=false).
//
// Bound: latency. Each sample depends on the last through r (a multiply
// and two fused multiply-adds) and, with the Jacobians, j_r (the same and a
// subtract), so N samples are a dependent chain of 3N or 4N float32
// operations; the inputs are 52 or 124 B a sample. Design: one block of one
// warp. The warp stages kChunk samples at a time into shared memory with
// coalesced loads, and lane 0 runs the recursion over them with every
// carry in registers. No parallel prefix: the sequential order is the
// reference's rounding order.

#include <cuda_runtime.h>

namespace tpuflow_imu {

constexpr int kChunk = 128;
constexpr int kPlain = 13;  // step (9, row-major), accel (3), dt
constexpr int kJac = 31;    // + right Jacobian (9), hat(accel) (9)

// a0 b0 + a1 b1 + a2 b2, accumulated left to right with one rounding a term.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

template <bool kJacobians>
__global__ void __launch_bounds__(32) imu_scan_kernel(const float* __restrict__ samples, int n,
                                                      float* __restrict__ out) {
  constexpr int kWidth = kJacobians ? kJac : kPlain;
  __shared__ float buf[kChunk * kWidth];
  const int lane = threadIdx.x;
  float r[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float v[3] = {}, p[3] = {};
  float jr[9] = {}, jvg[9] = {}, jva[9] = {}, jpg[9] = {}, jpa[9] = {};

  for (int base = 0; base < n; base += kChunk) {
    const int count = min(kChunk, n - base);
    const float* src = samples + static_cast<long long>(base) * kWidth;
    for (int i = lane; i < count * kWidth; i += 32) buf[i] = src[i];
    __syncwarp();
    if (lane == 0) {
      for (int k = 0; k < count; ++k) {
        const float* s = buf + k * kWidth;
        const float* st = s;      // Exp(w h)
        const float* a = s + 9;   // accel
        const float h = s[12];
        float aw[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          aw[i] = dot3(r[3 * i], a[0], r[3 * i + 1], a[1], r[3 * i + 2], a[2]);
        if (kJacobians) {
          const float* right = s + 13;
          const float* ah = s + 22;
          float ra[9], rajr[9], jr_new[9];
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              ra[3 * i + j] = dot3(r[3 * i], ah[j], r[3 * i + 1], ah[3 + j], r[3 * i + 2],
                                   ah[6 + j]);
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              rajr[3 * i + j] = dot3(ra[3 * i], jr[j], ra[3 * i + 1], jr[3 + j], ra[3 * i + 2],
                                     jr[6 + j]);
              jr_new[3 * i + j] =
                  dot3(st[i], jr[j], st[3 + i], jr[3 + j], st[6 + i], jr[6 + j]) -
                  right[3 * i + j] * h;
            }
#pragma unroll
          for (int e = 0; e < 9; ++e) {
            jpg[e] = (jpg[e] + jvg[e] * h) - ((0.5f * rajr[e]) * h) * h;
            jpa[e] = (jpa[e] + jva[e] * h) - ((0.5f * r[e]) * h) * h;
            jvg[e] = jvg[e] - rajr[e] * h;
            jva[e] = jva[e] - r[e] * h;
            jr[e] = jr_new[e];
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          p[i] = (p[i] + v[i] * h) + ((0.5f * aw[i]) * h) * h;
          v[i] = v[i] + aw[i] * h;
        }
        float rn[9];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            rn[3 * i + j] = dot3(r[3 * i], st[j], r[3 * i + 1], st[3 + j], r[3 * i + 2],
                                 st[6 + j]);
#pragma unroll
        for (int e = 0; e < 9; ++e) r[e] = rn[e];
      }
    }
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < 9; ++e) out[e] = r[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[9 + i] = v[i];
      out[12 + i] = p[i];
    }
    if (kJacobians) {
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        out[15 + e] = jr[e];
        out[24 + e] = jvg[e];
        out[33 + e] = jva[e];
        out[42 + e] = jpg[e];
        out[51 + e] = jpa[e];
      }
    }
  }
}

}  // namespace tpuflow_imu

// samples: (n, 13) f32 rows [Exp(w h) row-major, accel, dt], or (n, 31)
// with the right Jacobian and hat(accel) after them (bias_jacobians); out:
// 15 f32 [r (9), v, p], or 60 with [j_r, j_v_bg, j_v_ba, j_p_bg, j_p_ba].
extern "C" int tpuflow_imu_preintegrate(const float* samples, int n, int bias_jacobians,
                                        float* out, void* stream) {
  using namespace tpuflow_imu;
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_jacobians)
    imu_scan_kernel<true><<<1, 32, 0, s>>>(samples, n, out);
  else
    imu_scan_kernel<false><<<1, 32, 0, s>>>(samples, n, out);
  return (int)cudaGetLastError();
}
