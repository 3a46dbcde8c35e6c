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
// operations; the inputs are 52 or 124 B a sample. No parallel prefix: the
// sequential order is the reference's rounding order. Design: the carry
// splits across lanes with no exchange. r <- r step updates row i of r from
// row i alone, and j_r <- step^T j_r - J_r h column j of j_r from column j
// alone; element (i, j) of r a^ j_r needs row i of r and column j of j_r.
// So lane i of the rows warp holds row i of r, a_world_i, v_i and p_i; with
// the Jacobians, lane (i, j) of one warp holds row i of r and owns element
// (i, j) of j_v_ba and j_p_ba, and lane (i, j) of another holds row i of r
// and column j of j_r and owns element (i, j) of r a^ j_r, j_v_bg and
// j_p_bg. Each row of r is computed by several lanes (and every computing
// warp) with the same operations, so the same bits. The last warp stages
// the samples: 128 a chunk, by 4-B cp.async into rows padded to 16 or 32
// floats, two chunks in flight, each signalled full and empty on an
// mbarrier. A computing warp reads sample k + 1 by aligned 16-B shared loads
// while it computes sample k, and branches once every two samples, so
// neither memory latency nor a branch sits on the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuflow_imu {

constexpr int kChunk = 128;
constexpr int kPlain = 13;  // step (9, row-major), accel (3), dt
constexpr int kJac = 31;    // + right Jacobian (9), hat(accel) (9)

// a0 b0 + a1 b1 + a2 b2, accumulated left to right with one rounding a term.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// An arrive on the mbarrier once this thread's earlier cp.async are done.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

template <bool kJacobians>
struct Shape {
  static constexpr int kWidth = kJacobians ? kJac : kPlain;  // floats a sample in
  static constexpr int kPad = kJacobians ? 32 : 16;          // floats a staged sample
  static constexpr int kConsumers = kJacobians ? 3 : 1;      // computing warps
  static constexpr int kThreads = 32 * (kConsumers + 1);
};

template <bool kJacobians>
struct Stage {
  float buf[2][kChunk * Shape<kJacobians>::kPad];
  uint64_t full[2], empty[2];
};

// The staging warp: chunk c into buffer c % 2 once the computing warps have
// released it (chunk c - 2 read).
template <bool kJacobians>
__device__ void produce(Stage<kJacobians>& st, const float* __restrict__ samples, int n,
                        int lane) {
  using S = Shape<kJacobians>;
  const int chunks = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c >= 2) mbar_wait(&st.empty[b], ((c - 2) >> 1) & 1);
    const int count = min(kChunk, n - c * kChunk);
    const float* src = samples + static_cast<size_t>(c) * kChunk * S::kWidth;
    const uint32_t dst = smem_addr(st.buf[b]);
    for (int e = lane; e < count * S::kWidth; e += 32) {
      const int k = e / S::kWidth, col = e - k * S::kWidth;
      cp_async4(dst + 4 * (k * S::kPad + col), src + e);
    }
    cp_async_arrive(&st.full[b]);
  }
}

// The computing warps' parts of the carry.
enum Role {
  kRows,     // lane i (of 3): row i of r, a_world_i, v_i, p_i
  kJacA,     // lane (i, j) (of 9): row i of r; element (i, j) of j_v_ba, j_p_ba
  kJacG,     // lane (i, j): row i of r, column j of j_r; element (i, j) of
             // r a^ j_r, j_v_bg, j_p_bg
};

// A computing warp; the lanes past 3 or 9 repeat lane % 3 or lane % 9.
template <bool kJacobians, Role kRole>
__device__ void consume(Stage<kJacobians>& st, int n, float* __restrict__ out, int lane) {
  using S = Shape<kJacobians>;
  constexpr int kPad = S::kPad;
  constexpr bool kRowsRole = kRole == kRows;
  const int li = kRowsRole ? lane % 3 : lane % 9;
  const int i = kRowsRole ? li : li / 3, j = kRowsRole ? 0 : li % 3;
  float r[3] = {i == 0 ? 1.f : 0.f, i == 1 ? 1.f : 0.f, i == 2 ? 1.f : 0.f};  // row i of r
  float v = 0.f, p = 0.f;
  float jc[3] = {0.f, 0.f, 0.f};  // column j of j_r
  float jvg = 0.f, jva = 0.f, jpg = 0.f, jpa = 0.f;

  // Sample kk of the staged chunk into registers: what the warp uses of it
  // (all but the j_r warp its first 13 floats), and column j of its right
  // Jacobian.
  constexpr int kQuads = kRole == kJacG ? kPad / 4 : 4;
  auto load = [&](float (&x)[kPad], float (&right)[3], const float* chunk, int kk) {
    const float* src = chunk + kk * kPad;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float4 t = reinterpret_cast<const float4*>(src)[q];
      x[4 * q] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
    if constexpr (kRole == kJacG) {
#pragma unroll
      for (int m = 0; m < 3; ++m) right[m] = src[13 + 3 * m + j];
    }
  };

  auto step = [&](const float (&x)[kPad], const float (&right)[3]) {
    const float h = x[12];
    if constexpr (kRole == kRows) {
      const float aw = dot3(r[0], x[9], r[1], x[10], r[2], x[11]);
      p = (p + v * h) + ((0.5f * aw) * h) * h;
      v = v + aw * h;
    } else if constexpr (kRole == kJacA) {
      const float rij = j == 0 ? r[0] : j == 1 ? r[1] : r[2];
      jpa = (jpa + jva * h) - ((0.5f * rij) * h) * h;
      jva = jva - rij * h;
    } else {
      float ra[3], jn[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) ra[m] = dot3(r[0], x[22 + m], r[1], x[25 + m], r[2], x[28 + m]);
      const float rajr = dot3(ra[0], jc[0], ra[1], jc[1], ra[2], jc[2]);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        jn[m] = dot3(x[m], jc[0], x[3 + m], jc[1], x[6 + m], jc[2]) - right[m] * h;
      jpg = (jpg + jvg * h) - ((0.5f * rajr) * h) * h;
      jvg = jvg - rajr * h;
#pragma unroll
      for (int m = 0; m < 3; ++m) jc[m] = jn[m];
    }
    float rn[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) rn[m] = dot3(r[0], x[m], r[1], x[3 + m], r[2], x[6 + m]);
#pragma unroll
    for (int m = 0; m < 3; ++m) r[m] = rn[m];
  };

  // A chunk at a time, two register sets, unrolled by two: sample kk + 1 is
  // read while sample kk is computed, and the loop branches once a pair.
  float xa[kPad], xb[kPad], right_a[3] = {}, right_b[3] = {};
  const int chunks = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const float* chunk = st.buf[c & 1];
    const int count = min(kChunk, n - c * kChunk);
    mbar_wait(&st.full[c & 1], (c >> 1) & 1);
    load(xa, right_a, chunk, 0);
    int kk = 0;
#pragma unroll 2
    for (; kk + 2 <= count; kk += 2) {
      load(xb, right_b, chunk, kk + 1);
      step(xa, right_a);
      load(xa, right_a, chunk, min(kk + 2, kChunk - 1));  // past the chunk: never used
      step(xb, right_b);
    }
    if (kk < count) step(xa, right_a);
    mbar_arrive(&st.empty[c & 1]);  // chunk c is read
  }

  const int e = 3 * i + j;
  if constexpr (kRole == kRows) {
    if (lane < 3) {
#pragma unroll
      for (int m = 0; m < 3; ++m) out[3 * i + m] = r[m];
      out[9 + i] = v;
      out[12 + i] = p;
    }
  } else if constexpr (kRole == kJacA) {
    if (lane < 9) {
      out[33 + e] = jva;
      out[51 + e] = jpa;
    }
  } else if (lane < 9) {
    out[15 + e] = i == 0 ? jc[0] : i == 1 ? jc[1] : jc[2];
    out[24 + e] = jvg;
    out[42 + e] = jpg;
  }
}

template <bool kJacobians>
__global__ void __launch_bounds__(Shape<kJacobians>::kThreads)
    imu_scan_kernel(const float* __restrict__ samples, int n, float* __restrict__ out) {
  using S = Shape<kJacobians>;
  __shared__ __align__(16) Stage<kJacobians> st;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&st.full[b], 32);                    // the staging warp's lanes
      mbar_init(&st.empty[b], 32 * S::kConsumers);   // the computing warps' lanes
    }
  }
  __syncthreads();
  if (warp == S::kConsumers) {
    produce<kJacobians>(st, samples, n, lane);
  } else if (warp == 0) {
    consume<kJacobians, kRows>(st, n, out, lane);
  } else if constexpr (kJacobians) {
    if (warp == 1)
      consume<kJacobians, kJacA>(st, n, out, lane);
    else
      consume<kJacobians, kJacG>(st, n, out, lane);
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
    imu_scan_kernel<true><<<1, Shape<true>::kThreads, 0, s>>>(samples, n, out);
  else
    imu_scan_kernel<false><<<1, Shape<false>::kThreads, 0, s>>>(samples, n, out);
  return (int)cudaGetLastError();
}
