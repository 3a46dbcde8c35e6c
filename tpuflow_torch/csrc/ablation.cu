// Two measurement microkernels on Hopper (sm_90a), ports of the TPU
// ablation scripts. Neither is on a flow path; each answers on the card the
// question its TPU kernel asked there.
//
// K8, shift ablation: replaces scripts/shift_ablation.py::make_fn's kernel
// (pallas_call at :82, body :67-80). out = a[r0 + i, c0 + j], then the 15
// row-shifted slices a[r_k + i, c0 + j], then the 15 column-shifted slices
// a[r0 + i, c_k + j] added in that order (k = 1..15), for a (256, 2048)
// input and a (64, 1024) output. One thread per output element, 32x8
// blocks. Its loads are plain read-only global loads (__ldg, through L1),
// nothing staged in shared memory: a warp reads 32 consecutive floats
// (128 B) of one row, and the column offset decides how many 32-B sectors
// and 128-B lines that takes (4 sectors in one line when c is a multiple
// of 32 floats, 5 sectors over two lines otherwise). Rows start 8 KB
// apart, so row offsets never misalign a load. The 2 MB input stays in L2
// and, per block, mostly in L1. So the ratio measures L1 sector and line
// traffic for misaligned columns, not the TPU's sublane/lane shifts. Bound:
// L1 load throughput and launch latency (31 loads and 30 adds per output,
// 65,536 outputs).
//
// K9, warp-gather ablation: replaces
// scripts/warp_mxu_ablation.py::_build's kernel (pallas_call at :91, body
// :52-87). For every pixel of a (rows, wp) plane and each of `iters`
// candidate steps d, a sample g is taken from the (rows, wp + 256) band x
// and accumulated as acc = acc + g * coef[d] (coef[d] = f32(1 + 0.01 d)):
//   mode 0, gather: within the pixel's 128-column block of x[:, 128:128+wp]
//     at lane l, g = block[clip(l + off + d - iters/2, 0, 127)] (a
//     data-dependent load);
//   mode 1, shifts: g is the shifted view x[:, 128 + dx + col] for the one
//     dx in -maxd-1 .. maxd+2 with off == dx + d % 3 - 1, chosen by a chain
//     of 2*maxd + 4 selects (the TPU's shift-select form).
// One thread per pixel. -fmad=false rounds the product and the add
// separately, so both modes are bit-exact against the plain PyTorch
// versions in tpuflow_torch/ablation/warp_mxu_ablation.py. Bound: L1 load
// throughput (gather: 18 data-dependent loads a pixel; shifts: 20 loads a
// pixel, hoisted out of the candidate loop, and 360 selects).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShifts = 32;
constexpr int kMaxIters = 32;

struct Offsets {
  int r[kMaxShifts];
  int c[kMaxShifts];
};

struct Coefs {
  float c[kMaxIters];
};

__global__ void __launch_bounds__(256)
shift_ablation_kernel(const float* __restrict__ a, float* __restrict__ out,
                      int in_cols, int out_rows, int out_cols, int n_shifts,
                      const Offsets off) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= out_rows || j >= out_cols) return;
  float acc = __ldg(a + (size_t)(off.r[0] + i) * in_cols + off.c[0] + j);
  for (int k = 1; k < n_shifts; ++k)
    acc = acc + __ldg(a + (size_t)(off.r[k] + i) * in_cols + off.c[0] + j);
  for (int k = 1; k < n_shifts; ++k)
    acc = acc + __ldg(a + (size_t)(off.r[0] + i) * in_cols + off.c[k] + j);
  out[(size_t)i * out_cols + j] = acc;
}

template <int kMode>
__global__ void __launch_bounds__(256)
warp_gather_ablation_kernel(const float* __restrict__ x,
                            const int* __restrict__ off,
                            float* __restrict__ out, int rows, int wp,
                            int iters, int maxd, const Coefs coef) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= rows || col >= wp) return;
  const size_t o = (size_t)row * wp + col;
  const int dpx = off[o];
  const float* xrow = x + (size_t)row * (wp + 256) + 128;
  float acc = 0.0f;
  if (kMode == 0) {
    const int lane = col % 128;
    const float* block = xrow + (col - lane);
    for (int d = 0; d < iters; ++d) {
      const int idx = min(max(lane + dpx + (d - iters / 2), 0), 127);
      const float g = __ldg(block + idx);
      acc = acc + g * coef.c[d];
    }
  } else {
    for (int d = 0; d < iters; ++d) {
      float part = 0.0f;
      for (int dx = -maxd - 1; dx < maxd + 3; ++dx) {
        const float v = __ldg(xrow + col + dx);
        part = dpx == dx + (d % 3) - 1 ? v : part;
      }
      acc = acc + part * coef.c[d];
    }
  }
  out[o] = acc;
}

}  // namespace

// r_off, c_off: host arrays of n_shifts offsets each (n_shifts <= 32).
extern "C" int tpuflow_shift_ablation(const float* a, float* out, int in_cols,
                                      int out_rows, int out_cols, int n_shifts,
                                      const int* r_off, const int* c_off,
                                      void* stream) {
  if (n_shifts < 1 || n_shifts > kMaxShifts) return (int)cudaErrorInvalidValue;
  Offsets off{};
  for (int k = 0; k < n_shifts; ++k) {
    off.r[k] = r_off[k];
    off.c[k] = c_off[k];
  }
  const dim3 block(32, 8);
  const dim3 grid((out_cols + 31) / 32, (out_rows + 7) / 8);
  shift_ablation_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, in_cols, out_rows, out_cols, n_shifts, off);
  return (int)cudaGetLastError();
}

// mode 0 = gather, 1 = shifts; coef: host array of `iters` f32 (<= 32).
extern "C" int tpuflow_warp_gather_ablation(const float* x, const int* off,
                                            float* out, int rows, int wp,
                                            int mode, int iters, int maxd,
                                            const float* coef, void* stream) {
  if (iters < 1 || iters > kMaxIters || wp % 128 != 0) return (int)cudaErrorInvalidValue;
  Coefs c{};
  for (int d = 0; d < iters; ++d) c.c[d] = coef[d];
  const dim3 block(128, 2);
  const dim3 grid((wp + 127) / 128, (rows + 1) / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    warp_gather_ablation_kernel<0><<<grid, block, 0, s>>>(x, off, out, rows, wp, iters, maxd, c);
  } else if (mode == 1) {
    warp_gather_ablation_kernel<1><<<grid, block, 0, s>>>(x, off, out, rows, wp, iters, maxd, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
