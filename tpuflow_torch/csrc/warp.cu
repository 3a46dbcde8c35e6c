// Banded bilinear backward warp on Hopper (sm_90a), packed-corner variants.
//
// Replaces tpuflow/kernels/pallas_warp.py::_warp_batched (pallas_call at
// :498) -> _warp_kernel -> _warp_block with clamp_flow=True and
//   packing 8  = packed_u8  (pallas_warp.py:132-234): the finest pyramid
//                level, corners are whole 8-bit gray levels;
//   packing 16 = packed_u16 (pallas_warp.py:236-325): the coarse levels,
//                corners quantized to 8.8 fixed point.
//
// What it computes, per output pixel (x, y):
//   u, v clipped to +-max_disp, +-max_disp_v; xf = x + u, yf = y + v;
//   x0 = floor(xf) clamped to [x - max_disp - 1, x + max_disp], then to
//   [0, W-1]; y0 = floor(yf); the four corners (y0|y0+1, x0|x0+1) read 0
//   outside the image; h = c0*(1-fx) + c1*fx per row; out = up*(1-fy) +
//   low*fy (times 1/256 for 8.8); 0 where xf or yf lies outside [0, N-1].
// The TPU kernel's two-copy 128-lane gather selection, scratch copy and
// candidate-row loop exist only to gather on the TPU's vector unit; a GPU
// thread reads its four corners directly, so none of them is carried over.
// The f32 expression order is the Pallas kernel's (pallas_warp.py:80-85,
// :216-227, :307-318); the build uses -fmad=false so no product is fused
// into an FMA, and the result is bit-identical to the plain PyTorch
// version in tpuflow_torch/kernels/warp.py.
//
// Bound: device memory. Each pixel reads u, v and four corners (the
// corners mostly hit L1/L2: neighbouring threads read neighbouring
// columns) and writes one f32, about 16 B of DRAM traffic per pixel. One
// thread per pixel, 32x8 blocks, coalesced row-major accesses.

#include <cuda_runtime.h>

namespace {

template <int kPacking>
__device__ __forceinline__ float decode(float a) {
  if (kPacking == 8) {
    // astype(int32) truncation of the 8-bit gray level.
    return (float)(int)a;
  }
  // Round-to-nearest 8.8 fixed point, low 16 bits of the packed word.
  return (float)(((int)(a * 256.0f + 0.5f)) & 0xFFFF);
}

template <int kPacking>
__device__ __forceinline__ float corner(const float* __restrict__ img, int r,
                                        int c, int height, int width) {
  if (r < 0 || r >= height || c >= width) return 0.0f;
  return decode<kPacking>(__ldg(img + (size_t)r * width + c));
}

template <int kPacking>
__global__ void __launch_bounds__(256)
warp_banded_kernel(const float* __restrict__ img, const float* __restrict__ fu,
                   const float* __restrict__ fv, float* __restrict__ out,
                   int height, int width, int max_disp, int max_disp_v) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t i = (size_t)y * width + x;

  const float md = (float)max_disp;
  const float mdv = (float)max_disp_v;
  const float u = fminf(fmaxf(fu[i], -md), md);
  const float v = fminf(fmaxf(fv[i], -mdv), mdv);
  const float xf = (float)x + u;
  const float yf = (float)y + v;
  const float x0f = floorf(xf);
  const float y0f = floorf(yf);
  const float fx = xf - x0f;
  const float fy = yf - y0f;
  const float fxc = 1.0f - fx;
  const float fyc = 1.0f - fy;

  int x0 = min(max((int)x0f, x - max_disp - 1), x + max_disp);
  x0 = min(max(x0, 0), width - 1);
  const int y0 = (int)y0f;

  const float c00 = corner<kPacking>(img, y0, x0, height, width);
  const float c01 = corner<kPacking>(img, y0, x0 + 1, height, width);
  const float c10 = corner<kPacking>(img, y0 + 1, x0, height, width);
  const float c11 = corner<kPacking>(img, y0 + 1, x0 + 1, height, width);
  const float up = c00 * fxc + c01 * fx;
  const float low = c10 * fxc + c11 * fx;
  float res = up * fyc + low * fy;
  if (kPacking == 16) res = res * (1.0f / 256.0f);

  const bool inside = xf >= 0.0f && xf <= (float)(width - 1) && yf >= 0.0f &&
                      yf <= (float)(height - 1);
  out[i] = inside ? res : 0.0f;
}

}  // namespace

extern "C" int tpuflow_warp_banded(const float* img, const float* u,
                                   const float* v, float* out, int height,
                                   int width, int max_disp, int max_disp_v,
                                   int packing, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packing == 8) {
    warp_banded_kernel<8><<<grid, block, 0, s>>>(img, u, v, out, height, width,
                                                 max_disp, max_disp_v);
  } else if (packing == 16) {
    warp_banded_kernel<16><<<grid, block, 0, s>>>(img, u, v, out, height,
                                                  width, max_disp, max_disp_v);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tpuflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
