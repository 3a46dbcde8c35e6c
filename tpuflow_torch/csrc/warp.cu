// Banded bilinear backward warp on Hopper (sm_90a).
//
// Replaces tpuflow/kernels/pallas_warp.py::_warp_batched (pallas_call at
// :498) -> _warp_kernel -> _warp_block, in three variants:
//   packing 0  = no packing, f32 corners (pallas_warp.py:327-387), with
//                clamp_flow on or off: the exact-order configs' warp (K4);
//   packing 8  = packed_u8  (pallas_warp.py:132-234): the finest pyramid
//                level, corners are whole 8-bit gray levels (K1);
//   packing 16 = packed_u16 (pallas_warp.py:236-325): the coarse levels,
//                corners quantized to 8.8 fixed point (K2).
// The packed variants always clamp the flow (pallas_warp.py:598-601).
//
// What it computes, per output pixel (x, y):
//   u, v clipped to +-max_disp, +-max_disp_v if clamp_flow; xf = x + u,
//   yf = y + v; x0 = int(floor(xf)) clamped to [x - max_disp - 1,
//   x + max_disp], then to [0, W-1]; the second column is x0 + 1 for the
//   packed variants (0 past the last column) and int(floor(xf)) + 1
//   clamped to [x - max_disp - 1, x + max_disp + 1], then [0, W-1], for
//   the exact one (pallas_warp.py:92-96); rows y0 = floor(yf) and y0 + 1
//   read 0 outside the image; h = c0*(1-fx) + c1*fx per row.
//   The TPU kernel loops over the 2*max_disp_v + 2 candidate rows of its
//   band and selects the upper and lower row by equality masks
//   (pallas_warp.py:349-380), so with f = y0 - y the upper row counts only
//   for f in [-max_disp_v, max_disp_v + 1] and the lower only for f in
//   [-max_disp_v, max_disp_v]; otherwise that row is 0. (With clamp_flow
//   f always lies inside, so the rule only acts on unclamped flow.)
//   out = up*(1-fy) + low*fy (times 1/256 for 8.8); 0 where xf or yf lies
//   outside [0, N-1].
// The TPU kernel's two-copy 128-lane gather selection, scratch copy and
// candidate-row loop exist only to gather on the TPU's vector unit; a GPU
// thread reads its four corners directly, so none of them is carried over.
// The f32 expression order is the Pallas kernel's (pallas_warp.py:80-85,
// :216-227, :307-318, :373-380); the build uses -fmad=false so no product
// is fused into an FMA, and the result is bit-identical to the plain
// PyTorch version in tpuflow_torch/kernels/warp.py.
//
// Bound: device memory. Each pixel reads u, v and four corners (the
// corners mostly hit L1/L2: neighbouring threads read neighbouring
// columns) and writes one f32, about 16 B of DRAM traffic per pixel. One
// thread per pixel, 32x8 blocks, coalesced row-major accesses. A batch of
// planes is one launch, blockIdx.z the element (the TPU kernel's
// flattened (batch * row tiles) grid).

#include <cuda_runtime.h>

namespace {

template <int kPacking>
__device__ __forceinline__ float decode(float a) {
  if (kPacking == 0) return a;
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
__device__ __forceinline__ float lerp_row(const float* __restrict__ img, int r,
                                          int x0, int x1, float fx, float fxc,
                                          int height, int width) {
  const float c0 = corner<kPacking>(img, r, x0, height, width);
  const float c1 = corner<kPacking>(img, r, x1, height, width);
  return c0 * fxc + c1 * fx;
}

template <int kPacking>
__global__ void __launch_bounds__(256)
warp_banded_kernel(const float* __restrict__ img, const float* __restrict__ fu,
                   const float* __restrict__ fv, float* __restrict__ out,
                   int height, int width, int max_disp, int max_disp_v,
                   bool clamp_flow) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t plane = (size_t)blockIdx.z * height * width;
  img += plane;
  const size_t i = plane + (size_t)y * width + x;

  float u = fu[i];
  float v = fv[i];
  if (clamp_flow) {
    const float md = (float)max_disp;
    const float mdv = (float)max_disp_v;
    u = fminf(fmaxf(u, -md), md);
    v = fminf(fmaxf(v, -mdv), mdv);
  }
  const float xf = (float)x + u;
  const float yf = (float)y + v;
  const float x0f = floorf(xf);
  const float y0f = floorf(yf);
  const float fx = xf - x0f;
  const float fy = yf - y0f;
  const float fxc = 1.0f - fx;
  const float fyc = 1.0f - fy;

  const int ix0 = (int)x0f;
  int x0 = min(max(ix0, x - max_disp - 1), x + max_disp);
  x0 = min(max(x0, 0), width - 1);
  int x1 = x0 + 1;
  if (kPacking == 0) {
    x1 = min(max(ix0 + 1, x - max_disp - 1), x + max_disp + 1);
    x1 = min(max(x1, 0), width - 1);
  }
  const int y0 = (int)y0f;
  const int f = y0 - y;

  float up = 0.0f, low = 0.0f;
  if (f >= -max_disp_v && f <= max_disp_v + 1)
    up = lerp_row<kPacking>(img, y0, x0, x1, fx, fxc, height, width);
  if (f >= -max_disp_v && f <= max_disp_v)
    low = lerp_row<kPacking>(img, y0 + 1, x0, x1, fx, fxc, height, width);
  float res = up * fyc + low * fy;
  if (kPacking == 16) res = res * (1.0f / 256.0f);

  const bool inside = xf >= 0.0f && xf <= (float)(width - 1) && yf >= 0.0f &&
                      yf <= (float)(height - 1);
  out[i] = inside ? res : 0.0f;
}

}  // namespace

// img, u, v and out each hold `batch` contiguous (height, width) planes.
extern "C" int tpuflow_warp_banded(const float* img, const float* u,
                                   const float* v, float* out, int batch,
                                   int height, int width, int max_disp,
                                   int max_disp_v, int packing, int clamp_flow,
                                   void* stream) {
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((width + 31) / 32, (height + 7) / 8, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool clamp = clamp_flow != 0;
  if (packing == 0) {
    warp_banded_kernel<0><<<grid, block, 0, s>>>(img, u, v, out, height, width,
                                                 max_disp, max_disp_v, clamp);
  } else if (packing == 8 && clamp) {
    warp_banded_kernel<8><<<grid, block, 0, s>>>(img, u, v, out, height, width,
                                                 max_disp, max_disp_v, clamp);
  } else if (packing == 16 && clamp) {
    warp_banded_kernel<16><<<grid, block, 0, s>>>(img, u, v, out, height,
                                                  width, max_disp, max_disp_v,
                                                  clamp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tpuflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
