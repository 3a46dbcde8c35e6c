// The banded warp's parts, shared by its kernel (warp.cu) and the walk
// ablation (warp_walk.cu): the corner decodes, the zero-filling cp.async
// staging of the band's window, one output in the Pallas kernel's f32
// order, and the coarse planes' gathering body (which the gather ablation,
// ablation/warp_gather.py, also builds at other shapes). What the warp
// computes is set out in warp.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuflow_warp {

constexpr int kMaxBatch = 65535;   // gridDim.z
constexpr int kMaxSide = 1 << 24;  // x + md, y + mdv exact as floats
constexpr int kMaxDevices = 64;

// Copy flags: 16-byte copies of the image (kVecImage), of the flow
// (kVecFlow) and of the output (kVecOut), where the row width and the
// planes' bases allow them.
constexpr int kVecImage = 1;
constexpr int kVecFlow = 2;
constexpr int kVecOut = 4;

// Longest band ladder a round takes (the adaptive configs' have 2 or 3).
constexpr int kMaxLadder = 8;

// A round's device control (warp.cu): the latch of each batch element
// (nonzero: skip; null: never), the band index in device memory (null:
// the launch's max_disp_v) into the ladder: element z reads
// band[band_stride * z], one index for the whole batch (stride 0) or one
// per plane (stride 1).
struct Control {
  const int* latch;
  const int* band;
  int ladder[kMaxLadder];
  int n_ladder;
  int band_stride;
};

// ladder[i] with every index static: an index computed at run time into a
// kernel parameter's array makes the compiler copy the whole struct to
// local memory in every thread.
template <class T>
__device__ __forceinline__ T ladder_at(const T (&ladder)[kMaxLadder], int i) {
  T v = ladder[0];
#pragma unroll
  for (int k = 1; k < kMaxLadder; ++k) v = k == i ? ladder[k] : v;
  return v;
}

// Staged columns left of a block's first output column: md + 1, rounded up
// to a 16-byte chunk (the first column is a multiple of the block width,
// so the window starts on a chunk).
__host__ __device__ constexpr int left_halo(int max_disp) { return (max_disp + 4) / 4 * 4; }

// Staged row pitch in floats: the window's columns, a whole number of chunks.
__host__ __device__ constexpr int pitch(int tile_w, int max_disp) {
  return (left_halo(max_disp) + tile_w + max_disp + 1 + 3) / 4 * 4;
}

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

// `p` offset by a batch element's plane, opaque to the compiler, so that
// each load addresses it with one 32-bit index (one wide multiply-add)
// instead of re-adding the 64-bit plane offset.
__device__ __forceinline__ const float* plane_base(const float* p, size_t offset) {
  p += offset;
  asm("" : "+l"(p));
  return p;
}

// Asynchronous copy global -> shared of N = 4 or 16 bytes, of which the
// first `bytes` are read and the rest zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, int bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// fn(row, slot, column) for each (row, N-byte chunk) pair of rows [0, n)
// of a `p`-float-wide window this thread takes, row i going to slot
// slot0 + i (wrapping at `slots`); steps without a division.
template <int N, int kThreads, class Fn>
__device__ __forceinline__ void for_my_chunks(int n, int p, int slot0, int slots, Fn fn) {
  constexpr int kFloats = N / 4;
  const int chunks = p / kFloats;
  const int step_r = kThreads / chunks, step_c = kThreads - step_r * chunks;
  int tr = threadIdx.x / chunks, tc = threadIdx.x - tr * chunks;
  for (; tr < n; tr += step_r) {
    int slot = slot0 + tr;
    if (slot >= slots) slot -= slots;
    fn(tr, slot, tc * kFloats);
    tc += step_c;
    if (tc >= chunks) {
      tc -= chunks;
      ++tr;
    }
  }
}

// Copy rows [r0, r0 + n) of `src`, columns from c_base, p floats a row,
// into shared memory at `dst` (slots as above); rows outside [0, height)
// and columns < 0 or >= width are zero-filled (a chunk never straddles
// column 0), which is the corner test done once a staged pixel.
template <int N, int kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const float* src, int r0, int n, int slot0,
                                      int slots, int p, int c_base, int height, int width) {
  constexpr int kFloats = N / 4;
  for_my_chunks<N, kThreads>(n, p, slot0, slots, [&](int tr, int slot, int t) {
    const int r = r0 + tr, c = c_base + t;
    const int bytes = r >= 0 && r < height && c >= 0 ? max(0, min(kFloats, width - c)) * 4 : 0;
    cp_async<N>(dst + (uint32_t)(slot * p + t) * 4u, bytes ? src + r * width + c : src, bytes);
  });
}

// One output, in the Pallas kernel's f32 order. `row_sample(f, x0, x1,
// fxc, fx)` gives c0*fxc + c1*fx on image row y + f; it is called for every
// f (a row the rule drops is read from a valid address and then dropped),
// so that all four corners are in flight at once.
template <int kPacking, bool kClamp, class RowSample>
__device__ __forceinline__ float warp_one(int x, int y, float uu, float vv, int height, int width,
                                          int max_disp, int max_disp_v, RowSample row_sample) {
  if (kClamp) {
    uu = fminf(fmaxf(uu, -(float)max_disp), (float)max_disp);
    vv = fminf(fmaxf(vv, -(float)max_disp_v), (float)max_disp_v);
  }
  const float xf = (float)x + uu;
  const float yf = (float)y + vv;
  const float x0f = floorf(xf);
  const float y0f = floorf(yf);
  const float fx = xf - x0f;
  const float fy = yf - y0f;
  const float fxc = 1.0f - fx;
  const float fyc = 1.0f - fy;

  // With the flow clipped, floor(xf) lies in [x - md, x + md] and
  // floor(yf) - y in [-mdv, mdv] (x + md and y + mdv are exact floats,
  // and rounding is monotonic), so the band clamps and the row rule
  // change nothing and are left out.
  const int ix0 = (int)x0f;
  int x0 = kClamp ? ix0 : min(max(ix0, x - max_disp - 1), x + max_disp);
  x0 = min(max(x0, 0), width - 1);
  int x1 = x0 + 1;  // column width reads 0
  if (kPacking == 0) {
    x1 = kClamp ? ix0 + 1 : min(max(ix0 + 1, x - max_disp - 1), x + max_disp + 1);
    x1 = min(max(x1, 0), width - 1);
  }
  const int f = (int)y0f - y;
  const bool up_ok = kClamp || (f >= -max_disp_v && f <= max_disp_v + 1);
  const bool low_ok = kClamp || (f >= -max_disp_v && f <= max_disp_v);

  const float s_up = row_sample(f, x0, x1, fxc, fx);
  const float s_low = row_sample(f + 1, x0, x1, fxc, fx);
  const float up = up_ok ? s_up : 0.0f;
  const float low = low_ok ? s_low : 0.0f;
  float res = up * fyc + low * fy;
  if (kPacking == 16) res = res * (1.0f / 256.0f);

  const bool inside = xf >= 0.0f && xf <= (float)(width - 1) && yf >= 0.0f &&
                      yf <= (float)(height - 1);
  return inside ? res : 0.0f;
}

// c0*fxc + c1*fx on image row r, each corner read through L1 and decoded
// where it is read; a row outside the image and column `width` read 0 (the
// staged window's zeros). Every address is valid, so both loads issue at
// once.
template <int kPacking>
__device__ __forceinline__ float gather_row(const float* img, int r, int x0, int x1, float fxc,
                                            float fx, int height, int width) {
  const float* src = img + min(max(r, 0), height - 1) * width;
  const float a = __ldg(src + x0), b = __ldg(src + min(x1, width - 1));
  const bool row_in = r >= 0 && r < height;
  const float c0 = row_in ? decode<kPacking>(a) : 0.0f;
  const float c1 = row_in && x1 < width ? decode<kPacking>(b) : 0.0f;
  return c0 * fxc + c1 * fx;
}

inline int copy_flags(const float* img, const float* u, const float* v, int width,
                      const float* out = nullptr) {
  auto aligned = [](const float* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (width % 4 != 0) return 0;
  return (aligned(img) ? kVecImage : 0) | (aligned(u) && aligned(v) ? kVecFlow : 0) |
         (out != nullptr && aligned(out) ? kVecOut : 0);
}

// Loads the compiler may neither merge nor sink below a branch (volatile:
// they have side effects), so that loads issued before the latch's test
// leave together with the latch's; N floats (1, 2 or 4, the vector ones
// from an 8- or 16-byte aligned address) through the read-only path.
__device__ __forceinline__ int ld_early(const int* p) {
  int r;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

template <int N>
__device__ __forceinline__ void ld_early(const float* p, float* r) {
  if constexpr (N == 4) {
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3]) : "l"(p));
  } else if constexpr (N == 2) {
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];" : "=f"(r[0]), "=f"(r[1]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(r[0]) : "l"(p));
  }
}

// N consecutive floats to an 8- or 16-byte aligned address (N = 2, 4), or one.
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* r) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

// The coarse planes' body (warp.cu's design note): each thread kCols
// consecutive columns of kPasses rows kTy apart, a block kTx x kTy threads,
// so kTx * kCols columns by kTy * kPasses rows, at least kMinBlocks blocks
// resident an SM (the registers a thread capped to fit). Under device
// control the latch, the band index and (kFlowFirst) the thread's u and v
// go out in one memory round trip, the corners in the next; without
// kFlowFirst the flow waits for the latch's test (three trips). A set
// latch stores nothing. Every address a thread forms is inside the plane
// (the ragged edge is clamped and its results dropped), so no load waits
// on a test.
template <int kPacking, bool kClamp, int kCols, int kTx, int kTy, int kPasses, bool kFlowFirst,
          int kMinBlocks>
__global__ void __launch_bounds__(kTx * kTy, kMinBlocks)
warp_gather_kernel(const float* __restrict__ image, const float* __restrict__ flow_u,
                   const float* __restrict__ flow_v, float* __restrict__ out, int height,
                   int width, int max_disp, int mdv_arg, int vec, const Control ctl) {
  static_assert(kCols == 1 || kCols == 2 || kCols == 4, "1, 2 or 4 columns a thread");
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int x = blockIdx.x * (kTx * kCols) + tx * kCols;
  const int y_first = blockIdx.y * (kTy * kPasses) + ty;
  const size_t plane = (size_t)blockIdx.z * height * width;
  const float* img = plane_base(image, plane);
  const float* fu = plane_base(flow_u, plane);
  const float* fv = plane_base(flow_v, plane);
  out += plane;
  // kCols columns as one 8- or 16-byte access: the row width a multiple of
  // 4 and every base 16-byte aligned (x is a multiple of kCols).
  const bool wide = kCols > 1 && (vec & (kVecFlow | kVecOut)) == (kVecFlow | kVecOut) &&
                    x + kCols <= width;

  float u[kPasses][kCols], v[kPasses][kCols];
  auto load_flow = [&]() {
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int row = min(y_first + kTy * k, height - 1) * width;
      if (wide) {
        ld_early<kCols>(fu + row + x, u[k]);
        ld_early<kCols>(fv + row + x, v[k]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = row + min(x + c, width - 1);
          ld_early<1>(fu + i, &u[k][c]);
          ld_early<1>(fv + i, &v[k][c]);
        }
      }
    }
  };

  // Launched with programmatic stream serialization (the dependent-launch
  // ablation, ablation/warp_gather.py), wait here for the kernel before to
  // finish and its writes to land; a no-op on an ordinary launch.
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // 1. The control words (and, kFlowFirst, the flow): one round trip.
  const int latch = ctl.latch != nullptr ? ld_early(ctl.latch + blockIdx.z) : 0;
  const int idx = ctl.band != nullptr ? ld_early(ctl.band + ctl.band_stride * blockIdx.z) : 0;
  if (kFlowFirst) load_flow();
  if (latch != 0) return;
  const int max_disp_v =
      ctl.band != nullptr ? ladder_at(ctl.ladder, min(max(idx, 0), ctl.n_ladder - 1)) : mdv_arg;
  if (!kFlowFirst) load_flow();
  if (x >= width) return;

  // 2. The corners: every output's four loads in flight at once.
  float res[kPasses][kCols];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int y = min(y_first + kTy * k, height - 1);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      res[k][c] = warp_one<kPacking, kClamp>(
          min(x + c, width - 1), y, u[k][c], v[k][c], height, width, max_disp, max_disp_v,
          [&](int f, int x0, int x1, float fxc, float fx) {
            return gather_row<kPacking>(img, y + f, x0, x1, fxc, fx, height, width);
          });
    }
  }

  // 3. The stores.
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int y = y_first + kTy * k;
    if (y >= height) break;
    float* o = out + y * width + x;
    if (wide) {
      st_vec<kCols>(o, res[k]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (x + c < width) o[c] = res[k][c];
    }
  }
}

inline bool valid_plane(int batch, int height, int width, int max_disp, int max_disp_v) {
  return batch >= 1 && batch <= kMaxBatch && height >= 1 && width >= 1 && height < kMaxSide &&
         width < kMaxSide && (long)height * width < (1L << 31) && max_disp >= 0 &&
         max_disp_v >= 0;
}

// The card's shared memory a block (opt-in), read once a device. The
// caches here and in each launch function have internal linkage (static),
// so two builds of the library loaded in one process never share them.
static int smem_optin(int dev) {
  static int cache[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    cache[dev] = v;
  }
  return cache[dev];
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: nothing to do
// up to the default 48 KB; past it the card's limit is checked (a window
// that does not fit is refused, never launched) and the kernel opts in
// once a device and size (`opted`, one per kernel).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem, int (&opted)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_optin(dev)) return cudaErrorInvalidConfiguration;
  if ((size_t)opted[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = (int)smem;
  }
  return cudaSuccess;
}

}  // namespace tpuflow_warp
