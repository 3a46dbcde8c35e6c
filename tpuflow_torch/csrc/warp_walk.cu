// The banded warp as a walk: the design that warp.cu measured against
// its gathers on the coarse planes, kept as an ablation
// (tpuflow_torch/ablation/warp_walk.py times it beside them). Same
// function as warp.cu, bit for bit, on the same (batch, height, width)
// planes.
//
// A block walks down a strip of kTileW output columns, kStep rows a step,
// and keeps the band's source rows in a ring in shared memory, so the walk
// pays the vertical halo (2*mdv + 1 rows) once, not once a tile. Per step
// k:
//   1. each thread waits for the copies it issued for step k and decodes
//      those image pixels, once; then one barrier;
//   2. the rows step k + 2 adds to the window and step k + 2's u and v are
//      copied by zero-filling cp.async (16-byte where the width and the
//      bases allow) into the slots step k - 1 freed, in flight while steps
//      k and k + 1 compute;
//   3. kStep / (kThreads / kTileW) outputs a thread, every corner and the
//      flow from shared memory.
// The ring holds up to three steps' rows and 2*mdv + 1 more; the flow up to
// three steps. A ring that does not fit the card's shared memory a block
// is refused before launch.

#include "warp.cuh"

namespace tpuflow_warp {

// Decode, in place, the chunks `stage` gave this thread for the same
// rows (its own copies are complete after its cp.async.wait_group).
template <int kPacking, int N, int kThreads>
__device__ __forceinline__ void decode_mine(float* tile, int n, int slot0, int slots, int p) {
  if constexpr (kPacking != 0) {
    for_my_chunks<N, kThreads>(n, p, slot0, slots, [&](int, int slot, int t) {
      float* a = tile + slot * p + t;
      if constexpr (N == 16) {
        float4 q = *reinterpret_cast<float4*>(a);
        q.x = decode<kPacking>(q.x);
        q.y = decode<kPacking>(q.y);
        q.z = decode<kPacking>(q.z);
        q.w = decode<kPacking>(q.w);
        *reinterpret_cast<float4*>(a) = q;
      } else {
        *a = decode<kPacking>(*a);
      }
    });
  }
}

template <int kPacking, bool kClamp, int kTileW, int kStep, int kThreads>
__global__ void __launch_bounds__(kThreads)
warp_walk_kernel(const float* __restrict__ image, const float* __restrict__ flow_u,
                 const float* __restrict__ flow_v, float* __restrict__ out, int height,
                 int width, int max_disp, int max_disp_v, int walk, int n_ring, int vec) {
  constexpr int kRowStep = kThreads / kTileW;  // rows a pass of the block
  constexpr int kPer = kStep / kRowStep;       // outputs a thread a step
  constexpr int kFlowSlot = 2 * kStep * kTileW;  // floats of a step's u and v
  static_assert(kThreads % kTileW == 0 && kStep % kRowStep == 0, "whole rows a pass");
  extern __shared__ __align__(16) float smem[];

  const int col = threadIdx.x % kTileW, row = threadIdx.x / kTileW;
  const int x_first = blockIdx.x * kTileW, y_first = blockIdx.y * walk;
  const int y_end = min(y_first + walk, height);
  const size_t plane = (size_t)blockIdx.z * height * width;
  const float* img = plane_base(image, plane);
  const float* fu = plane_base(flow_u, plane);
  const float* fv = plane_base(flow_v, plane);
  out += plane;
  const int x = x_first + col;

  // Ring row i holds image row r_top + i (mod n_ring); a flow slot holds
  // one step's u and v.
  const int steps = (y_end - y_first + kStep - 1) / kStep;
  const int flow_slots = (n_ring - 2 * max_disp_v - 1) / kStep;
  const int p = pitch(kTileW, max_disp);
  const int r_top = y_first - max_disp_v;            // image row of ring row 0
  const int r_last = y_end + max_disp_v;             // last row any output reads
  const int c_base = x_first - left_halo(max_disp);  // image column of ring column 0
  float* ring = smem;
  const float* flow = smem + n_ring * p;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t flow_s = ring_s + (uint32_t)(n_ring * p) * 4u;
  // Step k's image rows: step 0 its whole window, step k > 0 the kStep
  // rows below step k - 1's, clipped at r_last.
  auto group_first = [&](int k) { return k == 0 ? 0 : k * kStep + 2 * max_disp_v + 1; };
  auto group_rows = [&](int k) {
    const int first = group_first(k);
    const int n = k == 0 ? kStep + 2 * max_disp_v + 1 : kStep;
    return max(0, min(n, r_last + 1 - r_top - first));
  };
  // Step k's image rows and its flow, one commit group (empty past the
  // walk's end).
  auto copy_step = [&](int k) {
    if (k < steps) {
      const int first = group_first(k), n = group_rows(k), slot0 = first % n_ring;
      if (vec & kVecImage)
        stage<16, kThreads>(ring_s, img, r_top + first, n, slot0, n_ring, p, c_base, height,
                            width);
      else
        stage<4, kThreads>(ring_s, img, r_top + first, n, slot0, n_ring, p, c_base, height,
                           width);
      const int y_k = y_first + k * kStep, rows = min(kStep, y_end - y_k);
      const uint32_t fs = flow_s + (uint32_t)((k % flow_slots) * kFlowSlot) * 4u;
      const uint32_t vs = fs + (uint32_t)(kStep * kTileW) * 4u;
      if (vec & kVecFlow) {
        stage<16, kThreads>(fs, fu, y_k, rows, 0, kStep, kTileW, x_first, height, width);
        stage<16, kThreads>(vs, fv, y_k, rows, 0, kStep, kTileW, x_first, height, width);
      } else {
        stage<4, kThreads>(fs, fu, y_k, rows, 0, kStep, kTileW, x_first, height, width);
        stage<4, kThreads>(vs, fv, y_k, rows, 0, kStep, kTileW, x_first, height, width);
      }
    }
    cp_async_commit();
  };

  copy_step(0);
  copy_step(1);
  int sb = 0;  // ring row of image row y_k - mdv
  int fslot = 0;
  for (int k = 0; k < steps; ++k) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    {
      const int first = group_first(k);
      if (vec & kVecImage)
        decode_mine<kPacking, 16, kThreads>(ring, group_rows(k), first % n_ring, n_ring, p);
      else
        decode_mine<kPacking, 4, kThreads>(ring, group_rows(k), first % n_ring, n_ring, p);
    }
    __syncthreads();  // step k's window and flow in; step k - 1's reads done
    copy_step(k + 2);
    if (x < width) {
      const float* fk = flow + fslot * kFlowSlot;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int dr = row + kRowStep * j;
        const int y = y_first + k * kStep + dr;
        if (y >= y_end) break;
        // Image row y + f is ring row sb + dr + mdv + f, inside step k's
        // window whenever the row rule lets that row count.
        out[y * width + x] = warp_one<kPacking, kClamp>(
            x, y, fk[dr * kTileW + col], fk[(kStep + dr) * kTileW + col], height, width,
            max_disp, max_disp_v, [&](int f, int x0, int x1, float fxc, float fx) {
              int d = dr + max_disp_v + f;
              if (!kClamp) d = min(max(d, 0), kStep + 2 * max_disp_v);
              int slot = sb + d;
              if (slot >= n_ring) slot -= n_ring;
              const float* r = ring + slot * p;
              return r[x0 - c_base] * fxc + r[x1 - c_base] * fx;
            });
      }
    }
    sb += kStep;
    if (sb >= n_ring) sb -= n_ring;
    if (++fslot == flow_slots) fslot = 0;
  }
}

// The walk's one geometry: 64-column strips, 16 rows a step, 256 threads
// (the fastest walk at 540x960 of a sweep of strips 32-128 wide, steps
// 4-32 rows, 128-512 threads).
constexpr int kWalkTileW = 64, kWalkStep = 16, kWalkThreads = 256;

// Steps in flight: up to three.
inline int walk_slots(int walk) { return min(3, (walk + kWalkStep - 1) / kWalkStep); }

inline int walk_ring_rows(int walk, int max_disp_v) {
  return walk_slots(walk) * kWalkStep + 2 * max_disp_v + 1;
}

inline size_t walk_smem_bytes(int walk, int max_disp, int max_disp_v) {
  return ((size_t)walk_ring_rows(walk, max_disp_v) * pitch(kWalkTileW, max_disp) +
          (size_t)walk_slots(walk) * 2 * kWalkStep * kWalkTileW) * sizeof(float);
}

template <int kPacking, bool kClamp>
static int launch_walk(const float* img, const float* u, const float* v, float* out,
                       int batch, int height, int width, int max_disp, int max_disp_v,
                       int walk, cudaStream_t s) {
  static int opted[kMaxDevices] = {};
  auto kernel = warp_walk_kernel<kPacking, kClamp, kWalkTileW, kWalkStep, kWalkThreads>;
  const size_t smem = walk_smem_bytes(walk, max_disp, max_disp_v);
  const cudaError_t err = allow_smem(kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width + kWalkTileW - 1) / kWalkTileW, (height + walk - 1) / walk, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  kernel<<<grid, kWalkThreads, smem, s>>>(img, u, v, out, height, width, max_disp, max_disp_v,
                                          walk, walk_ring_rows(walk, max_disp_v),
                                          copy_flags(img, u, v, width));
  return (int)cudaGetLastError();
}

}  // namespace tpuflow_warp

using namespace tpuflow_warp;

// As tpuflow_warp_banded, each block walking `walk` output rows (a
// positive multiple of 16).
extern "C" int tpuflow_warp_walk(const float* img, const float* u, const float* v, float* out,
                                 int batch, int height, int width, int max_disp, int max_disp_v,
                                 int packing, int clamp_flow, int walk, void* stream) {
  if (!valid_plane(batch, height, width, max_disp, max_disp_v) || walk < kWalkStep ||
      walk % kWalkStep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launcher) {
    return launcher(img, u, v, out, batch, height, width, max_disp, max_disp_v, walk, s);
  };
  if (packing == 0)
    return clamp_flow ? args(launch_walk<0, true>) : args(launch_walk<0, false>);
  if (!clamp_flow) return (int)cudaErrorInvalidValue;  // the packed variants clip the flow
  if (packing == 8) return args(launch_walk<8, true>);
  if (packing == 16) return args(launch_walk<16, true>);
  return (int)cudaErrorInvalidValue;
}
