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
// The f32 expression order is the Pallas kernel's (pallas_warp.py:80-85,
// :216-227, :307-318, :373-380); the build uses -fmad=false so no product
// is fused into an FMA, and the result is bit-identical to the plain
// PyTorch version in tpuflow_torch/kernels/warp.py.
//
// Bound on this card: device memory. Each pixel reads u, v and its image
// pixel once and writes one f32: 16 B a pixel, 0.0099 ms at 1080p at
// 3.35 TB/s.
//
// Design: one body, two ways to its corners, chosen by plane size.
// - Large planes (>= 2^20 pixels: the 1080p level of K1 and K4) stage the
//   band before the flow. The clamps fix every corner a block can read
//   before any flow is known: rows [y_first - mdv, y_last + mdv + 1] (the
//   row rule) and columns [x_first - md - 1, x_last + md + 1] (the column
//   clamps), with clamp_flow on or off. A block of 128 output columns by
//   32 rows, 256 threads,
//     1. issues 16-byte cp.async copies of that window into shared memory
//        (4-byte ones where the width or the base is not 16-byte aligned),
//        the zero-fill form for rows outside the image and columns at or
//        past W, which is the corner test done once a staged pixel;
//     2. then loads its u and v, so the flow's fetch overlaps the image's:
//        one memory round trip, not two;
//     3. decodes each staged pixel once in shared memory (K1 (float)(int)a,
//        K2 the 8.8 word as a float, K4 as it is), not four times an output;
//     4. computes 16 outputs a thread, one column on every other row (a
//        warp takes 32 consecutive columns of a row: coalesced, and
//        consecutive shared-memory banks), every corner from the tile.
//   Shared memory: (32 + 2*mdv + 1) x pitch(128, md) floats: 29,792 B at
//   md = mdv = 8, 72,960 B at 31. A window that does not fit the card is
//   refused before launch.
// - Smaller planes (the coarse levels: K2, and K4 there) gather each
//   corner through L1, decoded where it is read (warp_gather_kernel in
//   warp.cuh). Bound: the same 16 B a pixel, device memory (0.00248 ms at
//   540x960, 0.00062 at 270x480); what limits it is latency, so the body
//   cuts the dependent memory round trips a thread makes before it stores
//   from four (the latch, then the band index, then u and v, then the
//   corners) to two:
//     1. the latch, the band index and the thread's u and v are loaded
//        together (volatile loads the compiler cannot sink below the
//        latch's test); a set latch returns before any store, `out`
//        untouched;
//     2. the band clips v, and every corner load of the thread goes out at
//        once; every address is valid (rows and the ragged edge clamped,
//        then masked), so no load waits on a test.
//   One column a thread (a warp's corner loads of one row cover 32
//   consecutive outputs), one row in 32x8 blocks below 2^18 pixels (270x480:
//   510 blocks) and four rows in 32x32 blocks above (540x960: 510 blocks),
//   registers capped so that eight blocks of 256 threads fit an SM (the
//   grid is one wave). Measured against the other shapes and load orders
//   of ablation/warp_gather.py (PERF.md §6 has the times): two or four
//   columns a thread, with 8- or 16-byte flow and output accesses, read
//   0.5-2.8 us slower in 17 of 18 cases (a warp's corner load then spans
//   up to four cache lines); the flow after the latch's test made running
//   rounds 0.1-0.4 us slower in 5 of 6 cases, skipped ones 0.1-0.4 us
//   faster and the graphed 1080p frames 1-2 us slower; a programmatic
//   dependent launch made those 2-4 us slower. Breakdown at 540x960 K2
//   (ablation/port_against.py, NVIDIA H100 80GB HBM3, 700 W): launch
//   floor 0.00186 ms, an empty kernel on the grid 0.00215, skipped
//   0.00288 (the control words and the flow), band 8 on zero flow 0.00494
//   (the corners' trip and the stores), on random +-9 px flow 0.00532 (the
//   corners' spread), band 2 0.00522, the entry 0.00523. Staged tiles, and a block
//   that walks down a strip with the band's rows in a ring (warp_walk.cu,
//   the walk ablation), measured slower there (PERF.md): with the few
//   blocks an SM such a plane gives, a block waits for its window at a
//   barrier, and the halo at band 8 is 2-3 times the outputs.
// With the flow clipped, the band clamps and the row rule change nothing
// and are compiled out (kClamp); that needs x + md and y + mdv to be exact
// floats, so a plane's sides stay under 2^24.
// A batch of planes is one launch, blockIdx.z the element (the TPU
// kernel's flattened (batch * row tiles) grid); the geometry depends on
// the plane alone, so an element equals its 2-D launch.
//
// Device control (tpuflow_warp_round, the pyramidal driver's round): the
// reference runs a level's rounds in a lax.while_loop and picks the band
// by lax.switch, both on the device (tpuflow/flow/pyramidal.py:39-132,
// :169-199). Here every round is launched, and each block first reads two
// words of device memory: the element's converged latch (set: the round
// is skipped, and the block returns before any store, leaving `out` as it
// was) and the band index, which picks max_disp_v from the ladder passed
// as launch arguments. The staged tile reads both before the band's
// window is staged, since its rows depend on the band, and reads nothing
// else on a set latch; the gathers read them with the flow. The switch is one launch, with
// shared memory sized for the ladder's widest band and the window's rows
// from the band read (the grid does not depend on the band); every output
// bit is as the host-int band's launch gives it. A batch of independent
// streams reads one band index a plane (element z's, band[z]); one index
// may also serve every plane. (The switch's own form,
// one launch per candidate band whose blocks return at once unless the
// index read is theirs, was measured 5-6 us a round slower and dropped.)

#include "warp.cuh"

namespace tpuflow_warp {

// A block's outputs, `tile_w` columns by `rows` rows, on `threads`
// threads, `cols` consecutive columns a thread; `staged`: corners from the
// band staged in shared memory, else read from the image through L1.
struct Geometry {
  bool staged;
  int tile_w;
  int rows;
  int threads;
  int cols;
};

template <int kPacking, bool kClamp, int kTileW, int kRows, int kThreads>
__global__ void __launch_bounds__(kThreads)
warp_tile_kernel(const float* __restrict__ image, const float* __restrict__ flow_u,
                 const float* __restrict__ flow_v, float* __restrict__ out, int height,
                 int width, int max_disp, int mdv_arg, int vec, const Control ctl) {
  constexpr int kRowStep = kThreads / kTileW;  // rows a pass of the block
  constexpr int kPasses = kRows / kRowStep;    // outputs a thread
  static_assert(kThreads % kTileW == 0 && kRows % kRowStep == 0, "whole rows a pass");
  extern __shared__ __align__(16) float tile[];

  // 0. Device control: a skipped round writes nothing; the band comes
  // from the ladder at the index in device memory.
  if (ctl.latch != nullptr && ctl.latch[blockIdx.z] != 0) return;
  int max_disp_v = mdv_arg;
  if (ctl.band != nullptr) {
    const int idx = ctl.band[ctl.band_stride * blockIdx.z];
    max_disp_v = ladder_at(ctl.ladder, min(max(idx, 0), ctl.n_ladder - 1));
  }

  const int col = threadIdx.x % kTileW, row = threadIdx.x / kTileW;
  const int x_first = blockIdx.x * kTileW, y_first = blockIdx.y * kRows;
  const size_t plane = (size_t)blockIdx.z * height * width;
  const float* img = image + plane;
  const float* fu = flow_u + plane;
  const float* fv = flow_v + plane;
  out += plane;
  const int p = pitch(kTileW, max_disp);
  const int n_rows = kRows + 2 * max_disp_v + 1;
  const int r_base = y_first - max_disp_v;           // image row of tile row 0
  const int c_base = x_first - left_halo(max_disp);  // image column of tile column 0

  // 1. The band's window, before any flow is read.
  const uint32_t tile_s = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  if (vec & kVecImage)
    stage<16, kThreads>(tile_s, img, r_base, n_rows, 0, n_rows, p, c_base, height, width);
  else
    stage<4, kThreads>(tile_s, img, r_base, n_rows, 0, n_rows, p, c_base, height, width);
  cp_async_commit();

  // 2. The flow, in flight with the window (a plane holds < 2^31 pixels).
  const int x = x_first + col;
  float u[kPasses], v[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int y = y_first + row + kRowStep * k;
    const bool ok = x < width && y < height;
    const int i = ok ? y * width + x : 0;
    u[k] = ok ? __ldg(fu + i) : 0.0f;
    v[k] = ok ? __ldg(fv + i) : 0.0f;
  }

  // 3. Decode each staged pixel once, four at a time.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if constexpr (kPacking != 0) {
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < n_rows * p / 4; i += kThreads) {
      float4 a = t4[i];
      a.x = decode<kPacking>(a.x);
      a.y = decode<kPacking>(a.y);
      a.z = decode<kPacking>(a.z);
      a.w = decode<kPacking>(a.w);
      t4[i] = a;
    }
    __syncthreads();
  }
  if (x >= width) return;

  // 4. The outputs.
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int y = y_first + row + kRowStep * k;
    if (y >= height) break;
    // Image row y + f is tile row y - y_first + mdv + f: inside the window
    // whenever the row rule lets that row count (a dropped row is read from
    // the window's edge).
    const int dy = y - y_first + max_disp_v;
    out[y * width + x] = warp_one<kPacking, kClamp>(
        x, y, u[k], v[k], height, width, max_disp, max_disp_v,
        [&](int f, int x0, int x1, float fxc, float fx) {
          const int t = kClamp ? dy + f : min(max(dy + f, 0), n_rows - 1);
          const float* r = tile + t * p;
          return r[x0 - c_base] * fxc + r[x1 - c_base] * fx;
        });
  }
}

// Planes of this many pixels and more stage the band in 128x32 tiles;
// smaller ones gather their corners through L1 (see the design note
// above), in the small plane's block under kSmallPixels, else the large
// plane's.
constexpr long kStagedMinPixels = 1L << 20;
constexpr long kSmallPixels = 1L << 18;
constexpr Geometry kStagedTile{true, 128, 32, 256, 1};

struct Args {
  const float* img;
  const float* u;
  const float* v;
  float* out;
  int batch, height, width, max_disp, max_disp_v;  // max_disp_v sizes the window
  int vec;  // kVecImage | kVecFlow | kVecOut
  Control ctl;
};

inline dim3 grid_of(const Geometry& g, int batch, int height, int width) {
  return dim3((width + g.tile_w - 1) / g.tile_w, (height + g.rows - 1) / g.rows, batch);
}

// A gathering block (warp.cuh's warp_gather_kernel): kCols columns a
// thread, kTx x kTy threads, kPasses rows a thread, kMinBlocks blocks an
// SM; the flow leaves with the control words.
template <int kCols, int kTx, int kTy, int kPasses, int kMinBlocks>
struct Gather {
  static constexpr Geometry geometry{false, kTx * kCols, kTy * kPasses, kTx * kTy, kCols};

  template <int kPacking, bool kClamp>
  static int launch(const Args& a, cudaStream_t s) {
    const dim3 grid = grid_of(geometry, a.batch, a.height, a.width);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    warp_gather_kernel<kPacking, kClamp, kCols, kTx, kTy, kPasses, true, kMinBlocks>
        <<<grid, geometry.threads, 0, s>>>(a.img, a.u, a.v, a.out, a.height, a.width,
                                           a.max_disp, a.max_disp_v, a.vec, a.ctl);
    return (int)cudaGetLastError();
  }
};
using GatherSmall = Gather<1, 32, 8, 1, 8>;  // planes under kSmallPixels (270x480)
using GatherLarge = Gather<1, 32, 8, 4, 8>;  // the others (540x960)

// The block a plane gets, a function of the plane alone (so a batch
// element equals its 2-D launch): by its size where staged < 0, else
// staged (1) or gathering (0) whatever its size.
inline Geometry geometry(int height, int width, int staged) {
  const long pixels = (long)height * width;
  if (staged < 0) staged = pixels >= kStagedMinPixels;
  if (staged) return kStagedTile;
  return pixels < kSmallPixels ? GatherSmall::geometry : GatherLarge::geometry;
}

inline size_t smem_bytes(const Geometry& g, int max_disp, int max_disp_v) {
  if (!g.staged) return 0;
  return (size_t)(g.rows + 2 * max_disp_v + 1) * pitch(g.tile_w, max_disp) * sizeof(float);
}

template <int kPacking, bool kClamp>
static int launch_staged(const Args& a, cudaStream_t s) {
  static int opted[kMaxDevices] = {};
  constexpr Geometry g = kStagedTile;
  auto kernel = warp_tile_kernel<kPacking, kClamp, g.tile_w, g.rows, g.threads>;
  const size_t smem = smem_bytes(g, a.max_disp, a.max_disp_v);
  const cudaError_t err = allow_smem(kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(g, a.batch, a.height, a.width);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  kernel<<<grid, g.threads, smem, s>>>(a.img, a.u, a.v, a.out, a.height, a.width, a.max_disp,
                                       a.max_disp_v, a.vec, a.ctl);
  return (int)cudaGetLastError();
}

template <int kPacking, bool kClamp>
int launch_geometry(const Geometry& g, const Args& a, cudaStream_t s) {
  if (g.staged) return launch_staged<kPacking, kClamp>(a, s);
  if (g.rows == GatherSmall::geometry.rows)
    return GatherSmall::launch<kPacking, kClamp>(a, s);
  return GatherLarge::launch<kPacking, kClamp>(a, s);
}

inline int launch_any(const Geometry& g, int packing, bool clamp, const Args& a,
                      cudaStream_t s) {
  if (packing == 0)
    return clamp ? launch_geometry<0, true>(g, a, s) : launch_geometry<0, false>(g, a, s);
  if (!clamp) return (int)cudaErrorInvalidValue;  // the packed variants clip the flow
  if (packing == 8) return launch_geometry<8, true>(g, a, s);
  if (packing == 16) return launch_geometry<16, true>(g, a, s);
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace tpuflow_warp

using namespace tpuflow_warp;

// img, u, v and out each hold `batch` contiguous (height, width) planes;
// the block is chosen by plane size where staged < 0, else staged (1) or
// gathering (0) whatever the size (the same output bit for bit; for
// measurement).
extern "C" int tpuflow_warp_banded_as(const float* img, const float* u, const float* v,
                                      float* out, int batch, int height, int width,
                                      int max_disp, int max_disp_v, int packing,
                                      int clamp_flow, int staged, void* stream) {
  if (!valid_plane(batch, height, width, max_disp, max_disp_v))
    return (int)cudaErrorInvalidValue;
  const Args a{img, u, v, out, batch, height, width, max_disp, max_disp_v,
               copy_flags(img, u, v, width, out), Control{}};
  return launch_any(geometry(height, width, staged), packing, clamp_flow != 0, a,
                    static_cast<cudaStream_t>(stream));
}

// One round of the pyramidal driver under device control, the flow
// clamped: skipped where latch[b] != 0 (out untouched), the band
// ladder[band[b]] (ladder[0] where band is null), in one launch sized for
// the widest band. latch is the int32 flag of each of the `batch` elements;
// band holds n_band indices, 1 (every plane's) or `batch` (one a plane).
extern "C" int tpuflow_warp_round(const float* img, const float* u, const float* v, float* out,
                                  const int* latch, const int* band, int n_band,
                                  const int* ladder, int n_ladder, int batch, int height,
                                  int width, int max_disp, int packing, void* stream) {
  if (n_ladder < 1 || n_ladder > kMaxLadder || (band == nullptr && n_ladder != 1) ||
      (band != nullptr && n_band != 1 && n_band != batch))
    return (int)cudaErrorInvalidValue;
  Control ctl{latch, band, {}, n_ladder, n_band > 1 ? 1 : 0};
  int widest = 0;
  for (int i = 0; i < n_ladder; ++i) {
    if (ladder[i] < 0) return (int)cudaErrorInvalidValue;
    ctl.ladder[i] = ladder[i];
    if (ladder[i] > widest) widest = ladder[i];
  }
  if (!valid_plane(batch, height, width, max_disp, widest)) return (int)cudaErrorInvalidValue;
  const Args a{img, u, v, out, batch, height, width, max_disp, widest,
               copy_flags(img, u, v, width, out), ctl};
  return launch_any(geometry(height, width, -1), packing, true, a,
                    static_cast<cudaStream_t>(stream));
}

// The warp with the block its plane's size chooses.
extern "C" int tpuflow_warp_banded(const float* img, const float* u, const float* v, float* out,
                                   int batch, int height, int width, int max_disp,
                                   int max_disp_v, int packing, int clamp_flow, void* stream) {
  return tpuflow_warp_banded_as(img, u, v, out, batch, height, width, max_disp, max_disp_v,
                                packing, clamp_flow, -1, stream);
}

// The block a plane gets and the shared memory it stages at a band, into
// out[6]: staged (0 or 1), tile width, rows, threads, bytes, columns a
// thread.
extern "C" void tpuflow_warp_geometry(int height, int width, int max_disp, int max_disp_v,
                                      int* out) {
  const Geometry g = geometry(height, width, -1);
  out[0] = g.staged;
  out[1] = g.tile_w;
  out[2] = g.rows;
  out[3] = g.threads;
  out[4] = (int)smem_bytes(g, max_disp, max_disp_v);
  out[5] = g.cols;
}

// One launch of an empty kernel: the floor under any kernel's time.
extern "C" int tpuflow_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// An empty kernel on a grid of (gx, gy, gz) blocks of `threads` threads:
// what a kernel on that grid costs before its body.
extern "C" int tpuflow_empty_grid(int gx, int gy, int gz, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy, gz), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* tpuflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
