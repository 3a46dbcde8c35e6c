// Two measurement microkernels on Hopper (sm_90a), ports of the TPU
// ablation scripts. Neither is on a flow path; each answers on the card the
// question its TPU kernel asked there. Both are far below one launch of
// work (bounds 0.37 and 0.44 us against a ~1.8 us empty-kernel floor), so
// what a design can win is the time above that floor: one round trip to
// L2, then the arithmetic, in one wave of blocks.
//
// K8, shift ablation: replaces scripts/shift_ablation.py::make_fn's kernel
// (pallas_call at :82, body :67-80). out = a[r0 + i, c0 + j], then the 15
// row-shifted slices a[r_k + i, c0 + j], then the 15 column-shifted slices
// a[r0 + i, c_k + j] added in that order (k = 1..15), for a (256, 2048)
// input and a (64, 1024) output, at the four offset sets of the script
// (compiled in, one instantiation each; the caller's offsets are checked
// against them). A block owns a 32x16 output tile (128 blocks, one wave on
// 132 SMs) of 256 threads, and fetches only the distinct ranges its slices
// read, each once:
//   - the row strip, staged in shared memory by 16-byte cp.async: rows
//     r0 .. r15 + 31 of the tile's 16 columns (from c0 rounded down to 16
//     bytes), 152 rows for the 8-row offsets, 47 for the 1-row ones;
//   - the column terms a[r0 + i, c_k + j], c_k != c0 (a term with c_k ==
//     c0 is slice 0's own element). Where neighbouring columns share them
//     (offsets 1..16: one 32-wide window of the tile's rows), they are
//     staged in a second cp.async group, and the row part is summed while
//     that group lands. Where no other thread reads them (the 128-column
//     offsets: 7 distinct columns a row, 64 bytes apart from the next
//     thread's), each thread loads its own straight into registers,
//     issued first and in flight with the staging.
// A dense window around the tile would stage its whole reach (up to 152 x
// 912 floats); the "aligned" kind moves 2,432 staged and 7 x 512 loaded
// floats a block. Each thread computes two outputs of one column, spaced
// by the kind's row step (16 rows apart for the 8-row offsets, adjacent
// for the 1-row ones), so that a staged row serves several of them: term
// (q, k) reads strip row q * step + r_k, and equal rows are one shared-
// memory load. Row pitches put the warp's two thread rows 16 banks apart.
// A thread's outputs lie in one column, so its stores are scalar; a warp
// still writes whole 64-byte row segments. The adds stay in the plain
// version's order, so every kind is bit-exact against shift_adds_ref.
// Bound: the wave's one L2 round trip, then a few dozen shared loads and
// 60 dependent adds a thread.
//
// K9, warp-gather ablation: replaces
// scripts/warp_mxu_ablation.py::_build's kernel (pallas_call at :91, body
// :52-87). For every pixel of a (rows, wp) plane and each of the script's
// kIters = 18 candidate steps d, a sample g is taken from the (rows, wp +
// 256) band x and accumulated as acc = acc + g * f32(1 + 0.01 d):
//   mode 0, gather: within the pixel's 128-column block of x[:, 128:128+wp]
//     at lane l, g = block[clip(l + off + d - 9, 0, 127)] (a data-dependent
//     load; the clip stays inside the pixel's own block);
//   mode 1, shifts: g is the shifted view x[:, 128 + dx + col] for the one
//     dx in -9 .. 10 with off == dx + d % 3 - 1, chosen by a chain of 20
//     selects (the TPU's shift-select form), 0 where none matches.
// kIters, kMaxd and the coefficients are compile-time constants (the
// script has them as constants), so both loops unroll. A block owns 4 rows
// of one 128-column block, a warp one row, and stages its rows of the band
// (the 128 columns, plus 12 on each side in shifts mode) and their offsets
// once by 16-byte cp.async. Gather: a thread takes pixels lane + 32 e (e <
// 4), each step one shared load at its data-dependent index (random
// offsets: bank conflicts as they fall). Shifts: a thread takes 4 adjacent
// pixels, loads the 28 staged values they can select from into registers
// once (seven 16-byte loads), then runs the unrolled chain over them;
// with d unrolled, only d % 3 distinguishes the 18 chains, and the
// compiler may merge them. -fmad=false rounds the product and the add
// separately, so both modes are bit-exact against the plain PyTorch
// versions in tpuflow_torch/ablation/warp_mxu_ablation.py. Bound: the
// wave's one L2 round trip, then issue (gather: 18 clips, loads,
// multiplies and adds a pixel; shifts: the select chains).

#include <cuda_runtime.h>

#include <cstdint>

namespace tpuflow_ablation {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int round_up4(int n) { return (n + 3) / 4 * 4; }

// ---- K8 ----------------------------------------------------------------

constexpr int kInRows = 256, kInCols = 2048;
constexpr int kOutRows = 64, kOutCols = 1024;
constexpr int kShifts = 16;  // slices per axis, the first shared
constexpr int kKinds = 4;    // aligned, misaligned, rows_only, cols_only
constexpr int kTileRows = 32, kTileCols = 16;
constexpr int kOuts = 2;  // outputs a thread, one column
constexpr int kShiftThreads = kTileRows * kTileCols / kOuts;

struct Offsets {
  int r[kShifts];
  int c[kShifts];
};

// scripts/shift_ablation.py::_offsets: rows 8 i or 1 + i, columns
// 128 (i % 8) or 1 + i.
__host__ __device__ constexpr Offsets kind_offsets(int kind) {
  Offsets o{};
  for (int i = 0; i < kShifts; ++i) {
    o.r[i] = (kind == 0 || kind == 3) ? 8 * i : 1 + i;
    o.c[i] = (kind == 0 || kind == 2) ? 128 * (i % 8) : 1 + i;
  }
  return o;
}

// Where a column term k comes from: a staged window (>= 0), slice 0's
// element, or a load of the thread's own.
constexpr int kSlice0 = -1, kDirect = -2;

// Where a block's staged ranges sit in shared memory (floats; columns
// relative to the tile's first, rows to its first plus r0).
struct Layout {
  int step;                  // rows between a thread's outputs
  int strip_rows, strip_col, strip_width, strip_pitch;
  int n_win;                 // staged column windows (0: the terms are loaded)
  int win_col[kShifts], win_width[kShifts], win_pitch[kShifts], win_base[kShifts];
  int term[kShifts];         // source of column term k
  int floats;                // shared memory a block
};

// The least pitch >= width whose rows put the warp's two thread rows
// (`delta` rows apart) 16 banks apart.
__host__ __device__ constexpr int bank_pitch(int width, int delta) {
  int p = round_up4(width);
  while ((delta * p) % 32 != 16) p += 4;
  return p;
}

__host__ __device__ constexpr Layout make_layout(int kind) {
  const Offsets o = kind_offsets(kind);
  Layout l{};
  l.step = o.r[1] - o.r[0] >= kOuts ? kTileRows / kOuts : 1;
  const int delta = l.step == 1 ? kOuts : 1;  // rows between a warp's two thread rows
  l.strip_rows = kTileRows + o.r[kShifts - 1] - o.r[0];
  l.strip_col = o.c[0] / 4 * 4;
  l.strip_width = round_up4(o.c[0] - l.strip_col + kTileCols);
  l.strip_pitch = bank_pitch(l.strip_width, delta);
  l.floats = l.strip_rows * l.strip_pitch;
  // Column ranges [c_k, c_k + 16) of the terms that are not slice 0's,
  // widened to 16 bytes, in ascending order, overlapping ones merged.
  int starts[kShifts] = {};
  int n = 0;
  for (int k = 1; k < kShifts; ++k) {
    bool seen = o.c[k] == o.c[0];
    for (int m = 0; m < n; ++m) seen = seen || starts[m] == o.c[k];
    if (!seen) starts[n++] = o.c[k];
  }
  for (int a = 1; a < n; ++a)
    for (int b = a; b > 0 && starts[b - 1] > starts[b]; --b) {
      const int t = starts[b];
      starts[b] = starts[b - 1];
      starts[b - 1] = t;
    }
  l.n_win = 0;
  for (int m = 0; m < n; ++m) {
    const int lo = starts[m] / 4 * 4, hi = round_up4(starts[m] + kTileCols);
    const int w = l.n_win - 1;
    if (w >= 0 && lo <= l.win_col[w] + l.win_width[w]) {
      l.win_width[w] = hi - l.win_col[w];
    } else {
      l.win_col[l.n_win] = lo;
      l.win_width[l.n_win++] = hi - lo;
    }
  }
  // Windows no wider than the tile hold one offset's columns, each read by
  // one thread only: those terms are loaded, not staged.
  bool shared = false;
  for (int w = 0; w < l.n_win; ++w) shared = shared || l.win_width[w] > kTileCols;
  if (!shared) l.n_win = 0;
  for (int w = 0; w < l.n_win; ++w) {
    l.win_pitch[w] = bank_pitch(l.win_width[w], delta);
    l.win_base[w] = l.floats;
    l.floats += kTileRows * l.win_pitch[w];
  }
  for (int k = 0; k < kShifts; ++k) {
    l.term[k] = o.c[k] == o.c[0] ? kSlice0 : kDirect;
    for (int w = 0; w < l.n_win; ++w)
      if (l.term[k] == kDirect && o.c[k] >= l.win_col[w] &&
          o.c[k] + kTileCols <= l.win_col[w] + l.win_width[w])
        l.term[k] = w;
  }
  return l;
}

// Every staged range lies inside the input, and every term has its range.
__host__ __device__ constexpr bool layout_fits(int kind) {
  const Offsets o = kind_offsets(kind);
  const Layout l = make_layout(kind);
  bool ok = o.r[0] + kOutRows - kTileRows + l.strip_rows <= kInRows &&
            kOutCols - kTileCols + l.strip_col + l.strip_width <= kInCols &&
            o.r[0] + kOutRows <= kInRows && l.floats * 4 <= 48 * 1024;
  for (int w = 0; w < l.n_win; ++w)
    ok = ok && kOutCols - kTileCols + l.win_col[w] + l.win_width[w] <= kInCols;
  for (int k = 1; k < kShifts; ++k)
    ok = ok && o.c[k] + kOutCols <= kInCols && (l.term[k] != kDirect || l.n_win == 0);
  for (int k = 1; k < kShifts; ++k) ok = ok && o.r[k] > o.r[k - 1];
  return ok;
}

static_assert(layout_fits(0) && layout_fits(1) && layout_fits(2) && layout_fits(3),
              "a staged range leaves the input or a term has no source");
static_assert(make_layout(0).n_win == 0 && make_layout(1).n_win == 1,
              "the 128-column offsets' terms are loaded, columns 1..16 share one window");

template <int kKind>
__global__ void __launch_bounds__(kShiftThreads)
shift_ablation_kernel(const float* __restrict__ a, float* __restrict__ out) {
  constexpr Offsets o = kind_offsets(kKind);
  constexpr Layout l = make_layout(kKind);
  __shared__ __align__(16) float s[l.floats];
  const int i0 = blockIdx.y * kTileRows, j0 = blockIdx.x * kTileCols;
  const int tx = threadIdx.x % kTileCols, ty = threadIdx.x / kTileCols;
  const int row0 = l.step == 1 ? kOuts * ty : ty;  // the thread's first output row

  // The column terms no other thread reads, in flight first.
  float own[kOuts][kShifts];
  if constexpr (l.n_win == 0) {
    const float* g = a + (size_t)(i0 + o.r[0] + row0) * kInCols + j0 + tx;
#pragma unroll
    for (int q = 0; q < kOuts; ++q)
#pragma unroll
      for (int k = 1; k < kShifts; ++k)
        if (l.term[k] == kDirect) own[q][k] = __ldg(g + q * l.step * kInCols + o.c[k]);
  }
  // Stage the row strip, then the column windows, each element once.
  const float* src = a + (size_t)(i0 + o.r[0]) * kInCols + j0;
  {
    constexpr int chunks = l.strip_width / 4;
    for (int t = threadIdx.x; t < l.strip_rows * chunks; t += kShiftThreads) {
      const int row = t / chunks, c4 = 4 * (t % chunks);
      cp_async16(s + row * l.strip_pitch + c4, src + row * kInCols + l.strip_col + c4);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int w = 0; w < l.n_win; ++w) {
    const int chunks = l.win_width[w] / 4;
    for (int t = threadIdx.x; t < kTileRows * chunks; t += kShiftThreads) {
      const int row = t / chunks, c4 = 4 * (t % chunks);
      cp_async16(s + l.win_base[w] + row * l.win_pitch[w] + c4,
                 src + row * kInCols + l.win_col[w] + c4);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();  // the strip
  __syncthreads();

  // The row part: output q's term k reads strip row q * step + r_k - r0,
  // so equal rows are one load.
  const float* strip = s + row0 * l.strip_pitch + (o.c[0] - l.strip_col) + tx;
  float acc[kOuts];
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    acc[q] = strip[q * l.step * l.strip_pitch];
#pragma unroll
    for (int k = 1; k < kShifts; ++k)
      acc[q] = acc[q] + strip[(q * l.step + o.r[k] - o.r[0]) * l.strip_pitch];
  }
  if constexpr (l.n_win > 0) {
    cp_async_wait<0>();  // the windows
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
#pragma unroll
    for (int k = 1; k < kShifts; ++k) {
      const int w = l.term[k];
      const float v = w == kSlice0   ? strip[q * l.step * l.strip_pitch]
                      : w == kDirect ? own[q][k]
                                     : s[l.win_base[w] + (row0 + q * l.step) * l.win_pitch[w] +
                                         (o.c[k] - l.win_col[w]) + tx];
      acc[q] = acc[q] + v;
    }
  }
  float* dst = out + (size_t)(i0 + row0) * kOutCols + j0 + tx;
#pragma unroll
  for (int q = 0; q < kOuts; ++q) dst[q * l.step * kOutCols] = acc[q];
}

template <int kKind>
int launch_shift(const float* a, float* out, cudaStream_t s) {
  const dim3 grid(kOutCols / kTileCols, kOutRows / kTileRows);
  shift_ablation_kernel<kKind><<<grid, kShiftThreads, 0, s>>>(a, out);
  return (int)cudaGetLastError();
}

// ---- K9 ----------------------------------------------------------------

constexpr int kIters = 18;  // candidate rows at the full +-8 band
constexpr int kMaxd = 8;
constexpr int kLanes = 128;  // the TPU's lane block
constexpr int kMargin = 128;  // band columns left of the plane
constexpr int kHalo = 12;    // staged columns each side in shifts mode (>= kMaxd + 2)
constexpr int kBandRows = 4;  // rows a block, a warp each
constexpr int kPix = 4;       // pixels a thread
constexpr int kViews = 2 * kMaxd + 4;
constexpr int kLoaded = 28;   // staged values a shifts thread loads (7 x 16 B)

static_assert(kLanes == 32 * kPix, "a warp covers one 128-column block of a row");
static_assert(kHalo >= kMaxd + 2 && kHalo % 4 == 0, "the views reach maxd + 2 columns");
static_assert(kHalo - kMaxd - 1 >= 0 && kHalo + kPix - 1 + kMaxd + 2 < kLoaded,
              "a thread's views lie in the values it loads");

struct Coefs {
  float c[kIters];
};

// f32(1 + 0.01 d), as JAX casts the script's Python float.
__host__ __device__ constexpr Coefs make_coefs() {
  Coefs c{};
  for (int d = 0; d < kIters; ++d) c.c[d] = (float)(1.0 + 0.01 * d);
  return c;
}

template <int kMode>
__global__ void __launch_bounds__(32 * kBandRows)
warp_gather_ablation_kernel(const float* __restrict__ x, const int* __restrict__ off,
                            float* __restrict__ out, int rows, int wp) {
  constexpr Coefs coef = make_coefs();
  constexpr int halo = kMode == 0 ? 0 : kHalo;
  constexpr int width = kLanes + 2 * halo;
  constexpr int chunks = width / 4, off_chunks = kLanes / 4;
  __shared__ __align__(16) float band[kBandRows][width];
  __shared__ __align__(16) int offs[kBandRows][kLanes];
  const int c0 = blockIdx.x * kLanes, r0 = blockIdx.y * kBandRows;
  const int nrows = min(kBandRows, rows - r0);

  // Stage the block's rows of the band (and halo) and their offsets once.
  for (int t = threadIdx.x; t < nrows * chunks; t += 32 * kBandRows) {
    const int r = t / chunks, c4 = 4 * (t % chunks);
    cp_async16(&band[r][c4], x + (size_t)(r0 + r) * (wp + 2 * kMargin) + kMargin + c0 - halo + c4);
  }
  for (int t = threadIdx.x; t < nrows * off_chunks; t += 32 * kBandRows) {
    const int r = t / off_chunks, c4 = 4 * (t % off_chunks);
    cp_async16(&offs[r][c4], off + (size_t)(r0 + r) * wp + c0 + c4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= nrows) return;
  const float* row = band[r];
  float* dst = out + (size_t)(r0 + r) * wp + c0;

  if constexpr (kMode == 0) {
    // Pixels lane + 32 e: a warp's loads of one step sit near 32
    // consecutive lanes, spread by their offsets.
#pragma unroll
    for (int e = 0; e < kPix; ++e) {
      const int l = lane + 32 * e;
      const int base = l + offs[r][l] - kIters / 2;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < kIters; ++d) {
        const float g = row[min(max(base + d, 0), kLanes - 1)];
        acc = acc + g * coef.c[d];
      }
      dst[l] = acc;
    }
  } else {
    // Pixels 4 lane + e; view dx of pixel e is staged value halo + e + dx.
    float v[kLoaded];
#pragma unroll
    for (int m = 0; m < kLoaded; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + kPix * lane + m);
      v[m] = q.x;
      v[m + 1] = q.y;
      v[m + 2] = q.z;
      v[m + 3] = q.w;
    }
    const int4 o4 = *reinterpret_cast<const int4*>(&offs[r][kPix * lane]);
    const int o[kPix] = {o4.x, o4.y, o4.z, o4.w};
    float res[kPix];
#pragma unroll
    for (int e = 0; e < kPix; ++e) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < kIters; ++d) {
        float part = 0.0f;
#pragma unroll
        for (int dx = -kMaxd - 1; dx < kMaxd + 3; ++dx)
          part = o[e] == dx + d % 3 - 1 ? v[halo + e + dx] : part;
        acc = acc + part * coef.c[d];
      }
      res[e] = acc;
    }
    *reinterpret_cast<float4*>(dst + kPix * lane) = make_float4(res[0], res[1], res[2], res[3]);
  }
}

}  // namespace tpuflow_ablation

using namespace tpuflow_ablation;

// a: (256, 2048), out: (64, 1024); r_off, c_off: host arrays of n_shifts
// offsets, which must be one of the script's four sets (the kernel has
// them compiled in).
extern "C" int tpuflow_shift_ablation(const float* a, float* out, int in_cols,
                                      int out_rows, int out_cols, int n_shifts,
                                      const int* r_off, const int* c_off,
                                      void* stream) {
  if (in_cols != kInCols || out_rows != kOutRows || out_cols != kOutCols || n_shifts != kShifts)
    return (int)cudaErrorInvalidValue;
  int kind = 0;
  for (; kind < kKinds; ++kind) {
    const Offsets o = kind_offsets(kind);
    bool same = true;
    for (int k = 0; k < kShifts; ++k) same = same && o.r[k] == r_off[k] && o.c[k] == c_off[k];
    if (same) break;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_shift<0>(a, out, s);
    case 1: return launch_shift<1>(a, out, s);
    case 2: return launch_shift<2>(a, out, s);
    case 3: return launch_shift<3>(a, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: (rows, wp + 256), off: (rows, wp) int32, out: (rows, wp); mode 0 =
// gather, 1 = shifts; wp a multiple of 128.
extern "C" int tpuflow_warp_gather_ablation(const float* x, const int* off, float* out,
                                            int rows, int wp, int mode, void* stream) {
  if (rows < 1 || wp < kLanes || wp % kLanes != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(wp / kLanes, (rows + kBandRows - 1) / kBandRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    warp_gather_ablation_kernel<0><<<grid, 32 * kBandRows, 0, s>>>(x, off, out, rows, wp);
  } else if (mode == 1) {
    warp_gather_ablation_kernel<1><<<grid, 32 * kBandRows, 0, s>>>(x, off, out, rows, wp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
