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
// lk_tile.cuh's (`sobel()`, `solve_store()`); only the window sums differ.
//
// Window sums on the tensor cores. The TPU branch asked whether the matrix
// unit beats shifted adds for the window sums; on Hopper the same question
// is mma.sync against the shift tree. Each of the five product planes P is
// summed as two banded products, both with m16n8k8 TF32 mma.sync:
//   rows = Wv @ P, Wv the (16, 16 + w - 1) band Wv[i][k] = (i <= k < i + w),
//     3 k-steps at every window;
//   sums = rows @ Wh, Wh the band Wh[k][j] = (j <= k < j + w): 8 output
//     columns read 8 + w - 1 <= 14 row-sum columns, two k-steps, both
//     with nonzero band entries (no mma multiplies an all-zero band).
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
//
// Sums in registers. The m16n8k8 accumulator of lane (g = lane / 4,
// t = lane % 4) holds D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]; its
// A operand holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]. Number the
// horizontal product's k-slots so that slot t is row-sum column 2t and
// slot t + 4 column 2t + 1 (the band's B fragment, generated in registers,
// takes the same numbering): a vertical accumulator is then the horizontal
// pass's A fragment register for register, and the horizontal result lands
// on the same four pixels in every plane. So the row sums and the window
// sums never leave the lane that forms them, and the solve runs on the
// fragments.
//
// Block: 64x64 outputs, 8 warps; each warp owns a strip of 16 output rows
// by 32 columns and walks across it one 8-column tile at a time: it loads
// the next gradient tile's three planes once (two rows a k-step a lane),
// then, plane by plane, forms that tile's vertical sums (the product split
// once), runs the horizontal pass on the carried tile and the new one, and
// keeps the new one; then it solves its four pixels and stores each row's
// two as one float2 where the width is even. Plane by plane keeps one
// plane's accumulators live at a time (all five at once spilled at the
// 128 registers that two blocks an SM allow). Shared memory holds only the
// staged avg and the three gradient planes (pitch 72 floats, 8 mod 32
// banks, so a B fragment's four rows by eight columns load without bank
// conflicts); the frames are first copied as they are by cp.async into
// the gradient planes' space: 73.8-80.4 KB a block at windows 3-7, two
// blocks an SM. A strip takes 5 vertical and 4 horizontal tiles, 345 mma
// (15 a k-step: 5 planes x 3 parts).
//
// Bound: device memory (16-24 B a pixel, lk_tile.cuh). What this body
// spends beyond it is on chip, in instructions: the three-way splits (six
// operations each, 285 a lane a strip at window 5) are ~40% of a strip's,
// the staging and the Sobel about a quarter of the time, the tensor pipe
// about an eighth (PERF.md, measured on an H100).
// Batches: blockIdx.z is the batch element; each element reads its own
// planes and converged flag and writes its own block partials.

#include "lk_tile.cuh"
#include "warp.cuh"

using namespace tpuflow_lk;

namespace {

constexpr int kTW = 64;  // output tile width
constexpr int kTH = 64;  // output tile height
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStripRows = 16;               // a warp's output rows
constexpr int kStripCols = 32;               // and columns
constexpr int kStripTiles = kStripCols / 8;  // 8-column output tiles a strip
static_assert(kWarps * kStripRows * kStripCols == kTH * kTW, "warps tile the block");
constexpr int kPitch = 72;  // gradient planes' row pitch in floats
constexpr int kKT = 3;      // vertical k-steps: 16 + w - 1 <= 22 rows

// The block's shared memory at a window: the staged avg (kAH x kAW) and
// the three gradient planes (kGH x kPitch).
template <int kWindow>
struct Tile {
  static constexpr int kHalf = kWindow / 2;
  static constexpr int kR = kHalf + 1;  // halo: Sobel 1 + window half
  static constexpr int kAW = kTW + 2 * kR;
  static constexpr int kAH = kTH + 2 * kR;
  static constexpr int kGW = kTW + 2 * kHalf;  // gradient region
  static constexpr int kGH = kTH + 2 * kHalf;
  static constexpr int kPlane = kGH * kPitch;
  // The raw frames are staged where ix and iy go (and past them).
  static constexpr int kFloats =
      kAH * kAW + (3 * kPlane > kPlane + 2 * kAH * kAW ? 3 * kPlane : kPlane + 2 * kAH * kAW);
  static_assert(kGW <= kPitch, "gradient rows fit the pitch");
  static_assert(kStripRows + kWindow - 1 <= 8 * kKT, "vertical k-steps cover the window");
};

// f32 -> TF32, rounded to nearest with ties away from zero, as a 32-bit
// operand: cvt.rna.tf32.f32's result for every finite x, in two integer
// operations (ptxas emits four for the cvt, with a NaN test this data
// never needs): half of the dropped 13 bits' place added to the magnitude,
// then those bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x's exact three-way TF32 split: hi, mid, lo.
__device__ __forceinline__ void tf32_split(float x, uint32_t (&p)[3]) {
  const float hi = __uint_as_float(to_tf32(x));
  const float r = x - hi;
  const float mid = __uint_as_float(to_tf32(r));
  p[0] = __float_as_uint(hi);
  p[1] = __float_as_uint(mid);
  p[2] = __float_as_uint(r - mid);
}

constexpr uint32_t kOne = 0x3f800000u;  // 1.0f, exact in TF32

// d += a @ b, one m16n8k8 TF32 tile with an f32 accumulator. Fragments:
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
// b0 = B[t][g], b1 = B[t+4][g];
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three parts' sums, element i: (lo + mid) + hi.
__device__ __forceinline__ float combine(const float (&d)[3][4], int i) {
  return (d[2][i] + d[1][i]) + d[0][i];
}

// One gradient tile's three planes at this lane's B places: gradient rows
// kt*8 + t (j = 0) and kt*8 + t + 4 (j = 1) of the strip, one column.
struct Grads {
  float x[kKT][2], y[kKT][2], t[kKT][2];
};

// Loads a tile's gradients, zero at rows past the window or columns past
// the region (read at pixel 0 instead, so no lane branches). Rows kt*8 + 4
// .. kt*8 + 7 lie past the window in every lane when kt*8 + 4 >= the
// strip's rows (the last k-step at windows 3 and 5): not loaded at all.
template <int kWindow>
__device__ __forceinline__ void load_grads(const float* ix, const float* iy, const float* it,
                                           int row0, int col, bool col_ok, Grads& gr) {
  constexpr int kRows = kStripRows + kWindow - 1;  // gradient rows the strip reads
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = kt * 8 + 4 * j + t;
      const bool valid = kt * 8 + 4 * j < kRows && col_ok && k < kRows;
      const int at = valid ? (row0 + k) * kPitch + col : 0;
      gr.x[kt][j] = valid ? ix[at] : 0.0f;
      gr.y[kt][j] = valid ? iy[at] : 0.0f;
      gr.t[kt][j] = valid ? it[at] : 0.0f;
    }
}

// Product plane q (ix*ix, iy*iy, ix*iy, ix*it, iy*it) at one place.
__device__ __forceinline__ float product(const Grads& gr, int q, int kt, int j) {
  const float gx = gr.x[kt][j], gy = gr.y[kt][j], gt = gr.t[kt][j];
  return q == 0 ? gx * gx : q == 1 ? gy * gy : q == 2 ? gx * gy : q == 3 ? gx * gt : gy * gt;
}

// Vertical pass of plane q on one gradient tile: v = (Wv @ P_q) as this
// lane's accumulator fragment, the parts combined. `band` is Wv's A
// fragment at each k-step.
template <int kWindow>
__device__ __forceinline__ void vertical(const Grads& gr, int q, const uint32_t (&band)[kKT][4],
                                         float (&v)[4]) {
  constexpr int kRows = kStripRows + kWindow - 1;
  float d[3][4] = {};
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt) {
    uint32_t b0[3], b1[3] = {0u, 0u, 0u};
    tf32_split(product(gr, q, kt, 0), b0);
    if (kt * 8 + 4 < kRows) tf32_split(product(gr, q, kt, 1), b1);
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const uint32_t b[2] = {b0[part], b1[part]};
      mma_tf32(d[part], band[kt], b);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = combine(d, i);
}

// d[part] += (the vertical fragment v, as an A fragment in the permuted
// k-slots)[part] @ band for the three parts of v.
__device__ __forceinline__ void horizontal_step(float (&d)[3][4], const float (&v)[4],
                                                const uint32_t (&band)[2]) {
  uint32_t a[4][3];
  tf32_split(v[0], a[0]);  // A[g][slot t]       = rows[g][2t]
  tf32_split(v[2], a[1]);  // A[g+8][slot t]     = rows[g+8][2t]
  tf32_split(v[1], a[2]);  // A[g][slot t+4]     = rows[g][2t+1]
  tf32_split(v[3], a[3]);  // A[g+8][slot t+4]   = rows[g+8][2t+1]
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t ap[4] = {a[0][part], a[1][part], a[2][part], a[3][part]};
    mma_tf32(d[part], ap, band);
  }
}

template <int kWindow, bool kRelaxed, int kMode>
__global__ void __launch_bounds__(kThreads, 2) lk_mxu_kernel(const LkArgs args) {
  static_assert(kWindow == 3 || kWindow == 5 || kWindow == 7, "window 3/5/7");
  using T = Tile<kWindow>;
  constexpr int kHalf = T::kHalf, kR = T::kR, kAW = T::kAW, kAH = T::kAH;
  constexpr int kGW = T::kGW, kGH = T::kGH;

  extern __shared__ float smem[];
  float* avg_s = smem;                 // kAH x kAW
  float* it_s = smem + kAH * kAW;      // kGH x kPitch each
  float* ix_s = it_s + T::kPlane;
  float* iy_s = ix_s + T::kPlane;
  float* raw_p = ix_s;                 // kAH x kAW each, until the Sobel
  float* raw_c = ix_s + kAH * kAW;
  __shared__ float red_u[kWarps];  // refine only: one partial a warp
  __shared__ float red_v[kWarps];

  const int height = args.height, width = args.width;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const size_t plane = (size_t)blockIdx.z * height * width;
  const float* prev = args.prev + plane;
  const float* curr = args.curr + plane;

  // Stage the padded tile: avg over the whole halo, it over the gradient
  // region. avg_s[r][c] is image pixel (r0 + r - kR, c0 + c - kR), read
  // from the frames padded symmetric by one pixel and with zeros beyond.
  // The two frames are first copied as they are by 4-byte cp.async (zero
  // filled beyond the frame) into the space the gradient planes take
  // later, every copy in flight at once: each thread takes one or two
  // columns, its padded source column worked out once, and every
  // kStageRows-th row of them. Then avg and it are formed from the copies.
  constexpr int kStageRows = kThreads / 64;
  for (int c = tid % 64; c < kAW; c += 64) {
    int xs = c0 + c - kR;
    xs = xs == -1 ? 0 : xs == width ? width - 1 : xs;
    const bool x_ok = xs >= 0 && xs < width;
    for (int r = tid / 64; r < kAH; r += kStageRows) {
      int ys = r0 + r - kR;
      ys = ys == -1 ? 0 : ys == height ? height - 1 : ys;
      const bool ok = x_ok && ys >= 0 && ys < height;
      const size_t o = ok ? (size_t)ys * width + xs : 0;
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(raw_p + r * kAW + c));
      cp_async4(dst, prev + o, ok);
      cp_async4(dst + kAH * kAW * sizeof(float), curr + o, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int c = tid % 64; c < kAW; c += 64) {
    const bool it_col = c >= 1 && c < kAW - 1;
    for (int r = tid / 64; r < kAH; r += kStageRows) {
      const float p = raw_p[r * kAW + c], q = raw_c[r * kAW + c];
      avg_s[r * kAW + c] = (p + q) * 0.5f;
      if (it_col && r >= 1 && r < kAH - 1) it_s[(r - 1) * kPitch + c - 1] = p - q;
    }
  }
  __syncthreads();

  // Sobel over the gradient region; ix_s[g][h] is image pixel
  // (r0 + g - kHalf, c0 + h - kHalf), centred on avg_s[g + 1][h + 1]. The
  // walk's sobel() (lk_tile.cuh), so both kernels share one order.
  for (int k = tid; k < kGH * kGW; k += kThreads) {
    const int g = k / kGW, h = k % kGW;
    const float* a = avg_s + g * kAW + h;
    sobel<kRelaxed>(a[0], a[kAW], a[2 * kAW], a[1], a[2 * kAW + 1], a[2], a[kAW + 2],
                    a[2 * kAW + 2], ix_s[g * kPitch + h], iy_s[g * kPitch + h]);
  }
  __syncthreads();

  // Each warp's strip: output rows row0 .. row0 + 15 and columns col0 ..
  // col0 + 31 of the block; gradient rows row0 .. and columns col0 .. (the
  // gradient region starts kHalf before the first output).
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = (tid / 32) / 2 * kStripRows;
  const int col0 = (tid / 32) % 2 * kStripCols;

  // The bands depend only on the lane and the k-step. Vertical: Wv's A
  // fragment (output row i reads gradient rows i .. i + w - 1);
  // horizontal: Wh's B fragment in the permuted k-slots (slot t is tile
  // column 2t, slot t + 4 column 2t + 1), k-step 0 the tile's own row-sum
  // columns, k-step 1 the next tile's.
  uint32_t vband[kKT][4];
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt) {
    const int k0 = kt * 8 + t, k1 = k0 + 4;
    vband[kt][0] = (unsigned)(k0 - g) < (unsigned)kWindow ? kOne : 0u;
    vband[kt][1] = (unsigned)(k0 - g - 8) < (unsigned)kWindow ? kOne : 0u;
    vband[kt][2] = (unsigned)(k1 - g) < (unsigned)kWindow ? kOne : 0u;
    vband[kt][3] = (unsigned)(k1 - g - 8) < (unsigned)kWindow ? kOne : 0u;
  }
  uint32_t hband[2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int k0 = ks * 8 + 2 * t, k1 = k0 + 1;
    hband[ks][0] = (unsigned)(k0 - g) < (unsigned)kWindow ? kOne : 0u;
    hband[ks][1] = (unsigned)(k1 - g) < (unsigned)kWindow ? kOne : 0u;
  }

  bool frozen = false;
  if constexpr (kMode == kRefine) frozen = args.converged[blockIdx.z] != 0;
  float acc_u = 0.0f, acc_v = 0.0f;

  // v[q]: the current tile's vertical sums of plane q.
  float v[5][4];
  Grads gr;
  load_grads<kWindow>(ix_s, iy_s, it_s, row0, col0 + g, col0 + g < kGW, gr);
#pragma unroll
  for (int q = 0; q < 5; ++q) vertical<kWindow>(gr, q, vband, v[q]);
#pragma unroll
  for (int m = 0; m < kStripTiles; ++m) {
    const int col = col0 + 8 * (m + 1) + g;
    load_grads<kWindow>(ix_s, iy_s, it_s, row0, col, col < kGW, gr);
    // Plane by plane: the next tile's vertical sums, then the horizontal
    // pass on both tiles, which leaves this lane's four pixels of output
    // tile m in the accumulator's places.
    float s[5][4];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float next[4];
      vertical<kWindow>(gr, q, vband, next);
      float d[3][4] = {};
      horizontal_step(d, v[q], hband[0]);
      horizontal_step(d, next, hband[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[q][i] = combine(d, i);
        v[q][i] = next[i];
      }
    }

    // The solve and the mode's epilogue on this lane's four pixels (rows
    // y0 and y0 + 8, columns x and x + 1, x even), into registers; then
    // each row's two outputs are stored as one aligned float2 where the
    // width is even (a warp's store then fills whole 32-byte sectors),
    // else one by one.
    const int y0 = r0 + row0 + g;
    const int x = c0 + col0 + 8 * m + 2 * t;
    float u_out[4], v_out[4], det_out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = y0 + (i >= 2 ? 8 : 0), xi = x + (i & 1);
      const bool inside = y < height && xi < width;
      const float sums[5] = {s[0][i], s[1][i], s[2][i], s[3][i], s[4][i]};
      float u_in = 0.0f, v_in = 0.0f;
      if constexpr (kMode == kRefine) {
        if (inside) {
          u_in = args.u_in[plane + (size_t)y * width + xi];
          v_in = args.v_in[plane + (size_t)y * width + xi];
        }
      }
      solve_store<kHalf, kMode>(args, sums, y, xi, inside, frozen, args.max_disp_v,
                                u_in, v_in, &u_out[i],
                                &v_out[i], &det_out[i], acc_u, acc_v);
    }
    const bool pairs = (width & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + 8 * h;
      if (y >= height || x >= width) continue;
      const size_t o = plane + (size_t)y * width + x;
      if (pairs) {
        *reinterpret_cast<float2*>(args.u_out + o) = make_float2(u_out[2 * h], u_out[2 * h + 1]);
        *reinterpret_cast<float2*>(args.v_out + o) = make_float2(v_out[2 * h], v_out[2 * h + 1]);
        if constexpr (kMode == kFusedDet)
          *reinterpret_cast<float2*>(args.det_out + o) =
              make_float2(det_out[2 * h], det_out[2 * h + 1]);
      } else {
        args.u_out[o] = u_out[2 * h];
        args.v_out[o] = v_out[2 * h];
        if constexpr (kMode == kFusedDet) args.det_out[o] = det_out[2 * h];
        if (x + 1 < width) {
          args.u_out[o + 1] = u_out[2 * h + 1];
          args.v_out[o + 1] = v_out[2 * h + 1];
          if constexpr (kMode == kFusedDet) args.det_out[o + 1] = det_out[2 * h + 1];
        }
      }
    }
  }

  if constexpr (kMode == kRefine) {
    // A fixed order, so the early exit is reproducible: a shuffle tree in
    // each warp, then the warps' partials in turn.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_u += __shfl_xor_sync(0xffffffffu, acc_u, off);
      acc_v += __shfl_xor_sync(0xffffffffu, acc_v, off);
    }
    if (lane == 0) {
      red_u[tid / 32] = acc_u;
      red_v[tid / 32] = acc_v;
    }
    __syncthreads();
    if (tid == 0) {
      float su = red_u[0], sv = red_v[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        su += red_u[w];
        sv += red_v[w];
      }
      const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      args.part_du[b] = su;
      args.part_dv[b] = sv;
    }
  }
}

template <int kWindow, bool kRelaxed, int kMode>
int launch_mxu(const LkArgs& args, int batch, cudaStream_t stream) {
  static int opted[tpuflow_warp::kMaxDevices] = {};
  const auto kernel = lk_mxu_kernel<kWindow, kRelaxed, kMode>;
  const size_t smem = Tile<kWindow>::kFloats * sizeof(float);
  const cudaError_t err = tpuflow_warp::allow_smem(kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.width + kTW - 1) / kTW, (args.height + kTH - 1) / kTH, batch);
  kernel<<<grid, kThreads, smem, stream>>>(args);
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

// The mma.sync one batch element of a window_mxu call issues: each warp's
// strip takes kStripTiles + 1 vertical tiles of kKT k-steps and
// kStripTiles horizontal tiles of 2, each k-step 5 planes x 3 parts.
extern "C" long long tpuflow_lk_mxu_mma(int height, int width) {
  const long long per_strip = 15LL * ((kStripTiles + 1) * kKT + 2 * kStripTiles);
  return per_strip * kWarps * tpuflow_lk_refine_mxu_blocks(height, width);
}

// Bytes of dynamic shared memory a block takes at a window (0 for a window
// the kernel is not built for).
extern "C" int tpuflow_lk_mxu_smem(int window) {
  switch (window) {
    case 3: return Tile<3>::kFloats * (int)sizeof(float);
    case 5: return Tile<5>::kFloats * (int)sizeof(float);
    case 7: return Tile<7>::kFloats * (int)sizeof(float);
    default: return 0;
  }
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
