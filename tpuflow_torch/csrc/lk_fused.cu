// Fused single-scale Lucas-Kanade on Hopper (sm_90a): (prev, curr) ->
// (u, v), and optionally the |det| confidence plane.
//
// Replaces tpuflow/kernels/pallas_lk.py::_fused_batched (pallas_call at
// :460) -> _lk_kernel (:314, K6) or _lk_conf_kernel (:331, K7) -> _lk_tile,
// windows 3, 5 and 7, in exact or relaxed order, with uniform window sums
// or the separable Gaussian taps of _window_taps (:388-397), which the
// wrapper computes and passes as f32 values. One launch covers a batch of
// `batch` elements (blockIdx.z). The column-walk kernel, what it computes
// and its design are in lk_tile.cuh. The window_mxu variant (K10) is in
// lk_mxu.cu.
//
// tpuflow_lk_fused_tile_round is K6 as one round of the tiled pyramidal
// path under device control, the body of the reference's sharded
// lax.while_loop from the fused solve through the guarded add
// (tpuflow/sharding/tiled_pyramidal.py:176-212, :309-310): the same walk
// on the halo-extended tile, its crop's flow brought through the walk's
// cp.async ring and added in place, and sum|du|, sum|dv| finished by the
// element's last block for the tiled loop to reduce across the mesh; one
// launch a round. It is bound by device memory: 8 B a pixel of the
// extended tile and 16 B a pixel of its crop. lk_tile.cuh says what the
// design does about it.

#include "lk_tile.cuh"

using namespace tpuflow_lk;

namespace {

__global__ void __launch_bounds__(kWalkThreads) walk_empty_kernel() {}

template <bool kRelaxed, int kSum>
int launch_mode(int window, bool with_det, const LkArgs& args, int batch,
                cudaStream_t s) {
  if (with_det) return launch_window<kRelaxed, kSum, kFusedDet>(window, args, batch, s);
  return launch_window<kRelaxed, kSum, kFused>(window, args, batch, s);
}

}  // namespace

// taps: host pointer to `window` f32 weights, or null for the uniform
// window. det_out: null unless the |det| plane is wanted.
extern "C" int tpuflow_lk_fused(const float* prev, const float* curr,
                                float* u_out, float* v_out, float* det_out,
                                int batch, int height, int width, int window,
                                int relaxed, const float* taps,
                                float det_threshold, void* stream) {
  if (window < 3 || window > kMaxWindow) return (int)cudaErrorInvalidValue;
  LkArgs args{};
  args.prev = prev;
  args.curr = curr;
  args.u_out = u_out;
  args.v_out = v_out;
  args.det_out = det_out;
  args.height = height;
  args.width = width;
  args.det_threshold = det_threshold;
  if (taps != nullptr) {
    for (int d = 0; d < window; ++d) args.taps.t[d] = taps[d];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_det = det_out != nullptr;
  if (taps != nullptr) {
    if (relaxed) return launch_mode<true, kGaussian>(window, with_det, args, batch, s);
    return launch_mode<false, kGaussian>(window, with_det, args, batch, s);
  }
  if (relaxed) return launch_mode<true, kUniform>(window, with_det, args, batch, s);
  return launch_mode<false, kUniform>(window, with_det, args, batch, s);
}

// Block partials of one element of the tile round on a (height, width)
// extended tile, and the output rows each block walks.
extern "C" int tpuflow_lk_tile_round_blocks(int height, int width, int window) {
  return num_blocks<kTileRound>(height, width, window);
}

extern "C" int tpuflow_lk_tile_round_rows(int height, int width, int window) {
  return tile_round_rows(height, width, window);
}

// An empty kernel on the tile round's grid and block: what launching the
// grid costs, beside a skipped round.
extern "C" int tpuflow_lk_tile_round_empty(int batch, int height, int width, int window,
                                           void* stream) {
  if (batch < 1 || batch > kMaxBatch || window < 3 || window > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const dim3 grid =
      walk_grid(height, width, window, tile_round_rows(height, width, window), batch);
  walk_empty_kernel<<<grid, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// One round of the tiled path on `batch` halo-extended tiles of (height,
// width), each extended by `crop` px on every side: u and v are the tiles'
// (height - 2 crop, width - 2 crop) flow planes, updated in place where the
// element's latch (ctrl row 0) is clear; part_du, part_dv receive one
// partial sum a block (tpuflow_lk_tile_round_blocks(height, width, window)
// an element) and sums the (2, batch) sum|du|, sum|dv| of a running
// element, added in the kernel; ctrl row 1 is the ticket (0 between
// launches), row 2 counts the rounds run. (gy0, gx0) is the crop's global
// origin and (gh, gw) the level's global shape.
extern "C" int tpuflow_lk_fused_tile_round(const float* prev_ext, const float* warped_ext,
                                           float* u, float* v, int* ctrl, float* part_du,
                                           float* part_dv, float* sums, int batch, int height,
                                           int width, int crop, int gy0, int gx0, int gh,
                                           int gw, int window, int relaxed,
                                           float det_threshold, void* stream) {
  if (window < 3 || window > kMaxWindow || crop < window / 2 || height <= 2 * crop ||
      width <= 2 * crop)
    return (int)cudaErrorInvalidValue;
  LkArgs args{};
  args.prev = prev_ext;
  args.curr = warped_ext;
  args.u_out = u;
  args.v_out = v;
  args.part_du = part_du;
  args.part_dv = part_dv;
  args.sums = sums;
  args.height = height;
  args.width = width;
  args.det_threshold = det_threshold;
  args.ctrl = ctrl;
  args.crop = crop;
  args.tile_h = height - 2 * crop;
  args.tile_w = width - 2 * crop;
  args.gy0 = gy0;
  args.gx0 = gx0;
  args.gh = gh;
  args.gw = gw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relaxed) return launch_window<true, kUniform, kTileRound>(window, args, batch, s);
  return launch_window<false, kUniform, kTileRound>(window, args, batch, s);
}
