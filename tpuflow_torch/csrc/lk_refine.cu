// Fused Lucas-Kanade refinement step on Hopper (sm_90a): residual LK on
// (prev, warped), the clip of the carried flow, the convergence-latched
// accumulate and the per-block sums of |du|, |dv| for the early exit.
//
// Replaces tpuflow/kernels/pallas_lk.py::_refine_batched (pallas_call at
// :573) -> _lk_refine_kernel -> _lk_tile, windows 3, 5 and 7:
//   relaxed = 1: relaxed_order=True, separable Sobel and shift-tree sums (K3);
//   relaxed = 0: relaxed_order=False, direct Sobel and sequential sums (K5).
// The column-walk kernel, what it computes and its design are in
// lk_tile.cuh. One launch covers a batch of `batch` elements (blockIdx.z),
// each with its own converged flag. The wrapper adds each element's
// per-block partials with torch.sum, as XLA adds the TPU kernel's per-tile
// partials (pallas_lk.py:606-607). The window_mxu variant (K10) is in lk_mxu.cu.
// tpuflow_lk_refine_round is the same kernel as one round of the pyramidal
// driver under device control: the skip, the band and the sums, latch and
// round count in the kernel (lk_tile.cuh).

#include "lk_tile.cuh"

using namespace tpuflow_lk;

// Number of per-block partial sums of one batch element at a window
// (part_du and part_dv hold batch times as many).
extern "C" int tpuflow_lk_refine_blocks(int height, int width, int window) {
  return num_blocks(height, width, window);
}

// Threads of the column walk's block, which share a round's final sum.
extern "C" int tpuflow_lk_walk_threads() { return kWalkThreads; }

extern "C" int tpuflow_lk_refine(const float* prev, const float* warped,
                                 const float* u_in, const float* v_in,
                                 const void* converged, float* u_out,
                                 float* v_out, float* part_du, float* part_dv,
                                 int batch, int height, int width, int window,
                                 int relaxed, float det_threshold,
                                 float max_disp, float max_disp_v,
                                 void* stream) {
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
  if (relaxed) return launch_window<true, kUniform, kRefine>(window, args, batch, s);
  return launch_window<false, kUniform, kRefine>(window, args, batch, s);
}

// One round under device control. ctrl holds the int32 latch, ticket and
// round count of each of the `batch` elements (3 x batch, the tickets 0
// between launches); band (or null: ladder[0]) indexes the ladder of
// vertical bands, n_band indices: 1 (every element's) or `batch` (one an
// element); sums receives (2, batch) sum|du|, sum|dv|.
extern "C" int tpuflow_lk_refine_round(const float* prev, const float* warped,
                                       const float* u_in, const float* v_in, int* ctrl,
                                       const int* band, int n_band, const float* ladder,
                                       int n_ladder, float* u_out, float* v_out,
                                       float* part_du, float* part_dv, float* sums, int batch,
                                       int height, int width, int window, int relaxed,
                                       float det_threshold, float max_disp, float thr,
                                       void* stream) {
  if (n_ladder < 1 || n_ladder > kMaxLadder || (band == nullptr && n_ladder != 1) ||
      (band != nullptr && n_band != 1 && n_band != batch))
    return (int)cudaErrorInvalidValue;
  LkArgs args{};
  args.prev = prev;
  args.curr = warped;
  args.u_in = u_in;
  args.v_in = v_in;
  args.u_out = u_out;
  args.v_out = v_out;
  args.part_du = part_du;
  args.part_dv = part_dv;
  args.height = height;
  args.width = width;
  args.det_threshold = det_threshold;
  args.max_disp = max_disp;
  args.max_disp_v = ladder[0];
  args.ctrl = ctrl;
  args.band = band;
  args.band_stride = n_band > 1 ? 1 : 0;
  for (int i = 0; i < n_ladder; ++i) args.ladder[i] = ladder[i];
  args.n_ladder = n_ladder;
  args.sums = sums;
  args.thr = thr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relaxed) return launch_window<true, kUniform, kRefine>(window, args, batch, s);
  return launch_window<false, kUniform, kRefine>(window, args, batch, s);
}
