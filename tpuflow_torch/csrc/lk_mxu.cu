// Lucas-Kanade with the window sums as banded-ones products on the tensor
// cores (K10), on Hopper (sm_90a): the refine step and the fused
// single-scale solve, with or without the |det| plane.
//
// Replaces tpuflow/kernels/pallas_lk.py::_wsum_mxu (:139-186), the
// window_mxu branch of _lk_tile (:258-259) as reached by _refine_batched
// (pallas_call at :573) and _fused_batched (pallas_call at :460). The
// Sobel form follows `relaxed`; the window is uniform (Gaussian taps take
// precedence over window_mxu, so the wrapper launches lk_fused.cu's
// kernel for them). The tile kernel and the tensor-core order are in
// lk_tile.cuh (kSum == kMxu). Bound, like K3/K6: shared memory, not DRAM;
// the question this kernel answers is whether mma.sync window sums beat
// the shift tree's shared-memory adds.

#include "lk_tile.cuh"

using namespace tpuflow_lk;

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
  if (relaxed) return launch_window<true, kMxu, kRefine>(window, args, batch, s);
  return launch_window<false, kMxu, kRefine>(window, args, batch, s);
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
    if (relaxed) return launch_window<true, kMxu, kFusedDet>(window, args, batch, s);
    return launch_window<false, kMxu, kFusedDet>(window, args, batch, s);
  }
  if (relaxed) return launch_window<true, kMxu, kFused>(window, args, batch, s);
  return launch_window<false, kMxu, kFused>(window, args, batch, s);
}
