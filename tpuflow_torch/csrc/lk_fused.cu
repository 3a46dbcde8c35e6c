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

#include "lk_tile.cuh"

using namespace tpuflow_lk;

namespace {

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
