"""tpuflow_torch — dense optical flow in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The PyTorch counterpart of ``tpuflow`` (JAX), module for module:

- ``tpuflow_torch.core``     configs and the SciPy-parity numerics.
- ``tpuflow_torch.kernels``  plain PyTorch reference functions, the
                             CUDA kernels of the fast path with their plain
                             versions (``csrc/`` holds the sources), and the
                             S8.7 integer datapath (``fixed_point``).
- ``tpuflow_torch.flow``     single-scale and pyramidal flow:
                             ``backend="torch"`` (parity) and
                             ``backend="cuda"`` (fast path, no host
                             read; ``GraphedStream`` replays its step as
                             a CUDA graph on the card), and the flow
                             CLI (``python -m tpuflow_torch.flow``: frame
                             pairs, streams and the S8.7 ``rtl`` mode).
- ``tpuflow_torch.vo``       visual odometry: tracking, the front end on
                             the device, bundle adjustment, essential-matrix
                             initialization, ``OdometrySession`` (with
                             ``compact`` and checkpoint/resume),
                             ``run_odometry``, the chunked pose-graph
                             pipeline with loop closure, IMU and
                             visual-inertial refinement, and the VO CLI
                             (``python -m tpuflow_torch.vo``).
- ``tpuflow_torch.io``       frame, IMU and video readers and the frame
                             converter (numpy copies of ``tpuflow.io``'s),
                             and the frame stream with its uploads to the
                             card (``io.stream``).
- ``tpuflow_torch.eval``     the 13-pattern verifier and its CLI
                             (``python -m tpuflow_torch.eval.verifier``),
                             the VO trajectory verifier
                             (``python -m tpuflow_torch.eval.vo_verifier``),
                             the stage profilers (``eval.profile``,
                             ``eval.profile_vo``), the natural-frame
                             generator (``eval.natural``) and the plots
                             (``eval.visualize``, matplotlib optional).
- ``tpuflow_torch.ablation`` the two measurement microkernels (K8, K9).
- ``tpuflow_torch.convert``  configs, pyramids and VO state (front-end
                             state, bundle-adjustment problems, pose graphs,
                             IMU increments, whole sessions) carried over
                             from ``tpuflow``.

Importing the package neither imports ``jax`` nor builds a kernel: the
CUDA library is compiled by ``nvcc`` at the first kernel launch.
"""

__version__ = "0.1.0"

from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.flow.pyramidal import (
    lucas_kanade_pyramidal,
    lucas_kanade_pyramidal_from_pyramids,
    lucas_kanade_pyramidal_step,
)
from tpuflow_torch.flow.single_scale import lucas_kanade_single_scale

__all__ = [
    "PYRAMID_CONFIGS",
    "PyramidConfig",
    "lucas_kanade_single_scale",
    "lucas_kanade_pyramidal",
    "lucas_kanade_pyramidal_from_pyramids",
    "lucas_kanade_pyramidal_step",
    "__version__",
]
