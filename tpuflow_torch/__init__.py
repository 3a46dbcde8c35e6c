"""tpuflow_torch — dense optical flow in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The PyTorch counterpart of ``tpuflow`` (JAX), module for module:

- ``tpuflow_torch.core``     configs and the SciPy-parity numerics.
- ``tpuflow_torch.kernels``  plain PyTorch reference functions, and the
                             CUDA kernels of the fast path with their plain
                             versions (``csrc/`` holds the sources).
- ``tpuflow_torch.flow``     single-scale and pyramidal flow:
                             ``backend="torch"`` (parity) and
                             ``backend="cuda"`` (fast path).
- ``tpuflow_torch.eval``     the 13-pattern verifier and its CLI
                             (``python -m tpuflow_torch.eval.verifier``),
                             and the stage profiler
                             (``python -m tpuflow_torch.eval.profile``).
- ``tpuflow_torch.ablation`` the two measurement microkernels (K8, K9).
- ``tpuflow_torch.convert``  configs and pyramids carried over from
                             ``tpuflow``.

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
