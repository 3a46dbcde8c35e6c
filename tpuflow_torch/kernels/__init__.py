"""Kernels of the flow path and their plain PyTorch versions.

``torch_ref`` holds the parity-path functions (counterpart of
``tpuflow.kernels.jnp_ref``). ``warp`` and ``lk`` each hold one hand-written
CUDA kernel's wrapper, its plain PyTorch version and its launch counter.
Nothing here builds or loads the CUDA library at import.
"""

from tpuflow_torch.kernels import lk, warp
from tpuflow_torch.kernels.torch_ref import (
    build_gaussian_pyramid,
    compute_gradients,
    lucas_kanade_from_gradients,
    upsample_flow,
    warp_image,
)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {**warp.launch_counts, **lk.launch_counts}


def reset_launch_counts() -> None:
    for counts in (warp.launch_counts, lk.launch_counts):
        for name in counts:
            counts[name] = 0


__all__ = [
    "build_gaussian_pyramid",
    "compute_gradients",
    "launch_counts",
    "lucas_kanade_from_gradients",
    "reset_launch_counts",
    "upsample_flow",
    "warp_image",
]
