"""Kernels of the flow path and their plain PyTorch versions.

``torch_ref`` holds the parity-path functions (counterpart of
``tpuflow.kernels.jnp_ref``). ``warp`` (K1, K2, K4) and ``lk`` (K3, K5, K6,
K7, and K10 with ``window_mxu``) hold the hand-written CUDA kernels'
wrappers, their plain PyTorch versions and their launch counters; each
takes one (H, W) plane or a (B, H, W) batch. ``seed`` (the VO front end's
grid seed, gated on a predicate in device memory) and ``imu`` (IMU
preintegration's recursion as one scan) hold the port's two kernels with
no Pallas counterpart, the reference's ``lax.cond`` and ``lax.scan`` on the
card. ``fixed_point`` is the S8.7
integer datapath as torch int32 ops (no kernel of its own). Nothing here
builds or loads the CUDA library at import.
"""

from tpuflow_torch.kernels import fixed_point, imu, lk, seed, warp
from tpuflow_torch.kernels.torch_ref import (
    build_gaussian_pyramid,
    compute_gradients,
    lucas_kanade_from_gradients,
    upsample_flow,
    warp_image,
)


_COUNTS = (warp.launch_counts, lk.launch_counts, seed.launch_counts, imu.launch_counts)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add launches made without their wrappers: a CUDA graph's replay
    adds the launches its capture recorded."""
    for name, n in delta.items():
        next(counts for counts in _COUNTS if name in counts)[name] += n


__all__ = [
    "add_launch_counts",
    "build_gaussian_pyramid",
    "compute_gradients",
    "launch_counts",
    "lucas_kanade_from_gradients",
    "reset_launch_counts",
    "upsample_flow",
    "warp_image",
]
