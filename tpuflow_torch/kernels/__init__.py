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

import weakref

from tpuflow_torch.kernels import fixed_point, imu, lk, seed, warp
from tpuflow_torch.kernels.torch_ref import (
    build_gaussian_pyramid,
    compute_gradients,
    lucas_kanade_from_gradients,
    upsample_flow,
    warp_image,
)


_COUNTS = (warp.launch_counts, lk.launch_counts, seed.launch_counts, imu.launch_counts)
_REPLAYED: weakref.WeakSet = weakref.WeakSet()


class ReplayCounter:
    """The launches a CUDA graph's capture recorded and the graph's replays
    since the last reset: a replay adds one to ``replays`` and
    ``launch_counts`` adds ``launches`` times ``replays`` when it is read.
    A counter that is freed folds its replays into the counters."""

    __slots__ = ("launches", "replays", "__weakref__")

    def __init__(self, launches: dict[str, int]) -> None:
        self.launches = launches
        self.replays = 0
        _REPLAYED.add(self)

    def __del__(self) -> None:
        if self.replays:
            add_launch_counts({name: n * self.replays for name, n in self.launches.items()})


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    out = {name: n for counts in _COUNTS for name, n in counts.items()}
    for counter in list(_REPLAYED):
        for name, n in counter.launches.items():
            out[name] += n * counter.replays
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0
    for counter in list(_REPLAYED):
        counter.replays = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add launches made without their wrappers (a capture takes the
    launches it recorded back off: it runs nothing)."""
    for name, n in delta.items():
        next(counts for counts in _COUNTS if name in counts)[name] += n


__all__ = [
    "ReplayCounter",
    "add_launch_counts",
    "build_gaussian_pyramid",
    "compute_gradients",
    "launch_counts",
    "lucas_kanade_from_gradients",
    "reset_launch_counts",
    "upsample_flow",
    "warp_image",
]
