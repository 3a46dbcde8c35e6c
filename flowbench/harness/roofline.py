"""The bound of the flow's round kernels: a frozen copy of the bytes model
of ``tpuflow_torch/eval/bounds.py``, at each pyramid level's plane size.

One running round of one plane is a warp (16 B a pixel: the image, u and
v in, the warped image out) and a refine (24 B a pixel: prev, warped, u
and v in, u and v out), each input read once and each output written
once, over the card's memory rate. A skipped round needs no bytes: its
time counts and its bound does not. Bound by bytes: a round's ~120 f32
operations a pixel take less time at the card's f32 rate than its 40
bytes take at its memory rate.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, HBM3 (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
WARP_BYTES_PER_PIXEL = 16
REFINE_BYTES_PER_PIXEL = 24


def level_shapes(height: int, width: int, levels: int, scale: float) -> list[tuple[int, int]]:
    """The pyramid's plane sizes, coarsest first."""
    shapes = [(height, width)]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append((int(h * scale), int(w * scale)))
    return shapes[::-1]


def round_bytes(shape: tuple[int, int]) -> int:
    return (WARP_BYTES_PER_PIXEL + REFINE_BYTES_PER_PIXEL) * shape[0] * shape[1]


def bound_s(rounds: np.ndarray, shapes: list[tuple[int, int]]) -> float:
    """Seconds the running rounds need at the memory rate: ``rounds`` the
    rounds each element ran at each level ((..., levels), summed over
    steps), ``shapes`` the levels' planes, coarsest first."""
    per_level = np.asarray(rounds, dtype=np.float64).reshape(-1, len(shapes)).sum(axis=0)
    return float(sum(n * round_bytes(s) for n, s in zip(per_level, shapes)) / HBM_BYTES_PER_S)
