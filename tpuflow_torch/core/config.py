"""Pyramid / solver configuration.

Field-for-field counterpart of ``tpuflow.core.config``: the same
``PyramidConfig`` and the same nine named ``PYRAMID_CONFIGS``, so a
config chosen by name means the same solve in both packages. The fast
path here is ``backend="cuda"`` (the JAX package's ``"pallas"``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Static configuration for pyramidal Lucas-Kanade."""

    levels: int = 3
    window_size: int = 5
    iterations: int = 3
    scale_factor: float = 0.5
    # Early-exit threshold on the mean |residual| per component.
    convergence_threshold: float = 0.01
    # Texture gate on the structure-tensor determinant.
    det_threshold: float = 1e-4
    # Fast-path per-level flow saturation in pixels (the reference RTL's
    # +-8 px solver clamp). The parity path never clamps.
    max_disp: int = 8
    # Optional narrower vertical saturation band for the fast path;
    # None = max_disp.
    max_disp_v: int | None = None
    # Adaptive per-level vertical band (fast path / rtl_clamp only):
    # ascending candidate bands. At each level boundary the upsampled
    # coarse flow picks the narrowest band whose clamp would be inactive
    # on the masked interior; the coarsest level runs the full band.
    # None = static band (max_disp_v everywhere).
    adaptive_v_bands: tuple[int, ...] | None = None
    # A candidate band b is rejected if more than this fraction of
    # interior pixels carry |v| > b - 1.
    adaptive_v_frac: float = 0.005
    # Shift-tree (pairwise doubling) window sums and separable Sobel:
    # relaxed f32 summation order, own regression baseline.
    relaxed_order: bool = False
    # Finest-level warp decodes corners as whole 8-bit gray levels.
    # Correct only for frames with integer values in [0, 255].
    warp_packed_u8: bool = False
    # Warp corners quantized to 8.8 fixed point (step 1/256 gray) on the
    # levels packed_u8 does not serve. Values must lie in [0, 255].
    warp_packed_u16: bool = False
    description: str = ""

    def __post_init__(self):
        if self.adaptive_v_bands is not None:
            bands = tuple(int(b) for b in self.adaptive_v_bands)
            if len(bands) < 2 or list(bands) != sorted(set(bands)):
                raise ValueError(
                    f"adaptive_v_bands must be >=2 strictly ascending ints, got {bands}"
                )
            if bands[-1] > self.max_disp:
                raise ValueError(
                    f"adaptive_v_bands max {bands[-1]} exceeds max_disp {self.max_disp}"
                )
            object.__setattr__(self, "adaptive_v_bands", bands)

    @property
    def max_disp_v_effective(self) -> int:
        return self.max_disp if self.max_disp_v is None else self.max_disp_v


PYRAMID_CONFIGS: dict[str, PyramidConfig] = {
    "default": PyramidConfig(
        levels=3, window_size=5, iterations=3,
        description="3-level pyramid, 5x5 window, 3 iterations/level",
    ),
    "shallow": PyramidConfig(
        levels=2, window_size=5, iterations=3,
        description="2-level pyramid (faster, less memory)",
    ),
    "deep": PyramidConfig(
        levels=4, window_size=5, iterations=3,
        description="4-level pyramid (handles larger motion)",
    ),
    "large_window": PyramidConfig(
        levels=3, window_size=7, iterations=3,
        description="3-level pyramid, 7x7 window",
    ),
    "narrow_vertical": PyramidConfig(
        levels=3, window_size=5, iterations=3, max_disp_v=3,
        description="3-level pyramid, vertical flow band narrowed to +-3 px",
    ),
    "adaptive_vertical": PyramidConfig(
        levels=3, window_size=5, iterations=3, adaptive_v_bands=(3, 8),
        description="3-level pyramid, per-level vertical band selected "
        "from the coarse solve (3 or 8 px)",
    ),
    "relaxed_order": PyramidConfig(
        levels=3, window_size=5, iterations=3, relaxed_order=True,
        description="3-level pyramid, shift-tree window sums "
        "(relaxed f32 summation order)",
    ),
    # The serving path: band ladder (2, 3, 8) + relaxed-order refine +
    # packed-u8 finest / packed-u16 coarse warp (8-bit input contract).
    "production": PyramidConfig(
        levels=3, window_size=5, iterations=3, adaptive_v_bands=(2, 3, 8),
        relaxed_order=True, warp_packed_u8=True, warp_packed_u16=True,
        description="adaptive vertical band + relaxed-order kernels + "
        "packed-u8 finest / packed-u16 coarse warp (8-bit input contract)",
    ),
    "production_fullband": PyramidConfig(
        levels=3, window_size=5, iterations=3,
        relaxed_order=True, warp_packed_u8=True, warp_packed_u16=True,
        description="static full-band production kernels (worst-case-"
        "bounded serving latency; 8-bit input contract)",
    ),
}
