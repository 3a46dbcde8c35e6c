from tpuflow_torch.core.config import PyramidConfig, PYRAMID_CONFIGS
from tpuflow_torch.core.ops import (
    conv2d_symm,
    gaussian_kernel1d,
    gaussian_filter,
    map_coordinates_bilinear,
)

__all__ = [
    "PyramidConfig",
    "PYRAMID_CONFIGS",
    "conv2d_symm",
    "gaussian_kernel1d",
    "gaussian_filter",
    "map_coordinates_bilinear",
]
