from tpuflow_torch.flow.single_scale import lucas_kanade_single_scale
from tpuflow_torch.flow.pyramidal import (
    lucas_kanade_pyramidal,
    lucas_kanade_pyramidal_from_pyramids,
    lucas_kanade_pyramidal_step,
)
from tpuflow_torch.flow.graphed import GraphedStream, TiledGraphedStream

__all__ = [
    "GraphedStream",
    "TiledGraphedStream",
    "lucas_kanade_single_scale",
    "lucas_kanade_pyramidal",
    "lucas_kanade_pyramidal_from_pyramids",
    "lucas_kanade_pyramidal_step",
]
