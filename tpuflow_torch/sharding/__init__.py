"""Tiled flow over a process mesh (``torch.distributed``): the counterpart
of ``tpuflow.sharding``. One rank per tile; NCCL between cards, gloo
between processes on one card or on the CPU."""

from tpuflow_torch.sharding.halo import exchange_halo_2d
from tpuflow_torch.sharding.mesh import initialize_multihost, make_flow_mesh, release_mesh
from tpuflow_torch.sharding.tiled_flow import tiled_lucas_kanade_single_scale
from tpuflow_torch.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal

__all__ = [
    "make_flow_mesh",
    "exchange_halo_2d",
    "tiled_lucas_kanade_single_scale",
    "tiled_lucas_kanade_pyramidal",
    "initialize_multihost",
    "release_mesh",
]
