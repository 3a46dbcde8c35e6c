"""The mesh teardown order (``sharding.mesh``): ``release_mesh`` closes
every graph holder registered on a mesh before it destroys the mesh's
process groups, once; a released mesh takes no new holder. On the CPU over
gloo at world size 1, in this process (on four cards the hang it avoids is
witnessed by ``python -m tpuflow_torch.ablation.teardown``)."""

import pytest
import torch
import torch.distributed as dist

from tpuflow_torch.sharding import initialize_multihost, make_flow_mesh, release_mesh
from tpuflow_torch.sharding import mesh as mesh_module

torch.set_num_threads(1)


class Holder:
    """Stands for a graphed stream: records its close and what was alive."""

    def __init__(self, log: list, mesh) -> None:
        self.log, self.mesh = log, mesh
        self.closed = False

    def close(self) -> None:
        self.closed = True
        # The mesh's groups are still there when a graph is closed.
        self.log.append(dist.get_world_size(self.mesh.group))


@pytest.fixture
def gloo_world(tmp_path):
    initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("meshes", [1, 3])
def test_release_closes_graphs_then_destroys_groups(gloo_world, meshes):
    made = [make_flow_mesh(1, 1, 1, device="cpu") for _ in range(meshes)]
    log: list = []
    holders = [Holder(log, m) for m in made for _ in range(2)]
    for h in holders:
        mesh_module.hold_graph(h.mesh, h)
    groups = [(m.group, m.spatial) for m in made]
    for m in made:
        release_mesh(m)
        release_mesh(m)  # a second call does nothing
    assert all(h.closed for h in holders) and log == [1] * len(holders)
    for group, spatial in groups:
        for g in (group, spatial):
            with pytest.raises(ValueError, match="not initialized"):
                dist.get_backend(g)
    with pytest.raises(ValueError, match="released"):
        mesh_module.hold_graph(made[0], Holder(log, made[0]))
    # The world is still there for the fixture's destroy.
    dist.all_reduce(torch.zeros(1))
