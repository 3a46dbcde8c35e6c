"""The tiled path's static plans above 1080p, against ``tpuflow.sharding``.

``_level_shapes`` (the pyramid's global level dims) and ``_shard_plan``
(which levels run tiled) are pure functions of the frame size, the
config's levels and scale, the mesh's ("ty", "tx") and the warp halo
(``max_disp + 1``), so the port's must equal the reference's exactly, at
1080p, 4K, 5K and 8K, on every mesh the port runs or the reference names
(``tpuflow/sharding/tiled_pyramidal.py``: up to (4, 4) at 4K), for every
named config. No Pallas call is made.
"""

import pytest
import torch

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.sharding import tiled_pyramidal as jtp
from tpuflow_torch import PYRAMID_CONFIGS
from tpuflow_torch.sharding import tiled_pyramidal as tp

torch.set_num_threads(1)

SIZES = {"1080p": (1080, 1920), "4K": (2160, 3840), "5K": (2880, 5120), "8K": (4320, 7680)}
MESHES = {"1x1x1": (1, 1, 1), "1x2x2": (1, 2, 2), "1x4x1": (1, 4, 1), "1x1x4": (1, 1, 4),
          "2x1x2": (2, 1, 2), "1x2x4": (1, 2, 4), "1x4x4": (1, 4, 4)}
# Plans stated by hand where the design turns on them: at 1080p on 1x4x1
# the coarsest level (270 rows, 270 % 4 != 0) is replicated and gathered
# once; at 4K every level of every 4-rank mesh is tiled (540 / 4 = 135).
EXPECTED = {
    ("1080p", "1x4x1", "default"): [False, True, True],
    ("1080p", "1x4x1", "production_fullband"): [False, True, True],
    ("1080p", "1x2x2", "default"): [True, True, True],
    ("4K", "1x4x1", "default"): [True, True, True],
    ("4K", "1x4x1", "production_fullband"): [True, True, True],
    ("4K", "1x2x2", "default"): [True, True, True],
    ("4K", "2x1x2", "default"): [True, True, True],
    ("4K", "1x1x1", "production_fullband"): [True, True, True],
}


@pytest.mark.parametrize("config", list(PYRAMID_CONFIGS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", list(SIZES))
def test_level_shapes_and_shard_plan_match_the_reference(size, mesh, config):
    gh, gw = SIZES[size]
    _, ty, tx = MESHES[mesh]
    cfg, jcfg = PYRAMID_CONFIGS[config], JAX_CONFIGS[config]
    assert (cfg.levels, cfg.scale_factor, cfg.max_disp) == (jcfg.levels, jcfg.scale_factor,
                                                            jcfg.max_disp)
    dims = tp._level_shapes(gh, gw, cfg.levels, cfg.scale_factor)
    assert dims == jtp._level_shapes(gh, gw, jcfg.levels, jcfg.scale_factor)
    assert dims[-1] == (gh, gw) and len(dims) == cfg.levels
    halo = cfg.max_disp + 1
    plan = tp._shard_plan(dims, ty, tx, halo)
    assert plan == jtp._shard_plan(dims, ty, tx, jcfg.max_disp + 1)
    if (size, mesh, config) in EXPECTED:
        assert plan == EXPECTED[(size, mesh, config)]
    # A tiled level's tile exceeds twice the warp halo and divides the mesh.
    for (h, w), tiled in zip(dims, plan):
        if tiled:
            assert h % ty == 0 and w % tx == 0 and h // ty > 2 * halo and w // tx > 2 * halo
