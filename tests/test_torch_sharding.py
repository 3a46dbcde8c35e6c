"""The port's tiled flow (``tpuflow_torch.sharding``) against
``tpuflow.sharding`` on the CPU: the cases of tests/test_sharding.py.

The JAX side runs here on the conftest's virtual 8-device CPU mesh. The
port runs in 4 gloo worker processes on the CPU (tests/mesh_harness.py,
tests/torch_mesh_worker.py), started once per tiling for the whole module;
each case below reads its results from every rank.

Limits:
- the halo exchange equals ``np.pad`` exactly (symmetric and zero fill);
- tiled single scale within 1e-4 px of the JAX tiled path and of the
  port's untiled path (the reference holds its tiled path to its untiled
  one at 1e-4);
- tiled pyramidal within 1e-3 px of the port's untiled ``rtl_clamp`` path
  (divergence g: the tiled warp's tile-local coordinates round otherwise
  than the global ones), and p99.9 within 2e-3 px of the JAX tiled path,
  the limit tests/test_torch_pyramidal.py holds between the packages at
  the finest level; ``backend="cuda"`` (the kernels' plain versions here)
  within 1e-3 px of JAX's ``backend="pallas"`` in interpret mode;
- the fused LK solve on halo-extended tiles within 1e-5 px of the whole
  frame's (the reference's geometry test);
- the tiled pyramid operators within 1e-3 (downsample, 0..255 data) and
  1e-4 (flow upsample) of the untiled ones, as the reference holds them
  (divergence f: per-rank operator slices against banded blocks).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.ndimage import gaussian_filter, shift

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.core.config import PyramidConfig as JaxPyramidConfig
from tpuflow.sharding import make_flow_mesh as jax_mesh
from tpuflow.sharding import tiled_lucas_kanade_single_scale as jax_tiled_single
from tpuflow.sharding import tiled_pyramidal as jtp
from tpuflow_torch.core import ops
from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.flow import lucas_kanade_pyramidal, lucas_kanade_single_scale
from tpuflow_torch.kernels import lk, torch_ref
from tpuflow_torch.sharding import tiled_pyramidal as tp
from tpuflow_torch.sharding.mesh import check_one_rank_per_card

sys.path.insert(0, str(Path(__file__).parent))
from mesh_harness import run_ranks  # noqa: E402

TILINGS = {"1x2x2": (1, 2, 2), "2x1x2": (2, 1, 2), "1x4x1": (1, 4, 1)}
# The pyramidal frames: the finest level tiles, and the coarse ones run
# replicated after one gather (at 1x4x1 two levels tile).
PYR_SHAPE = {"1x2x2": (48, 64), "2x1x2": (48, 64), "1x4x1": (192, 64)}
CASES = {
    "1x2x2": ["mesh", "halo", "single", "bad_tiling", "pyr_torch", "pyr_cuda", "narrow",
              "fully", "down_up"],
    "2x1x2": ["single", "pyr_torch", "fully"],
    "1x4x1": ["single", "pyr_torch", "fully"],
}
PYR_CFG = dict(levels=3, window_size=5, iterations=2)
CUDA_CFG = dict(levels=2, iterations=2)
NARROW_CFG = dict(levels=3, window_size=5, iterations=2, max_disp_v=3)
FULLY_CFG = dict(levels=3, window_size=5, iterations=2, max_disp=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as the other port test files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(rng, n, shape, moves):
    prev, curr = [], []
    for i in range(n):
        base = gaussian_filter(rng.uniform(0, 255, shape).astype(np.float32), 2.0)
        base = base.astype(np.float32)
        dy, dx = moves(i)
        prev.append(base)
        curr.append(shift(base, (dy, dx), order=1, mode="constant").astype(np.float32))
    return np.stack(prev), np.stack(curr)


def _inputs(name: str) -> dict:
    """Every case's inputs for one tiling, from a seed."""
    batch = TILINGS[name][0]
    rng = np.random.default_rng(1234)
    inp = {}
    inp["ss_prev"], inp["ss_curr"] = _pairs(rng, batch, (48, 64), lambda i: (0.3, 0.7 + i))
    inp["pyr_prev"], inp["pyr_curr"] = _pairs(rng, batch, PYR_SHAPE[name],
                                              lambda i: (0.5, 1.5 + i))
    inp["fd_prev"], inp["fd_curr"] = _pairs(rng, batch, (96, 128), lambda i: (0.5, 1.5 + i))
    inp["halo_img"] = rng.uniform(0, 1, (1, 16, 24)).astype(np.float32)
    base = rng.uniform(0, 255, (80, 128)).astype(np.float32)
    inp["pc_prev"], inp["pc_curr"] = base[None], np.roll(base, 2, axis=1)[None]
    inp["nv_prev"], inp["nv_curr"] = _pairs(rng, 1, (48, 64), lambda i: (0.8, 1.5))
    inp["down_img"] = rng.uniform(0, 255, (1, 96, 128)).astype(np.float32)
    inp["up_u"] = rng.uniform(-3, 3, (1, 24, 32)).astype(np.float32)
    inp["up_v"] = rng.uniform(-3, 3, (1, 24, 32)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(name)``: every rank's results for tiling ``name``; the four
    workers run once per tiling for the whole module."""
    done: dict = {}

    def get(name: str):
        if name not in done:
            try:
                done[name] = run_ranks(tmp_path_factory.mktemp(name), 4, ",".join(
                    str(x) for x in TILINGS[name]), CASES[name], _inputs(name))
            except RuntimeError as exc:
                done[name] = exc
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    return get


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _p999(*diffs) -> float:
    return float(np.quantile(np.abs(np.concatenate([d.ravel() for d in diffs])), 0.999))


def _jax_mesh(name):
    return jax_mesh(*TILINGS[name])


# -- mesh and halo -----------------------------------------------------------------------------


def test_mesh_construction(port):
    ranks = port("1x2x2")
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mesh/shape"], [1, 2, 2])
        np.testing.assert_array_equal(res["mesh/coords"], [0, r // 2, r % 2])  # row-major
        assert res["mesh/refused"], "a mesh larger than the world must raise ValueError"
        assert res["joined"]


@pytest.mark.parametrize("boundary", ["symm", "zero"])
def test_halo_exchange_matches_padding(port, boundary):
    """Halo-extended tiles are slices of the padded global image, corners
    included (relayed through the vertical neighbour)."""
    img = _inputs("1x2x2")["halo_img"][0]
    halo = 3
    padded = np.pad(img, halo, mode="symmetric" if boundary == "symm" else "constant")
    for res in port("1x2x2"):
        _, iy, ix = res["mesh/coords"]
        want = padded[iy * 8:iy * 8 + 8 + 2 * halo, ix * 12:ix * 12 + 12 + 2 * halo]
        np.testing.assert_array_equal(res[f"halo/{boundary}"], want)


@pytest.mark.parametrize("name", list(TILINGS))
def test_every_rank_holds_the_global_result(port, name):
    ranks = port(name)
    for key in ranks[0]:
        if key.split("/")[0] in ("single", "pyr_torch", "pyr_cuda", "narrow", "fully") \
                and key.endswith(("/u", "/v")):
            for res in ranks[1:]:
                np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=key)


def test_one_rank_per_card_check():
    check_one_rank_per_card([("a", 0), ("a", 1), ("b", 0)])
    with pytest.raises(ValueError, match="share CUDA device 1"):
        check_one_rank_per_card([("a", 0), ("a", 1), ("a", 1)])


# -- tiled single scale ------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TILINGS))
def test_tiled_single_scale_matches_jax(port, name):
    inp = _inputs(name)
    ju, jv = jax_tiled_single(jnp.asarray(inp["ss_prev"]), jnp.asarray(inp["ss_curr"]),
                              _jax_mesh(name))
    res = port(name)[0]
    np.testing.assert_allclose(res["single/u"], np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["single/v"], np.asarray(jv), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(TILINGS))
def test_tiled_single_scale_matches_untiled(port, name):
    inp = _inputs(name)
    res = port(name)[0]
    for b in range(TILINGS[name][0]):
        u, v = lucas_kanade_single_scale(_t(inp["ss_prev"][b]), _t(inp["ss_curr"][b]))
        np.testing.assert_allclose(res["single/u"][b], u.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(res["single/v"][b], v.numpy(), rtol=0, atol=1e-4)


def test_tiled_single_scale_rejects_bad_tiling(port):
    assert port("1x2x2")[0]["bad_tiling/refused"]


# -- tiled pyramidal ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TILINGS))
def test_tiled_pyramidal_matches_jax(port, name):
    inp = _inputs(name)
    ju, jv = jtp.tiled_lucas_kanade_pyramidal(
        jnp.asarray(inp["pyr_prev"]), jnp.asarray(inp["pyr_curr"]), _jax_mesh(name),
        config=JaxPyramidConfig(**PYR_CFG))
    res = port(name)[0]
    assert _p999(res["pyr_torch/u"] - np.asarray(ju), res["pyr_torch/v"] - np.asarray(jv)) <= 2e-3


@pytest.mark.parametrize("name", list(TILINGS))
def test_tiled_pyramidal_matches_untiled(port, name):
    inp = _inputs(name)
    res = port(name)[0]
    cfg = PyramidConfig(**PYR_CFG)
    for b in range(TILINGS[name][0]):
        u, v = lucas_kanade_pyramidal(_t(inp["pyr_prev"][b]), _t(inp["pyr_curr"][b]), config=cfg,
                                      rtl_clamp=True)
        np.testing.assert_allclose(res["pyr_torch/u"][b], u.numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(res["pyr_torch/v"][b], v.numpy(), rtol=0, atol=1e-3)
    # Coarse levels replicated: the coarsest tiled level was gathered once.
    assert int(res["pyr_torch/level_gathers"]) == 1


def test_tiled_cuda_backend_matches_pallas_interpret(port):
    """``backend="cuda"`` per tile (the warp and fused LK kernels' plain
    versions on the CPU) against the reference's Pallas kernels in
    interpret mode on the same (1, 2, 2) tiling."""
    inp = _inputs("1x2x2")
    devs = np.array(jax.devices()[:4]).reshape(1, 2, 2)
    ju, jv = jtp.tiled_lucas_kanade_pyramidal(
        jnp.asarray(inp["pc_prev"]), jnp.asarray(inp["pc_curr"]), Mesh(devs, ("batch", "ty", "tx")),
        config=JaxPyramidConfig(**CUDA_CFG), backend="pallas", interpret=True)
    res = port("1x2x2")[0]
    np.testing.assert_allclose(res["pyr_cuda/u"], np.asarray(ju), rtol=0, atol=1e-3)
    np.testing.assert_allclose(res["pyr_cuda/v"], np.asarray(jv), rtol=0, atol=1e-3)


def test_extended_tile_lk_geometry():
    """The fused LK solve on a halo-extended tile, cropped, equals the whole
    frame's over that tile, for interior and border tiles alike (the symm
    halo ring stands in for the kernel's own symmetric pad)."""
    rng = np.random.default_rng(1234)
    gh, gw = 64, 256
    prev = _t(rng.uniform(0, 255, (gh, gw)).astype(np.float32))
    curr = _t(rng.uniform(0, 255, (gh, gw)).astype(np.float32))
    u_g, v_g = lk.lucas_kanade_fused(prev, curr)
    ext = 3
    prev_p = np.pad(prev.numpy(), ext, mode="symmetric")
    curr_p = np.pad(curr.numpy(), ext, mode="symmetric")
    th, tw = 32, 128
    for y0, x0 in [(0, 0), (32, 128), (0, 128), (32, 0)]:
        pe = _t(prev_p[y0:y0 + th + 2 * ext, x0:x0 + tw + 2 * ext])
        ce = _t(curr_p[y0:y0 + th + 2 * ext, x0:x0 + tw + 2 * ext])
        du, dv = lk.lucas_kanade_fused(pe, ce)
        du, dv = tp._border_zero(du[ext:ext + th, ext:ext + tw], dv[ext:ext + th, ext:ext + tw],
                                 y0, x0, gh, gw, 2)
        np.testing.assert_allclose(du.numpy(), u_g[y0:y0 + th, x0:x0 + tw].numpy(), atol=1e-5,
                                   rtol=0, err_msg=f"tile ({y0},{x0}) u")
        np.testing.assert_allclose(dv.numpy(), v_g[y0:y0 + th, x0:x0 + tw].numpy(), atol=1e-5,
                                   rtol=0, err_msg=f"tile ({y0},{x0}) v")


def test_tiled_narrow_vertical_matches_untiled(port):
    """``max_disp_v`` reaches the tiled path, and the narrow band engages."""
    inp = _inputs("1x2x2")
    res = port("1x2x2")[0]
    prev, curr = _t(inp["nv_prev"][0]), _t(inp["nv_curr"][0])
    u, v = lucas_kanade_pyramidal(prev, curr, config=PyramidConfig(**NARROW_CFG), rtl_clamp=True)
    np.testing.assert_allclose(res["narrow/u"][0], u.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(res["narrow/v"][0], v.numpy(), rtol=0, atol=1e-3)
    _, v_full = lucas_kanade_pyramidal(prev, curr, config=PyramidConfig(**PYR_CFG), rtl_clamp=True)
    assert np.abs(v_full.numpy() - v.numpy()).max() > 0


# -- the distributed pyramid -------------------------------------------------------------------


def test_sharded_downsample_matches_single_device(port):
    img = _inputs("1x2x2")["down_img"][0]
    want = ops.downsample_fused(_t(img), 48, 64, 2.0).numpy()
    for res in port("1x2x2"):
        _, iy, ix = res["mesh/coords"]
        np.testing.assert_allclose(res["down_up/down"], want[iy * 24:iy * 24 + 24,
                                                             ix * 32:ix * 32 + 32],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["up", "rep"])
def test_sharded_upsample_flow_matches_single_device(port, kind):
    """Tiled-to-tiled (``sharded_upsample_flow``) and whole-to-tiled
    (``replicated_to_sharded_upsample``) flow upsampling."""
    inp = _inputs("1x2x2")
    u, v = torch_ref.upsample_flow(_t(inp["up_u"][0]), _t(inp["up_v"][0]), (48, 64))
    for res in port("1x2x2"):
        _, iy, ix = res["mesh/coords"]
        sl = np.s_[iy * 24:iy * 24 + 24, ix * 32:ix * 32 + 32]
        np.testing.assert_allclose(res[f"down_up/{kind}_u"], u.numpy()[sl], rtol=0, atol=1e-4)
        np.testing.assert_allclose(res[f"down_up/{kind}_v"], v.numpy()[sl], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(TILINGS))
def test_fully_distributed_pyramidal_matches_untiled(port, name):
    """96x128 frames with max_disp=4: at 1x2x2 and 2x1x2 every level tiles
    and no level is gathered; at 1x4x1 the coarsest level's 6-row tiles do
    not exceed the warp halo, so it runs replicated after one gather."""
    inp = _inputs(name)
    cfg = PyramidConfig(**FULLY_CFG)
    _, ty, tx = TILINGS[name]
    plan = tp._shard_plan(tp._level_shapes(96, 128, cfg.levels, cfg.scale_factor), ty, tx,
                          cfg.max_disp + 1)
    res = port(name)[0]
    assert int(res["fully/level_gathers"]) == (0 if all(plan) else 1)
    assert all(plan) == (name != "1x4x1")
    for b in range(TILINGS[name][0]):
        u, v = lucas_kanade_pyramidal(_t(inp["fd_prev"][b]), _t(inp["fd_curr"][b]), config=cfg,
                                      rtl_clamp=True)
        np.testing.assert_allclose(res["fully/u"][b], u.numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(res["fully/v"][b], v.numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", list(TILINGS))
def test_fully_distributed_pyramidal_matches_jax(port, name):
    inp = _inputs(name)
    ju, jv = jtp.tiled_lucas_kanade_pyramidal(
        jnp.asarray(inp["fd_prev"]), jnp.asarray(inp["fd_curr"]), _jax_mesh(name),
        config=JaxPyramidConfig(**FULLY_CFG))
    res = port(name)[0]
    assert _p999(res["fully/u"] - np.asarray(ju), res["fully/v"] - np.asarray(jv)) <= 2e-3


@pytest.mark.parametrize("tiling, plan", [((1, 2, 2), [True, True, True]),
                                          ((1, 4, 1), [False, True, True])])
def test_level_shapes_and_plan_match_reference(tiling, plan):
    """1080p under ``production_fullband`` (warp halo 9): on 1x2x2 every
    level tiles (540x960, 270x480, 135x240); on 1x4x1 the coarsest level's
    270 rows do not divide by 4, so it runs replicated."""
    cfg, jcfg = PYRAMID_CONFIGS["production_fullband"], JAX_CONFIGS["production_fullband"]
    dims = tp._level_shapes(1080, 1920, cfg.levels, cfg.scale_factor)
    assert dims == jtp._level_shapes(1080, 1920, jcfg.levels, jcfg.scale_factor)
    _, ty, tx = tiling
    got = tp._shard_plan(dims, ty, tx, cfg.max_disp + 1)
    assert got == jtp._shard_plan(dims, ty, tx, jcfg.max_disp + 1) == plan
