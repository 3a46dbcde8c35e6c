"""Batched streams: B independent frame streams through the port's
pyramidal flow in one call, the counterpart of ``jax.vmap`` over
``tpuflow.flow.lucas_kanade_pyramidal`` (BASELINE.json config 4, "batched
streams"), on the CPU.

The batch: B = 3 seeded 240x320 pairs of 8-bit frames, one textured frame
moved 2 px right, the same frame still (no_motion), and moved 3 px down
and 0.5 px right (vertical): their band indices and latches differ by
element.

- The parity path (``backend="torch"``) on the batch against
  ``jax.vmap`` of the reference's jnp path, per element, ``production``
  and ``default``: max |d| <= 3e-3 px and p99.9 <= 5e-4 px. The readings
  were max 1.13e-3 / 9.5e-4 px and p99.9 1.5e-4 / 2.4e-4 px on the moved
  elements, 0 on no_motion, under both configs: both sides build their
  pyramids with other GEMMs (one ulp, divergence f) and the solve
  amplifies that at weakly textured pixels.
- The fast path (``backend="cuda"`` on CPU tensors: the kernels' plain
  versions) per element bit for bit the port's own 2-D call (flow and the
  rounds of each level), and within the limits of
  tests/test_torch_pyramidal.py (coarsest level p99.9 1e-4 px, finest 2e-3
  px) of JAX's Pallas path run on each element alone in interpret mode
  (the reference's interpreter cannot vmap its while loop,
  tests/test_pallas_kernels.py:386-392), both sides from JAX's batched
  pyramid carried over by ``convert.pyramid_from_numpy``.
- Each element's band index equal to JAX's ``_select_band_index`` on that
  element, at every level that picks one; the batch mixes bands.
- No host read on a batch, under the ``TorchDispatchMode`` of
  tests/test_torch_device_control.py.
- Divergence p (ROADMAP section 3): with ``rtl_clamp=True`` a patch moved
  6 px on a flat field latches its finest level at the first round with
  |u| up to 6.8 px past a 2 px band, beside an element that runs every
  round. The port's element equals JAX's per-frame result (p99.9 <= 1e-3
  px, max <= 2e-3 px; read 3.2e-4 / 7.0e-4 at the flat field's weak
  solves), and JAX's vmapped result does not re-clip it either: ``jax.vmap``
  of a ``lax.while_loop`` updates an element's carry only while that
  element's own condition holds. It read bit for bit the per-frame result
  (held to the same limit), where a re-clip would move the patch by up to
  4.8 px.
- ``warp.warp_round`` and ``lk.refine_round`` with a (B,) band, one index
  a plane, running and skipped: each plane as its own call with its own
  index; sizes other than 1 and B refused.
- The bounds of a batch's rounds: B times a plane's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as nd_shift
from torch.utils._python_dispatch import TorchDispatchMode

import tpuflow.flow as jflow
from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.core.config import PyramidConfig as JaxPyramidConfig
from tpuflow.flow import lucas_kanade_pyramidal_from_pyramids as jax_from_pyramids
from tpuflow.flow import pyramidal as jax_pyramidal
from tpuflow.kernels import jnp_ref
from tpuflow_torch import convert
from tpuflow_torch.core import ops
from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.eval import bounds
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import lk, torch_ref, warp

torch.set_num_threads(1)

HEIGHT, WIDTH = 240, 320
CONFIGS = ["production", "default"]
PARITY_MAX = 3e-3
PARITY_P999 = 5e-4
COARSEST_P999 = 1e-4
FINEST_P999 = 2e-3
WITNESS_P999 = 1e-3
WITNESS_MAX = 2e-3
WITNESS_BAND = 2  # the witness config's max_disp


class NoHostRead(TorchDispatchMode):
    """Raises on ``aten._local_scalar_dense``: a tensor's value read to the
    host (``bool``, ``int``, ``float``, ``.item()``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor value was read to the host")
        return func(*args, **(kwargs or {}))


def _batch() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(21)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (HEIGHT, WIDTH)), 2.0))

    def moved(dy: float, dx: float) -> np.ndarray:
        return np.round(nd_shift(a, (dy, dx), order=1, mode="constant", cval=128.0))

    prev = np.stack([a, a, a]).astype(np.float32)
    curr = np.stack([moved(0.0, 2.0), a, moved(3.0, 0.5)]).astype(np.float32)
    return prev, curr


def _pyramids(config: str):
    """JAX's batched pyramids of both frames (its pyramid under vmap), and the
    same carried to the port as (B, h, w) levels."""
    jcfg = JAX_CONFIGS[config]
    build = jax.vmap(lambda f: jnp_ref.build_gaussian_pyramid(f, jcfg.levels, jcfg.scale_factor))
    jax_pyr = [build(jnp.asarray(f)) for f in _batch()]
    port_pyr = [convert.pyramid_from_numpy([np.asarray(x) for x in p], "cpu") for p in jax_pyr]
    return jax_pyr, port_pyr


def _p999(*diffs) -> float:
    return float(np.percentile(np.abs(np.stack(diffs)), 99.9))


def _max(*diffs) -> float:
    return float(np.abs(np.stack(diffs)).max())


@pytest.mark.parametrize("config", CONFIGS)
def test_parity_batch_matches_jax_vmap(config):
    prev, curr = _batch()
    jcfg = JAX_CONFIGS[config]
    fn = jax.jit(jax.vmap(lambda p, c: jflow.lucas_kanade_pyramidal(p, c, config=jcfg,
                                                                   backend="jnp")))
    ju, jv = (np.asarray(t) for t in fn(jnp.asarray(prev), jnp.asarray(curr)))
    pyramidal.counters.reset()
    u, v = pyramidal.lucas_kanade_pyramidal(torch.from_numpy(prev), torch.from_numpy(curr),
                                            config=PYRAMID_CONFIGS[config], backend="torch")
    assert u.shape == v.shape == prev.shape
    iterations = pyramidal.counters.level_iterations
    assert len(iterations) == 3 and iterations[1] == [1, 1, 1] and iterations[0] != [1, 1, 1]
    # Each element's early exit read once a round it ran short of the last.
    assert pyramidal.counters.convergence_reads == sum(
        min(n, jcfg.iterations - 1) for element in iterations for n in element)
    for b in range(prev.shape[0]):
        du, dv = u[b].numpy() - ju[b], v[b].numpy() - jv[b]
        assert _max(du, dv) <= PARITY_MAX and _p999(du, dv) <= PARITY_P999, b
    assert not u[1].any() and not v[1].any()


@pytest.fixture(scope="module")
def jax_pallas():
    """JAX's fast path on one element's prebuilt pyramids in interpret
    mode, jitted once a config for 240x320."""
    fns = {c: jax.jit(lambda a, b, cfg=JAX_CONFIGS[c]: jax_from_pyramids(
        a, b, cfg, backend="pallas", return_levels=True)) for c in CONFIGS}

    def run(config, pyr_a, pyr_b):
        with pltpu.force_tpu_interpret_mode():
            u, v, levels = fns[config](pyr_a, pyr_b)
        return np.asarray(u), np.asarray(v), [(np.asarray(x), np.asarray(y)) for x, y in levels]

    return run


@pytest.mark.parametrize("config", CONFIGS)
def test_fast_batch_is_each_streams_2d_call_and_matches_pallas(jax_pallas, config):
    cfg = PYRAMID_CONFIGS[config]
    (ja, jb), (pa, pb) = _pyramids(config)
    pyramidal.counters.reset()
    with NoHostRead():
        u, v, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
            pa, pb, cfg, backend="cuda", return_levels=True)
    rounds = pyramidal.counters.level_rounds
    assert rounds.dtype == torch.int32 and rounds.shape == (3, cfg.levels)
    assert pyramidal.counters.convergence_reads == pyramidal.counters.band_reads == 0
    assert rounds[1].tolist() == [1] * cfg.levels and rounds[0].tolist() != rounds[1].tolist()
    for b in range(3):
        one_u, one_v, one_levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
            [p[b] for p in pa], [p[b] for p in pb], cfg, backend="cuda", return_levels=True)
        assert torch.equal(one_u, u[b]) and torch.equal(one_v, v[b]), b
        assert all(torch.equal(x, y[b]) for lv, blv in zip(one_levels, levels)
                   for x, y in zip(lv, blv))
        assert torch.equal(pyramidal.counters.level_rounds, rounds[b])
        ju, jv, jlevels = jax_pallas(config, [p[b] for p in ja], [p[b] for p in jb])
        (cu, cv), (ju0, jv0) = levels[0], jlevels[0]
        assert _p999(cu[b].numpy() - ju0, cv[b].numpy() - jv0) <= COARSEST_P999, b
        assert _p999(u[b].numpy() - ju, v[b].numpy() - jv) <= FINEST_P999, b


@pytest.mark.parametrize("config", CONFIGS)
def test_step_on_a_batch_carries_each_stream(config):
    # Two steps of the batched stream step, no host read, each element the
    # 2-D step's on its own carry; the carry is each frame's own pyramid.
    cfg = PYRAMID_CONFIGS[config]
    prev, curr = (torch.from_numpy(f) for f in _batch())
    carry = torch_ref.build_gaussian_pyramid(prev, cfg.levels, cfg.scale_factor)
    singles = [torch_ref.build_gaussian_pyramid(prev[b], cfg.levels, cfg.scale_factor)
               for b in range(3)]
    assert all(torch.equal(c[b], s) for b in range(3) for c, s in zip(carry, singles[b]))
    for frame in (curr, prev):
        with NoHostRead():
            u, v, carry = pyramidal.lucas_kanade_pyramidal_step(carry, frame, cfg,
                                                                backend="cuda")
        for b in range(3):
            one_u, one_v, singles[b] = pyramidal.lucas_kanade_pyramidal_step(
                singles[b], frame[b], cfg, backend="cuda")
            assert torch.equal(one_u, u[b]) and torch.equal(one_v, v[b])
            assert all(torch.equal(c[b], s) for c, s in zip(carry, singles[b]))


@pytest.mark.parametrize("config", ["production", "adaptive_vertical"])
def test_band_index_per_element_equals_jax(config):
    cfg = PYRAMID_CONFIGS[config]
    _, (pa, pb) = _pyramids("production")
    _, _, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
        pa, pb, PYRAMID_CONFIGS["production"], backend="cuda", return_levels=True)
    margin = 2 * (cfg.max_disp + cfg.window_size)
    picked = []
    for level in range(1, cfg.levels):
        _, fv = torch_ref.upsample_flow(*levels[level - 1], tuple(pa[level].shape))
        idx = pyramidal._select_band_index(fv, cfg.adaptive_v_bands, cfg.adaptive_v_frac, margin)
        assert idx.dtype == torch.int32 and idx.shape == (3,)
        for b in range(3):
            want = jax_pyramidal._select_band_index(jnp.asarray(fv[b].numpy()),
                                                    cfg.adaptive_v_bands,
                                                    cfg.adaptive_v_frac, margin)
            assert int(idx[b]) == int(want)
            assert torch.equal(pyramidal._select_band_index(
                fv[b], cfg.adaptive_v_bands, cfg.adaptive_v_frac, margin), idx[b])
        picked.append(idx.tolist())
    # The still element takes the narrowest band, the vertical one a wider.
    assert any(len(set(p)) > 1 for p in picked), picked


def _witness_batch() -> tuple[np.ndarray, np.ndarray]:
    """Element 0: a flat 128x256 field with one 6 px textured patch moved 6
    px right (its finest level latches at the first round, the patch's
    flow past a 2 px band); element 1: a textured field moved 1 px (every
    round runs)."""
    rng = np.random.default_rng(0)
    tex = gaussian_filter(rng.uniform(0, 255, (10, 10)), 1.0)[2:-2, 2:-2]
    p0 = np.full((128, 256), 128.0, np.float32)
    c0 = p0.copy()
    p0[60:66, 100:106] = tex
    c0[60:66, 106:112] = tex
    field = np.round(gaussian_filter(np.random.default_rng(3).uniform(0, 255, (128, 256)), 2.0))
    c1 = np.round(nd_shift(field, (0.0, 1.0), order=1, mode="constant", cval=128.0))
    return (np.stack([np.round(p0), field]).astype(np.float32),
            np.stack([np.round(c0), c1]).astype(np.float32))


def test_divergence_p_witness_per_frame_semantics_under_rtl_clamp():
    kw = dict(levels=3, window_size=5, iterations=3, max_disp=WITNESS_BAND)
    jcfg, cfg = JaxPyramidConfig(**kw), PyramidConfig(**kw)
    prev, curr = _witness_batch()
    pyramidal.counters.reset()
    u, v = pyramidal.lucas_kanade_pyramidal(torch.from_numpy(prev), torch.from_numpy(curr),
                                            config=cfg, backend="torch", rtl_clamp=True)
    rounds = pyramidal.counters.level_iterations
    assert rounds[0][-1] == 1 and rounds[1][-1] == cfg.iterations, rounds

    def solve(p, c):
        return jflow.lucas_kanade_pyramidal(p, c, config=jcfg, backend="jnp", rtl_clamp=True)

    one = jax.jit(solve)
    per = [tuple(np.asarray(t) for t in one(jnp.asarray(prev[b]), jnp.asarray(curr[b])))
           for b in range(2)]
    mapped = [np.asarray(t) for t in jax.jit(jax.vmap(solve))(jnp.asarray(prev),
                                                              jnp.asarray(curr))]
    # The latched element's flow lies past the band: a re-clip would show.
    assert np.abs(per[0][0]).max() > WITNESS_BAND + 2
    for b in range(2):
        du, dv = u[b].numpy() - per[b][0], v[b].numpy() - per[b][1]
        assert _p999(du, dv) <= WITNESS_P999 and _max(du, dv) <= WITNESS_MAX, b
        mu, mv = mapped[0][b] - per[b][0], mapped[1][b] - per[b][1]
        print(f"element {b}: jax.vmap against per-frame max |d| {_max(mu, mv):.3g} px, "
              f"{int((np.abs(np.stack([mu, mv])) > 0).sum())} values differ")
        assert _max(mu, mv) <= WITNESS_MAX, b


def _round_inputs(rng, batch: int = 3, shape=(40, 56)):
    prev = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (batch, *shape)), (0, 1.5, 1.5)))
    curr = np.roll(prev, 1, axis=-1)
    flow = rng.uniform(-4.0, 4.0, (2, batch, *shape))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in (prev, curr, flow[0], flow[1])]


LADDER = (2, 3, 8)


@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
@pytest.mark.parametrize("latch", [(0, 0, 0), (0, 1, 0)])
def test_warp_round_takes_a_band_a_plane(packing, latch):
    _, curr, u, v = _round_inputs(np.random.default_rng(4))
    band = torch.tensor([2, 0, 1], dtype=torch.int32)
    latch_t = torch.tensor(latch, dtype=torch.int32)
    fill = torch.full_like(curr, -1.0)
    kw = dict(max_disp=8, ladder=LADDER, packing=packing)
    out = warp.warp_round(curr, u, v, fill.clone(), latch_t, band=band, **kw)
    for b in range(3):
        one = warp.warp_round(curr[b], u[b], v[b], fill[b].clone(), latch_t[b:b + 1],
                              band=band[b:b + 1], **kw)
        assert torch.equal(out[b], one), b
        if latch[b]:
            assert torch.equal(out[b], fill[b])
    # One index still serves every plane.
    shared = warp.warp_round(curr, u, v, fill.clone(), latch_t, band=band[:1], **kw)
    assert torch.equal(shared, warp.warp_round(curr, u, v, fill.clone(), latch_t,
                                               band=band[:1].expand(3).contiguous(), **kw))
    # Plane 1's own band (ladder[0]) is not plane 0's (ladder[2]).
    assert not torch.equal(shared[1], out[1]) or latch[1]
    with pytest.raises(ValueError, match="one a plane"):
        warp.warp_round(curr, u, v, fill.clone(), latch_t, band=band[:2], **kw)


@pytest.mark.parametrize("relaxed", [True, False])
@pytest.mark.parametrize("latch", [(0, 0, 0), (1, 0, 0)])
def test_refine_round_takes_a_band_a_plane(relaxed, latch):
    prev, curr, u, v = _round_inputs(np.random.default_rng(5))
    band = torch.tensor([0, 2, 1], dtype=torch.int32)
    kw = dict(ladder=tuple(float(b) for b in LADDER), relaxed_order=relaxed,
              convergence_threshold=0.5)
    ctrl = torch.zeros((lk.CTRL_ROWS, 3), dtype=torch.int32)
    ctrl[0] = torch.tensor(latch, dtype=torch.int32)
    want_ctrl = ctrl.clone()
    got_u, got_v, sums = lk.refine_round(prev, curr, u, v, ctrl, band=band, **kw)
    for b in range(3):
        one_ctrl = want_ctrl[:, b].clone()
        ou, ov, osums = lk.refine_round(prev[b], curr[b], u[b], v[b], one_ctrl,
                                        band=band[b:b + 1], **kw)
        assert torch.equal(got_u[b], ou) and torch.equal(got_v[b], ov), b
        assert torch.equal(ctrl[:, b], one_ctrl) and torch.equal(sums[:, b], osums), b
        if latch[b]:
            assert torch.equal(got_u[b], u[b]) and torch.equal(got_v[b], v[b])
    # The widest band keeps more of the vertical flow than the narrowest.
    assert not torch.equal(got_v[2], got_v[1]) or latch[2]
    with pytest.raises(ValueError, match="one a plane"):
        lk.refine_round(prev, curr, u, v, want_ctrl.clone(), band=band[:2], **kw)


def test_pyramid_ops_take_a_batch_plane_by_plane():
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(0, 255, (3, 300, 70)).astype(np.float32))
    down = ops.downsample_fused(img, 150, 35, 2.0)
    up = ops.resize_bilinear(img, 600, 140)
    for b in range(3):
        assert torch.equal(down[b], ops.downsample_fused(img[b], 150, 35, 2.0))
        assert torch.equal(up[b], ops.resize_bilinear(img[b], 600, 140))


def test_batched_carry_from_jax_and_its_refusals():
    levels = [np.zeros((2, 3, 4)), np.ones((2, 6, 8))]
    carry = convert.pyramid_from_numpy(levels, "cpu")
    assert [tuple(t.shape) for t in carry] == [(2, 3, 4), (2, 6, 8)]
    for bad in ([np.zeros((2, 3, 4)), np.ones((3, 6, 8))], [np.zeros((2, 3, 4)), np.ones((6, 8))]):
        with pytest.raises(ValueError, match="one B"):
            convert.pyramid_from_numpy(bad, "cpu")
    with pytest.raises(ValueError, match="one shape"):
        pyramidal.lucas_kanade_pyramidal_from_pyramids(carry, [c[:1] for c in carry],
                                                       PYRAMID_CONFIGS["default"], backend="cuda")


@pytest.mark.parametrize("name", ["warp_packed_u8", "warp_packed_u16", "warp_exact", "lk_refine",
                                  "lk_refine_exact"])
def test_a_batch_rounds_bound_is_b_planes(name):
    one = bounds.bound(name, 1, 1080, 1920)
    for b in (4, 16):
        many = bounds.bound(name, b, 1080, 1920)
        assert many[1] == one[1] and many[0] == pytest.approx(b * one[0], rel=1e-12)
