"""The fast path's device-resident driver (``backend="cuda"`` on CPU
tensors, where the kernels' plain versions run the same driver as the
card): no host read, the reference's results.

- ``production`` and ``default`` at 320x240 against
  ``tpuflow.flow.lucas_kanade_pyramidal_from_pyramids(..., backend="pallas")``
  in interpret mode, both sides from the same JAX-built pyramids, on
  translate_medium, translate_large and a textured pair made from a seed
  with numpy (blurred noise rounded to gray levels, shifted 2 px). Limits
  those of tests/test_torch_pyramidal.py: the coarsest level p99.9 |d| <=
  1e-4 px, the finest p99.9 <= 2e-3 px (its docstring gives the reasons).
- The same solves under a ``TorchDispatchMode`` that raises on
  ``aten._local_scalar_dense``, the op behind ``bool``, ``int`` and
  ``.item()``: none is left (the parity path, which reads its early exit
  to the host, raises under the same mode).
- A skipped round is a bit-exact pass-through, also where the flow has
  left the band after an early exit and a re-clip would change it.
- A band index in a tensor gives the bits of the host-int band.
- The round's sums and latch agree with ``torch.sum`` and with the JAX
  kernel's ``sdu / n_px < thr``.
- One level under device control equals the host-read loop bit for bit,
  with the same rounds.
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

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.eval import patterns
from tpuflow.flow import lucas_kanade_pyramidal_from_pyramids as jax_from_pyramids
from tpuflow.kernels import jnp_ref, pallas_lk
from tpuflow_torch import convert
from tpuflow_torch.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow_torch.flow import GraphedStream, graphed, pyramidal
from tpuflow_torch.kernels import lk, torch_ref, warp
from tpuflow_torch.vo import device_loop

HEIGHT, WIDTH = 240, 320


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as the other port test files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class NoHostRead(TorchDispatchMode):
    """Raises on ``aten._local_scalar_dense``: a tensor's value read to the
    host (``bool``, ``int``, ``float``, ``.item()``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor value was read to the host")
        return func(*args, **(kwargs or {}))


def _frames(name: str) -> tuple[np.ndarray, np.ndarray]:
    if name == "seeded_shift":
        rng = np.random.default_rng(13)
        a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (HEIGHT, WIDTH)), 2.0))
        b = nd_shift(a, (0.0, 2.0), order=1, mode="constant", cval=128.0)
        return a.astype(np.float32), b.astype(np.float32)
    f0, f1 = patterns.generate_test_pattern(patterns.TEST_PATTERNS[name], WIDTH, HEIGHT,
                                            output_dir=None)
    return f0.astype(np.float32), f1.astype(np.float32)


def _pyramids(config: str, name: str):
    """Both frames' pyramids built by JAX, and the same carried to the port."""
    jcfg = JAX_CONFIGS[config]
    f0, f1 = _frames(name)
    jax_pyr = [jnp_ref.build_gaussian_pyramid(jnp.asarray(f), jcfg.levels, jcfg.scale_factor)
               for f in (f0, f1)]
    port_pyr = [convert.pyramid_from_numpy([np.asarray(x) for x in p], "cpu") for p in jax_pyr]
    return jax_pyr, port_pyr


def _p999(*diffs) -> float:
    return float(np.percentile(np.abs(np.stack(diffs)), 99.9))


@pytest.mark.parametrize("name", ["translate_medium", "translate_large", "seeded_shift"])
@pytest.mark.parametrize("config", ["production", "default"])
def test_device_driver_matches_pallas_with_no_host_read(config, name):
    jcfg, cfg = JAX_CONFIGS[config], PYRAMID_CONFIGS[config]
    (ja, jb), (pa, pb) = _pyramids(config, name)
    fn = jax.jit(lambda a, b: jax_from_pyramids(a, b, jcfg, backend="pallas",
                                                return_levels=True))
    with pltpu.force_tpu_interpret_mode():
        ju, jv, jlevels = fn(ja, jb)

    pyramidal.counters.reset()
    with NoHostRead():
        u, v, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
            pa, pb, cfg, backend="cuda", return_levels=True)
    assert pyramidal.counters.convergence_reads == 0 and pyramidal.counters.band_reads == 0
    rounds = pyramidal.counters.level_rounds
    assert rounds.dtype == torch.int32 and rounds.shape == (cfg.levels,)
    assert all(1 <= n <= cfg.iterations for n in rounds.tolist())
    assert torch.isfinite(u).all() and torch.isfinite(v).all()
    (cu, cv), (ju0, jv0) = levels[0], jlevels[0]
    assert _p999(cu.numpy() - np.asarray(ju0), cv.numpy() - np.asarray(jv0)) <= 1e-4
    assert _p999(u.numpy() - np.asarray(ju), v.numpy() - np.asarray(jv)) <= 2e-3


def test_no_host_read_mode_catches_the_parity_paths_reads():
    # The witness that the mode sees a read: the parity path reads its early
    # exit (and with rtl_clamp its band) to the host.
    _, (pa, pb) = _pyramids("production", "translate_medium")
    with pytest.raises(AssertionError, match="read to the host"), NoHostRead():
        pyramidal.lucas_kanade_pyramidal_from_pyramids(
            pa, pb, PYRAMID_CONFIGS["production"], backend="torch", rtl_clamp=True)


def test_step_and_front_end_step_make_no_host_read():
    cfg = PYRAMID_CONFIGS["production"]
    f0, f1 = (torch.from_numpy(f) for f in _frames("seeded_shift"))
    carry = torch_ref.build_gaussian_pyramid(f0, cfg.levels, cfg.scale_factor)
    fe = device_loop.FrontEnd(backend="cuda", config=cfg, fb_check_threshold=1.0)
    state, _ = fe.init(f0)
    with NoHostRead():
        pyramidal.lucas_kanade_pyramidal_step(carry, f1, cfg, backend="cuda")
        fe.step(state, f1)


def _level_inputs(seed: int = 3, shape=(60, 80), reach: float = 2.5):
    rng = np.random.default_rng(seed)
    prev = np.round(gaussian_filter(rng.uniform(0.0, 255.0, shape), 1.5)).astype(np.float32)
    curr = np.roll(prev, 1, axis=1)
    flow = rng.uniform(-reach, reach, (2, *shape)).astype(np.float32)
    return (torch.from_numpy(prev), torch.from_numpy(curr), torch.from_numpy(flow[0]),
            torch.from_numpy(flow[1]))


def _ctrl(latch: int = 0) -> torch.Tensor:
    return torch.tensor([latch, 0, 0], dtype=torch.int32)


def test_skipped_round_passes_the_flow_through_bit_for_bit():
    prev, curr, u, v = _level_inputs(reach=5.0)
    band = 2.0  # |v| up to 5 px: outside the band, where a re-clip acts
    assert (v.abs() > band).any()
    ctrl = _ctrl(latch=1)
    out = torch.full_like(prev, 7.0)
    warp.warp_round(curr, u, v, out, ctrl[0], max_disp=8, ladder=(2,), packing="u8")
    assert torch.equal(out, torch.full_like(prev, 7.0))  # a skipped warp writes nothing
    u2, v2, sums = lk.refine_round(prev, out, u, v, ctrl, ladder=(band,), relaxed_order=True)
    assert torch.equal(u2, u) and torch.equal(v2, v)
    assert not sums.any() and ctrl.tolist() == [1, 0, 0]  # no sums, no round counted
    # The reference's frozen refine re-clips; the skip does not.
    frozen = lk.lucas_kanade_refine_ref(prev, out, u, v, torch.tensor(True), max_disp_v=band,
                                        relaxed_order=True)
    assert not torch.equal(frozen[1], v)


def test_early_exit_keeps_the_flow_that_left_the_band():
    # A threshold every round meets: round 0 latches, rounds 1 and 2 are
    # skipped. The flow leaves the +-2 px band in round 0 (clip, then the
    # residual), and the skipped rounds keep it: the result is round 0's,
    # bit for bit, with one round counted.
    prev, curr, u, v = _level_inputs(reach=3.0)
    cfg = PyramidConfig(iterations=3, max_disp_v=2, convergence_threshold=1e9)
    one = PyramidConfig(iterations=1, max_disp_v=2, convergence_threshold=1e9)
    ctrl3, ctrl1 = torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    u3, v3 = pyramidal._refine_level_device(prev, curr, u, v, cfg, ctrl3, None, finest=False)
    u1, v1 = pyramidal._refine_level_device(prev, curr, u, v, one, ctrl1, None, finest=False)
    assert torch.equal(u3, u1) and torch.equal(v3, v1)
    assert ctrl3.tolist() == [1, 0, 1]
    assert (v3.abs() > 2.0).any()  # a re-clip in rounds 1-2 would have changed these


@pytest.mark.parametrize("index,band", [(0, 2), (1, 3), (2, 8)])
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
def test_forced_band_index_equals_the_host_int_band(index, band, packing):
    prev, curr, u, v = _level_inputs(reach=9.0)
    idx = torch.tensor(index, dtype=torch.int32)
    ladder = (2, 3, 8)
    got = warp.warp_round(curr, u, v, torch.empty_like(curr), torch.zeros((), dtype=torch.int32),
                          max_disp=8, ladder=ladder, band=idx, packing=packing)
    want = warp.warp_banded(curr, u, v, max_disp=8, clamp_flow=True, max_disp_v=band,
                            packing=packing)
    assert torch.equal(got, want)
    ctrl = _ctrl()
    ru, rv, _ = lk.refine_round(prev, got, u, v, ctrl, ladder=tuple(map(float, ladder)),
                                band=idx, relaxed_order=packing != "exact")
    wu, wv, _, _ = lk.lucas_kanade_refine(prev, got, u, v, torch.tensor(False),
                                          max_disp_v=float(band),
                                          relaxed_order=packing != "exact")
    assert torch.equal(ru, wu) and torch.equal(rv, wv)


@pytest.mark.parametrize("side", [0.99, 1.01])
@pytest.mark.parametrize("relaxed", [True, False])
def test_round_sums_and_latch_agree_with_torch_sum_and_jax(side, relaxed):
    prev, curr, u, v = _level_inputs()
    warped = warp.warp_banded(curr, u, v, max_disp=8, clamp_flow=True, packing="exact")
    args = (prev, warped, u, v)
    _, _, sdu, sdv = lk.lucas_kanade_refine(*args, torch.tensor(False), relaxed_order=relaxed)
    n_px = prev.numel()
    # A threshold just below or above the larger mean: the latch both ways.
    thr = side * float(max(sdu, sdv)) / n_px
    ctrl = _ctrl()
    _, _, sums = lk.refine_round(*args, ctrl, ladder=(8.0,), convergence_threshold=thr,
                                 relaxed_order=relaxed)
    torch.testing.assert_close(sums, torch.stack([sdu, sdv]), rtol=1e-6, atol=0)
    with pltpu.force_tpu_interpret_mode():
        _, _, jdu, jdv = pallas_lk.lucas_kanade_refine(
            *(jnp.asarray(t.numpy()) for t in args), jnp.asarray(False),
            relaxed_order=relaxed)
    np.testing.assert_allclose(sums.numpy(), [float(jdu), float(jdv)], rtol=1e-5)
    jax_latch = bool((jdu / n_px < thr) & (jdv / n_px < thr))
    assert ctrl.tolist() == [int(jax_latch), 0, 1]
    assert jax_latch == (side > 1.0)


def _host_read_level(prev, curr, u, v, cfg):
    """One level's rounds through the reference-signature kernels with the
    early exit read to the host after each round (the reference's
    while-loop condition)."""
    n_px = prev.numel()
    thr, mdv = cfg.convergence_threshold, cfg.max_disp_v_effective
    converged = torch.tensor(False)
    rounds = 0
    while rounds < cfg.iterations:
        warped = warp.warp_banded(curr, u, v, max_disp=cfg.max_disp, clamp_flow=True,
                                  max_disp_v=mdv, packing=pyramidal._warp_packing(cfg, False))
        u, v, sdu, sdv = lk.lucas_kanade_refine(
            prev, warped, u, v, converged, window_size=cfg.window_size,
            det_threshold=cfg.det_threshold, max_disp=float(cfg.max_disp),
            max_disp_v=float(mdv), relaxed_order=cfg.relaxed_order)
        converged = converged | ((sdu / n_px < thr) & (sdv / n_px < thr))
        rounds += 1
        if bool(converged):
            break
    return u, v, rounds


def test_device_level_equals_the_host_read_loop():
    # One level under device control (the tiled path's replicated levels
    # run it with the static band) against the same rounds with the early
    # exit read to the host: the same bits and rounds.
    prev, curr, u, v = _level_inputs(reach=1.0)
    for thr in (0.01, 0.2, 1e9):
        cfg = PyramidConfig(convergence_threshold=thr, relaxed_order=True)
        hu, hv, rounds = _host_read_level(prev, curr, u, v, cfg)
        ctrl = torch.zeros(3, dtype=torch.int32)
        du, dv = pyramidal._refine_level_device(prev, curr, u, v, cfg, ctrl, None, finest=False)
        assert torch.equal(du, hu) and torch.equal(dv, hv)
        assert int(ctrl[2]) == rounds


def test_graphed_stream_and_front_end_graph_need_the_card():
    cfg = PYRAMID_CONFIGS["production"]
    frame = torch.zeros(HEIGHT, WIDTH)
    with pytest.raises(ValueError, match="CUDA"):
        GraphedStream(frame, cfg)
    fe = device_loop.FrontEnd(backend="cuda", config=cfg)
    assert not fe.graphed(frame[None])


def test_bound_kernels_follow_a_swapped_wrapper(monkeypatch):
    # A captured graph keeps the wrappers bound at its capture; a swap is
    # seen, so the graph is captured again (VO) or refuses to replay.
    captured = graphed.bound_kernels()
    assert graphed.same_kernels(captured)
    monkeypatch.setattr(lk, "refine_round", lk.refine_round_ref)
    assert not graphed.same_kernels(captured)
    monkeypatch.undo()
    assert graphed.same_kernels(captured)
