"""The port's pyramidal fast path (``backend="cuda"``, which runs the
kernels' plain versions on CPU tensors) against the JAX package's
``backend="pallas"`` path in interpret mode: ``production`` and ``default``
at 320x240; ``shallow``, ``deep``, ``large_window`` and a window-7
relaxed-order config at 160x120. Also single scale through the fused
kernel's plain version against ``pallas_lk.lucas_kanade_fused``.

Tolerance. Both sides start from the same JAX-built pyramids (carried over
with ``convert.pyramid_from_numpy``). At the coarsest level the two agree
to p99.9 |d| <= 1e-4 px. Finer levels inherit the upsampled coarse flow,
and the LK solve amplifies one-ulp differences at ill-conditioned pixels
(flat sky, the gray border fill): the slice's own f32 rounding floor on
translate_medium, the port in f32 against the same port in f64, measures
p99.9 8.4e-4 px and max 3.4e-3 px at the finest level. Interpret mode's
XLA:CPU contracts some products into FMAs where the port rounds each one,
so the finest level is held to p99.9 <= 2e-3 px, about twice that floor.
Single scale has no pyramid to amplify the differences, but its weakly
textured windows amplify the one-ulp det differences the same way: 5e-5 px
(measured 1.6e-5 px on 5 of 76,800 pixels, translate_medium).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.core.config import PyramidConfig as JaxPyramidConfig
from tpuflow.eval import patterns, verifier
from tpuflow.eval.metrics import compute_all_metrics
from tpuflow.flow import lucas_kanade_pyramidal_from_pyramids as jax_from_pyramids
from tpuflow.kernels import jnp_ref, pallas_lk
from tpuflow_torch import convert, lucas_kanade_pyramidal_step, lucas_kanade_single_scale
from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import lk, torch_ref, warp

CFG = PYRAMID_CONFIGS["production"]
JAX_CFG = JAX_CONFIGS["production"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_production():
    """The JAX fast path on prebuilt pyramids, jitted once for 320x240."""
    fn = jax.jit(
        lambda a, b: jax_from_pyramids(a, b, JAX_CFG, backend="pallas", return_levels=True)
    )

    def run(pyr_a, pyr_b):
        with pltpu.force_tpu_interpret_mode():
            u, v, levels = fn(pyr_a, pyr_b)
        return np.asarray(u), np.asarray(v), [(np.asarray(a), np.asarray(b)) for a, b in levels]

    return run


def _pattern(name, width=320, height=240):
    f0, f1 = patterns.generate_test_pattern(
        patterns.TEST_PATTERNS[name], width, height, output_dir=None
    )
    return f0.astype(np.float32), f1.astype(np.float32)


def _jax_pyramid(frame, cfg=JAX_CFG):
    return jnp_ref.build_gaussian_pyramid(jnp.asarray(frame), cfg.levels, cfg.scale_factor)


def _p999(*diffs):
    return float(np.percentile(np.abs(np.stack(diffs)), 99.9))


@pytest.mark.parametrize("name", ["translate_medium", "translate_large"])
def test_production_from_jax_pyramids_matches_pallas(jax_production, name):
    f0, f1 = _pattern(name)
    pyr_a, pyr_b = _jax_pyramid(f0), _jax_pyramid(f1)
    ju, jv, jlevels = jax_production(pyr_a, pyr_b)

    to_port = lambda pyr: convert.pyramid_from_numpy([np.asarray(x) for x in pyr], "cpu")  # noqa: E731
    u, v, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
        to_port(pyr_a), to_port(pyr_b), CFG, backend="cuda", return_levels=True
    )
    iters = pyramidal.counters.level_rounds.tolist()
    print(f"{name}: port rounds per level {iters}")
    assert len(iters) == CFG.levels and all(1 <= n <= CFG.iterations for n in iters)
    assert u.shape == (240, 320) and torch.isfinite(u).all() and torch.isfinite(v).all()

    (cu, cv), (ju0, jv0) = levels[0], jlevels[0]
    assert _p999(cu.numpy() - ju0, cv.numpy() - jv0) <= 1e-4
    assert _p999(u.numpy() - ju, v.numpy() - jv) <= 2e-3
    if name == "translate_large":
        # The +-8 clamp engages: the 15 px motion saturates near the band
        # (clip, then one last residual step), on both sides.
        mask = verifier.get_test_region_mask((240, 320), name)
        assert np.median(u.numpy()[mask]) < 9.0 and np.median(ju[mask]) < 9.0


def test_pyramid_carry_goes_to_the_card_by_default(monkeypatch):
    # The carry crosses over onto the card unless the caller names another
    # device; without a card the default raises instead of falling back.
    levels = [np.full((3, 4), 1.5, np.float64), np.zeros((6, 8), np.float32)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.pyramid_from_numpy(levels)
    carry = convert.pyramid_from_numpy(levels, "cpu")
    assert [t.device.type for t in carry] == ["cpu", "cpu"]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in carry)
    assert torch.equal(carry[0], torch.full((3, 4), 1.5))


# (config name, pattern, width, height); "relaxed_w7" is the window-7
# relaxed-order config whose refine the port once refused.
SLICES = [
    ("default", "translate_medium", 320, 240),
    ("default", "translate_large", 320, 240),
    ("shallow", "translate_medium", 160, 120),
    ("deep", "translate_medium", 160, 120),
    ("large_window", "translate_medium", 160, 120),
    ("relaxed_w7", "translate_medium", 160, 120),
]


def _configs(name):
    if name == "relaxed_w7":
        fields = dict(levels=2, window_size=7, relaxed_order=True)
        return JaxPyramidConfig(**fields), convert.config_from_reference(JaxPyramidConfig(**fields))
    return JAX_CONFIGS[name], PYRAMID_CONFIGS[name]


@pytest.mark.parametrize("config,name,width,height", SLICES)
def test_slice_from_jax_pyramids_matches_pallas(config, name, width, height):
    jax_cfg, cfg = _configs(config)
    f0, f1 = _pattern(name, width, height)
    pyr_a, pyr_b = _jax_pyramid(f0, jax_cfg), _jax_pyramid(f1, jax_cfg)
    fn = jax.jit(
        lambda a, b: jax_from_pyramids(a, b, jax_cfg, backend="pallas", return_levels=True)
    )
    with pltpu.force_tpu_interpret_mode():
        ju, jv, jlevels = fn(pyr_a, pyr_b)

    to_port = lambda pyr: convert.pyramid_from_numpy([np.asarray(x) for x in pyr], "cpu")  # noqa: E731
    u, v, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
        to_port(pyr_a), to_port(pyr_b), cfg, backend="cuda", return_levels=True
    )
    assert len(levels) == cfg.levels and u.shape == (height, width)
    assert torch.isfinite(u).all() and torch.isfinite(v).all()
    (cu, cv), (ju0, jv0) = levels[0], jlevels[0]
    assert _p999(cu.numpy() - np.asarray(ju0), cv.numpy() - np.asarray(jv0)) <= 1e-4
    assert _p999(u.numpy() - np.asarray(ju), v.numpy() - np.asarray(jv)) <= 2e-3


def test_single_scale_cuda_matches_pallas():
    f0, f1 = _pattern("translate_medium")
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_fused(jnp.asarray(f0), jnp.asarray(f1), window_size=5)
    got = lucas_kanade_single_scale(torch.from_numpy(f0), torch.from_numpy(f1), 5,
                                    backend="cuda")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-5)


def test_streaming_steps_stay_within_verifier_envelope(jax_production):
    """A 3-frame stream, each side building its own pyramids: the port's
    accuracy stays within the verifier's 10% envelope of the JAX result."""
    f0, f1 = _pattern("translate_medium")
    mask = verifier.get_test_region_mask((240, 320), "translate_medium")
    frames, truths = [f1, f0], [2.0, -2.0]

    jax_carry = _jax_pyramid(f0)
    carry = torch_ref.build_gaussian_pyramid(torch.from_numpy(f0), CFG.levels, CFG.scale_factor)
    for frame, truth in zip(frames, truths):
        jax_next = _jax_pyramid(frame)
        ju, jv, _ = jax_production(jax_carry, jax_next)
        jax_carry = jax_next
        u, v, carry = lucas_kanade_pyramidal_step(
            carry, torch.from_numpy(frame), CFG, backend="cuda"
        )
        got = compute_all_metrics(u.numpy(), v.numpy(), truth, 0.0, mask)
        want = compute_all_metrics(ju, jv, truth, 0.0, mask)
        cmp = verifier.compare_metrics(got, want, threshold_percent=10.0)
        assert cmp["passed"], cmp["flags"]
        assert got["epe"] < 1.0


def test_step_equals_pairwise_and_counts_host_reads():
    f0, f1 = _pattern("translate_small")
    a, b = torch.from_numpy(f0), torch.from_numpy(f1)
    pyramidal.counters.reset()
    u1, v1 = pyramidal.lucas_kanade_pyramidal(a, b, config=CFG, backend="cuda")
    # The fast path keeps its early exit and band on the device.
    assert pyramidal.counters.convergence_reads == 0 and pyramidal.counters.band_reads == 0
    assert all(1 <= n <= CFG.iterations for n in pyramidal.counters.level_rounds.tolist())
    # The parity path with the clamp reads them to the host: one band read
    # per level above the coarsest; one early-exit read per round that is
    # not a level's last permitted one.
    pyramidal.lucas_kanade_pyramidal(a, b, config=CFG, backend="torch", rtl_clamp=True)
    reads = pyramidal.counters.convergence_reads
    assert pyramidal.counters.band_reads == CFG.levels - 1
    assert reads == sum(min(n, CFG.iterations - 1) for n in pyramidal.counters.level_iterations)
    carry = torch_ref.build_gaussian_pyramid(a, CFG.levels, CFG.scale_factor)
    u2, v2, nxt = lucas_kanade_pyramidal_step(carry, b, CFG, backend="cuda")
    torch.testing.assert_close(u2, u1, rtol=0, atol=0)
    torch.testing.assert_close(v2, v1, rtol=0, atol=0)
    assert [t.shape for t in nxt] == [t.shape for t in carry]


def test_no_motion_parity_path_is_exactly_zero():
    f0, _ = _pattern("no_motion")
    a = torch.from_numpy(f0)
    u, v = pyramidal.lucas_kanade_pyramidal(a, a, config=PYRAMID_CONFIGS["default"])
    assert not u.any() and not v.any()
    u, v = pyramidal.lucas_kanade_pyramidal(a, a, config=CFG, backend="torch", rtl_clamp=True)
    assert not u.any() and not v.any()


@pytest.mark.parametrize("name,kernel", [("default", "K5"), ("relaxed_order", "K4")])
def test_fast_path_configs_without_a_kernel_name_it(monkeypatch, name, kernel):
    # Both configs now run under backend="cuda" through the kernel named
    # (K5: the exact-order refine; K4: the unpacked warp), and agree with the
    # port's own parity path under the same clamp to the finest-level
    # tolerance.
    cfg = PYRAMID_CONFIGS[name]
    f0, f1 = _pattern("translate_medium", 160, 120)
    a, b = torch.from_numpy(f0), torch.from_numpy(f1)
    calls = set()
    plain_warp, plain_refine = warp.warp_round, lk.refine_round

    def spy_warp(*args, **kw):
        calls.add("K4" if kw["packing"] == "exact" else "K1/K2")
        return plain_warp(*args, **kw)

    def spy_refine(*args, **kw):
        calls.add("K3" if kw["relaxed_order"] else "K5")
        return plain_refine(*args, **kw)

    monkeypatch.setattr(warp, "warp_round", spy_warp)
    monkeypatch.setattr(lk, "refine_round", spy_refine)
    u, v = pyramidal.lucas_kanade_pyramidal(a, b, config=cfg, backend="cuda")
    assert kernel in calls
    pu, pv = pyramidal.lucas_kanade_pyramidal(a, b, config=cfg, backend="torch", rtl_clamp=True)
    assert _p999(u.numpy() - pu.numpy(), v.numpy() - pv.numpy()) <= 2e-3
    with pytest.raises(ValueError):
        pyramidal.lucas_kanade_pyramidal(a, b, config=CFG, backend="pallas")


def test_select_band_index_masked_interior():
    from tpuflow.flow.pyramidal import _select_band_index as jax_select

    rng = np.random.default_rng(7)
    for frac in (0.0, 0.003, 0.01, 0.2):
        v = rng.uniform(-0.9, 0.9, (120, 160)).astype(np.float32)
        n = int(frac * v.size)
        v.reshape(-1)[rng.choice(v.size, n, replace=False)] = 2.5
        v[:5] = 9.0  # border garbage inside the margin
        want = int(jax_select(jnp.asarray(v), (2, 3, 8), 0.005, 26))
        got = int(pyramidal._select_band_index(torch.from_numpy(v), (2, 3, 8), 0.005, 26))
        assert got == want
