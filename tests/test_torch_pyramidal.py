"""The port's pyramidal main path (``production``, ``backend="cuda"``, which
runs the kernels' plain versions on CPU tensors) against the JAX package's
``backend="pallas"`` path in interpret mode, at 320x240.

Tolerance. Both sides start from the same JAX-built pyramids (carried over
with ``convert.pyramid_from_numpy``). At the coarsest level the two agree
to p99.9 |d| <= 1e-4 px. Finer levels inherit the upsampled coarse flow,
and the LK solve amplifies one-ulp differences at ill-conditioned pixels
(flat sky, the gray border fill): the slice's own f32 rounding floor on
translate_medium, the port in f32 against the same port in f64, measures
p99.9 8.4e-4 px and max 3.4e-3 px at the finest level. Interpret mode's
XLA:CPU contracts some products into FMAs where the port rounds each one,
so the finest level is held to p99.9 <= 2e-3 px, about twice that floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.eval import patterns, verifier
from tpuflow.eval.metrics import compute_all_metrics
from tpuflow.flow import lucas_kanade_pyramidal_from_pyramids as jax_from_pyramids
from tpuflow.kernels import jnp_ref
from tpuflow_torch import convert, lucas_kanade_pyramidal_step
from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import torch_ref

CFG = PYRAMID_CONFIGS["production"]
JAX_CFG = JAX_CONFIGS["production"]


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


def _pattern(name):
    f0, f1 = patterns.generate_test_pattern(patterns.TEST_PATTERNS[name], 320, 240, output_dir=None)
    return f0.astype(np.float32), f1.astype(np.float32)


def _jax_pyramid(frame):
    return jnp_ref.build_gaussian_pyramid(jnp.asarray(frame), JAX_CFG.levels, JAX_CFG.scale_factor)


def _p999(*diffs):
    return float(np.percentile(np.abs(np.stack(diffs)), 99.9))


@pytest.mark.parametrize("name", ["translate_medium", "translate_large"])
def test_production_from_jax_pyramids_matches_pallas(jax_production, name):
    f0, f1 = _pattern(name)
    pyr_a, pyr_b = _jax_pyramid(f0), _jax_pyramid(f1)
    ju, jv, jlevels = jax_production(pyr_a, pyr_b)

    to_port = lambda pyr: convert.pyramid_from_numpy([np.asarray(x) for x in pyr])  # noqa: E731
    u, v, levels = pyramidal.lucas_kanade_pyramidal_from_pyramids(
        to_port(pyr_a), to_port(pyr_b), CFG, backend="cuda", return_levels=True
    )
    iters = pyramidal.counters.level_iterations
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
    reads = pyramidal.counters.convergence_reads
    # One band read per level above the coarsest; one early-exit read per
    # round that is not a level's last permitted one.
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
def test_fast_path_configs_without_a_kernel_name_it(name, kernel):
    z = torch.zeros(32, 32)
    with pytest.raises(NotImplementedError, match=kernel):
        pyramidal.lucas_kanade_pyramidal(z, z, config=PYRAMID_CONFIGS[name], backend="cuda")
    with pytest.raises(ValueError):
        pyramidal.lucas_kanade_pyramidal(z, z, config=CFG, backend="pallas")


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
