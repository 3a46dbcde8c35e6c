"""The plain PyTorch versions of the port's CUDA kernels against the Pallas
kernels they replace, run in interpret mode on the CPU.

K1/K2 (``kernels.warp``) against ``pallas_warp.warp_image_banded`` with
``clamp_flow=True`` and ``packed_u8`` / ``packed_u16``; K3 (``kernels.lk``)
against ``pallas_lk.lucas_kanade_refine(relaxed_order=True)`` at windows 3,
5 and 7. The flow reaches +-9 px, so the band clips engage. (K4-K7 are in
``test_torch_kernels_exact.py``.)

Warp tolerance: two ulp of a gray level below 256 (2**-15). The port
rounds each product and sum separately, as the CUDA kernel does under
``-fmad=false``; interpret mode's XLA:CPU contracts some of the corner-lerp
products into FMAs (the same effect ``test_pallas_kernels`` notes between
its own packed and exact warps), which moves a result by up to one ulp per
lerp stage. Refine tolerance: 1e-5 px on u, v and rtol 1e-5 on the sums
(reassociation and contraction rounding of a ~1e3-magnitude solve); 1e-4
px on u, v at window 3, whose 3x3 windows are weakly conditioned and
amplify the same one-ulp differences in det (measured up to 6.2e-5 px, on
one pixel of 12,800, at 64x200).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import gaussian_filter

from tpuflow.kernels import pallas_lk, pallas_warp
from tpuflow_torch.ablation import warp_walk
from tpuflow_torch.kernels import launch_counts, lk, warp

WARP_ATOL = 2 * float(np.spacing(np.float32(255.0)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flow(rng, shape, reach=9.0):
    return (
        rng.uniform(-reach, reach, shape).astype(np.float32),
        rng.uniform(-reach, reach, shape).astype(np.float32),
    )


@pytest.mark.parametrize("band", [2, 3, 8])
@pytest.mark.parametrize("frames", ["u8_integer", "u8_fractional", "u16"])
def test_warp_plain_matches_pallas(rng, band, frames):
    shape = (64, 200)
    if frames == "u8_integer":
        img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    else:
        # Fractional gray levels: u8 truncates them as the packed word does.
        img = rng.uniform(0, 255, shape).astype(np.float32)
    packing = frames.split("_")[0]
    u, v = _flow(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_warp.warp_image_banded(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), max_disp=8,
            clamp_flow=True, max_disp_v=band, packed_u8=packing == "u8",
            packed_u16=packing == "u16",
        )
    got = warp.warp_banded(_t(img), _t(u), _t(v), max_disp=8, clamp_flow=True, max_disp_v=band,
                           packing=packing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("band", [2, 3, 8])
@pytest.mark.parametrize("packing", ["u16", "exact"])
def test_warp_plain_and_round_match_pallas_at_a_ragged_width(rng, band, packing):
    # 37x203: a width that is a multiple of neither 4 nor 8, the planes the
    # CUDA gathers serve through their scalar path; the entry's and the
    # round's plain versions (the flow clamped) against the Pallas kernel.
    shape = (37, 203)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    u, v = _flow(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_warp.warp_image_banded(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), max_disp=8, clamp_flow=True,
            max_disp_v=band, packed_u16=packing == "u16"))
    got = warp.warp_banded_ref(_t(img), _t(u), _t(v), 8, clamp_flow=True, max_disp_v=band,
                               packing=packing)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    ladder = (2, 3, 8)
    fill = _t(rng.uniform(-1, 1, shape))
    for latch in (0, 1):
        rnd = warp.warp_round_ref(_t(img), _t(u), _t(v), fill.clone(),
                                  torch.tensor(latch, dtype=torch.int32), max_disp=8,
                                  ladder=ladder,
                                  band=torch.tensor(ladder.index(band), dtype=torch.int32),
                                  packing=packing)
        if latch:
            assert torch.equal(rnd, fill)
        else:
            assert torch.equal(rnd, got)


def test_warp_plain_zero_flow_and_edges(rng):
    img = np.round(rng.uniform(0, 255, (24, 40))).astype(np.float32)
    z = np.zeros_like(img)
    np.testing.assert_array_equal(
        warp.warp_banded(_t(img), _t(z), _t(z), packing="u8", clamp_flow=True).numpy(), img)
    got = warp.warp_banded(_t(img + 0.3), _t(z), _t(z), packing="u16", clamp_flow=True).numpy()
    np.testing.assert_allclose(got, np.floor((img + 0.3) * 256.0 + 0.5) / 256.0, atol=1e-5)
    # A sample beyond the last column reads 0; one exactly on it does not.
    u = np.full_like(img, 0.5)
    out = warp.warp_banded(_t(img), _t(u), _t(z), packing="u8", clamp_flow=True).numpy()
    assert np.all(out[:, -1] == 0.0) and np.all(out[:, -2] != 0.0)


def test_warp_wrapper_checks_inputs():
    z = torch.zeros(8, 16)
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z, packing="u4")
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z, packing="u8", clamp_flow=False)
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z, max_disp=32)
    with pytest.raises(ValueError):
        warp.warp_banded(z, z[:4], z)
    with pytest.raises(TypeError):
        warp.warp_banded(z.double(), z, z)


@pytest.mark.parametrize("band", [2, 3, 8])
@pytest.mark.parametrize("converged", [False, True])
def test_refine_plain_matches_pallas(rng, band, converged):
    _check_refine(rng, (64, 200), band, converged)


def test_refine_plain_matches_pallas_multi_tile_ragged(rng):
    # 52 rows: several refine tiles of the Pallas grid, the last one ragged.
    _check_refine(rng, (52, 200), 8, False, tile_rows=16)


@pytest.mark.parametrize("window", [3, 7])
def test_refine_plain_matches_pallas_windows(rng, window):
    _check_refine(rng, (64, 200), 3, False, window=window)


def _check_refine(rng, shape, band, converged, tile_rows=None, window=5):
    prev = gaussian_filter(rng.uniform(0, 255, shape), 2.0).astype(np.float32)
    warped = np.roll(prev, 1, axis=1) + rng.uniform(-1, 1, shape).astype(np.float32)
    u, v = _flow(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_refine(
            jnp.asarray(prev), jnp.asarray(warped), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(converged), window_size=window, max_disp=8.0,
            max_disp_v=float(band), relaxed_order=True, tile_rows=tile_rows,
        )
    got = lk.lucas_kanade_refine(
        _t(prev), _t(warped), _t(u), _t(v), torch.tensor(converged), window_size=window,
        max_disp=8.0, max_disp_v=float(band), relaxed_order=True,
    )
    atol = 1e-4 if window == 3 else 1e-5
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if converged:
        np.testing.assert_array_equal(got[0].numpy(), np.clip(u, -8, 8))
        np.testing.assert_array_equal(got[1].numpy(), np.clip(v, -band, band))


def test_refine_wrapper_checks_inputs():
    z = torch.zeros(8, 16)
    f = torch.tensor(False)
    with pytest.raises(ValueError):
        lk.lucas_kanade_refine(z, z, z, z, f, window_size=9)
    with pytest.raises(TypeError):
        lk.lucas_kanade_refine(z, z, z, z, torch.tensor(0))
    with pytest.raises(ValueError):
        lk.lucas_kanade_refine(z, z, z, z[:, :8], f)


def test_cpu_tensors_run_plain_versions_and_count_no_launch(rng):
    before = launch_counts()
    img = _t(np.round(rng.uniform(0, 255, (16, 24))))
    warp.warp_banded(img, img * 0, img * 0, packing="u8", clamp_flow=True)
    for relaxed in (False, True):
        lk.lucas_kanade_refine(img, img, img * 0, img * 0, torch.tensor(False),
                               relaxed_order=relaxed)
    warp.warp_banded(img, img * 0, img * 0, packing="exact", clamp_flow=False)
    lk.lucas_kanade_fused(img, img)
    lk.lucas_kanade_fused(img, img, return_confidence=True)
    assert launch_counts() == before


# A plane under 2**20 pixels (the CUDA kernel gathers its corners) and one
# at 2**20 (it stages the band).
@pytest.mark.parametrize("staged", [False, True])
def test_warp_block_choice_leaves_the_cpu_result_alone(rng, staged):
    # The CUDA kernel chooses its block by plane size, and the walk
    # ablation walks; on the CPU both run the plain version whatever the
    # plane, and no launch is counted.
    shape = (1024, 1024) if staged else (16, 24)
    before = launch_counts()
    walks_before = dict(warp_walk.launch_counts)
    img = _t(np.round(rng.uniform(0, 255, shape)))
    u, v = _flow(rng, shape)
    kw = dict(max_disp_v=3, packing="u8", clamp_flow=True)
    want = warp.warp_banded_ref(img, _t(u), _t(v), 8, **kw)
    assert torch.equal(warp.warp_banded(img, _t(u), _t(v), 8, **kw), want)
    assert torch.equal(warp_walk.warp_walk(img, _t(u), _t(v), 8, 3, "u8", walk_rows=32), want)
    assert launch_counts() == before and warp_walk.launch_counts == walks_before
