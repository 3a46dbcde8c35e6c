"""The plain PyTorch versions of K4-K7 against the Pallas kernels they
replace, run in interpret mode on the CPU, at 64x200 with inputs from a
numpy seed.

- K4 (``warp.warp_banded(packing="exact")``) against
  ``pallas_warp.warp_image_banded`` with no packing, ``clamp_flow`` on and
  off, bands 2/3/8, fractional gray levels and flow reaching +-12 px, so
  every branch of the row rule (upper row only, both rows, neither) and of
  the column clamps is taken.
- K5 (``lk.lucas_kanade_refine(relaxed_order=False)``) against
  ``pallas_lk.lucas_kanade_refine(relaxed_order=False)``, windows 3/5/7,
  converged or not, and a multi-tile ragged height.
- K6 and K7 (``lk.lucas_kanade_fused``) against
  ``pallas_lk.lucas_kanade_fused``, exact and relaxed order, windows 3/5/7
  and Gaussian taps at window 5, without and with the |det| plane.

Tolerances. Interpret mode's XLA:CPU contracts some products into FMAs
where the port rounds each one (as the CUDA kernels do under
``-fmad=false``):
- K4: 2**-15, two ulp of a gray level below 256, one per lerp stage
  (measured 3.05e-5 on 6-17% of pixels);
- u, v: 1e-5 px at windows 5 and 7 (measured up to 2.1e-6 px); 2e-5 px with
  Gaussian taps (up to 1.2e-5 px: one more product per tap); 1e-4 px at
  window 3, whose 3x3 windows are weakly conditioned and amplify the
  one-ulp differences in det (up to 6.2e-5 px);
- the refine sums: rtol 1e-5;
- |det|: 2e-6 of the plane's largest value. det = sxx*syy - sxy*sxy
  cancels two products, and one contracted product moves det by an ulp of
  the products, not of det (measured up to 7e-7 of the largest |det|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import gaussian_filter

from tpuflow.kernels import pallas_lk, pallas_warp
from tpuflow_torch.kernels import lk, warp

SHAPE = (64, 200)
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


def _flow_atol(window, taps=False):
    return 1e-4 if window == 3 else 2e-5 if taps else 1e-5


def _frames(rng, shape=SHAPE):
    prev = gaussian_filter(rng.uniform(0, 255, shape), 2.0).astype(np.float32)
    curr = np.roll(prev, 1, axis=1) + rng.uniform(-1, 1, shape).astype(np.float32)
    return prev, curr


@pytest.mark.parametrize("band", [2, 3, 8])
@pytest.mark.parametrize("clamp_flow", [True, False])
def test_exact_warp_plain_matches_pallas(rng, band, clamp_flow):
    img = rng.uniform(0, 255, SHAPE).astype(np.float32)
    u = rng.uniform(-12, 12, SHAPE).astype(np.float32)
    v = rng.uniform(-12, 12, SHAPE).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_warp.warp_image_banded(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), max_disp=8,
            clamp_flow=clamp_flow, max_disp_v=band,
        )
    got = warp.warp_banded(_t(img), _t(u), _t(v), 8, max_disp_v=band, packing="exact",
                           clamp_flow=clamp_flow)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_ATOL)


def test_exact_warp_row_rule_beyond_the_band(rng):
    # Band 3, unclamped uniform vertical flow, on an image row far from the
    # edges: floor(v) = 4 keeps only the upper row's sample, 5 and -4 give
    # 0, and 3 and -3 give the full bilinear sample.
    img = rng.uniform(1, 255, (40, 64)).astype(np.float32)
    z = torch.zeros(40, 64)
    for vv, expect in [(4.25, "upper"), (5.25, "zero"), (-3.75, "zero"),
                       (3.25, "full"), (-2.75, "full")]:
        out = warp.warp_banded(_t(img), z, z + vv, 3, max_disp_v=3, packing="exact",
                               clamp_flow=False).numpy()
        y0 = 10 + int(np.floor(vv))
        fy = vv - np.floor(vv)
        row = out[10, 5:-5]
        if expect == "zero":
            assert not row.any()
        elif expect == "upper":
            np.testing.assert_allclose(row, img[y0, 5:-5] * (1 - fy), rtol=1e-6)
        else:
            full = img[y0, 5:-5] * (1 - fy) + img[y0 + 1, 5:-5] * fy
            np.testing.assert_allclose(row, full, rtol=1e-6)


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("converged", [False, True])
def test_exact_refine_plain_matches_pallas(rng, window, converged):
    _check_exact_refine(rng, SHAPE, window, converged)


def test_exact_refine_plain_matches_pallas_multi_tile_ragged(rng):
    # 52 rows: several refine tiles of the Pallas grid, the last one ragged.
    _check_exact_refine(rng, (52, 200), 5, False, tile_rows=16)


def _check_exact_refine(rng, shape, window, converged, tile_rows=None):
    prev, warped = _frames(rng, shape)
    u = rng.uniform(-9, 9, shape).astype(np.float32)
    v = rng.uniform(-9, 9, shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_refine(
            jnp.asarray(prev), jnp.asarray(warped), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(converged), window_size=window, max_disp=8.0, max_disp_v=3.0,
            relaxed_order=False, tile_rows=tile_rows,
        )
    got = lk.lucas_kanade_refine(
        _t(prev), _t(warped), _t(u), _t(v), torch.tensor(converged), window_size=window,
        max_disp=8.0, max_disp_v=3.0, relaxed_order=False,
    )
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=_flow_atol(window))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if converged:
        np.testing.assert_array_equal(got[0].numpy(), np.clip(u, -8, 8))
        np.testing.assert_array_equal(got[1].numpy(), np.clip(v, -3, 3))


FUSED_CASES = [(w, r, False) for r in (False, True) for w in (3, 5, 7)] + [
    (5, False, True), (5, True, True)
]


@pytest.mark.parametrize("window,relaxed,taps", FUSED_CASES)
@pytest.mark.parametrize("confidence", [False, True])
def test_fused_plain_matches_pallas(rng, window, relaxed, taps, confidence):
    prev, curr = _frames(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_fused(
            jnp.asarray(prev), jnp.asarray(curr), window_size=window,
            gaussian_weights=taps, return_confidence=confidence, relaxed_order=relaxed,
        )
    got = lk.lucas_kanade_fused(
        _t(prev), _t(curr), window, gaussian_weights=taps, return_confidence=confidence,
        relaxed_order=relaxed,
    )
    assert len(got) == len(want) == (3 if confidence else 2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=_flow_atol(window, taps))
    if confidence:
        det = np.asarray(want[2])
        np.testing.assert_allclose(got[2].numpy(), det, rtol=0, atol=2e-6 * np.abs(det).max())
        half = window // 2
        assert not got[2][:half].any() and not got[2][:, -half:].any()


def test_fused_wrapper_checks_inputs():
    z = torch.zeros(8, 16)
    with pytest.raises(ValueError):
        lk.lucas_kanade_fused(z, z, window_size=9)
    with pytest.raises(ValueError):
        lk.lucas_kanade_fused(z, z[:4])
    with pytest.raises(TypeError):
        lk.lucas_kanade_fused(z.double(), z.double())


def test_fused_empty_interior_gives_zero_flow():
    # Frames smaller than the window: no pixel has a full window.
    for shape in [(1, 1), (4, 40), (40, 6)]:
        a = torch.arange(float(np.prod(shape))).reshape(shape)
        u, v, det = lk.lucas_kanade_fused(a, a.flip(1), 7, return_confidence=True)
        assert not u.any() and not v.any() and not det.any()
