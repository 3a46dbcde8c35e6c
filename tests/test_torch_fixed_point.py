"""The port's S8.7 integer datapath (``tpuflow_torch.kernels.fixed_point``)
and natural-frame generator (``tpuflow_torch.eval.natural``) against
``tpuflow``'s on the CPU, bit for bit.

Both compute in int32 with two's-complement wraparound: the reference's
``astype(jnp.int64)`` is int32 without ``jax_enable_x64``, so its
``num << 7`` wraps once ``|num| >= 2**24``. The high-contrast case is the
witness: the wrap occurs there, the port equals the reference, and the
same datapath widened to int64 (``tests/s87_witness.py``) does not. The
cases of
``tests/test_fixed_point.py`` are mirrored on the port with the same
limits.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from s87_witness import lucas_kanade_s87_widened, shift_wraps
from scipy.ndimage import gaussian_filter

from tpuflow.eval import natural as jax_natural
from tpuflow.kernels import fixed_point as jax_fp
from tpuflow_torch import lucas_kanade_single_scale
from tpuflow_torch.eval import natural
from tpuflow_torch.kernels import fixed_point

REGION = np.s_[105:135, 55:85]


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
def natural_pair():
    return natural.generate_pair(320, 240, dx=2.0, dy=0.0)


def _both(f0, f1, window=5):
    """(port u, v) and (JAX u, v) as numpy arrays."""
    pu, pv = fixed_point.lucas_kanade_s87(torch.from_numpy(f0), torch.from_numpy(f1), window)
    ju, jv = jax_fp.lucas_kanade_s87(jnp.asarray(f0), jnp.asarray(f1), window_size=window)
    return (pu.numpy(), pv.numpy()), (np.asarray(ju), np.asarray(jv))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_natural_pair_matches_jax_and_the_committed_frames(natural_pair):
    want = jax_natural.generate_pair(320, 240, 2.0, 0.0)
    for got in (natural_pair, natural.committed_pair()):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
    synthetic = natural.generate_pair(64, 48, 1.5, -0.5, synthetic=True)
    for g, w in zip(synthetic, jax_natural.generate_pair(64, 48, 1.5, -0.5, synthetic=True)):
        np.testing.assert_array_equal(g, w)


def test_natural_pair_without_pil(monkeypatch, natural_pair):
    # Without Pillow the committed size still comes from the npz; any
    # other size fails with an error that names the library.
    monkeypatch.setitem(sys.modules, "PIL", None)
    for g, w in zip(natural.generate_pair(320, 240, 2.0, 0.0), natural_pair):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ImportError, match="Pillow"):
        natural.generate_pair(64, 48)


@pytest.mark.parametrize("window", [3, 5, 7])
def test_s87_matches_jax_on_the_natural_pair(natural_pair, window):
    got, want = _both(*natural_pair, window)
    _assert_same(got, want)
    assert np.count_nonzero(got[0]) > 0


def test_s87_matches_jax_where_the_int32_shift_wraps():
    rng = np.random.default_rng(11)
    f0 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    f1 = np.roll(f0, 1, axis=1) ^ rng.integers(0, 64, (48, 64), dtype=np.uint8)
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    wraps = shift_wraps(t0, t1)
    assert wraps > 0
    got, want = _both(f0, f1)
    _assert_same(got, want)
    # Widened to int64, as the reference's docstring says, the result
    # differs from what the reference computes.
    wide = [a.numpy() for a in lucas_kanade_s87_widened(t0, t1)]
    assert any(np.any(w != j) for w, j in zip(wide, want))
    # On a smooth pair nothing wraps, and the witness's own datapath then
    # gives the shipped flow bit for bit.
    g0 = gaussian_filter(rng.uniform(0, 255, (48, 64)), 2.0).astype(np.uint8)
    s0, s1 = torch.from_numpy(g0), torch.from_numpy(np.roll(g0, 1, axis=1))
    assert shift_wraps(s0, s1) == 0
    for w, g in zip(lucas_kanade_s87_widened(s0, s1), fixed_point.lucas_kanade_s87(s0, s1)):
        assert torch.equal(w, g)


def test_s87_matches_jax_on_identical_and_quantization_frames(natural_pair):
    f0, _ = natural_pair
    got, want = _both(f0, f0)
    _assert_same(got, want)
    rng = np.random.default_rng(0)
    g0 = gaussian_filter(rng.uniform(0, 255, (64, 96)), 2.0).astype(np.uint8)
    _assert_same(*_both(g0, np.roll(g0, 1, axis=1)))


@pytest.mark.parametrize("shape", [(4, 4), (7, 9), (240, 320)])
def test_box_downsample_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    f = rng.integers(0, 256, shape, dtype=np.uint8)
    got = fixed_point.box_downsample_2x(torch.from_numpy(f)).numpy()
    want = np.asarray(jax_fp.box_downsample_2x(jnp.asarray(f)))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# tests/test_fixed_point.py's cases, on the port.


def test_rtl_testbench_criteria(natural_pair):
    f0, f1 = natural_pair
    u, v = fixed_point.lucas_kanade_s87(torch.from_numpy(f0), torch.from_numpy(f1))
    mean_u = float(u.numpy()[REGION].mean())
    mean_v = float(v.numpy()[REGION].mean())
    assert np.sqrt(mean_u**2 + mean_v**2) >= 0.5
    assert abs(mean_v) < 0.5


def test_fixed_point_underestimates_float(natural_pair):
    f0, f1 = natural_pair
    uf, _ = lucas_kanade_single_scale(
        torch.from_numpy(f0.astype(np.float32)), torch.from_numpy(f1.astype(np.float32)))
    u8, _ = fixed_point.lucas_kanade_s87(torch.from_numpy(f0), torch.from_numpy(f1))
    mean_float = float(uf.numpy()[REGION].mean())
    mean_fixed = float(u8.numpy()[REGION].mean())
    np.testing.assert_allclose(mean_float, 1.1811, atol=2e-3)
    assert mean_fixed < mean_float < 2.0
    assert 0.9 < mean_fixed


def test_flow_clamp():
    assert fixed_point.FLOW_CLAMP / (1 << fixed_point.FRAC_BITS) == 8.0
    assert (fixed_point.DET_THRESHOLD, fixed_point.FRAC_BITS, fixed_point.FLOW_CLAMP) == (
        jax_fp.DET_THRESHOLD, jax_fp.FRAC_BITS, jax_fp.FLOW_CLAMP)


def test_identical_frames_zero_flow(natural_pair):
    f0 = torch.from_numpy(natural_pair[0])
    u, v = fixed_point.lucas_kanade_s87(f0, f0)
    assert not u.any() and not v.any()


def test_s87_quantization():
    rng = np.random.default_rng(0)
    f0 = gaussian_filter(rng.uniform(0, 255, (64, 96)), 2.0).astype(np.uint8)
    f1 = np.roll(f0, 1, axis=1)
    u, _ = fixed_point.lucas_kanade_s87(torch.from_numpy(f0), torch.from_numpy(f1))
    codes = u.numpy() * 128.0
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)


def test_box_downsample():
    d = fixed_point.box_downsample_2x(torch.arange(16, dtype=torch.uint8).reshape(4, 4))
    assert d.shape == (2, 2)
    assert d[0, 0] == 2
    assert d[1, 1] == (10 + 11 + 14 + 15) // 4
