"""The port's batched kernel API and the ``window_mxu`` window sums (K10),
against the JAX package on the CPU (Pallas in interpret mode), with inputs
from a numpy seed.

Batches (B = 3, 64x200): ``warp.warp_banded``, ``lk.lucas_kanade_refine``
and ``lk.lucas_kanade_fused`` on (B, H, W) against JAX's batched calls,
with per-element ``converged`` (one frozen, two not). Each batch element is
bit-identical to the port's own 2-D call on that plane, so the batch adds
no rounding of its own; against JAX the limits are those of
``test_torch_kernels.py`` and ``test_torch_kernels_exact.py`` (2**-15 for
the warps; 1e-5 px for the flow at windows 5 and 7; rtol 1e-5 for the
refine sums; 2e-6 of the largest |det|), except two that this seed's
batch exceeds at its worst-conditioned window. Interpret mode's XLA:CPU
contracts products into FMAs where the port rounds each one, and the
solve amplifies that ulp by the window's conditioning; the batch has 3x
the 2-D tests' pixels and one window with det 38 (median 1.8e3), pixel
(1, 37, 22):
- window 3: measured 5.6e-4 px (exact order) and 2.1e-4 px (relaxed) at
  that pixel, against 6.2e-5 px in the 2-D tests; held to 1e-3 px;
- Gaussian taps: measured 7.9e-5 px (det 1.8 against a median of 29) and
  3.2e-5 px; held to 1e-4 px.

K10 (``window_mxu=True``):
- the plain window sum against ``pallas_lk._wsum_mxu`` called directly on
  the same plane, within 2 ulp of the largest |sum| (both are f32 matmuls
  that add the same terms in their own orders; measured 1-2 ulp);
- the plain solve against JAX's batched kernel *without* ``window_mxu``:
  JAX's ``window_mxu`` kernel does not trace (``_wsum_mxu`` builds its band
  matrices inside the kernel, which Pallas refuses as captured constants),
  and its 2-D route drops the flag, so the plain sequential / shift-tree
  kernel is the nearest reference. The banded products add the window's
  terms in another order than either, which moves the sums by an ulp or
  two and the solve by the conditioning of each window. Measured at this
  seed, fused: window 3 5.6e-4 px (exact Sobel) and 2.1e-4 px (relaxed),
  at the pixel above, where the sequential sums already differ from JAX's
  by as much; window 5 1.2e-5 and 1.3e-5 px; window 7 2.6e-6 px; |det|
  3.4e-7 of its largest value. So window 3 is held to 1e-3 px, as above,
  and window 5 to 2e-5 px (the relaxed-order limit 1e-5, widened for that
  reason); window 7, |det| and the sums keep theirs;
- Gaussian taps take precedence over the flag, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import gaussian_filter

from tpuflow.kernels import pallas_lk, pallas_warp
from tpuflow_torch.kernels import launch_counts, lk, warp

B, SHAPE = 3, (64, 200)
WARP_ATOL = 2 * float(np.spacing(np.float32(255.0)))
CONVERGED = np.array([True, False, False])


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
    return 1e-3 if window == 3 else 1e-4 if taps else 1e-5


def _mxu_flow_atol(window):
    return {3: 1e-3, 5: 2e-5, 7: 1e-5}[window]


def _frames(rng, batch=B, shape=SHAPE):
    prev = np.stack([gaussian_filter(rng.uniform(0, 255, shape), 2.0) for _ in range(batch)])
    prev = prev.astype(np.float32)
    curr = np.roll(prev, 1, axis=-1) + rng.uniform(-1, 1, prev.shape).astype(np.float32)
    return prev, curr


def _each_equal(batched, single_fn):
    """Every batch element of each output equals the 2-D call's output."""
    for b in range(B):
        single = single_fn(b)
        for got, want in zip(batched, single):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("packing,clamp_flow", [
    ("u8", True), ("u16", True), ("exact", True), ("exact", False),
])
def test_batched_warp_matches_pallas(rng, packing, clamp_flow):
    img = rng.uniform(0, 255, (B, *SHAPE)).astype(np.float32)
    if packing == "u8":
        img = np.round(img)
    u = rng.uniform(-12, 12, img.shape).astype(np.float32)
    v = rng.uniform(-12, 12, img.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_warp.warp_image_banded(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), max_disp=8,
            clamp_flow=clamp_flow, max_disp_v=3, packed_u8=packing == "u8",
            packed_u16=packing == "u16",
        )
    kw = dict(max_disp_v=3, packing=packing, clamp_flow=clamp_flow)
    got = warp.warp_banded(_t(img), _t(u), _t(v), 8, **kw)
    assert got.shape == (B, *SHAPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_ATOL)
    _each_equal([got], lambda b: [warp.warp_banded(_t(img[b]), _t(u[b]), _t(v[b]), 8, **kw)])


def _refine_inputs(rng):
    prev, warped = _frames(rng)
    u = rng.uniform(-9, 9, prev.shape).astype(np.float32)
    v = rng.uniform(-9, 9, prev.shape).astype(np.float32)
    return prev, warped, u, v


def _pallas_refine(prev, warped, u, v, window, relaxed):
    with pltpu.force_tpu_interpret_mode():
        return pallas_lk.lucas_kanade_refine(
            jnp.asarray(prev), jnp.asarray(warped), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(CONVERGED), window_size=window, max_disp=8.0, max_disp_v=3.0,
            relaxed_order=relaxed,
        )


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
def test_batched_refine_matches_pallas(rng, window, relaxed):
    prev, warped, u, v = _refine_inputs(rng)
    want = _pallas_refine(prev, warped, u, v, window, relaxed)
    kw = dict(window_size=window, max_disp=8.0, max_disp_v=3.0, relaxed_order=relaxed)
    got = lk.lucas_kanade_refine(_t(prev), _t(warped), _t(u), _t(v),
                                 torch.from_numpy(CONVERGED), **kw)
    assert got[2].shape == got[3].shape == (B,)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=_flow_atol(window))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # The frozen element passes its clipped flow through.
    np.testing.assert_array_equal(got[0][0].numpy(), np.clip(u[0], -8, 8))
    np.testing.assert_array_equal(got[1][0].numpy(), np.clip(v[0], -3, 3))
    assert not torch.equal(got[0][1], torch.from_numpy(np.clip(u[1], -8, 8)))
    _each_equal(got, lambda b: lk.lucas_kanade_refine(
        _t(prev[b]), _t(warped[b]), _t(u[b]), _t(v[b]), torch.tensor(CONVERGED[b]), **kw))


FUSED_CASES = [(3, False), (5, False), (7, False), (5, True)]


@pytest.mark.parametrize("window,taps", FUSED_CASES)
@pytest.mark.parametrize("relaxed", [False, True])
def test_batched_fused_matches_pallas(rng, window, taps, relaxed):
    prev, curr = _frames(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_fused(
            jnp.asarray(prev), jnp.asarray(curr), window_size=window,
            gaussian_weights=taps, return_confidence=True, relaxed_order=relaxed,
        )
    kw = dict(gaussian_weights=taps, return_confidence=True, relaxed_order=relaxed)
    got = lk.lucas_kanade_fused(_t(prev), _t(curr), window, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=_flow_atol(window, taps))
    det = np.asarray(want[2])
    np.testing.assert_allclose(got[2].numpy(), det, rtol=0, atol=2e-6 * np.abs(det).max())
    _each_equal(got, lambda b: lk.lucas_kanade_fused(_t(prev[b]), _t(curr[b]), window, **kw))
    # Without the |det| plane, the same flow.
    uv = lk.lucas_kanade_fused(_t(prev), _t(curr), window, gaussian_weights=taps,
                               relaxed_order=relaxed)
    assert len(uv) == 2 and torch.equal(uv[0], got[0]) and torch.equal(uv[1], got[1])


@pytest.mark.parametrize("window", [3, 5, 7])
def test_wsum_mxu_plain_matches_jax(rng, window):
    # A structure-tensor product plane (ix * ix of a textured frame) over a
    # 64x200 output's gradient region.
    prev, curr = _frames(rng, batch=1, shape=(64 + window + 1, 200 + window + 1))
    avg = (prev[0] + curr[0]) * 0.5
    ix = (avg[1:-1, :-2] - avg[1:-1, 2:]) * 0.25
    a = (ix * ix).astype(np.float32)
    want = np.asarray(pallas_lk._wsum_mxu(jnp.asarray(a), window, 64, 200))
    got = lk._wsum_mxu_ref(_t(a), window, 64, 200).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * float(np.spacing(np.abs(want).max())))
    # The same window sums as the sequential order, up to the same rounding.
    seq = lk._sliding_sum_sequential(_t(a), window, 64, 200).numpy()
    np.testing.assert_allclose(got, seq, rtol=0, atol=2 * float(np.spacing(np.abs(seq).max())))


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("batch", [1, 2, 5])
def test_wsum_mxu_batch_element_equals_its_plane(rng, window, batch):
    # Each element of a batched window_mxu sum is its plane's 2-D sum bit for
    # bit, whatever blocking the GEMM would choose for either shape.
    for out_rows, out_cols in [(1, 1), (8, 16), (37, 130), (64, 200), (120, 300)]:
        a = rng.uniform(0, 50, (batch, out_rows + window - 1, out_cols + window - 1))
        got = lk._wsum_mxu_ref(_t(a), window, out_rows, out_cols)
        assert got.shape == (batch, out_rows, out_cols)
        for b in range(batch):
            assert torch.equal(got[b], lk._wsum_mxu_ref(_t(a[b]), window, out_rows, out_cols))


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
def test_mxu_refine_plain_matches_pallas_without_flag(rng, window, relaxed):
    prev, warped, u, v = _refine_inputs(rng)
    want = _pallas_refine(prev, warped, u, v, window, relaxed)
    kw = dict(window_size=window, max_disp=8.0, max_disp_v=3.0, relaxed_order=relaxed,
              window_mxu=True)
    got = lk.lucas_kanade_refine(_t(prev), _t(warped), _t(u), _t(v),
                                 torch.from_numpy(CONVERGED), **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=_mxu_flow_atol(window))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    _each_equal(got, lambda b: lk.lucas_kanade_refine(
        _t(prev[b]), _t(warped[b]), _t(u[b]), _t(v[b]), torch.tensor(CONVERGED[b]), **kw))


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
def test_mxu_fused_plain_matches_pallas_without_flag(rng, window, relaxed):
    prev, curr = _frames(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_fused(
            jnp.asarray(prev), jnp.asarray(curr), window_size=window,
            return_confidence=True, relaxed_order=relaxed,
        )
    kw = dict(return_confidence=True, relaxed_order=relaxed, window_mxu=True)
    got = lk.lucas_kanade_fused(_t(prev), _t(curr), window, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=_mxu_flow_atol(window))
    det = np.asarray(want[2])
    np.testing.assert_allclose(got[2].numpy(), det, rtol=0, atol=2e-6 * np.abs(det).max())
    # The port honours the flag on a plane: the same as the batch element,
    # and not the sequential / shift-tree sums.
    _each_equal(got, lambda b: lk.lucas_kanade_fused(_t(prev[b]), _t(curr[b]), window, **kw))
    plain = lk.lucas_kanade_fused(_t(prev[0]), _t(curr[0]), window, return_confidence=True,
                                  relaxed_order=relaxed)
    assert not torch.equal(plain[2], got[2][0])


@pytest.mark.parametrize("relaxed", [False, True])
def test_mxu_gaussian_taps_take_precedence(rng, relaxed):
    prev, curr = _frames(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_lk.lucas_kanade_fused(
            jnp.asarray(prev), jnp.asarray(curr), window_size=5, gaussian_weights=True,
            relaxed_order=relaxed,
        )
    got = lk.lucas_kanade_fused(_t(prev), _t(curr), 5, gaussian_weights=True,
                                relaxed_order=relaxed, window_mxu=True)
    taps = lk.lucas_kanade_fused(_t(prev), _t(curr), 5, gaussian_weights=True,
                                 relaxed_order=relaxed)
    for g, t, w in zip(got, taps, want):
        assert torch.equal(g, t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=_flow_atol(5, True))


def test_reference_window_mxu_faults(rng):
    # The JAX side, recorded: its 2-D route drops window_mxu, and its batched
    # window_mxu kernel does not trace.
    prev, curr = _frames(rng, batch=1, shape=(24, 40))
    p, c = jnp.asarray(prev[0]), jnp.asarray(curr[0])
    with pltpu.force_tpu_interpret_mode():
        flag = pallas_lk.lucas_kanade_fused(p, c, window_mxu=True)
        no_flag = pallas_lk.lucas_kanade_fused(p, c)
        np.testing.assert_array_equal(np.asarray(flag[0]), np.asarray(no_flag[0]))
        with pytest.raises(ValueError, match="captures constants"):
            pallas_lk.lucas_kanade_fused(p[None], c[None], window_mxu=True)


def test_batched_wrappers_check_inputs():
    z = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):  # one flag for a batch of two
        lk.lucas_kanade_refine(z, z, z, z, torch.tensor(False))
    with pytest.raises(ValueError):
        lk.lucas_kanade_refine(z, z, z, z, torch.tensor([False, True, False]))
    with pytest.raises(ValueError):  # 4-D
        lk.lucas_kanade_fused(z[None], z[None])
    with pytest.raises(ValueError):
        lk.lucas_kanade_fused(z[:0], z[:0])
    with pytest.raises(ValueError):
        warp.warp_banded(z[None], z[None], z[None], packing="u8", clamp_flow=True)
    with pytest.raises(ValueError):
        warp.warp_banded(z[:0], z[:0], z[:0], packing="u8", clamp_flow=True)
    with pytest.raises(ValueError):
        warp.warp_banded(z, z[0], z[0], packing="u8", clamp_flow=True)


def test_cpu_batches_run_plain_versions_and_count_no_launch(rng):
    before = launch_counts()
    img = _t(np.round(rng.uniform(0, 255, (2, 16, 24))))
    conv = torch.tensor([False, True])
    warp.warp_banded(img, img * 0, img * 0, packing="u8", clamp_flow=True)
    for mxu in (False, True):
        lk.lucas_kanade_refine(img, img, img * 0, img * 0, conv, window_mxu=mxu)
        lk.lucas_kanade_fused(img, img, return_confidence=True, window_mxu=mxu)
        lk.lucas_kanade_fused(img[0], img[1], window_mxu=mxu)
    assert launch_counts() == before
