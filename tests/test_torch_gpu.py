"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor ``tpuflow``, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Limits: the warps (K1, K2, K4) bit-exact; the refine steps' (K3, K5) u, v
within 1e-5 px and their sums to rtol 1e-5 (per-block partials are summed
in another order); the fused single-scale solve (K6, K7) u, v and |det|
within 1e-5; short `production` and `default` streams with the same rounds
per level and within 1e-3 px.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import launch_counts, lk, torch_ref, warp

pytestmark = pytest.mark.gpu

_WARP_COUNTER = {"u8": "warp_packed_u8", "u16": "warp_packed_u16", "exact": "warp_exact"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(37, 61), (64, 200), (1, 1)])
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
@pytest.mark.parametrize("band", [0, 2, 3, 8])
def test_warp_kernel_bit_exact(cuda, shape, packing, band):
    rng = np.random.default_rng(band)
    img = _rand(rng, shape, 0, 255, cuda)
    if packing == "u8":
        img = img.round()
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    before = launch_counts()[_WARP_COUNTER[packing]]
    got = warp.warp_banded(img, u, v, 8, band, packing)
    want = warp.warp_banded_ref(img, u, v, 8, band, packing)
    torch.cuda.synchronize()
    assert launch_counts()[_WARP_COUNTER[packing]] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(37, 61), (64, 200), (1, 1)])
@pytest.mark.parametrize("band", [2, 3, 8])
def test_exact_warp_kernel_unclamped_bit_exact(cuda, shape, band):
    rng = np.random.default_rng(band)
    img = _rand(rng, shape, 0, 255, cuda)
    u, v = _rand(rng, shape, -12, 12, cuda), _rand(rng, shape, -12, 12, cuda)
    got = warp.warp_banded(img, u, v, 8, band, "exact", clamp_flow=False)
    want = warp.warp_banded_ref(img, u, v, 8, band, "exact", clamp_flow=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7), (17, 33), (52, 200), (64, 96)])
@pytest.mark.parametrize("converged", [False, True])
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [True, False])
def test_refine_kernel_matches_plain(cuda, shape, converged, window, relaxed):
    rng = np.random.default_rng(shape[0])
    prev = _rand(rng, shape, 0, 255, cuda)
    warped = prev.roll(1, dims=1) + _rand(rng, shape, -1, 1, cuda)
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    conv = torch.tensor(converged, device=cuda)
    args = (prev, warped, u, v, conv, window, 1e-4, 8.0, 3.0, relaxed)
    name = "lk_refine" if relaxed else "lk_refine_exact"
    before = launch_counts()[name]
    got = lk.lucas_kanade_refine(*args)
    want = lk.lucas_kanade_refine_ref(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(37, 61), (1, 1), (52, 200)])
@pytest.mark.parametrize("window,taps", [(3, False), (5, False), (7, False), (5, True)])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("confidence", [False, True])
def test_fused_kernel_matches_plain(cuda, shape, window, taps, relaxed, confidence):
    rng = np.random.default_rng(shape[1])
    prev = _rand(rng, shape, 0, 255, cuda)
    curr = prev.roll(1, dims=1) + _rand(rng, shape, -1, 1, cuda)
    args = (prev, curr, window, 1e-4, taps, 1.0, confidence, relaxed)
    name = "lk_fused_conf" if confidence else "lk_fused"
    before = launch_counts()[name]
    got = lk.lucas_kanade_fused(*args)
    want = lk.lucas_kanade_fused_ref(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_wrappers_reject_non_contiguous(cuda):
    z = torch.zeros(16, 32, device=cuda).t()
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z)
    with pytest.raises(ValueError):
        lk.lucas_kanade_refine(z, z, z, z, torch.tensor(False, device=cuda))
    with pytest.raises(ValueError):
        lk.lucas_kanade_fused(z, z)


@pytest.mark.parametrize("config", ["production", "default"])
def test_short_stream_matches_plain_path(cuda, monkeypatch, config):
    cfg = PYRAMID_CONFIGS[config]
    rng = np.random.default_rng(3)
    a = np.round(gaussian_filter(rng.uniform(0, 255, (120, 160)), 2.0)).astype(np.float32)
    a = torch.from_numpy(a).to(cuda)
    b = a.roll(2, dims=1)

    def stream():
        carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
        out = []
        for frame in (b, a, b):
            u, v, carry = lucas_kanade_pyramidal_step(carry, frame, cfg, backend="cuda")
            out.append((u, v, list(pyramidal.counters.level_iterations)))
        return out

    kernels = stream()
    monkeypatch.setattr(warp, "warp_banded", warp.warp_banded_ref)
    monkeypatch.setattr(lk, "lucas_kanade_refine", lk.lucas_kanade_refine_ref)
    plain = stream()
    for (u, v, n), (pu, pv, pn) in zip(kernels, plain):
        assert n == pn
        torch.testing.assert_close(u, pu, rtol=0, atol=1e-3)
        torch.testing.assert_close(v, pv, rtol=0, atol=1e-3)
