"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor ``tpuflow``, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Limits: the warps bit-exact; the refine's u, v within 1e-5 px and its sums
to rtol 1e-5 (per-block partials are summed in another order); a short
production stream with the same rounds per level and within 1e-3 px.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import launch_counts, lk, torch_ref, warp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(37, 61), (64, 200), (1, 1)])
@pytest.mark.parametrize("packing", ["u8", "u16"])
@pytest.mark.parametrize("band", [0, 2, 3, 8])
def test_warp_kernel_bit_exact(cuda, shape, packing, band):
    rng = np.random.default_rng(band)
    img = _rand(rng, shape, 0, 255, cuda)
    if packing == "u8":
        img = img.round()
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    before = launch_counts()[f"warp_packed_{packing}"]
    got = warp.warp_banded(img, u, v, 8, band, packing)
    want = warp.warp_banded_ref(img, u, v, 8, band, packing)
    torch.cuda.synchronize()
    assert launch_counts()[f"warp_packed_{packing}"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7), (17, 33), (52, 200), (64, 96)])
@pytest.mark.parametrize("converged", [False, True])
def test_refine_kernel_matches_plain(cuda, shape, converged):
    rng = np.random.default_rng(shape[0])
    prev = _rand(rng, shape, 0, 255, cuda)
    warped = prev.roll(1, dims=1) + _rand(rng, shape, -1, 1, cuda)
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    conv = torch.tensor(converged, device=cuda)
    before = launch_counts()["lk_refine"]
    got = lk.lucas_kanade_refine(prev, warped, u, v, conv, max_disp=8.0, max_disp_v=3.0)
    want = lk.lucas_kanade_refine_ref(prev, warped, u, v, conv, max_disp=8.0, max_disp_v=3.0)
    torch.cuda.synchronize()
    assert launch_counts()["lk_refine"] == before + 1
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_wrappers_reject_non_contiguous(cuda):
    z = torch.zeros(16, 32, device=cuda).t()
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z)
    with pytest.raises(ValueError):
        lk.lucas_kanade_refine(z, z, z, z, torch.tensor(False, device=cuda))


def test_short_stream_matches_plain_path(cuda, monkeypatch):
    cfg = PYRAMID_CONFIGS["production"]
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
