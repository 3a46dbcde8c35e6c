"""The port's kernel entry points take the reference's calls with the
reference's meaning.

``kernels.warp.warp_banded``, ``kernels.lk.lucas_kanade_refine`` and
``kernels.lk.lucas_kanade_fused`` (and their plain versions) list
``pallas_warp.warp_image_banded``'s, ``pallas_lk.lucas_kanade_refine``'s and
``pallas_lk.lucas_kanade_fused``'s parameters in the same order with the
same defaults; the port adds only the keyword-only ``packing``. Each of the
reference's call forms below, made on both packages at 64x200 with inputs
from a numpy seed (Pallas in interpret mode), gives the reference's result:
the defaults (the exact warp, flow not clamped), ``tile_rows`` given
positionally, the packed flags, and a positional call that asks for
Gaussian taps.

Limits, as ``test_torch_kernels.py`` and ``test_torch_kernels_exact.py``
state them: 2**-15 for the warps (XLA:CPU contracts lerp products into
FMAs), 2e-5 px with Gaussian taps, 1e-5 px at window 5 and rtol 1e-5 on
the refine's sums.
"""

import inspect

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

# (port function, reference function) pairs that must list the same
# parameters.
PAIRS = {
    "warp_banded": (warp.warp_banded, pallas_warp.warp_image_banded),
    "warp_banded_ref": (warp.warp_banded_ref, pallas_warp.warp_image_banded),
    "lucas_kanade_refine": (lk.lucas_kanade_refine, pallas_lk.lucas_kanade_refine),
    "lucas_kanade_refine_ref": (lk.lucas_kanade_refine_ref, pallas_lk.lucas_kanade_refine),
    "lucas_kanade_fused": (lk.lucas_kanade_fused, pallas_lk.lucas_kanade_fused),
    "lucas_kanade_fused_ref": (lk.lucas_kanade_fused_ref, pallas_lk.lucas_kanade_fused),
}

# Name -> (entry point, positional arguments after the planes, keywords,
# limit on u, v or the warped frame).
FORMS = {
    "warp_defaults": ("warp", (), {}, WARP_ATOL),
    "warp_tile_rows_positional": ("warp", (8, 16, True, 3), {}, WARP_ATOL),
    "warp_packed_u16": ("warp", (), dict(clamp_flow=True, packed_u16=True), WARP_ATOL),
    "fused_taps_positional": ("fused", (5, 1e-4, None, True), {}, 2e-5),
    "refine_tile_rows_and_band_positional": ("refine", (5, 1e-4, 8.0, 16, 3.0), {}, 1e-5),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind is not p.KEYWORD_ONLY]


@pytest.mark.parametrize("name", list(PAIRS))
def test_entry_points_list_the_reference_parameters(name):
    port, ref = PAIRS[name]
    assert _params(port) == _params(ref)
    extra = [p for p in inspect.signature(port).parameters.values() if p.kind is p.KEYWORD_ONLY]
    assert [p.name for p in extra] == (["packing"] if "warp" in name else [])


def _planes(rng, entry):
    """The planes of one call: numpy arrays for the reference, in order."""
    if entry == "warp":
        img = rng.integers(0, 256, SHAPE).astype(np.float32)
        return [img] + [rng.uniform(-12, 12, SHAPE).astype(np.float32) for _ in range(2)]
    prev = gaussian_filter(rng.uniform(0, 255, SHAPE), 2.0).astype(np.float32)
    curr = np.roll(prev, 1, axis=1) + rng.uniform(-1, 1, SHAPE).astype(np.float32)
    if entry == "fused":
        return [prev, curr]
    flow = [rng.uniform(-9, 9, SHAPE).astype(np.float32) for _ in range(2)]
    return [prev, curr, *flow, np.asarray(False)]


@pytest.mark.parametrize("form", list(FORMS))
def test_reference_call_forms_mean_the_same(rng, form):
    entry, args, kw, atol = FORMS[form]
    planes = _planes(rng, entry)
    ref = {"warp": pallas_warp.warp_image_banded, "fused": pallas_lk.lucas_kanade_fused,
           "refine": pallas_lk.lucas_kanade_refine}[entry]
    port = {"warp": warp.warp_banded, "fused": lk.lucas_kanade_fused,
            "refine": lk.lucas_kanade_refine}[entry]
    with pltpu.force_tpu_interpret_mode():
        want = ref(*(jnp.asarray(p) for p in planes), *args, **kw)
    got = port(*(torch.from_numpy(p) for p in planes), *args, **kw)
    want = [want] if entry == "warp" else list(want)
    got = [got] if entry == "warp" else list(got)
    assert len(got) == len(want)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    for g, w in zip(got[2:], want[2:]):  # the refine's sums
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(packed_u8=True, packed_u16=True),
                                dict(packed_u8=True, packing="exact"),
                                dict(packed_u16=True, packing="u8")])
def test_warp_refuses_conflicting_packings(kw):
    z = torch.zeros(8, 16)
    for fn in (warp.warp_banded, warp.warp_banded_ref):
        with pytest.raises(ValueError):
            fn(z, z, z, clamp_flow=True, **kw)
    with pytest.raises(ValueError):  # a packed flag without the clamp
        warp.warp_banded(z, z, z, packed_u16=True)
    got = warp.warp_banded(z, z, z, clamp_flow=True, packed_u8=True, packing="u8")
    assert torch.equal(got, z)
