"""The ablation microkernels' plain PyTorch versions (K8, K9) against the
TPU scripts' Pallas kernels, run in interpret mode on the CPU. The scripts
are not a package; they are imported by file path and stay unedited.

- K8 (``shift_ablation.shift_adds``): against ``make_fn(kind)(a, 1)``, which
  returns the kernel's out[0, 0] * 1e-20, exactly, and against slice-adds
  built in numpy from the script's ``_offsets``, exactly, for all four
  kinds (there are only adds, in one order); and against the Pallas
  kernel's whole output exactly on signed values spread over 2^-20..2^20,
  where the same slices added in another order differ on most outputs.
- K9 (``warp_mxu_ablation.candidate_accumulate``): against ``_build(mode, 8,
  256)`` in both modes, and at (rows, wp) = (1, 128), (3, 128) and (5,
  384), within one ulp of the largest |acc|. XLA:CPU contracts
  ``acc + g * c`` into an FMA where the port rounds the product and the add
  separately, as the CUDA kernel does under ``-fmad=false`` (measured 4.9e-4,
  one ulp at |acc| < 8192, on 29% of pixels in gather mode and 32% in
  shifts mode).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation, warp_walk

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_shift():
    return _script("shift_ablation")


@pytest.fixture(scope="module")
def tpu_warp():
    return _script("warp_mxu_ablation")


def test_shift_constants_match_the_script(tpu_shift):
    assert (shift_ablation.ROWS, shift_ablation.COLS) == (tpu_shift.ROWS, tpu_shift.COLS)
    assert (shift_ablation.OUT_R, shift_ablation.OUT_C) == (tpu_shift.OUT_R, tpu_shift.OUT_C)
    assert shift_ablation.N_SHIFTS == tpu_shift.N_SHIFTS
    for kind in shift_ablation.KINDS:
        assert shift_ablation.offsets(kind) == tpu_shift._offsets(kind)


@pytest.mark.parametrize("kind", shift_ablation.KINDS)
def test_shift_adds_plain_matches_pallas(rng, tpu_shift, kind):
    a = rng.uniform(0.0, 1.0, (tpu_shift.ROWS, tpu_shift.COLS)).astype(np.float32)
    got = shift_ablation.shift_adds(torch.from_numpy(a), kind).numpy()
    with pltpu.force_tpu_interpret_mode():
        scalar = float(tpu_shift.make_fn(kind)(jnp.asarray(a), 1))
    assert scalar == float(np.float32(got[0, 0]) * np.float32(1e-20))
    r, c = tpu_shift._offsets(kind)
    n_r, n_c = tpu_shift.OUT_R, tpu_shift.OUT_C
    want = a[r[0] : r[0] + n_r, c[0] : c[0] + n_c]
    for i in range(1, len(r)):
        want = want + a[r[i] : r[i] + n_r, c[0] : c[0] + n_c]
    for i in range(1, len(c)):
        want = want + a[r[0] : r[0] + n_r, c[i] : c[i] + n_c]
    np.testing.assert_array_equal(got, want)


def _pallas_shift_kernel(tpu_shift, kind):
    """``make_fn(kind)``'s pallas_call itself, whose (64, 1024) output the
    timing loop reduces to one element; taken from the loop's closure, so
    it must be built in interpret mode."""
    loop = tpu_shift.make_fn(kind).__wrapped__
    return dict(zip(loop.__code__.co_freevars, loop.__closure__))["call"].cell_contents


@pytest.mark.parametrize("kind", shift_ablation.KINDS)
def test_shift_adds_plain_matches_pallas_on_order_sensitive_input(tpu_shift, kind):
    a = shift_ablation.make_input(torch.device("cpu"), 3, spread=True)
    got = shift_ablation.shift_adds(a, kind)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_shift_kernel(tpu_shift, kind)(jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    # The input tells the order apart: column slices before row slices
    # round otherwise on most outputs.
    r, c = shift_ablation.offsets(kind)
    n_r, n_c = shift_ablation.OUT_R, shift_ablation.OUT_C
    swapped = a[r[0] : r[0] + n_r, c[0] : c[0] + n_c]
    for i in range(1, len(c)):
        swapped = swapped + a[r[0] : r[0] + n_r, c[i] : c[i] + n_c]
    for i in range(1, len(r)):
        swapped = swapped + a[r[i] : r[i] + n_r, c[0] : c[0] + n_c]
    assert float((swapped != got).float().mean()) > 0.5


def test_warp_gather_constants_match_the_script(tpu_warp):
    assert warp_mxu_ablation.ITERS == tpu_warp.ITERS
    assert warp_mxu_ablation.MAXD == tpu_warp.MAXD


@pytest.mark.parametrize("mode", warp_mxu_ablation.MODES)
def test_warp_gather_plain_matches_pallas(tpu_warp, mode):
    rows, wp = 8, 256
    x, off = warp_mxu_ablation.make_inputs(torch.device("cpu"), rows, wp)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tpu_warp._build(mode, rows, wp)(
            jnp.asarray(x.numpy()[None]), jnp.asarray(off.numpy()[None])))[0]
    got = warp_mxu_ablation.candidate_accumulate(x, off, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.spacing(np.abs(want).max())))
    assert (got != want).any()  # the FMA contraction is real, so the limit is needed


@pytest.mark.parametrize("mode", warp_mxu_ablation.MODES)
@pytest.mark.parametrize("rows,wp", [(1, 128), (3, 128), (5, 384)])
def test_warp_gather_plain_matches_pallas_at_odd_shapes(tpu_warp, mode, rows, wp):
    x, off = warp_mxu_ablation.make_inputs(torch.device("cpu"), rows, wp, seed=rows)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tpu_warp._build(mode, rows, wp)(
            jnp.asarray(x.numpy()[None]), jnp.asarray(off.numpy()[None])))[0]
    got = warp_mxu_ablation.candidate_accumulate(x, off, mode).numpy()
    # One ulp in the binade of the script's sums ([4096, 8192): 18 steps of
    # at most 255 x 1.17), the limit the (8, 256) case reads off its plane.
    # A small plane's largest |acc| may sit a binade lower, where the FMA
    # contraction's 4.9e-4 is two of that plane's ulps.
    atol = float(np.spacing(np.float32(4096.0)))
    assert np.abs(want).max() < 8192.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_ablation_wrappers_check_inputs_and_count_no_cpu_launch():
    before = (dict(shift_ablation.launch_counts), dict(warp_mxu_ablation.launch_counts))
    a = shift_ablation.make_input(torch.device("cpu"))
    with pytest.raises(ValueError):
        shift_ablation.shift_adds(a, "diagonal")
    with pytest.raises(ValueError):
        shift_ablation.shift_adds(a[:, :1024], "aligned")
    shift_ablation.shift_adds(a, "aligned")
    x, off = warp_mxu_ablation.make_inputs(torch.device("cpu"), 2, 128)
    with pytest.raises(ValueError):
        warp_mxu_ablation.candidate_accumulate(x, off, "matmul")
    with pytest.raises(ValueError):
        warp_mxu_ablation.candidate_accumulate(x[:, :300], off, "gather")
    with pytest.raises(TypeError):
        warp_mxu_ablation.candidate_accumulate(x, off.to(torch.int64), "gather")
    with pytest.raises(ValueError):  # no rows: the kernel takes rows >= 1
        warp_mxu_ablation.candidate_accumulate(x[:0], off[:0], "gather")
    warp_mxu_ablation.candidate_accumulate(x, off, "shifts")
    assert (shift_ablation.launch_counts, warp_mxu_ablation.launch_counts) == before


# The walk ablation's function is the banded warp's: its plain version
# against the Pallas warp (interpret mode), to test_torch_kernels' limit.
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
@pytest.mark.parametrize("band", [(8, 3), (8, 8), (0, 0)])
def test_warp_walk_plain_matches_pallas(rng, packing, band):
    from tpuflow.kernels import pallas_warp

    shape = (40, 72)
    md, mdv = band
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    u, v = (rng.uniform(-md - 1, md + 1, shape).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_warp.warp_image_banded(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), max_disp=md, clamp_flow=True,
            max_disp_v=mdv, packed_u8=packing == "u8", packed_u16=packing == "u16")
    got = warp_walk.warp_walk(*(torch.from_numpy(a) for a in (img, u, v)), md, mdv, packing,
                              walk_rows=16)
    atol = 2 * float(np.spacing(np.float32(255.0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_warp_walk_checks_inputs_and_counts_no_cpu_launch():
    before = dict(warp_walk.launch_counts)
    z = torch.zeros(8, 16)
    for walk_rows in (0, 8, 24):
        with pytest.raises(ValueError):
            warp_walk.warp_walk(z, z, z, walk_rows=walk_rows)
    with pytest.raises(ValueError):
        warp_walk.warp_walk(z, z, z, packing="u8", clamp_flow=False)
    with pytest.raises(ValueError):
        warp_walk.warp_block(z, z, z, 8, 8, "u16", True, staged=True)
    assert torch.equal(warp_walk.warp_walk(z, z, z, walk_rows=48), z)
    assert warp_walk.launch_counts == before
