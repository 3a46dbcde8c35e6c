"""The port's configs, numerics core and plain reference functions against
the JAX package, on numpy-seeded inputs fed to both sides (CPU).

Tolerances: the unrolled shift/add numerics and the map_coordinates
sampling are bit-exact between torch and XLA on the CPU. The banded
matmuls are not: a torch f32 matmul and XLA's differ by a few ulp, up to
4.6e-5 on 0..255 data for ``downsample_fused`` (hence 1e-4) and 2.4e-7 for
``resize_bilinear`` on flow-sized data (hence 1e-6).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as nd_gaussian_filter

from tpuflow.core import config as jconfig
from tpuflow.core import ops as jops
from tpuflow.eval import patterns
from tpuflow.flow import lucas_kanade_single_scale as j_single_scale
from tpuflow.kernels import jnp_ref
from tpuflow_torch import convert
from tpuflow_torch.core import config as tconfig
from tpuflow_torch.core import ops as tops
from tpuflow_torch.flow import lucas_kanade_single_scale as t_single_scale
from tpuflow_torch.kernels import lk, torch_ref

REPO = Path(__file__).resolve().parent.parent


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


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _textured(rng, shape):
    return nd_gaussian_filter(rng.uniform(0, 255, shape), 2.0).astype(np.float32)


# --- (a) configs and operator builders ---------------------------------------


@pytest.mark.parametrize("name", sorted(jconfig.PYRAMID_CONFIGS))
def test_named_config_matches_field_for_field(name):
    assert set(tconfig.PYRAMID_CONFIGS) == set(jconfig.PYRAMID_CONFIGS)
    j, t = jconfig.PYRAMID_CONFIGS[name], tconfig.PYRAMID_CONFIGS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.max_disp_v_effective == j.max_disp_v_effective
    assert convert.config_from_reference(j) == t
    assert convert.config_from_reference(dataclasses.asdict(j)) == t


def test_config_defaults_and_validation_match():
    assert dataclasses.asdict(tconfig.PyramidConfig()) == dataclasses.asdict(
        jconfig.PyramidConfig()
    )
    for bad in ((3,), (3, 3), (8, 3), (3, 9)):
        with pytest.raises(ValueError):
            jconfig.PyramidConfig(adaptive_v_bands=bad)
        with pytest.raises(ValueError):
            tconfig.PyramidConfig(adaptive_v_bands=bad)
    with pytest.raises(ValueError):
        convert.config_from_reference({"levels": 3})


@pytest.mark.parametrize(
    "args", [(240, 120, 2.0), (1080, 540, 2.0), (135, 67, 2.0), (17, 8, 1.0)]
)
def test_downsample_operator_builder_equal(args):
    assert np.array_equal(tops._downsample_matrix_np(*args), jops._downsample_matrix_np(*args))


@pytest.mark.parametrize("args", [(60, 120), (270, 540), (960, 1920), (7, 13)])
def test_resample_operator_builder_equal(args):
    assert np.array_equal(tops._resample_matrix_np(*args), jops._resample_matrix_np(*args))
    assert tops._banded_blocks(tops._resample_matrix_np(*args), 256) == jops._banded_blocks(
        jops._resample_matrix_np(*args), 256
    )


def test_gaussian_taps_and_window_kernels_equal():
    assert np.array_equal(tops.gaussian_kernel1d(2.0), jops.gaussian_kernel1d(2.0))
    assert np.array_equal(tops.linspace_grid(240, 120), jops.linspace_grid(240, 120))
    assert np.array_equal(
        tops.gaussian_window_kernel(5, 1.0), jops.gaussian_window_kernel(5, 1.0)
    )


# --- (b) ops against tpuflow.core.ops -----------------------------------------


@pytest.mark.parametrize(
    "src,dst", [((60, 80), (120, 160)), ((120, 160), (240, 320)), ((135, 240), (270, 480))]
)
def test_resize_bilinear(rng, src, dst):
    # Coarse-level flow: |v| < 4 px, so 1e-6 is about 2 ulp.
    img = rng.uniform(-4, 4, src).astype(np.float32)
    want = np.asarray(jops.resize_bilinear(_j(img), *dst))
    got = tops.resize_bilinear(_t(img), *dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "src,dst", [((240, 320), (120, 160)), ((600, 800), (300, 400)), ((1080, 1920), (540, 960))]
)
def test_downsample_fused(rng, src, dst):
    img = np.round(_textured(rng, src))
    want = np.asarray(jops.downsample_fused(_j(img), *dst, 2.0))
    got = tops.downsample_fused(_t(img), *dst, 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kernel", ["sobel_x", "sobel_y", "asym"])
def test_conv2d_symm_exact(rng, kernel):
    k = {
        "sobel_x": jnp_ref.SOBEL_X,
        "sobel_y": jnp_ref.SOBEL_Y,
        "asym": rng.uniform(-1, 1, (3, 5)).astype(np.float32),
    }[kernel]
    img = _textured(rng, (48, 64))
    np.testing.assert_array_equal(
        tops.conv2d_symm(_t(img), k).numpy(), np.asarray(jops.conv2d_symm(_j(img), k))
    )


def test_map_coordinates_bilinear_exact(rng):
    img = _textured(rng, (40, 56))
    y = rng.uniform(-3, 43, (40, 56)).astype(np.float32)
    x = rng.uniform(-3, 59, (40, 56)).astype(np.float32)
    y[0, :4] = [0.0, 39.0, 39.5, -0.0]  # exact edges
    want = np.asarray(jops.map_coordinates_bilinear(_j(img), _j(y), _j(x), cval=7.0))
    got = tops.map_coordinates_bilinear(_t(img), _t(y), _t(x), cval=7.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_gaussian_filter_and_window_sums(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tops.gaussian_filter(_t(img), 2.0).numpy(),
        np.asarray(jops.gaussian_filter(_j(img), 2.0)), rtol=0, atol=1e-4,
    )
    np.testing.assert_array_equal(
        tops.uniform_window_sum_valid(_t(img), 5).numpy(),
        np.asarray(jops.uniform_window_sum_valid(_j(img), 5)),
    )
    wk = jops.gaussian_window_kernel(5, 1.0)
    np.testing.assert_allclose(
        tops.weighted_window_sum_valid(_t(img), wk).numpy(),
        np.asarray(jops.weighted_window_sum_valid(_j(img), wk)), rtol=1e-6, atol=1e-4,
    )


# --- (c) torch_ref against jnp_ref --------------------------------------------


def test_gradients_exact(rng):
    prev, curr = _textured(rng, (48, 64)), _textured(rng, (48, 64))
    for got, want in zip(
        torch_ref.compute_gradients(_t(prev), _t(curr)),
        jnp_ref.compute_gradients(_j(prev), _j(curr)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gaussian_weights", [False, True])
def test_lk_solve(rng, gaussian_weights):
    prev, curr = _textured(rng, (48, 64)), _textured(rng, (48, 64))
    grads = jnp_ref.compute_gradients(_j(prev), _j(curr))
    want = jnp_ref.lucas_kanade_from_gradients(
        *grads, gaussian_weights=gaussian_weights, return_confidence=True
    )
    got = torch_ref.lucas_kanade_from_gradients(
        *(_t(np.asarray(g)) for g in grads), gaussian_weights=gaussian_weights,
        return_confidence=True,
    )
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-3)


def test_warp_image_exact(rng):
    img = _textured(rng, (40, 56))
    u = rng.uniform(-6, 6, (40, 56)).astype(np.float32)
    v = rng.uniform(-6, 6, (40, 56)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_ref.warp_image(_t(img), _t(u), _t(v)).numpy(),
        np.asarray(jnp_ref.warp_image(_j(img), _j(u), _j(v))),
    )


def test_upsample_flow_and_pyramid(rng):
    u = rng.uniform(-4, 4, (60, 80)).astype(np.float32)
    v = rng.uniform(-4, 4, (60, 80)).astype(np.float32)
    for g, w in zip(
        torch_ref.upsample_flow(_t(u), _t(v), (120, 160)),
        jnp_ref.upsample_flow(_j(u), _j(v), (120, 160)),
    ):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    img = np.round(_textured(rng, (240, 320)))
    got = torch_ref.build_gaussian_pyramid(_t(img), 3)
    want = jnp_ref.build_gaussian_pyramid(_j(img), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(patterns.TEST_PATTERNS))
def test_single_scale_flow_on_pattern_exact(name):
    # The parity path repeats jnp_ref's f32 operations in order, and the
    # divide-form solve rounds the same on both sides: bit-identical.
    f0, f1 = patterns.generate_test_pattern(
        patterns.TEST_PATTERNS[name], 320, 240, output_dir=None
    )
    want = j_single_scale(_j(f0), _j(f1), 5, backend="jnp")
    got = t_single_scale(_t(f0), _t(f1), 5, backend="torch")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name == "no_motion":
        assert not got[0].any() and not got[1].any()


def test_single_scale_cuda_backend_names_missing_kernel(rng):
    # backend="cuda" is the fused kernel (K6, K7 with confidence); on CPU
    # tensors it runs the kernel's plain version.
    f0 = _t(nd_gaussian_filter(rng.uniform(0, 255, (40, 56)), 2.0))
    f1 = f0.roll(1, dims=1)
    for conf in (False, True):
        got = t_single_scale(f0, f1, backend="cuda", return_confidence=conf)
        want = lk.lucas_kanade_fused_ref(f0, f1, 5, return_confidence=conf)
        assert len(got) == len(want) == (3 if conf else 2)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_single_scale(f0, f1, backend="pallas")


# --- (h) import isolation, (i) no CPU fallback for the chip smoke ------------


def test_import_pulls_in_no_jax_triton_or_build():
    code = (
        "import sys\n"
        "import tpuflow_torch, tpuflow_torch.convert, tpuflow_torch.core.ops\n"
        "import tpuflow_torch.kernels.warp, tpuflow_torch.kernels.lk\n"
        "import tpuflow_torch.flow.pyramidal, tpuflow_torch.eval.verifier\n"
        "from tpuflow_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuflow', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not _build.is_loaded()\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def _run_chip_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = _run_chip_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
