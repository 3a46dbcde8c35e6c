"""The kernels' bounds (``tpuflow_torch.eval.bounds``) against hand counts.

Bytes one call must move, each input read once and each output written
once, over the H100's 3.35 TB/s; every kernel is bound by bytes. Also that
``chip_smoke.py`` has a bound and a yardstick entry for every kernel it
reports. CPU only: nothing here times anything.
"""

import pytest
import torch

import chip_smoke
from tpuflow_torch.eval import bounds

PIXELS_1080P = 1080 * 1920  # 2,073,600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_refine_at_1080p_moves_24_bytes_a_pixel():
    # prev, warped, u, v in; u, v out: 6 f32 planes.
    assert bounds.call_bytes("lk_refine", 1, 1080, 1920) == 49_766_400
    ms, by = bounds.bound("lk_refine", 1, 1080, 1920)
    assert by == "bytes"
    assert ms == pytest.approx(0.01486, abs=5e-6)
    assert ms == pytest.approx(49_766_400 / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("name,per_pixel", [
    ("warp_packed_u8", 16), ("warp_packed_u16", 16), ("warp_exact", 16),
    ("lk_refine", 24), ("lk_refine_exact", 24), ("lk_refine_mxu", 24),
    ("lk_fused", 16), ("lk_fused_mxu", 16),
    ("lk_fused_conf", 20), ("lk_fused_conf_mxu", 20),
])
def test_plane_kernels_bytes_at_1080p(name, per_pixel):
    assert bounds.call_bytes(name, 1, 1080, 1920) == per_pixel * PIXELS_1080P
    ms, by = bounds.bound(name, 1, 1080, 1920)
    assert by == "bytes"
    assert ms == pytest.approx(per_pixel * PIXELS_1080P / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("name", ["warp_packed_u16", "lk_refine_exact", "lk_fused_conf"])
@pytest.mark.parametrize("batch", [2, 5])
def test_batches_scale_bytes_and_bound(name, batch):
    one = bounds.call_bytes(name, 1, 540, 960)
    assert bounds.call_bytes(name, batch, 540, 960) == batch * one
    assert bounds.bound_ms(name, batch, 540, 960) == pytest.approx(
        batch * bounds.bound_ms(name, 1, 540, 960), rel=1e-12)


def test_coarse_levels_of_the_production_pyramid():
    # K2 at 540x960: 8,294,400 B, 2.476 us; K3 at 270x480: 3,110,400 B, 0.928 us.
    assert bounds.call_bytes("warp_packed_u16", 1, 540, 960) == 8_294_400
    assert bounds.bound_ms("warp_packed_u16", 1, 540, 960) == pytest.approx(0.002476, abs=1e-6)
    assert bounds.call_bytes("lk_refine", 1, 270, 480) == 3_110_400
    assert bounds.bound_ms("lk_refine", 1, 270, 480) == pytest.approx(0.000928, abs=1e-6)


def test_shift_ablation_reads_its_input_once():
    # "aligned", the kind the smoke times: its 31 (64, 1024) slices cover
    # rows 0-183 of columns 0-1023 and rows 0-63 of columns 1024-1919 of the
    # (256, 2048) input; the (64, 1024) f32 output is written once.
    want = 4 * (184 * 1024 + 64 * 896 + 64 * 1024)
    assert want == 1_245_184
    assert bounds.call_bytes("shift_ablation", 1, 64, 1024) == want
    assert bounds.call_bytes("shift_ablation", 1, 64, 1024, "aligned") == want
    ms, by = bounds.bound("shift_ablation", 1, 64, 1024)
    assert by == "bytes"
    assert ms == pytest.approx(0.00037170, abs=5e-9)
    with pytest.raises(ValueError):
        bounds.call_bytes("shift_ablation", 1, 256, 2048)


@pytest.mark.parametrize("kind,covered", [
    # Row slices at rows r_k..r_k+63 of columns c_0..c_0+1023, column slices
    # at rows r_0..r_0+63 of columns c_k..c_k+1023.
    ("aligned", 184 * 1024 + 64 * 896),     # r 0..120 by 8, c 0..896 by 128
    ("misaligned", 79 * 1024 + 64 * 15),    # r and c 1..16
    ("rows_only", 79 * 1024 + 64 * 896),    # r 1..16, c 0..896 by 128
    ("cols_only", 184 * 1024 + 64 * 15),    # r 0..120 by 8, c 1..16
])
def test_shift_ablation_bytes_by_kind(kind, covered):
    got = bounds.call_bytes("shift_ablation", 1, 64, 1024, kind)
    assert got == 4 * (covered + 64 * 1024)
    assert bounds.bound_ms("shift_ablation", 1, 64, 1024, kind) == pytest.approx(
        got / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("mode,band_cols", [
    ("gather", 1920),              # x[:, 128:128 + wp], every column reached
    ("shifts", 1920 + 2 * 8 + 2),  # dx in -9..9 for offsets in [-8, 8]
])
def test_warp_gather_ablation_bytes(mode, band_cols):
    # The band columns the mode reads and the (64, 1920) int32 offsets in,
    # the (64, 1920) f32 output out.
    want = 4 * 64 * (band_cols + 1920 + 1920)
    assert want == {"gather": 1_474_560, "shifts": 1_479_168}[mode]
    assert bounds.call_bytes("warp_mxu_ablation", 1, 64, 1920, mode) == want
    assert bounds.bound("warp_mxu_ablation", 1, 64, 1920, mode)[1] == "bytes"
    assert bounds.call_bytes("warp_mxu_ablation", 2, 64, 1920, mode) == 2 * want
    with pytest.raises(ValueError):
        bounds.call_bytes("warp_mxu_ablation", 1, 64, 1920, "scatter")


def test_warp_gather_ablation_defaults_to_gather():
    assert (bounds.call_bytes("warp_mxu_ablation", 1, 64, 1920)
            == bounds.call_bytes("warp_mxu_ablation", 1, 64, 1920, "gather"))


def test_operations_are_below_the_bytes_bound():
    # Even at half the published f32 rate (no fused multiply-adds, as the
    # kernels are built), the operations take less time than the bytes.
    for name in bounds.KERNELS:
        dims = (1, 64, 1024) if name == "shift_ablation" else (1, 1080, 1920)
        ops_ms = bounds.call_ops(name, *dims) / (bounds.F32_TFLOPS / 2 * 1e12) * 1e3
        assert 0 < ops_ms < bounds.bound_ms(name, *dims)


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        bounds.call_bytes("lk_tile", 1, 8, 8)
    with pytest.raises(KeyError):
        bounds.bound("lk_tile", 1, 8, 8)


def test_smoke_reports_a_bound_and_a_yardstick_for_every_kernel():
    assert set(chip_smoke.KERNELS) == set(bounds.KERNELS)
    # Every kernel but the shift ablation (timed beside one F.conv2d) has a
    # reason why no single PyTorch call computes its function.
    assert set(chip_smoke.NO_LIBRARY_CALL) == set(bounds.KERNELS) - {"shift_ablation"}
    assert all(chip_smoke.NO_LIBRARY_CALL.values())


def test_seed_bound_at_1080p_grid_16():
    # The f32 frame read once, xy (8 B) and alive (1 B) written for each of
    # the 67 x 120 cells; a false predicate writes alive alone.
    assert bounds.seed_bytes(1080, 1920, 16) == 4 * PIXELS_1080P + 9 * 8040 == 8_366_760
    ms, by = bounds.seed_bound(1080, 1920, 16)
    assert by == "bytes" and ms == pytest.approx(8_366_760 / 3.35e9, rel=1e-12)
    assert bounds.seed_bytes(1080, 1920, 16, taken=False) == 8040
    ops_ms = bounds.SEED_OPS_PER_PIXEL * PIXELS_1080P / (bounds.F32_TFLOPS * 1e9)
    assert 0 < ops_ms < ms


@pytest.mark.parametrize("jac,per_sample,out,chain", [(False, 52, 60, 3), (True, 124, 240, 4)])
def test_imu_scan_bounds(jac, per_sample, out, chain):
    assert bounds.imu_bytes(751, jac) == per_sample * 751 + out
    assert bounds.imu_bound(751, jac)[1] == "bytes"
    # The dependent chain: 3 or 4 f32 operations a sample, 4 cycles each
    # at 1980 MHz, far above the bytes' time.
    want = chain * 751 * 4 / 1.98e9 * 1e3
    assert bounds.imu_chain_ms(751, jac) == pytest.approx(want, rel=1e-12)
    assert bounds.imu_chain_ms(751, jac) > 100 * bounds.imu_bound(751, jac)[0]


def test_smoke_reports_the_port_kernels():
    assert set(chip_smoke.PORT_KERNELS) == set(bounds.PORT_KERNELS)
    assert all(why for _, _, why in chip_smoke.PORT_KERNELS.values())


@pytest.mark.parametrize("window", [3, 5, 7])
def test_tile_round_bytes_on_the_extended_tile_and_its_crop(window):
    # prev and the warped frame read on the extended tile (8 B a pixel); u
    # and v read and written in place on its crop (16 B a pixel).
    ext = window // 2 + 1
    h, w = 1080 + 2 * ext, 1920 + 2 * ext
    want = 8 * h * w + 16 * PIXELS_1080P
    assert bounds.call_bytes("lk_fused_tile_round", 1, h, w, window) == want
    assert bounds.call_bytes("lk_fused_tile_round", 2, h, w, window) == 2 * want
    ms, by = bounds.bound("lk_fused_tile_round", 1, h, w, window)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e9, rel=1e-12)
