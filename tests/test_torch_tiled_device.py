"""The tiled pyramidal path under device control (``backend="cuda"``) on
the CPU, where each kernel wrapper runs its plain version.

The port runs in 4 gloo worker processes (tests/mesh_harness.py,
tests/torch_mesh_worker.py), once per tiling for the whole module; the
JAX side (``tpuflow.sharding``, Pallas in interpret mode) on the
conftest's virtual CPU devices. The tilings are 1x2x2, 1x4x1 and 2x1x2,
whose "batch" axis gives each batch element a slice of two ranks: one
latch an element, its sums reduced over its slice's ranks only, as the
reference's ``lax.psum`` over ("ty", "tx").

Limits:
- ``fused_tile_round_ref`` equals ``lucas_kanade_fused_ref`` on the
  extended tile, cropped, zeroed outside the global interior and added
  into the tile's flow, bit for bit, and its sums ``du.abs().sum()`` of
  that crop, (2,) for a plane and (2, B) for a batch whose columns are its
  planes' sums; a set latch leaves the flow and the round count
  untouched; the depth of the kernel's in-kernel sums
  (``kernels.lk.tile_round_depth_of``) equals a hand count of its adds;
- the device-controlled step equals the host-steered loop of the same
  kernels (the early exit read to the host) bit for bit, rounds and all,
  and stays within 1e-3 px of the reference's Pallas path, the limit of
  tests/test_torch_sharding.py's ``backend="cuda"`` case;
- divergence d: on a pair whose finest level converges at its first round
  with the flow past the band, the frozen flow is kept, not re-clipped
  (its largest |u| exceeds ``max_disp``), and against the reference's
  Pallas path within p99.9 2e-3 px (the limit tests/test_torch_sharding.py
  holds the tiled paths to between the packages) and max 1e-2 px: the
  flat field's weakly conditioned solves, 20 px and more from the patch,
  amplify the pyramids' float32 rounding (divergence f) to 2.5e-3 px in u
  and 3.6e-3 px in v there, at 39 and 32 of 65,536 pixels (1x2x2), where
  the textured pair holds 1e-3;
- no host read: with ``Tensor.__bool__``, ``item``, ``tolist`` and the
  number conversions refused, the device-controlled step runs and the
  host-steered loop is caught.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.ndimage import gaussian_filter

from tpuflow.core.config import PyramidConfig as JaxPyramidConfig
from tpuflow.sharding import tiled_pyramidal as jtp
from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow import TiledGraphedStream
from tpuflow_torch.kernels import lk

sys.path.insert(0, str(Path(__file__).parent))
from mesh_harness import run_ranks  # noqa: E402
from torch_mesh_worker import DEVICE_CFGS  # noqa: E402

torch.set_num_threads(1)

TILINGS = {"1x2x2": (1, 2, 2), "1x4x1": (1, 4, 1), "2x1x2": (2, 1, 2)}
CASES = ["tiled_device", "no_host_read", "graph_refusals"]
PALLAS_ATOL = 1e-3
WITNESS_P999 = 2e-3
WITNESS_MAX = 1e-2
WITNESS_MAX_DISP = DEVICE_CFGS["wd"]["max_disp"]


def _witness_pair(seed: int, size: int, dx: int):
    """A flat 128x256 field with one ``size`` px textured patch moved
    ``dx`` px right: the flat field holds the mean |du| under the
    threshold, so a level can converge at its first round while the
    patch's flow lies past the band."""
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.uniform(0, 255, (size + 4, size + 4)), 1.0)[2:-2, 2:-2]
    prev = np.full((128, 256), 128.0, np.float32)
    curr = prev.copy()
    prev[60:60 + size, 100:100 + size] = tex
    curr[60:60 + size, 100 + dx:100 + dx + size] = tex
    return prev, curr


def _inputs(name: str) -> dict:
    """The frames of tiling ``name``: "pc" has one element a batch slice
    (the second, where the mesh has two slices, moved 1 px where the first
    moves 2), "wd" two elements."""
    rng = np.random.default_rng(1234)
    base = rng.uniform(0, 255, (80, 128)).astype(np.float32)
    # Element 0 converges at the finest level's first round, element 1 (a
    # textured field moved 1 px) later or not at all: one latch each.
    p0, c0 = _witness_pair(0, 6, 6)
    p1 = gaussian_filter(rng.uniform(0, 255, (128, 256)), 2.0).astype(np.float32)
    pc_prev, pc_curr = [base], [np.roll(base, 2, axis=1)]
    if TILINGS[name][0] == 2:
        other = rng.uniform(0, 255, (80, 128)).astype(np.float32)
        pc_prev.append(other)
        pc_curr.append(np.roll(other, 1, axis=1))
    return {"pc_prev": np.stack(pc_prev), "pc_curr": np.stack(pc_curr),
            "wd_prev": np.stack([p0, p1]), "wd_curr": np.stack([c0, np.roll(p1, 1, axis=1)])}


def _slice_lead(name: str, rank: int) -> int:
    """The first rank of ``rank``'s batch slice."""
    per = TILINGS[name][1] * TILINGS[name][2]
    return rank // per * per


def _rounds(ranks: list, name: str, key: str) -> np.ndarray:
    """The global (B, levels) rounds run: each batch slice's local rounds,
    read from its first rank, in batch order."""
    per = TILINGS[name][1] * TILINGS[name][2]
    return np.concatenate([ranks[r][key] for r in range(0, len(ranks), per)])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(name)``: every rank's results for tiling ``name``."""
    done: dict = {}

    def get(name: str):
        if name not in done:
            try:
                done[name] = run_ranks(tmp_path_factory.mktemp(name), 4, ",".join(
                    str(x) for x in TILINGS[name]), CASES, _inputs(name))
            except RuntimeError as exc:
                done[name] = exc
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    return get


# -- (a) the round form of K6's plain version ----------------------------------------------


def _tile_case(seed: int, window: int, shape=(19, 23)):
    rng = np.random.default_rng(seed)
    ext = window // 2 + 1
    h, w = shape
    prev = torch.from_numpy(rng.uniform(0, 255, (h + 2 * ext, w + 2 * ext)).astype(np.float32))
    curr = torch.from_numpy(rng.uniform(0, 255, (h + 2 * ext, w + 2 * ext)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, 3, shape).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, 3, shape).astype(np.float32))
    return prev, curr, u, v, ext


@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("window", lk.WINDOWS)
@pytest.mark.parametrize("origin", [(0, 0), (19, 23), (38, 0)], ids=["corner", "inner", "edge"])
def test_tile_round_ref_is_fused_cropped_masked_added(window, relaxed, origin):
    """The tile at ``origin`` of a 57x69 level (3x3 tiles of 19x23): the
    fused solve on the extended tile, cropped, zeroed within window // 2
    of the level's border, added into u, v in place; the sums of the
    crop's |du|, |dv|; the round counted in ctrl row 2."""
    prev, curr, u, v, ext = _tile_case(window + 10 * relaxed, window)
    gy0, gx0 = origin
    gh, gw, half = 57, 69, window // 2
    h, w = u.shape
    du, dv = lk.lucas_kanade_fused_ref(prev, curr, window_size=window, relaxed_order=relaxed)
    du, dv = du[ext:ext + h, ext:ext + w], dv[ext:ext + h, ext:ext + w]
    rows = torch.arange(h)[:, None] + gy0
    cols = torch.arange(w)[None, :] + gx0
    inside = (rows >= half) & (rows < gh - half) & (cols >= half) & (cols < gw - half)
    du, dv = torch.where(inside, du, 0.0), torch.where(inside, dv, 0.0)
    want_u, want_v = u + du, v + dv
    ctrl = torch.zeros(lk.CTRL_ROWS, dtype=torch.int32)
    sums = lk.fused_tile_round(prev, curr, u, v, ctrl, gy0=gy0, gx0=gx0, gh=gh, gw=gw,
                               window_size=window, relaxed_order=relaxed)
    assert torch.equal(u, want_u) and torch.equal(v, want_v)
    assert torch.equal(sums, torch.stack([du.abs().sum(), dv.abs().sum()]))
    assert ctrl.tolist() == [0, 0, 1]
    if origin == (19, 23):
        assert bool(inside.all())  # an inner tile has no border to zero
    else:
        assert not bool(inside.all()) and float(du.abs().sum()) > 0


@pytest.mark.parametrize("window", lk.WINDOWS)
def test_tile_round_ref_skips_on_a_set_latch(window):
    prev, curr, u, v, _ = _tile_case(3, window)
    u0, v0 = u.clone(), v.clone()
    ctrl = torch.tensor([1, 0, 4], dtype=torch.int32)
    lk.fused_tile_round_ref(prev, curr, u, v, ctrl, gy0=0, gx0=0, gh=19, gw=23,
                            window_size=window)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert ctrl.tolist() == [1, 0, 4]


def test_tile_round_batch_keeps_one_latch_an_element():
    """A (2, ...) batch: element 1 latched keeps its flow, element 0 runs as
    its plane alone."""
    prev, curr, u, v, _ = _tile_case(4, 5)
    p2, c2, u2, v2, _ = _tile_case(5, 5)
    bu, bv = torch.stack([u, u2]), torch.stack([v, v2])
    ctrl = torch.tensor([[0, 1], [0, 0], [2, 2]], dtype=torch.int32)
    sums = lk.fused_tile_round(torch.stack([prev, p2]), torch.stack([curr, c2]), bu, bv, ctrl,
                               gy0=0, gx0=0, gh=19, gw=23)
    one = torch.zeros(lk.CTRL_ROWS, dtype=torch.int32)
    s0 = lk.fused_tile_round(prev, curr, u, v, one, gy0=0, gx0=0, gh=19, gw=23)
    assert torch.equal(bu[0], u) and torch.equal(bv[0], v) and torch.equal(sums[:, 0], s0)
    assert torch.equal(bu[1], u2) and torch.equal(bv[1], v2)
    assert ctrl.tolist() == [[0, 1], [0, 0], [3, 2]]


def test_tile_round_sums_shapes_and_batch_elements():
    """On CPU tensors the round returns (2,) sums for a plane and (2, B)
    for a batch, each element's column equal to its plane's call."""
    cases = [_tile_case(20 + i, 5) for i in range(3)]
    ctrl = torch.zeros((lk.CTRL_ROWS, 3), dtype=torch.int32)
    bu, bv = torch.stack([c[2] for c in cases]), torch.stack([c[3] for c in cases])
    sums = lk.fused_tile_round(torch.stack([c[0] for c in cases]),
                               torch.stack([c[1] for c in cases]), bu, bv, ctrl,
                               gy0=0, gx0=0, gh=19, gw=23)
    assert sums.shape == (2, 3) and sums.dtype == torch.float32
    for b, (prev, curr, u, v, _) in enumerate(cases):
        one = lk.fused_tile_round(prev, curr, u, v, torch.zeros(lk.CTRL_ROWS, dtype=torch.int32),
                                  gy0=0, gx0=0, gh=19, gw=23)
        assert one.shape == (2,) and torch.equal(sums[:, b], one)
        assert torch.equal(bu[b], u) and torch.equal(bv[b], v)


@pytest.mark.parametrize("rows, threads, blocks, depth", [
    # 1080p world-1 tiles at window 5: a lane's 31 adds, the butterfly's 5,
    # 3 across 4 warps; then 6 partials a thread (646 over 128), 5 of them
    # rounded, the butterfly's 5 and the 3 across the warps.
    (32, 128, 646, 31 + 5 + 3 + 5 + 5 + 3),
    (16, 128, 350, 15 + 5 + 3 + 2 + 5 + 3),  # 546x966: 3 partials a thread
    (4, 128, 345, 3 + 5 + 3 + 2 + 5 + 3),  # 276x486
    (1, 128, 1, 0 + 5 + 3 + 0 + 5 + 3),  # one row, one block: exact first adds
    (32, 128, 2516, 31 + 5 + 3 + 19 + 5 + 3),  # 4K tile: 20 partials a thread
    (8, 64, 129, 7 + 5 + 1 + 2 + 5 + 1),  # two warps, 3 partials a thread
    # 4K on 1x4x1 (546x3846, 276x1926, 141x966) and a 2x1x2 slice
    # (2166x1926, 1086x966, 546x486): rows and blocks by tile_round_rows.
    (32, 128, 666, 31 + 5 + 3 + 5 + 5 + 3),
    (16, 128, 342, 15 + 5 + 3 + 2 + 5 + 3),
    (4, 128, 360, 3 + 5 + 3 + 2 + 5 + 3),
    (32, 128, 1292, 31 + 5 + 3 + 10 + 5 + 3),
    (32, 128, 340, 31 + 5 + 3 + 2 + 5 + 3),
    (8, 128, 345, 7 + 5 + 3 + 2 + 5 + 3),
])
def test_tile_round_depth_counts_the_in_kernel_order(rows, threads, blocks, depth):
    assert lk.tile_round_depth_of(rows, threads, blocks) == depth


@pytest.mark.parametrize("bad", ["shape", "ctrl", "window"])
def test_tile_round_refuses_bad_arguments(bad):
    prev, curr, u, v, _ = _tile_case(6, 5)
    ctrl = torch.zeros(lk.CTRL_ROWS, dtype=torch.int32)
    kw = dict(gy0=0, gx0=0, gh=19, gw=23)
    if bad == "shape":
        prev, curr = prev[1:], curr[1:]
    elif bad == "ctrl":
        ctrl = torch.zeros(lk.CTRL_ROWS, dtype=torch.int64)
    else:
        kw["window_size"] = 9
    with pytest.raises((ValueError, TypeError)):
        lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)


def test_tiled_graphed_stream_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        TiledGraphedStream(torch.zeros(1, 64, 64), PyramidConfig(), None)


# -- (b) the step under device control against the host-steered loop -------------------------


@pytest.mark.parametrize("name", list(TILINGS))
@pytest.mark.parametrize("prefix", list(DEVICE_CFGS))
def test_device_control_equals_the_host_steered_loop(port, name, prefix):
    """Bit for bit, on every rank, with no host read counted (the loop
    counts its reads), and every rank of a batch slice ran the same rounds."""
    ranks = port(name)
    for r, res in enumerate(ranks):
        for c in "uv":
            np.testing.assert_array_equal(res[f"tiled_device/{prefix}_{c}"],
                                          res[f"tiled_device/{prefix}_host_{c}"])
            np.testing.assert_array_equal(res[f"tiled_device/{prefix}_{c}"],
                                          ranks[0][f"tiled_device/{prefix}_{c}"])
        np.testing.assert_array_equal(res[f"tiled_device/{prefix}_rounds"],
                                      ranks[_slice_lead(name, r)][f"tiled_device/{prefix}_rounds"])
        assert int(res[f"tiled_device/{prefix}_reads"]) == 0
        assert int(res[f"tiled_device/{prefix}_host_reads"]) > 0


def _jax_pallas(name, prefix):
    """The reference's Pallas path (interpret mode) on the tiling's
    frames. On a mesh with a "batch" axis each element runs alone on a
    (1, ty, tx) mesh: its batch slice's tiles and reduction group. The
    interpreter holds every device at each Pallas call, so a (2, ty, tx)
    mesh whose slices run different numbers of rounds (the witness pair's)
    never returns."""
    inp = _inputs(name)
    batch, ty, tx = TILINGS[name]
    devs = np.array(jax.devices()[:ty * tx]).reshape(1, ty, tx)
    prev, curr = inp[f"{prefix}_prev"], inp[f"{prefix}_curr"]
    per = prev.shape[0] // batch
    outs = [jtp.tiled_lucas_kanade_pyramidal(
        jnp.asarray(prev[b * per:(b + 1) * per]), jnp.asarray(curr[b * per:(b + 1) * per]),
        Mesh(devs, ("batch", "ty", "tx")), config=JaxPyramidConfig(**DEVICE_CFGS[prefix]),
        backend="pallas", interpret=True) for b in range(batch)]
    return tuple(np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(2))


@pytest.mark.parametrize("name", list(TILINGS))
def test_device_control_matches_pallas_interpret(port, name):
    ju, jv = _jax_pallas(name, "pc")
    res = port(name)[0]
    np.testing.assert_allclose(res["tiled_device/pc_u"], np.asarray(ju), rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_allclose(res["tiled_device/pc_v"], np.asarray(jv), rtol=0, atol=PALLAS_ATOL)


# -- (c) divergence d: a frozen flow is not re-clipped ----------------------------------------


@pytest.mark.parametrize("name", list(TILINGS))
def test_frozen_flow_past_the_band_is_kept(port, name):
    """Element 0's finest level converges at its first round (one round
    run of three) with its flow past the 2 px band, and keeps that flow;
    element 1 runs more rounds on its own latch. Both against the
    reference's Pallas path (limits in the module docstring)."""
    res = port(name)[0]
    rounds = _rounds(port(name), name, "tiled_device/wd_rounds")
    its = DEVICE_CFGS["wd"]["iterations"]
    assert rounds.shape == (2, DEVICE_CFGS["wd"]["levels"])
    assert rounds[0, -1] == 1 and (rounds[1] > 1).any()
    u = res["tiled_device/wd_u"]
    assert np.abs(u[0]).max() > WITNESS_MAX_DISP + 1
    assert rounds.max() <= its
    ju, jv = _jax_pallas(name, "wd")
    du, dv = np.abs(u - np.asarray(ju)), np.abs(res["tiled_device/wd_v"] - np.asarray(jv))
    assert np.quantile(np.concatenate([du.ravel(), dv.ravel()]), 0.999) <= WITNESS_P999
    assert max(du.max(), dv.max()) <= WITNESS_MAX


# -- (d) no host read --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TILINGS))
@pytest.mark.parametrize("prefix", list(DEVICE_CFGS))
def test_device_control_reads_nothing_to_the_host(port, name, prefix):
    for res in port(name):
        assert not bool(res[f"no_host_read/{prefix}_device_raised"])
        assert bool(res[f"no_host_read/{prefix}_host_raised"])
        for c in "uv":
            np.testing.assert_array_equal(res[f"no_host_read/{prefix}_{c}"],
                                          res[f"tiled_device/{prefix}_{c}"])


def test_gloo_mesh_is_never_graphed(port):
    for res in port("1x2x2"):
        assert not bool(res["graph_refusals/graphable"])
        assert not bool(res["graph_refusals/vo_graphed"])
