"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor ``tpuflow``, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Limits: the warps (K1, K2, K4) bit-exact, at their blocks' edges (through
the block a plane gets, each block forced, and the walk ablation), on
planes down to 1x1, at bands 0 to 31, with flows far past the band, from an
unaligned base and per batch element; the refine steps' (K3, K5) u, v
bit-identical and their sums to rtol 1e-5 (per-block partials are summed
in another order); the fused single-scale solve (K6, K7) u, v and |det|
bit-identical; short `production` and `default` streams with the same
rounds per level and within 1e-3 px. The refine and fused shapes straddle
the column walk's strip and block edges (``lk_tile.cuh``: 28/26/24 output
columns a strip at windows 3/5/7, 4 strips a block, and 4, 8, 16 or 32
rows a block by the plane's size), include planes narrower or shorter than
the window, a plane of border blocks only, mostly interior ones, and
planes that take each walk length with a ragged last block. Batches (B = 2): each element of a
batched launch bit-identical to the same kernel's 2-D launch on that
plane, and within the limits above of the plain version. The window_mxu kernels
(K10), whose tensor-core sums round otherwise than the plain version's
torch.matmul: u, v within 1e-4 px at window 3 and 1e-5 px at 5 and 7,
|det| within 2e-6 of the plane's largest, sums to rtol 1e-5. The ablation
microkernels (K8, K9) bit-exact: K8 in every kind, also on signed inputs
spread over 2^-20..2^20 where another add order rounds otherwise; K9 in
both modes at the script's shape, at planes of 1, 3, 5 and 6 rows (the
block's 4-row tile ragged) and 1 to 15 column blocks, with offsets in
+-8 and in +-200 (the gather's clip, no select matching); each call one
launch; the C entry points refuse what no instantiation covers. The VO
session (``tpuflow_torch.vo``) at 240x320 on the kernels against the same
session on the plain versions: alive, ids and counters identical, live
track positions within 1e-3 px; its front-end step makes no synchronizing
operation and no host read; two bundle-adjustment solves
of one problem give the same bits, and the sorted segment sums agree with
``index_add_`` to 1e-5 relative. Two pose-graph solves (17 nodes, loop
and rotation-only edges) give the same bits and agree with the CPU's to
1e-4; IMU preintegration on the card agrees with the CPU's to 5e-6. The
S8.7 integer datapath on the card equals the CPU's bit for bit. The main
path under device control: the warp round (both band-switch forms) and
the refine round bit-identical to their plain versions and to the
host-int band's calls at each band index and when skipped (a skipped
warp leaves ``out`` untouched, a skipped refine passes u, v through), the
refine's in-kernel sums within 1e-6 relative of torch.sum of its block
partials, each batch element latched alone; batched streams: K1-K5's
rounds on B=4 with one band index a plane (mixed), running and skipped,
bit for bit their plain versions and each plane's own 2-D round, a
batched ``GraphedStream`` of four streams bit for bit each stream's own
2-D ``GraphedStream`` and the batched eager step (rounds included), and,
where four cards are present, a 4x1x1 data-parallel mesh whose gathered
slices equal one card's batch and whose released teardown returns; the
graphed stream
(``flow.GraphedStream``) and the VO front end's graphed ``scan_steps``
bit-identical to the eager steps, with the eager step's launch counts.
K6's tile round: u, v and the control bit for bit the plain version's at
odd crops, windows 3/5/7, both orders, running and skipped, its
in-kernel sums within their depth's limit; one kernel a call, its ticket
0 after every round; a graphed tiled step with no reduction after a
round; at the 4K tiles (NCCL world 1 and 1x4x1) bit for bit, running and
skipped, its walk rows, blocks and sum depth at every 4K tile (world 1,
1x4x1, a 2x1x2 slice) equal to hand counts.
The grid seed (``kernels.seed``) bit-identical to its plain version at
2160x3840, 1080x1920 and 121x163, margins 0, 3, 13 and 20 (cells all
``-inf``), on noise, blurred noise and constant patches (exact ties),
grid steps 8, 16 and 32; a false predicate writes alive 0 and counts no
reseed, a true one counts one (also at 2160x3840, margins 0 and 13). The
IMU scan (``kernels.imu``) within 2e-6 of the plain loop in r and 1e-5
of the largest entry in v, p and each Jacobian, at 1, 2 and 751 samples. A stride-2 VO front end (odd steps skip the reseed) gives the
same records and reseed count graphed, eager and through the plain
versions. The suite generator's warp (``eval.patterns.apply_motion``) on
the card equals the CPU's at 640x480, bit for bit. The native reader
(``io.stream.FrameStream``) feeds ``prefetch_to_device`` 64 frames through
its few pinned buffers, each reused many times, with no stale frame.
"""

import re

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step
from tpuflow_torch import telemetry
from tpuflow_torch.flow import GraphedStream, graphed
from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation, warp_walk
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import _build, launch_counts, lk, seed, torch_ref, warp
from tpuflow_torch.kernels import imu as imu_kernel
from tpuflow_torch.vo import ba, device_loop, imu, pose_graph, se3
from tpuflow_torch.vo.pipeline import OdometrySession

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
    kw = dict(clamp_flow=True, max_disp_v=band, packing=packing)
    got = warp.warp_banded(img, u, v, 8, **kw)
    want = warp.warp_banded_ref(img, u, v, 8, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[_WARP_COUNTER[packing]] == before + 1
    assert torch.equal(got, want)


# The warp's blocks (csrc/warp.cu): planes under 2**20 pixels gather their
# corners, several consecutive columns a thread, larger ones stage the band
# in 128x32 tiles. Shapes at and across the block edges (widths 31-33,
# 127-129, 255-257, heights around 16 and 32), widths that are not a
# multiple of 4 (4-byte staging; the gathers' scalar path, 197x333 and
# 271x479 also a ragged last thread), planes smaller than a block down to
# 1x1, one row and one column, staged planes with ragged last tiles, one
# tile row, one narrow tile column, and an odd width, and the 2**20-pixel
# boundary (1023x1024 gathers, 1024x1024 stages).
_TILE_SHAPES = [(1, 1), (1, 200), (200, 1), (3, 5), (15, 31), (16, 32), (17, 33), (31, 127),
                (33, 129), (65, 61), (130, 1922), (197, 333), (270, 480), (271, 479),
                (545, 960), (1023, 1024), (1024, 1024), (1057, 1920), (1025, 1027),
                (9, 120000), (120000, 9)]
# (max_disp, max_disp_v): the narrowest and widest bands, and a mix.
_TILE_BANDS = [(0, 0), (8, 3), (0, 31), (31, 0), (31, 31)]


def _warp_as(block, *args):
    """The warp with its CUDA block: by plane size (None), forced staged
    (True) or gathering (False), or the walk ablation ("walk16", "walk48");
    ``args`` are (image, u, v, max_disp, max_disp_v, packing, clamp_flow)."""
    if block is None:
        img, u, v, md, mdv, packing, clamp = args
        return warp.warp_banded(img, u, v, md, clamp_flow=clamp, max_disp_v=mdv,
                                packing=packing)
    if block in (False, True):
        return warp_walk.warp_block(*args, staged=block)
    return warp_walk.warp_walk(*args, walk_rows=int(block[4:]))


# Each shape through the block its size chooses, through each block forced
# and through the walk ablation at one and three steps a walk (the same
# output bit for bit).
_BLOCKS = [None, False, True, "walk16", "walk48"]
# The gathers' blocks (csrc/warp.cu kGatherSmall, kGatherLarge): output
# columns, rows, threads, consecutive columns a thread.
_GATHER_SMALL = (32, 8, 256, 1)
_GATHER_LARGE = (32, 32, 256, 1)


@pytest.mark.parametrize("staged", _BLOCKS)
@pytest.mark.parametrize("shape", _TILE_SHAPES)
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
def test_warp_tile_edges_and_bands_bit_exact(cuda, shape, packing, staged):
    rng = np.random.default_rng(7 * shape[0] + shape[1])
    img = _rand(rng, shape, 0, 255, cuda)
    if packing == "u8":
        img = img.round()
    for md, mdv in _TILE_BANDS:
        u, v = _rand(rng, shape, -md - 3, md + 3, cuda), _rand(rng, shape, -mdv - 3, mdv + 3, cuda)
        got = _warp_as(staged, img, u, v, md, mdv, packing, True)
        want = warp.warp_banded_ref(img, u, v, md, clamp_flow=True, max_disp_v=mdv,
                                    packing=packing)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (md, mdv)


@pytest.mark.parametrize("staged", _BLOCKS)
@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_exact_warp_far_outside_the_band_unclamped(cuda, shape, staged):
    # clamp_flow off, flows up to 40 px past the band: the row rule and the
    # column clamps keep every corner inside the staged window.
    rng = np.random.default_rng(shape[1])
    img = _rand(rng, shape, 0, 255, cuda)
    for md, mdv in _TILE_BANDS:
        reach = max(md, mdv) + 40
        u, v = _rand(rng, shape, -reach, reach, cuda), _rand(rng, shape, -reach, reach, cuda)
        got = _warp_as(staged, img, u, v, md, mdv, "exact", False)
        want = warp.warp_banded_ref(img, u, v, md, max_disp_v=mdv, packing="exact",
                                    clamp_flow=False)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (md, mdv)


@pytest.mark.parametrize("staged", [None, "walk32"])
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
@pytest.mark.parametrize("shape", [(1025, 1024), (540, 960), (270, 480)])
def test_warp_unaligned_base_bit_exact(cuda, packing, staged, shape):
    # Planes whose width is a multiple of 4, on bases that are not 16-byte
    # aligned: the staged plane stages by 4-byte copies, the gathered ones
    # take their scalar path; the walk also stages an unaligned flow so.
    rng = np.random.default_rng(11)
    buf = _rand(rng, (3, shape[0] * shape[1] + 1), 0, 255, cuda)
    buf[1:] = buf[1:] * (18 / 255) - 9  # flows in [-9, 9]
    if packing == "u8":
        buf[0] = buf[0].round()
    img, u, v = (b[1:].view(shape) for b in buf)
    assert u.data_ptr() % 16 != 0 and v.data_ptr() % 16 != 0 and img.data_ptr() % 16 != 0
    assert warp.tile_geometry(*shape, 8, 8)["staged"] == (shape[0] * shape[1] >= 1 << 20)
    for md, mdv in _TILE_BANDS:
        got = _warp_as(staged, img, u, v, md, mdv, packing, True)
        want = warp.warp_banded_ref(img, u, v, md, clamp_flow=True, max_disp_v=mdv,
                                    packing=packing)
        assert torch.equal(got, want), (md, mdv)


@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 33, 257), (3, 545, 130), (2, 270, 480),
                                   (2, 1057, 1000)])
@pytest.mark.parametrize("packing,clamp", [("u8", True), ("u16", True), ("exact", True),
                                           ("exact", False)])
def test_batched_warp_tiles_per_element(cuda, shape, packing, clamp):
    rng = np.random.default_rng(shape[-1])
    img = _rand(rng, shape, 0, 255, cuda)
    if packing == "u8":
        img = img.round()
    for md, mdv in [(0, 0), (8, 3), (31, 31)]:
        reach = max(md, mdv) + (3 if clamp else 40)
        u, v = _rand(rng, shape, -reach, reach, cuda), _rand(rng, shape, -reach, reach, cuda)
        kw = dict(clamp_flow=clamp, max_disp_v=mdv, packing=packing)
        got = warp.warp_banded(img, u, v, md, **kw)
        assert torch.equal(got, warp.warp_banded_ref(img, u, v, md, **kw)), (md, mdv)
        for b in range(shape[0]):
            assert torch.equal(got[b], warp.warp_banded(img[b], u[b], v[b], md, **kw)), (md, mdv, b)


def test_warp_geometry_by_plane_size(cuda):
    # The production pyramid's coarse levels gather (270x480 in the small
    # planes' block, under 2**18 pixels, 540x960 in the large ones'), its
    # 1080p level stages the band: 29,792 B at md = mdv = 8, 72,960 B at
    # the widest band. The block depends on the plane alone, not the band.
    small = dict(staged=0, tile_w=_GATHER_SMALL[0], rows=_GATHER_SMALL[1],
                 threads=_GATHER_SMALL[2], smem_bytes=0, cols=_GATHER_SMALL[3])
    large = dict(staged=0, tile_w=_GATHER_LARGE[0], rows=_GATHER_LARGE[1],
                 threads=_GATHER_LARGE[2], smem_bytes=0, cols=_GATHER_LARGE[3])
    assert warp.tile_geometry(270, 480, 8, 8) == small
    assert warp.tile_geometry(270, 480, 31, 2) == small
    assert warp.tile_geometry(511, 512, 8, 8) == small
    assert warp.tile_geometry(512, 512, 8, 8) == large
    assert warp.tile_geometry(540, 960, 8, 8) == large
    assert warp.tile_geometry(1023, 1025, 8, 8) == large
    assert warp.tile_geometry(1023, 1024, 8, 8) == large
    staged = dict(staged=1, tile_w=128, rows=32, threads=256, cols=1)
    assert warp.tile_geometry(1024, 1024, 8, 8) == dict(staged, smem_bytes=49 * 152 * 4)
    assert warp.tile_geometry(1080, 1920, 8, 8) == dict(staged, smem_bytes=49 * 152 * 4)
    assert warp.tile_geometry(1080, 1920, 31, 31) == dict(staged, smem_bytes=95 * 192 * 4)
    _build.launch_empty()
    torch.cuda.synchronize()


def test_warp_refuses_a_side_of_2_to_the_24(cuda):
    # x + max_disp and y + max_disp_v must be exact floats: a side of 2**24
    # is refused by the wrapper, and by the kernel's entry points before
    # any launch.
    shape = (warp.MAX_SIDE, 1)
    img = torch.zeros(shape, device=cuda)
    before = launch_counts()["warp_exact"]
    with pytest.raises(ValueError, match="sides under"):
        warp.warp_banded(img, img, img, 8, clamp_flow=True, max_disp_v=8, packing="exact")
    with pytest.raises(ValueError, match="sides under"):
        warp_walk.warp_walk(img, img, img, 8, 8, "exact", walk_rows=16)
    assert launch_counts()["warp_exact"] == before
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (img.data_ptr(),) * 4
    for h, w in (shape, shape[::-1]):
        assert lib.tpuflow_warp_banded(*ptrs, 1, h, w, 8, 8, 0, 1, stream) != 0
        assert lib.tpuflow_warp_walk(*ptrs, 1, h, w, 8, 8, 0, 1, 16, stream) != 0
    # A row of 2**24 - 1 pixels is taken.
    assert lib.tpuflow_warp_banded(*ptrs, 1, 1, warp.MAX_SIDE - 1, 8, 8, 0, 1, stream) == 0
    torch.cuda.synchronize()


def test_warp_refuses_a_window_that_does_not_fit(cuda, monkeypatch):
    # Past the wrapper's band limit, a staged window beyond the card's
    # 227 KB of shared memory a block is refused before launch; one above
    # the default 48 KB that fits runs, bit-exact.
    monkeypatch.setattr(warp, "MAX_BAND", 400)
    rng = np.random.default_rng(5)
    shape = (1100, 1000)
    img = _rand(rng, shape, 0, 255, cuda)
    u, v = _rand(rng, shape, -50, 50, cuda), _rand(rng, shape, -50, 50, cuda)
    assert warp.tile_geometry(*shape, 300, 300)["smem_bytes"] > 232448
    before = launch_counts()["warp_exact"]
    with pytest.raises(RuntimeError, match="configuration"):
        warp.warp_banded(img, u, v, 300, clamp_flow=True, max_disp_v=300, packing="exact")
    assert launch_counts()["warp_exact"] == before
    assert 48 * 1024 < warp.tile_geometry(*shape, 60, 40)["smem_bytes"] <= 232448
    kw = dict(clamp_flow=True, max_disp_v=40, packing="exact")
    got = warp.warp_banded(img, u, v, 60, **kw)
    assert torch.equal(got, warp.warp_banded_ref(img, u, v, 60, **kw))
    # The walk's ring and flow at 300 px do not fit either; at 60, 40 they
    # take more than 48 KB, and fit.
    walks = warp_walk.launch_counts["warp_walk_ablation"]
    with pytest.raises(RuntimeError, match="configuration"):
        warp_walk.warp_walk(img, u, v, 300, 300, "exact", walk_rows=48)
    assert warp_walk.launch_counts["warp_walk_ablation"] == walks
    got = warp_walk.warp_walk(img, u, v, 60, 40, "exact", walk_rows=48)
    assert torch.equal(got, warp.warp_banded_ref(img, u, v, 60, **kw))


@pytest.mark.parametrize("shape", [(37, 61), (64, 200), (1, 1)])
@pytest.mark.parametrize("band", [2, 3, 8])
def test_exact_warp_kernel_unclamped_bit_exact(cuda, shape, band):
    rng = np.random.default_rng(band)
    img = _rand(rng, shape, 0, 255, cuda)
    u, v = _rand(rng, shape, -12, 12, cuda), _rand(rng, shape, -12, 12, cuda)
    kw = dict(clamp_flow=False, max_disp_v=band, packing="exact")
    got = warp.warp_banded(img, u, v, 8, **kw)
    want = warp.warp_banded_ref(img, u, v, 8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# Strip widths 28/26/24 (windows 3/5/7) +- 1, heights around the 4-row
# walk these small planes take (and 32 +- 1), a plane several blocks wide
# with a ragged last strip, planes narrower or shorter than the window.
_WALK_SHAPES = [(31, 25), (33, 27), (32, 29), (5, 61), (70, 233), (2, 40), (40, 2), (3, 6)]


@pytest.mark.parametrize("shape", [(5, 7), (17, 33), (52, 200), (64, 96), *_WALK_SHAPES])
@pytest.mark.parametrize("converged", [False, True])
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [True, False])
def test_refine_kernel_matches_plain(cuda, shape, converged, window, relaxed):
    rng = np.random.default_rng(shape[0])
    prev = _rand(rng, shape, 0, 255, cuda)
    warped = prev.roll(1, dims=1) + _rand(rng, shape, -1, 1, cuda)
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    conv = torch.tensor(converged, device=cuda)
    args = (prev, warped, u, v, conv, window, 1e-4, 8.0)
    kw = dict(max_disp_v=3.0, relaxed_order=relaxed)
    name = "lk_refine" if relaxed else "lk_refine_exact"
    before = launch_counts()[name]
    got = lk.lucas_kanade_refine(*args, **kw)
    want = lk.lucas_kanade_refine_ref(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(37, 61), (1, 1), (52, 200), *_WALK_SHAPES])
@pytest.mark.parametrize("window,taps", [(3, False), (5, False), (7, False), (5, True)])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("confidence", [False, True])
def test_fused_kernel_matches_plain(cuda, shape, window, taps, relaxed, confidence):
    rng = np.random.default_rng(shape[1])
    prev = _rand(rng, shape, 0, 255, cuda)
    curr = prev.roll(1, dims=1) + _rand(rng, shape, -1, 1, cuda)
    kw = dict(gaussian_weights=taps, return_confidence=confidence, relaxed_order=relaxed)
    name = "lk_fused_conf" if confidence else "lk_fused"
    before = launch_counts()[name]
    got = lk.lucas_kanade_fused(prev, curr, window, **kw)
    want = lk.lucas_kanade_fused_ref(prev, curr, window, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# Border blocks only: every block of the walk meets the frame's edge (one
# block at every window). Interior-heavy: 300x560, 75 x 6 blocks of 4-row
# walks at window 7, most away from every edge. Then planes whose walks are
# 8, 16 and 32 rows (lk_tile.cuh::walk_rows), each with a ragged last block.
@pytest.mark.parametrize("shape", [(30, 90), (300, 560), (545, 960), (601, 1920), (1057, 1920)])
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [True, False])
def test_walk_border_and_interior_blocks_bit_exact(cuda, shape, window, relaxed):
    rng = np.random.default_rng(window)
    prev, curr = _smooth(rng, shape, cuda)
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    conv = torch.tensor(False, device=cuda)
    rargs = (prev, curr, u, v, conv, window)
    rkw = dict(max_disp_v=3.0, relaxed_order=relaxed)
    got = lk.lucas_kanade_refine(*rargs, **rkw)
    want = lk.lucas_kanade_refine_ref(*rargs, **rkw)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    for taps in (False, True):
        fkw = dict(gaussian_weights=taps, return_confidence=True, relaxed_order=relaxed)
        got = lk.lucas_kanade_fused(prev, curr, window, **fkw)
        want = lk.lucas_kanade_fused_ref(prev, curr, window, **fkw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_wrappers_reject_non_contiguous(cuda):
    z = torch.zeros(16, 32, device=cuda).t()
    with pytest.raises(ValueError):
        warp.warp_banded(z, z, z, packing="u8", clamp_flow=True)
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
            out.append((u, v, pyramidal.counters.level_rounds.tolist()))
        return out

    kernels = stream()
    monkeypatch.setattr(warp, "warp_round", warp.warp_round_ref)
    monkeypatch.setattr(lk, "refine_round", lk.refine_round_ref)
    plain = stream()
    for (u, v, n), (pu, pv, pn) in zip(kernels, plain):
        assert n == pn
        torch.testing.assert_close(u, pu, rtol=0, atol=1e-3)
        torch.testing.assert_close(v, pv, rtol=0, atol=1e-3)


def _smooth(rng, shape, dev):
    """Textured frames (a smoothed noise frame, batched along axis 0) and
    the same shifted 1 px with noise."""
    prev = np.stack([gaussian_filter(rng.uniform(0, 255, shape[-2:]), 2.0)
                     for _ in range(int(np.prod(shape[:-2])))]).reshape(shape)
    prev = torch.from_numpy(prev.astype(np.float32)).to(dev)
    return prev, prev.roll(1, dims=-1) + _rand(rng, shape, -1, 1, dev)


@pytest.mark.parametrize("packing,clamp", [("u8", True), ("u16", True), ("exact", True),
                                           ("exact", False)])
def test_batched_warp_kernel_bit_exact_per_element(cuda, packing, clamp):
    rng = np.random.default_rng(7)
    shape = (2, 37, 61)
    img = _rand(rng, shape, 0, 255, cuda)
    if packing == "u8":
        img = img.round()
    u, v = _rand(rng, shape, -12, 12, cuda), _rand(rng, shape, -12, 12, cuda)
    kw = dict(clamp_flow=clamp, max_disp_v=3, packing=packing)
    got = warp.warp_banded(img, u, v, 8, **kw)
    assert torch.equal(got, warp.warp_banded_ref(img, u, v, 8, **kw))
    for b in range(2):
        assert torch.equal(got[b], warp.warp_banded(img[b], u[b], v[b], 8, **kw))


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [True, False])
@pytest.mark.parametrize("mxu", [False, True])
def test_batched_refine_kernel_per_element(cuda, window, relaxed, mxu):
    rng = np.random.default_rng(window)
    prev, warped = _smooth(rng, (2, 52, 200), cuda)
    u, v = _rand(rng, prev.shape, -9, 9, cuda), _rand(rng, prev.shape, -9, 9, cuda)
    conv = torch.tensor([True, False], device=cuda)
    kw = dict(window_size=window, max_disp_v=3.0, relaxed_order=relaxed, window_mxu=mxu)
    name = "lk_refine_mxu" if mxu else "lk_refine" if relaxed else "lk_refine_exact"
    before = launch_counts()[name]
    got = lk.lucas_kanade_refine(prev, warped, u, v, conv, **kw)
    want = lk.lucas_kanade_refine_ref(prev, warped, u, v, conv, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    assert got[2].shape == got[3].shape == (2,)
    atol = 1e-4 if mxu and window == 3 else 1e-5 if mxu else 0.0
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=atol)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0][0], u[0].clamp(-8, 8))
    for b in range(2):
        single = lk.lucas_kanade_refine(prev[b], warped[b], u[b], v[b], conv[b:b + 1], **kw)
        for g, s in zip(got, single):
            assert torch.equal(g[b], s)


@pytest.mark.parametrize("window,taps", [(3, False), (5, False), (7, False), (5, True)])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("mxu", [False, True])
def test_batched_fused_kernel_per_element(cuda, window, taps, relaxed, mxu):
    rng = np.random.default_rng(10 + window)
    prev, curr = _smooth(rng, (2, 37, 161), cuda)
    kw = dict(gaussian_weights=taps, return_confidence=True, relaxed_order=relaxed,
              window_mxu=mxu)
    name = "lk_fused_conf" + ("_mxu" if mxu and not taps else "")
    before = launch_counts()[name]
    got = lk.lucas_kanade_fused(prev, curr, window, **kw)
    want = lk.lucas_kanade_fused_ref(prev, curr, window, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    walk = not mxu or taps  # taps take precedence over window_mxu
    atol = 0.0 if walk else 1e-4 if window == 3 else 1e-5
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=atol)
    det_atol = 0.0 if walk else 2e-6 * float(want[2].max())
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=det_atol)
    for b in range(2):
        single = lk.lucas_kanade_fused(prev[b], curr[b], window, **kw)
        for g, s in zip(got, single):
            assert torch.equal(g[b], s)


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
def test_mxu_fused_kernel_on_planes(cuda, window, relaxed):
    rng = np.random.default_rng(20 + window)
    prev, curr = _smooth(rng, (64, 200), cuda)
    before = launch_counts()["lk_fused_mxu"]
    got = lk.lucas_kanade_fused(prev, curr, window, relaxed_order=relaxed, window_mxu=True)
    want = lk.lucas_kanade_fused_ref(prev, curr, window, relaxed_order=relaxed, window_mxu=True)
    torch.cuda.synchronize()
    assert launch_counts()["lk_fused_mxu"] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 if window == 3 else 1e-5)


# K10's block (csrc/lk_mxu.cu) is 64x64 outputs, 8 warps of 16 rows by 32
# columns, each walking its strip one 8-column tile at a time. Planes
# smaller than a block down to 1x1, one row and one column, widths that end
# mid tile (69, 203) and mid strip (100), a height that ends mid strip (72),
# several blocks with ragged edges, and a batch of two.
_MXU_SHAPES = [(1, 1), (1, 200), (200, 1), (37, 61), (72, 69), (64, 100), (130, 203),
               (2, 130, 203)]
# u, v on float frames, px by window: chip_smoke.MXU_ATOL. The batch's
# frames hold weakly conditioned windows where the plain version's own f32
# rounding shows: the kernel's earlier body (every intermediate in shared
# memory) and this one both read 3.4e-4 / 3.4e-5 px there at windows 3 / 5
# on an H100, above the 1e-4 / 1e-5 px that the other K10 tests' frames
# meet.
_MXU_FLOAT_ATOL = {3: 2e-3, 5: 2e-4, 7: 5e-5}


@pytest.mark.parametrize("shape", _MXU_SHAPES)
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("mode", ["refine", "refine_frozen", "fused", "fused_det"])
def test_mxu_kernel_blocks_and_strips(cuda, shape, window, relaxed, mode):
    # On 8-bit frames the window sums are exact in any order: max |d| 0.
    # On float frames u, v within _MXU_FLOAT_ATOL, |det| within 2e-6 of
    # the plane's largest, sums to rtol 1e-5. A
    # frozen refine passes the clipped flow through; a batch element equals
    # its 2-D launch.
    rng = np.random.default_rng(window * 100 + shape[-1])
    smooth = _smooth(rng, shape, cuda)
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    batch = shape[0] if len(shape) == 3 else 0
    frozen = mode == "refine_frozen"
    conv = (torch.tensor([frozen] + [False] * (batch - 1), device=cuda) if batch
            else torch.tensor(frozen, device=cuda))
    refine = mode.startswith("refine")
    kw = dict(window_size=window, relaxed_order=relaxed, window_mxu=True)
    if refine:
        kw.update(max_disp_v=3.0)
        kernel, plain, name = lk.lucas_kanade_refine, lk.lucas_kanade_refine_ref, "lk_refine_mxu"
    else:
        kw.update(return_confidence=mode == "fused_det")
        kernel, plain = lk.lucas_kanade_fused, lk.lucas_kanade_fused_ref
        name = "lk_fused_conf_mxu" if mode == "fused_det" else "lk_fused_mxu"

    def call(fn, p, c, uu, vv, cv):
        return fn(p, c, uu, vv, cv, **kw) if refine else fn(p, c, **kw)

    for frames, (p, c) in (("8-bit", tuple(f.round() for f in smooth)), ("float", smooth)):
        before = launch_counts()[name]
        got, want = call(kernel, p, c, u, v, conv), call(plain, p, c, u, v, conv)
        torch.cuda.synchronize()
        assert launch_counts()[name] == before + 1
        atol = 0.0 if frames == "8-bit" else _MXU_FLOAT_ATOL[window]
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=0, atol=atol)
        if mode == "fused_det":
            det_atol = 0.0 if frames == "8-bit" else 2e-6 * float(want[2].max())
            torch.testing.assert_close(got[2], want[2], rtol=0, atol=det_atol)
        if refine:
            for g, w in zip(got[2:], want[2:]):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        if frozen:
            first = (lambda t: t[0]) if batch else (lambda t: t)
            assert torch.equal(first(got[0]), first(u).clamp(-8, 8))
        for b in range(batch):
            single = call(kernel, p[b], c[b], u[b], v[b], conv[b:b + 1])
            for g, s1 in zip(got, single):
                assert torch.equal(g[b], s1)


@pytest.mark.parametrize("kind", shift_ablation.KINDS)
def test_shift_ablation_kernel_bit_exact(cuda, kind):
    a = shift_ablation.make_input(cuda)
    before = shift_ablation.launch_counts["shift_ablation"]
    got = shift_ablation.shift_adds(a, kind)
    want = shift_ablation.shift_adds_ref(a, kind)
    torch.cuda.synchronize()
    assert shift_ablation.launch_counts["shift_ablation"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", warp_mxu_ablation.MODES)
def test_warp_gather_ablation_kernel_bit_exact(cuda, mode):
    x, off = warp_mxu_ablation.make_inputs(cuda)
    before = warp_mxu_ablation.launch_counts["warp_mxu_ablation"]
    got = warp_mxu_ablation.candidate_accumulate(x, off, mode)
    want = warp_mxu_ablation.candidate_accumulate_ref(x, off, mode)
    torch.cuda.synchronize()
    assert warp_mxu_ablation.launch_counts["warp_mxu_ablation"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", shift_ablation.KINDS)
def test_shift_ablation_kernel_bit_exact_on_order_sensitive_input(cuda, kind, seed):
    a = shift_ablation.make_input(cuda, seed, spread=True)
    before = shift_ablation.launch_counts["shift_ablation"]
    got = shift_ablation.shift_adds(a, kind)
    want = shift_ablation.shift_adds_ref(a, kind)
    torch.cuda.synchronize()
    assert shift_ablation.launch_counts["shift_ablation"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("reach", [warp_mxu_ablation.MAXD, 200])
@pytest.mark.parametrize("rows,wp", [(1, 128), (3, 128), (5, 384), (6, 256), (1, 1920)])
@pytest.mark.parametrize("mode", warp_mxu_ablation.MODES)
def test_warp_gather_ablation_kernel_edges_and_far_offsets(cuda, mode, rows, wp, reach):
    rng = np.random.default_rng(rows * wp + reach)
    x = torch.from_numpy(rng.uniform(0, 255, (rows, wp + 256)).astype(np.float32)).to(cuda)
    off = torch.from_numpy(rng.integers(-reach, reach + 1, (rows, wp)).astype(np.int32)).to(cuda)
    before = warp_mxu_ablation.launch_counts["warp_mxu_ablation"]
    got = warp_mxu_ablation.candidate_accumulate(x, off, mode)
    want = warp_mxu_ablation.candidate_accumulate_ref(x, off, mode)
    torch.cuda.synchronize()
    assert warp_mxu_ablation.launch_counts["warp_mxu_ablation"] == before + 1
    assert torch.equal(got, want)


def test_ablation_entry_points_refuse_uncovered_arguments(cuda):
    import ctypes

    lib = _build.load()
    a = shift_ablation.make_input(cuda)
    out = torch.empty((shift_ablation.OUT_R, shift_ablation.OUT_C), device=cuda)
    r, c = shift_ablation.offsets("aligned")
    ints = ctypes.c_int * shift_ablation.N_SHIFTS
    stream = torch.cuda.current_stream().cuda_stream
    for rr, cc, n in ((r, c, shift_ablation.N_SHIFTS), ([r[0] + 1, *r[1:]], c, 16), (r, c, 15)):
        code = lib.tpuflow_shift_ablation(a.data_ptr(), out.data_ptr(), shift_ablation.COLS,
                                          shift_ablation.OUT_R, shift_ablation.OUT_C, n,
                                          ints(*rr), ints(*cc), stream)
        assert (code == 0) == (rr is r and n == shift_ablation.N_SHIFTS)
    x, off = warp_mxu_ablation.make_inputs(cuda, 2, 256)
    res = torch.empty((2, 256), device=cuda)
    for rows, wp, mode in ((2, 256, 0), (2, 200, 0), (0, 256, 1), (2, 256, 2)):
        code = lib.tpuflow_warp_gather_ablation(x.data_ptr(), off.data_ptr(), res.data_ptr(),
                                                rows, wp, mode, stream)
        assert (code == 0) == ((rows, wp, mode) == (2, 256, 0))
    torch.cuda.synchronize()


VO_KERNELS = {"production": {"warp_packed_u8", "warp_packed_u16", "lk_refine", "seed_grid"},
              "default": {"warp_exact", "lk_refine_exact", "seed_grid"}}


def _vo_frames(n, shape=(240, 320)):
    rng = np.random.default_rng(5)
    a = np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0)).astype(np.float32)
    return np.stack([a if i % 2 == 0 else np.roll(a, 2, axis=1) for i in range(n)])


@pytest.mark.parametrize("config", ["production", "default"])
def test_vo_session_matches_plain_versions(cuda, monkeypatch, config):
    frames = _vo_frames(5)

    def session():
        sess = OdometrySession((240.0, 240.0, 160.0, 120.0), backend="cuda",
                               pyramid_config=config, device=cuda,
                               fb_check_threshold=1.0 if config == "default" else None)
        sess.process_frames(frames)
        return sess

    before = launch_counts()
    kernels = session()
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k for k in after if after[k] > before[k]} == VO_KERNELS[config]
    monkeypatch.setattr(warp, "warp_round", warp.warp_round_ref)
    monkeypatch.setattr(lk, "refine_round", lk.refine_round_ref)
    monkeypatch.setattr(seed, "seed_grid", seed.seed_grid_ref)
    plain = session()
    assert kernels.n_landmarks == plain.n_landmarks
    for uv, puv, ids, pids, ok, pok in zip(kernels.obs_uv, plain.obs_uv, kernels.obs_lm,
                                           plain.obs_lm, kernels.obs_valid, plain.obs_valid):
        np.testing.assert_array_equal(ids, pids)
        np.testing.assert_array_equal(ok, pok)
        np.testing.assert_allclose(uv[ok], puv[ok], rtol=0, atol=1e-3)
    assert kernels.track_loss_frames == plain.track_loss_frames


def test_vo_step_makes_no_host_read_of_its_own(cuda):
    import warnings

    frames = torch.from_numpy(_vo_frames(3)).to(cuda)
    fe = device_loop.FrontEnd(backend="cuda", fb_check_threshold=1.0,
                              config=PYRAMID_CONFIGS["default"])
    state, _ = fe.init(frames[0])
    state, _ = fe.step(state, frames[1])  # warm-up: operator blocks, pad indices
    pyramidal.counters.reset()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fe.step(state, frames[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    reads = pyramidal.counters.convergence_reads + pyramidal.counters.band_reads
    assert reads == 0 and not syncs, [f"{w.filename}:{w.lineno}" for w in syncs]


def _ba_problem(dev, k=6, m=500, seed=11):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m), rng.uniform(4, 8, m)],
                   axis=1).astype(np.float32)
    xi = np.zeros((k, 6), np.float32)
    xi[:, 0] = 0.3 * np.arange(k)
    xi[:, 4] = 0.02 * np.arange(k)
    gt_r, gt_t = se3.se3_exp(torch.from_numpy(xi))
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0])
    cam = np.repeat(np.arange(k), m)
    lm = np.tile(np.arange(m), k)
    uv = ba.project(gt_r[cam], gt_t[cam], torch.from_numpy(pts)[lm], intr).numpy()
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    noise = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    noise[:2] = 0.0
    r0, t0 = se3.retract(gt_r, gt_t, torch.from_numpy(noise))
    return ba.BAProblem(
        poses_r=r0.to(dev), poses_t=t0.to(dev),
        landmarks=torch.from_numpy(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)).to(dev),
        obs_uv=torch.from_numpy(uv).to(dev), obs_cam=torch.from_numpy(cam).to(dev),
        obs_lm=torch.from_numpy(lm).to(dev), obs_valid=torch.ones(k * m, dtype=torch.bool,
                                                                   device=dev),
        intrinsics=intr.to(dev),
    )


def test_ba_solve_repeats_its_bits(cuda):
    p = _ba_problem(cuda)
    first = ba.solve(p, iterations=8, fixed_cams=(0, 1))
    again = ba.solve(p, iterations=8, fixed_cams=(0, 1))
    for f in ("poses_r", "poses_t", "landmarks"):
        assert torch.equal(getattr(first, f), getattr(again, f))
    assert float(ba.reprojection_errors(first).mean()) < 1.0
    assert not torch.backends.cuda.matmul.allow_tf32


def test_segment_sum_repeats_its_bits_and_sums(cuda):
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.integers(0, 300, 100_000)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(100_000, 6, 3)).astype(np.float32)).to(cuda)
    got = ba.segment_sum(vals, keys, 300)
    assert torch.equal(got, ba.segment_sum(vals, keys, 300))
    want = torch.zeros(300, 6, 3, dtype=torch.float64, device=cuda).index_add_(
        0, keys, vals.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


def _pose_graph(dev, k=17):
    """A chain of k poses with noisy odometry edges, two loop edges and a
    rotation-only edge, started from the truth perturbed (node 0 exact)."""
    rng = np.random.default_rng(3)
    xi = rng.normal(0, 0.2, (k, 6)).astype(np.float32)
    xi[0] = 0.0
    gt_r, gt_t = se3.se3_exp(torch.from_numpy(xi))
    pairs = [(i, i + 1) for i in range(k - 1)] + [(0, k - 1), (2, k - 3), (4, 5)]
    ei = torch.tensor([i for i, _ in pairs])
    ej = torch.tensor([j for _, j in pairs])
    er, et = se3.compose(*se3.inverse(gt_r[ei], gt_t[ei]), gt_r[ej], gt_t[ej])
    er, et = se3.retract(er, et, torch.from_numpy(
        rng.normal(0, 0.01, (len(pairs), 6)).astype(np.float32)))
    noise = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    noise[0] = 0.0
    r0, t0 = se3.retract(gt_r, gt_t, torch.from_numpy(noise))
    mask = torch.ones(len(pairs), 6)
    mask[-1, :3] = 0.0
    g = pose_graph.PoseGraph(poses_r=r0, poses_t=t0, edge_i=ei, edge_j=ej, edge_r=er, edge_t=et,
                             edge_valid=torch.ones(len(pairs), dtype=torch.bool),
                             edge_weight=torch.from_numpy(
                                 rng.uniform(0.5, 5.0, len(pairs)).astype(np.float32)),
                             edge_mask=mask)
    return pose_graph.to_device(g, dev)


def test_pose_graph_solve_repeats_its_bits(cuda):
    g = _pose_graph(cuda)
    first = pose_graph.solve(g, iterations=15, device=cuda)
    again = pose_graph.solve(g, iterations=15, device=cuda)
    assert torch.equal(first.poses_r, again.poses_r) and torch.equal(first.poses_t, again.poses_t)
    cpu = pose_graph.solve(g, iterations=15, device="cpu")
    torch.testing.assert_close(first.poses_r.cpu(), cpu.poses_r, rtol=0, atol=1e-4)
    torch.testing.assert_close(first.poses_t.cpu(), cpu.poses_t, rtol=0, atol=1e-4)
    assert float(pose_graph.residuals(first).abs().max()) < 0.05
    assert not torch.backends.cuda.matmul.allow_tf32


def test_imu_preintegration_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(4)
    gyro = rng.normal(scale=0.5, size=(200, 3)).astype(np.float32)
    accel = rng.normal(scale=3.0, size=(200, 3)).astype(np.float32)
    got = imu.preintegrate(gyro, accel, 0.005, bias_jacobians=True, device=cuda)
    want = imu.preintegrate(gyro, accel, 0.005, bias_jacobians=True, device="cpu")
    for a, b in zip(got, want):
        if isinstance(b, torch.Tensor):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=5e-6)
    times = np.arange(200) * 0.005
    bounds = np.append(times[::50], 1.0)
    incs = imu.preintegrate_segments(times, gyro, accel, bounds, device=cuda)
    assert [inc.n_samples for inc in incs] == [50, 50, 50, 50]
    assert not torch.backends.cuda.matmul.allow_tf32


def test_s87_on_the_card_matches_the_cpu(cuda):
    # The S8.7 datapath is torch int32 ops: the card wraps as the CPU does,
    # bit for bit, on the natural pair and a high-contrast pair where
    # ``num << 7`` wraps, at windows 3/5/7; the box downsample too.
    from s87_witness import shift_wraps

    from tpuflow_torch.eval import natural
    from tpuflow_torch.kernels import fixed_point

    rng = np.random.default_rng(11)
    g0 = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    g1 = np.roll(g0, 1, axis=1) ^ rng.integers(0, 64, (96, 128), dtype=np.uint8)
    for f0, f1 in (natural.committed_pair(), (g0, g1)):
        c0, c1 = torch.from_numpy(f0), torch.from_numpy(f1)
        assert shift_wraps(c0, c1) > 0
        for window in (3, 5, 7):
            want = fixed_point.lucas_kanade_s87(c0, c1, window)
            got = fixed_point.lucas_kanade_s87(c0.to(cuda), c1.to(cuda), window)
            for g, w in zip(got, want):
                assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
        assert torch.equal(fixed_point.box_downsample_2x(c0.to(cuda)).cpu(),
                           fixed_point.box_downsample_2x(c0))


# -- the main path under device control: the round kernels and the graphs --

# The gathers' ragged widths, 1-row and 1-column planes, the coarse 1080p
# planes and the largest gathered one, then a staged one (>= 2^20 px).
_ROUND_SHAPES = [(37, 61), (1, 333), (197, 1), (197, 333), (270, 480), (271, 479), (540, 960),
                 (1023, 1024), (1025, 1024)]
# (ladder, band index): the adaptive ladder's rungs 2 / 3 / 8, a one-band
# ladder without an index, and the narrowest and widest bands 0 and 31.
_ROUND_BANDS = [((2, 3, 8), 0), ((2, 3, 8), 1), ((2, 3, 8), 2), ((5,), None), ((0, 31), 0),
                ((0, 31), 1)]


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values on a base ``offset`` floats past a fresh allocation's
    (16-byte aligned) one."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape", _ROUND_SHAPES)
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
@pytest.mark.parametrize("ladder,index", _ROUND_BANDS)
@pytest.mark.parametrize("offset", [0, 1])
def test_warp_round_bit_exact_at_each_band_and_skipped(cuda, shape, packing, ladder, index,
                                                       offset):
    # offset 1: every plane (image, flow, out) one float past a 16-byte
    # boundary, which sends the gathers down their scalar path.
    rng = np.random.default_rng(17)
    img = _offset(_rand(rng, shape, 0, 255, cuda).round(), offset)
    u = _offset(_rand(rng, shape, -9, 9, cuda), offset)
    v = _offset(_rand(rng, shape, -9, 9, cuda), offset)
    band = None if index is None else torch.tensor(index, dtype=torch.int32, device=cuda)
    kw = dict(max_disp=8, ladder=ladder, band=band, packing=packing)
    mdv = ladder[index or 0]
    for latch in (0, 1):
        flag = torch.tensor(latch, dtype=torch.int32, device=cuda)
        fill = _offset(_rand(rng, shape, -1, 1, cuda), offset)
        before = launch_counts()[_WARP_COUNTER[packing]]
        got = warp.warp_round(img, u, v, _offset(fill, offset), flag, **kw)
        launched = launch_counts()[_WARP_COUNTER[packing]] - before
        want = warp.warp_round_ref(img, u, v, fill.clone(), flag, **kw)
        torch.cuda.synchronize()
        assert launched == 1 and got.data_ptr() % 16 == 4 * offset
        assert torch.equal(got, want)
        if latch:
            assert torch.equal(got, fill)
        else:
            assert torch.equal(got, warp.warp_banded(img, u, v, max_disp=8, clamp_flow=True,
                                                     max_disp_v=mdv, packing=packing))


@pytest.mark.parametrize("shape", [(17, 33), (270, 480), (1080, 1920)])
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [True, False])
def test_refine_round_matches_plain_and_sums_its_partials(cuda, shape, window, relaxed):
    rng = np.random.default_rng(window)
    prev, warped = _smooth(rng, shape, cuda)
    u, v = _rand(rng, shape, -5, 5, cuda), _rand(rng, shape, -5, 5, cuda)
    ladder = (2.0, 3.0, 8.0)
    band = torch.tensor(1, dtype=torch.int32, device=cuda)
    kw = dict(ladder=ladder, band=band, window_size=window, relaxed_order=relaxed)
    n_blocks = lk.refine_blocks(*shape, window)
    for latch in (0, 1):
        ctrl = torch.tensor([latch, 0, 0], dtype=torch.int32, device=cuda)
        ctrl_ref = ctrl.clone()
        parts = torch.zeros((2, 1, n_blocks), device=cuda)
        got = lk.refine_round(prev, warped, u, v, ctrl, parts=parts, **kw)
        want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        assert torch.equal(ctrl, ctrl_ref)
        if latch:
            assert torch.equal(got[0], u) and torch.equal(got[1], v) and not got[2].any()
        else:
            torch.testing.assert_close(got[2], parts.sum(dim=(1, 2)), rtol=1e-6, atol=0)
            fixed = lk.lucas_kanade_refine(prev, warped, u, v, torch.tensor(False, device=cuda),
                                           window_size=window, max_disp_v=3.0,
                                           relaxed_order=relaxed)
            assert torch.equal(got[0], fixed[0]) and torch.equal(got[1], fixed[1])


def test_refine_round_batch_latches_each_element(cuda):
    rng = np.random.default_rng(4)
    prev, warped = _smooth(rng, (2, 270, 480), cuda)
    u, v = _rand(rng, prev.shape, -2, 2, cuda), _rand(rng, prev.shape, -2, 2, cuda)
    ctrl = torch.tensor([[0, 1], [0, 0], [0, 0]], dtype=torch.int32, device=cuda)
    ctrl_ref = ctrl.clone()
    kw = dict(ladder=(8.0,), relaxed_order=True, convergence_threshold=10.0)
    got = lk.refine_round(prev, warped, u, v, ctrl, **kw)
    want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0][1], u[1]) and ctrl.tolist() == [[1, 1], [0, 0], [1, 0]]
    assert torch.equal(ctrl, ctrl_ref)


_MIXED_BANDS = (0, 2, 1, 2)  # one band index a plane of a B=4 batch


@pytest.mark.parametrize("shape", [(4, 37, 61), (4, 270, 480), (4, 1025, 1024), (3, 197, 333),
                                   (4, 540, 960)])
@pytest.mark.parametrize("packing", ["u8", "u16", "exact"])
def test_warp_round_takes_a_band_a_plane(cuda, shape, packing):
    """Batched streams: a round with one band index a plane (B=4: bands
    2 / 8 / 3 / 8; B=3: 2 / 8 / 3), running, partly skipped (one latched
    plane of three) and all skipped: one launch, bit for bit its plain
    version and each plane's own 2-D round at its own band."""
    rng = np.random.default_rng(23)
    img = _rand(rng, shape, 0, 255, cuda).round()
    u, v = _rand(rng, shape, -9, 9, cuda), _rand(rng, shape, -9, 9, cuda)
    batch = shape[0]
    band = torch.tensor(_MIXED_BANDS[:batch], dtype=torch.int32, device=cuda)
    kw = dict(max_disp=8, ladder=_LADDER, packing=packing)
    for latch in ((0,) * batch, (0, 1, 0, 1)[:batch], (1,) * batch):
        flag = torch.tensor(latch, dtype=torch.int32, device=cuda)
        fill = _rand(rng, shape, -1, 1, cuda)
        before = launch_counts()[_WARP_COUNTER[packing]]
        got = warp.warp_round(img, u, v, fill.clone(), flag, band=band, **kw)
        launched = launch_counts()[_WARP_COUNTER[packing]] - before
        want = warp.warp_round_ref(img, u, v, fill.clone(), flag, band=band, **kw)
        torch.cuda.synchronize()
        assert launched == 1 and torch.equal(got, want)
        for b in range(shape[0]):
            one = warp.warp_round(img[b], u[b], v[b], fill[b].clone(), flag[b:b + 1],
                                  band=band[b:b + 1], **kw)
            assert torch.equal(got[b], fill[b] if latch[b] else one), b


@pytest.mark.parametrize("shape", [(4, 17, 33), (4, 270, 480), (4, 540, 960)])
@pytest.mark.parametrize("relaxed", [True, False])
def test_refine_round_takes_a_band_a_plane(cuda, shape, relaxed):
    """Batched streams: a B=4 refine round with one band index a plane,
    running and partly skipped: u, v and the control bit for bit its plain
    version (its sums to rtol 1e-5) and each plane's own 2-D round."""
    rng = np.random.default_rng(29)
    prev, warped = _smooth(rng, shape, cuda)
    u, v = _rand(rng, shape, -5, 5, cuda), _rand(rng, shape, -5, 5, cuda)
    band = torch.tensor(_MIXED_BANDS, dtype=torch.int32, device=cuda)
    kw = dict(ladder=tuple(map(float, _LADDER)), band=band, relaxed_order=relaxed)
    for latch in ((0, 0, 0, 0), (1, 0, 1, 0)):
        ctrl = torch.zeros((lk.CTRL_ROWS, shape[0]), dtype=torch.int32, device=cuda)
        ctrl[0] = torch.tensor(latch, dtype=torch.int32, device=cuda)
        ctrl0, ctrl_ref = ctrl.clone(), ctrl.clone()
        got = lk.refine_round(prev, warped, u, v, ctrl, **kw)
        want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        assert torch.equal(ctrl, ctrl_ref)
        for b in range(shape[0]):
            one_ctrl = ctrl0[:, b].clone()
            one = lk.refine_round(prev[b], warped[b], u[b], v[b], one_ctrl,
                                  **dict(kw, band=band[b:b + 1]))
            assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1]), b
            assert torch.equal(got[2][:, b], one[2]) and torch.equal(ctrl[:, b], one_ctrl), b


def _streams(dev, batch: int = 4, shape=(240, 320)):
    """B textured streams' first frames and next frames: moved 2 px right,
    still, moved 3 px down and 0.5 px right, and 1 px both ways (repeated
    past four)."""
    from scipy.ndimage import shift as nd_shift

    rng = np.random.default_rng(8)
    a = np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0))
    moves = [(0.0, 2.0), (0.0, 0.0), (3.0, 0.5), (1.0, 1.0)]
    nxt = [np.round(nd_shift(a, moves[b % 4], order=1, mode="constant", cval=128.0))
           for b in range(batch)]
    first = torch.from_numpy(np.stack([a] * batch).astype(np.float32)).to(dev)
    return first, torch.from_numpy(np.stack(nxt).astype(np.float32)).to(dev)


@pytest.mark.parametrize("config", ["production", "default"])
def test_batched_graphed_stream_is_each_streams_own(cuda, config):
    """Four streams in one GraphedStream: each step's flow and rounds bit
    for bit each element's own 2-D GraphedStream and the batched eager
    step; the replay launches as many kernels as one stream's."""
    cfg = PYRAMID_CONFIGS[config]
    first, nxt = _streams(cuda)
    stream = GraphedStream(first, cfg)
    singles = [GraphedStream(first[b], cfg) for b in range(4)]
    assert stream.launches == singles[0].launches
    carry = torch_ref.build_gaussian_pyramid(first, cfg.levels, cfg.scale_factor)
    for frames in (nxt, first, nxt):
        u, v = stream.step(frames)
        eu, ev, carry = lucas_kanade_pyramidal_step(carry, frames, cfg, backend="cuda")
        assert torch.equal(u, eu) and torch.equal(v, ev)
        assert torch.equal(stream.level_rounds, pyramidal.counters.level_rounds)
        assert stream.level_rounds.shape == (4, cfg.levels)
        for b, single in enumerate(singles):
            su, sv = single.step(frames[b])
            assert torch.equal(u[b], su) and torch.equal(v[b], sv), b
            assert torch.equal(stream.level_rounds[b], single.level_rounds), b
    assert stream.level_rounds[1].tolist() == [1] * cfg.levels


def _dp_rank(rank: int, world: int, addr: str, out: str) -> None:
    """One rank of the 4x1x1 data-parallel mesh: the batched GraphedStream
    on its slice of a B=4 and a B=8 batch, the slices all-gathered and
    held against the whole batch on this card; then the mesh released and
    the world destroyed."""
    import json

    import torch.distributed as dist

    from tpuflow_torch.sharding import initialize_multihost, make_flow_mesh, release_mesh
    from tpuflow_torch.sharding.mesh import all_gather

    initialize_multihost(addr, world, rank, backend="nccl")
    dev = torch.device("cuda", rank)
    mesh = make_flow_mesh(world, 1, 1, device=dev)
    cfg = PYRAMID_CONFIGS["default"]
    equal = []
    for batch in (4, 8):
        first, nxt = _streams(dev, batch)
        per = batch // world
        mine = slice(rank * per, (rank + 1) * per)
        local = GraphedStream(first[mine].contiguous(), cfg)
        u, v = local.step(nxt[mine].contiguous())
        gathered = [torch.cat(all_gather(t, mesh.group)) for t in (u, v, local.level_rounds)]
        whole = GraphedStream(first, cfg)
        wu, wv = whole.step(nxt)
        equal.append([bool(torch.equal(gathered[0][b], wu[b]) and torch.equal(gathered[1][b], wv[b])
                           and torch.equal(gathered[2][b], whole.level_rounds[b]))
                      for b in range(batch)])
        del local, whole
    release_mesh(mesh)
    dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(equal, f)


def test_data_parallel_mesh_gathers_each_streams_own(tmp_path):
    """bench_scaling's data-parallel design point on a 4x1x1 mesh, one
    rank a card: each rank's slice of a batch, gathered, equals one card's
    batch element by element, and the teardown returns."""
    import json
    import socket

    import torch.multiprocessing as mp

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, 4, addr, str(tmp_path))) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    assert not hung and [p.exitcode for p in procs] == [0] * 4
    for r in range(4):
        assert json.loads((tmp_path / f"rank{r}.json").read_text()) == [[True] * 4, [True] * 8]


def _launches(fn):
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("config", ["production", "default"])
def test_graphed_stream_equals_the_eager_step(cuda, config):
    cfg = PYRAMID_CONFIGS[config]
    rng = np.random.default_rng(8)
    a = np.round(gaussian_filter(rng.uniform(0, 255, (240, 320)), 2.0)).astype(np.float32)
    a = torch.from_numpy(a).to(cuda)
    frames = [a.roll(2, dims=1) if i % 2 == 0 else a for i in range(4)]
    carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    eager = []
    for frame in frames:
        (u, v, carry), counts = _launches(
            lambda: lucas_kanade_pyramidal_step(carry, frame, cfg, backend="cuda"))
        eager.append((u, v, pyramidal.counters.level_rounds.tolist(), counts))
    stream = GraphedStream(a, cfg)
    assert stream.launches == eager[0][3]
    for frame, (eu, ev, rounds, counts) in zip(frames, eager):
        (u, v), replayed = _launches(lambda: stream.step(frame))
        assert replayed == counts
        assert torch.equal(u, eu) and torch.equal(v, ev)
        assert stream.level_rounds.tolist() == rounds
    with pytest.raises(ValueError):
        stream.step(a.cpu())


@pytest.mark.parametrize("config,fb", [("production", None), ("default", 1.0)])
def test_vo_graphed_scan_equals_eager_steps(cuda, config, fb):
    frames = torch.from_numpy(_vo_frames(5)).to(cuda)
    fe = device_loop.FrontEnd(backend="cuda", fb_check_threshold=fb,
                              config=PYRAMID_CONFIGS[config])
    state0, _ = fe.init(frames[0])
    state, records, eager_counts = state0, [], None
    for frame in frames[1:]:
        (state, obs), eager_counts = _launches(lambda: fe.step(state, frame))
        records.append(obs)
    assert fe.graphed(frames)
    g_state, g_obs = fe.scan_steps(state0, frames[1:])
    (g_state2, _), counts = _launches(lambda: fe.scan_steps(state0, frames[1:2]))
    assert counts == eager_counts
    for i, obs in enumerate(records):
        for got, want in zip(g_obs, obs):
            assert torch.equal(got[i], want)
    for got, want in zip(device_loop._tensors(g_state), device_loop._tensors(state)):
        assert torch.equal(got, want)


def _traced_port_launches(fn) -> int:
    """Launches of the port's kernels that the device ran in ``fn()``, from
    a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "tpuflow_" in e.key)


@pytest.mark.parametrize("config", ["production", "default"])
def test_graph_replay_runs_the_captured_launches(cuda, config):
    cfg = PYRAMID_CONFIGS[config]
    a = torch.from_numpy(_vo_frames(1)[0]).to(cuda)
    stream = GraphedStream(a, cfg)
    frame = a.roll(2, dims=1)
    stream.step(frame)
    assert _traced_port_launches(lambda: stream.step(frame)) == sum(stream.launches.values())


def test_graphed_stream_counts_its_kernel_nodes(cuda):
    """A B=3 GraphedStream's ``nodes``, counted at its capture through the
    driver API, hold as many kernels as the same step captured here with
    ``keep_graph=True``; the stream's flow is the eager step's bit for
    bit."""
    cfg = PYRAMID_CONFIGS["production"]
    first, nxt = _streams(cuda, batch=3)
    stream = GraphedStream(first, cfg)
    carry = torch_ref.build_gaussian_pyramid(first, cfg.levels, cfg.scale_factor)
    static, frame = [level.clone() for level in carry], nxt.clone()

    def body():
        u, v, pyr = lucas_kanade_pyramidal_step(static, frame, cfg, backend="cuda")
        for dst, src in zip(static, pyr):
            dst.copy_(src)
        return u, v

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    own = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(own):
        body()
    print(f"B=3 production graph nodes: {stream.nodes}")
    assert graphed.graph_nodes(own)["kernel"] == stream.nodes["kernel"] > 0
    for frames in (nxt, first, nxt):
        u, v = stream.step(frames)
        eu, ev, carry = lucas_kanade_pyramidal_step(carry, frames, cfg, backend="cuda")
        assert torch.equal(u, eu) and torch.equal(v, ev)


def test_spans_put_no_annotation_on_the_device_timeline(cuda):
    """Under torch.profiler a span, and each span of a chain, is on the
    host's timeline alone: no device event carries its name (a tool that
    sums the device's timeline would read an annotation there as device
    work), while the kernels launched inside it are traced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1 << 20, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with telemetry.span("tpuflow_torch.test.card"):
            (x * 2).sum()
        with telemetry.chain("tpuflow_torch.test.first", "tpuflow_torch.test.then") as spans:
            (x * 4).sum()
            spans.next()
            (x * 5).sum()
        with record_function("test.user_scope"):
            (x * 3).sum()
        torch.cuda.synchronize()
    on = {"host": set(), "device": []}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            on["device"].append(e.name())
        else:
            on["host"].add(e.name())
    print(f"record_function's scope on the device timeline: {'test.user_scope' in on['device']}")
    for name in ("tpuflow_torch.test.card", "tpuflow_torch.test.first",
                 "tpuflow_torch.test.then"):
        assert name in on["host"]
        assert name not in on["device"]
    assert len([n for n in on["device"] if n != "test.user_scope"]) >= 4


def test_graphs_follow_a_swapped_wrapper(cuda, monkeypatch):
    frames = torch.from_numpy(_vo_frames(3)).to(cuda)
    cfg = PYRAMID_CONFIGS["production"]
    stream = GraphedStream(frames[0], cfg)
    fe = device_loop.FrontEnd(backend="cuda", config=cfg)
    state0, _ = fe.init(frames[0])
    fe.scan_steps(state0, frames[1:])
    calls = []

    def refine_round(*args, **kw):
        calls.append(1)
        return lk.refine_round_ref(*args, **kw)

    monkeypatch.setattr(lk, "refine_round", refine_round)
    with pytest.raises(RuntimeError, match="wrappers"):
        stream.step(frames[1])
    fe.scan_steps(state0, frames[1:])
    assert calls  # captured again, through the wrapper bound now


def _seed_frame(source: str, shape, dev):
    rng = np.random.default_rng(shape[1])
    if source == "noise":
        a = rng.uniform(0, 255, shape)
    elif source == "texture":
        a = np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0))
    else:  # 8x8 constant patches: exact ties in every cell
        levels = rng.integers(0, 255, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        a = np.kron(levels, np.ones((8, 8)))[: shape[0], : shape[1]]
    return torch.from_numpy(a.astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(2160, 3840), (1080, 1920), (121, 163)])
@pytest.mark.parametrize("margin", [0, 3, 13, 20])
@pytest.mark.parametrize("source", ["noise", "texture", "patches"])
def test_seed_kernel_bit_exact(cuda, shape, margin, source):
    frame = _seed_frame(source, shape, cuda)
    (xy, alive), counts = _launches(lambda: seed.seed_grid(frame, 16, margin=margin))
    want_xy, want_alive = seed.seed_grid_ref(frame, 16, margin=margin)
    assert counts == {"seed_grid": 1}
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive)


@pytest.mark.parametrize("step", [8, 32])
def test_seed_kernel_bit_exact_at_other_grid_steps(cuda, step):
    frame = _seed_frame("texture", (270, 481), cuda)
    xy, alive = seed.seed_grid(frame, step, margin=5)
    want_xy, want_alive = seed.seed_grid_ref(frame, step, margin=5)
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive)


def test_seed_kernel_gated_on_the_device(cuda):
    frame = _seed_frame("texture", (240, 320), cuda)
    taken = torch.zeros(1, dtype=torch.int32, device=cuda)
    off = torch.tensor(False, device=cuda)
    on = torch.tensor(True, device=cuda)
    (_, alive), counts = _launches(lambda: seed.seed_grid(frame, 16, predicate=off, taken=taken))
    assert counts == {"seed_grid": 1}
    assert alive.shape == (15 * 20,) and not bool(alive.any()) and int(taken) == 0
    xy, alive = seed.seed_grid(frame, 16, predicate=on, taken=taken)
    want_xy, want_alive = seed.seed_grid_ref(frame, 16)
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive) and int(taken) == 1
    with pytest.raises(ValueError):
        seed.seed_grid(frame, 16, predicate=off.cpu())
    with pytest.raises(ValueError):
        seed.seed_grid(frame[:8], 16)  # no grid cell


@pytest.mark.parametrize("margin", [0, 13])
def test_seed_kernel_gated_at_4k(cuda, margin):
    """At 2160x3840, grid 16 (135 x 240 cells, 32,400 track slots): a false
    predicate leaves every cell dead and counts no reseed; a true one gives
    the plain version's cells and counts one."""
    frame = _seed_frame("texture", (2160, 3840), cuda)
    taken = torch.zeros(1, dtype=torch.int32, device=cuda)
    off = torch.tensor(False, device=cuda)
    _, alive = seed.seed_grid(frame, 16, margin=margin, predicate=off, taken=taken)
    assert alive.shape == (135 * 240,) and not bool(alive.any()) and int(taken) == 0
    xy, alive = seed.seed_grid(frame, 16, margin=margin, predicate=~off, taken=taken)
    want_xy, want_alive = seed.seed_grid_ref(frame, 16, margin=margin)
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive) and int(taken) == 1


@pytest.mark.parametrize("n", [1, 2, 751])
@pytest.mark.parametrize("jacobians", [False, True])
def test_imu_scan_kernel_matches_the_plain_loop(cuda, n, jacobians):
    rng = np.random.default_rng(n)
    g, a = (torch.from_numpy(rng.normal(scale=s, size=(n, 3)).astype(np.float32)).to(cuda)
            for s in (0.5, 3.0))
    h = torch.from_numpy(rng.uniform(0.004, 0.006, n).astype(np.float32)).to(cuda)
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), a, h]
    if jacobians:
        args += [se3.so3_right_jacobian(wh), se3.hat(a)]
    got, counts = _launches(lambda: imu_kernel.preintegrate_scan(*args))
    want = imu_kernel.preintegrate_scan_ref(*args)
    assert counts == {"imu_preintegrate": 1}
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5 * float(y.abs().max()))
    assert not torch.backends.cuda.matmul.allow_tf32


# The seed kernel's tiling (csrc/seed.cu): a block holds cell_rows rows of
# cells_x cells (by grid step: 1 -> 16 x 245, 8 -> 2 x 30, 16 -> 1 x 15,
# 32 -> 1 x 7, 64 -> 1 x 3, 1020 -> 1 x 1), each warp 124 output columns.
# Per step a frame whose cells across and cell rows are no multiple of the
# block's, with its width a multiple of 4 (16-B staging) or not (4-B), and
# a frame of one cell row (at step 1, of one block row: the plain version
# takes no frame under the window's 5 rows); margins 0, 5 and 13.
_SEED_TILING_SHAPES = {1: [(37, 263), (5, 300)], 8: [(75, 500), (15, 333)],
                       16: [(121, 1000), (16, 261)], 32: [(100, 777), (40, 300)],
                       64: [(200, 1300), (64, 700)], 1020: [(1100, 2100), (1020, 1025)]}


@pytest.mark.parametrize("step,shape", [(s, shape) for s, shapes in _SEED_TILING_SHAPES.items()
                                        for shape in shapes])
@pytest.mark.parametrize("margin", [0, 5, 13])
@pytest.mark.parametrize("source", ["texture", "flat"])
def test_seed_kernel_bit_exact_at_the_tiling_edges(cuda, step, shape, margin, source):
    # A flat frame: a zero response everywhere (ties in every cell) and cells
    # wholly outside the margin all -inf.
    frame = (_seed_frame("texture", shape, cuda) if source == "texture"
             else torch.full(shape, 77.0, device=cuda))
    (xy, alive), counts = _launches(lambda: seed.seed_grid(frame, step, margin=margin))
    want_xy, want_alive = seed.seed_grid_ref(frame, step, margin=margin)
    assert counts == {"seed_grid": 1}
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive)


def test_seed_kernel_bit_exact_on_an_unaligned_frame(cuda):
    # A frame 4 B past a 16-B boundary, width a multiple of 4: 4-B staging.
    h, w = 121, 1000
    flat = torch.empty(h * w + 1, device=cuda)
    frame = flat[1:].view(h, w)
    frame.copy_(_seed_frame("texture", (h, w), cuda))
    assert frame.data_ptr() % 16 != 0
    xy, alive = seed.seed_grid(frame, 16, margin=13)
    want_xy, want_alive = seed.seed_grid_ref(frame, 16, margin=13)
    assert torch.equal(xy, want_xy) and torch.equal(alive, want_alive)


def test_seed_kernel_square_root_is_sqrtf_on_every_float(cuda):
    # The kernel's branch-free square root against sqrtf, bit for bit, over
    # every non-negative float32 (csrc/seed.cu, sqrt_rn).
    lib = _build.load()
    mismatches = torch.zeros(1, dtype=torch.int64, device=cuda)
    code = lib.tpuflow_seed_sqrt_mismatches(mismatches.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "sqrt check")
    assert int(mismatches) == 0


@pytest.mark.parametrize("step,shape", [(1, (37, 263)), (16, (121, 1000)), (1020, (1100, 2100))])
def test_seed_kernel_false_predicate_at_the_tiling_edges(cuda, step, shape):
    frame = _seed_frame("texture", shape, cuda)
    taken = torch.full((1,), 5, dtype=torch.int32, device=cuda)
    off = torch.tensor(False, device=cuda)
    xy, alive = seed.seed_grid(frame, step, predicate=off, taken=taken)
    assert alive.numel() == (shape[0] // step) * (shape[1] // step)
    assert not bool(alive.any()) and int(taken) == 5


def _scan_args(n: int, jacobians: bool, dev):
    rng = np.random.default_rng(n)
    g, a = (torch.from_numpy(rng.normal(scale=s, size=(n, 3)).astype(np.float32)).to(dev)
            for s in (0.5, 3.0))
    h = torch.from_numpy(rng.uniform(0.004, 0.006, n).astype(np.float32)).to(dev)
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), a, h]
    if jacobians:
        args += [se3.so3_right_jacobian(wh), se3.hat(a)]
    return args


# The scan stages 128 samples a chunk, two chunks in flight: no sample, one,
# two, one below a chunk, a chunk, one above, and swing_imu's 751.
@pytest.mark.parametrize("n", [0, 1, 2, 127, 128, 129, 751])
@pytest.mark.parametrize("jacobians", [False, True])
def test_imu_scan_kernel_at_the_chunk_edges(cuda, n, jacobians):
    args = _scan_args(n, jacobians, cuda)
    got, counts = _launches(lambda: imu_kernel.preintegrate_scan(*args))
    want = imu_kernel.preintegrate_scan_ref(*args)
    assert counts == {"imu_preintegrate": 1}
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-6)


@pytest.mark.parametrize("jacobians", [False, True])
def test_imu_scan_kernel_over_ten_thousand_samples(cuda, jacobians):
    # Over 10,000 random samples the float32 plain loop (cuBLAS's 3x3
    # products) and the kernel (dot3's order) round ~5e-5 apart in r, so
    # both are held to the loop in float64: the kernel within twice the
    # float32 loop's own distance from it, plus 2e-6.
    args = _scan_args(10_000, jacobians, cuda)
    got, counts = _launches(lambda: imu_kernel.preintegrate_scan(*args))
    want32 = imu_kernel.preintegrate_scan_ref(*args)
    want64 = imu_kernel.preintegrate_scan_ref(*[a.double() for a in args])
    assert counts == {"imu_preintegrate": 1}
    for x, y32, y64 in zip(got, want32, want64):
        loop_err = float((y32.double() - y64).abs().max())
        assert float((x.double() - y64).abs().max()) <= 2 * loop_err + 2e-6


@pytest.mark.parametrize("jacobians", [False, True])
def test_imu_scan_kernel_bit_identical_on_swing_imu(cuda, jacobians):
    from tpuflow_torch.eval import vo_verifier

    n = vo_verifier.SEQUENCE_LENGTHS["swing_imu"]
    ts, gyro, accel, _ = vo_verifier._imu_swing(n)
    dts = np.append(np.diff(ts), np.median(np.diff(ts)))
    g, a, h = (torch.from_numpy(np.asarray(x, np.float32)).to(cuda) for x in (gyro, accel, dts))
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), a, h]
    if jacobians:
        args += [se3.so3_right_jacobian(wh), se3.hat(a)]
    got = imu_kernel.preintegrate_scan(*args)
    want = imu_kernel.preintegrate_scan_ref(*args)
    assert len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want))


def test_vo_stride_two_graphed_eager_and_plain_agree(cuda, monkeypatch):
    frames = torch.from_numpy(_vo_frames(7)).to(cuda)
    fe = device_loop.FrontEnd(backend="cuda", keyframe_stride=2,
                              config=PYRAMID_CONFIGS["production"])
    counter = pyramidal.counters.reseeds(cuda)

    def eager():
        state, _ = fe.init(frames[0])
        start = int(counter)
        records = []
        for frame in frames[1:]:
            state, obs = fe.step(state, frame)
            records.append(obs)
        return records, int(counter) - start

    state0, _ = fe.init(frames[0])
    start = int(counter)
    _, g_obs = fe.scan_steps(state0, frames[1:])
    g_taken = int(counter) - start
    e_obs, e_taken = eager()
    monkeypatch.setattr(warp, "warp_round", warp.warp_round_ref)
    monkeypatch.setattr(lk, "refine_round", lk.refine_round_ref)
    monkeypatch.setattr(seed, "seed_grid", seed.seed_grid_ref)
    before = launch_counts()
    p_obs, p_taken = eager()
    assert launch_counts() == before
    assert g_taken == e_taken == p_taken <= 3  # at most the even steps
    for i in range(len(e_obs)):
        for g, e, p in zip(g_obs, e_obs[i], p_obs[i]):
            assert torch.equal(g[i], e) and torch.equal(e, p)


@pytest.mark.parametrize("name", ["translate_small", "rotate_small", "rotate_large", "zoom_in",
                                  "zoom_out", "translate_rotate", "custom"])
def test_suite_generator_on_the_card_equals_the_cpu(cuda, name):
    from tpuflow_torch.eval import patterns

    base = patterns.load_base_texture(640, 480)
    params = (patterns.MotionParameters("custom", dx=1.3, dy=-2.7, rotation=7.5, scale=1.05)
              if name == "custom" else patterns.TEST_PATTERNS[name])
    got = patterns.apply_motion(base, params, device=cuda)
    want = patterns.apply_motion(base, params, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lookahead", [0, 2])
@pytest.mark.parametrize("depth", [1, 3])
def test_native_reader_feeds_the_uploads_without_a_stale_frame(cuda, tmp_path, lookahead,
                                                               depth):
    # 64 frames, each a distinct constant plus a ramp, through the native
    # reader's few pinned buffers, each reused many times; the consumer
    # queues work behind every frame so the copies and the reads overlap it.
    from tpuflow_torch.io import fastio
    from tpuflow_torch.io.frames import save_frame_bin
    from tpuflow_torch.io.stream import FrameStream, prefetch_to_device

    h, w = 270, 480
    ramp = np.arange(h * w, dtype=np.int64).reshape(h, w) % 7
    paths = []
    for i in range(64):
        p = tmp_path / f"frame_{i:02d}.bin"
        save_frame_bin(p, (i * 3 + ramp) % 256)
        paths.append(p)
    before = fastio.live_workers()
    got = []
    for frame in prefetch_to_device(FrameStream(paths, w, h, depth=depth), lookahead=lookahead,
                                    device=cuda):
        torch.cuda._sleep(200_000)  # the consumer's stream is busy
        got.append((frame.sum(dtype=torch.float64), frame[:2, :3].clone()))
    torch.cuda.synchronize()
    assert fastio.live_workers() == before
    assert len(got) == 64
    for i, (total, corner) in enumerate(got):
        want = (i * 3 + ramp) % 256
        assert float(total) == float(want.sum())
        assert torch.equal(corner.cpu(), torch.from_numpy(want[:2, :3].astype(np.float32)))


# Frame sizes above 1080p: the planes a 4K (2160x3840) and an 8K
# (4320x7680) pyramid give the kernels.
_LADDER = (2, 3, 8)


def _textured_pair(shape, dev, seed=0):
    """A blurred 8-bit noise frame and it rolled 2 px right."""
    rng = np.random.default_rng(seed)
    a = np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0)).astype(np.float32)
    a = torch.from_numpy(a).to(dev)
    return a, a.roll(2, dims=1)


def test_packed_u16_warp_on_the_staged_tile_at_1080x1920(cuda):
    # The second level of a 4K production pyramid: K2 there takes the
    # staged 128x32 tile (planes of 2**20 pixels and more), where at 1080p
    # it only ever gathered; the entry and the round, bit-exact.
    shape = (1080, 1920)
    assert warp.tile_geometry(*shape, 8, 8)["staged"]
    rng = np.random.default_rng(21)
    img = _rand(rng, shape, 0, 255, cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    for i, mdv in enumerate(_LADDER):
        u, v = _rand(rng, shape, -11, 11, cuda), _rand(rng, shape, -11, 11, cuda)
        kw = dict(clamp_flow=True, max_disp_v=mdv, packing="u16")
        before = launch_counts()["warp_packed_u16"]
        got = warp.warp_banded(img, u, v, 8, **kw)
        band = torch.tensor(i, dtype=torch.int32, device=cuda)
        rkw = dict(max_disp=8, ladder=_LADDER, band=band, packing="u16")
        rnd = warp.warp_round(img, u, v, torch.empty_like(img), zero, **rkw)
        assert launch_counts()["warp_packed_u16"] == before + 2
        assert torch.equal(got, warp.warp_banded_ref(img, u, v, 8, **kw))
        assert torch.equal(rnd, warp.warp_round_ref(img, u, v, torch.empty_like(img), zero,
                                                    **rkw))
        assert torch.equal(rnd, got)


def test_4k_production_pair_equals_the_plain_versions(cuda, monkeypatch):
    cfg = PYRAMID_CONFIGS["production"]
    a, b = _textured_pair((2160, 3840), cuda)

    def step():
        carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
        u, v, _ = lucas_kanade_pyramidal_step(carry, b, cfg, backend="cuda")
        return u, v, pyramidal.counters.level_rounds.tolist()

    (u, v, rounds), counts = _launches(step)
    assert counts == {"warp_packed_u8": 3, "warp_packed_u16": 6, "lk_refine": 9}
    monkeypatch.setattr(warp, "warp_round", warp.warp_round_ref)
    monkeypatch.setattr(lk, "refine_round", lk.refine_round_ref)
    pu, pv, plain_rounds = step()
    assert rounds == plain_rounds
    assert torch.equal(u, pu) and torch.equal(v, pv)
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())


def test_8k_default_pair_every_launch_equals_its_plain_version(cuda, monkeypatch):
    # Each of the step's 18 launches (K4 and K5 at the three levels of an 8K
    # pyramid) against its plain version on the same inputs: u, v and the
    # control bit-identical, the sums to rtol 1e-5.
    cfg = PYRAMID_CONFIGS["default"]
    a, b = _textured_pair((4320, 7680), cuda)
    real_warp, real_refine = warp.warp_round, lk.refine_round
    seen = []

    def warp_checked(image, u, v, out, latch, **kw):
        want = warp.warp_round_ref(image, u, v, out.clone(), latch.clone(), **kw)
        got = real_warp(image, u, v, out, latch, **kw)
        assert torch.equal(got, want)
        seen.append(("warp_exact", tuple(image.shape)))
        return got

    def refine_checked(prev, warped, u, v, ctrl, **kw):
        ctrl_ref = ctrl.clone()
        want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
        got = real_refine(prev, warped, u, v, ctrl, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(ctrl, ctrl_ref)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        seen.append(("lk_refine_exact", tuple(prev.shape)))
        return got

    monkeypatch.setattr(warp, "warp_round", warp_checked)
    monkeypatch.setattr(lk, "refine_round", refine_checked)
    carry = torch_ref.build_gaussian_pyramid(a, cfg.levels, cfg.scale_factor)
    (u, v, _), counts = _launches(lambda: lucas_kanade_pyramidal_step(carry, b, cfg,
                                                                      backend="cuda"))
    levels = [tuple(level.shape) for level in carry]
    assert levels[-1] == (4320, 7680)
    assert counts == {"warp_exact": 9, "lk_refine_exact": 9}
    assert sorted(set(seen)) == sorted({(k, s) for k in ("warp_exact", "lk_refine_exact")
                                        for s in levels})
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())
    assert abs(float(u[32:-32, 32:-32].median()) - 2.0) < 0.1


@pytest.mark.parametrize("shape", [(2160, 3840), (4320, 7680)])
def test_refine_round_sums_within_their_depth_above_1080p(cuda, shape):
    # The round's in-kernel sum adds ~4x (4K) and ~16x (8K) the partials of
    # 1080p, so its depth (kernels.lk.round_sum_depth) grows: within
    # 1e-6 scaled by that depth over 1080p's of torch.sum of the same
    # partials, and within gamma_depth of their float64 sum.
    depth = lk.round_sum_depth(*shape, 5)
    ref_depth = lk.round_sum_depth(1080, 1920, 5)
    assert depth > ref_depth
    unit = 2.0 ** -24
    rng = np.random.default_rng(31)
    prev, warped = _smooth(rng, shape, cuda)
    u, v = _rand(rng, shape, -5, 5, cuda), _rand(rng, shape, -5, 5, cuda)
    band = torch.tensor(2, dtype=torch.int32, device=cuda)
    ctrl = torch.zeros(3, dtype=torch.int32, device=cuda)
    ctrl_ref = ctrl.clone()
    parts = torch.zeros((2, 1, lk.refine_blocks(*shape, 5)), device=cuda)
    kw = dict(ladder=(2.0, 3.0, 8.0), band=band, relaxed_order=True)
    got = lk.refine_round(prev, warped, u, v, ctrl, parts=parts, **kw)
    want = lk.refine_round_ref(prev, warped, u, v, ctrl_ref, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(ctrl, ctrl_ref)
    part = parts.sum(dim=(1, 2))
    exact = parts.double().sum(dim=(1, 2))
    assert float(((got[2] - part).abs() / part).max()) <= 1e-6 * depth / ref_depth
    assert float(((got[2].double() - exact).abs() / exact).max()) <= \
        depth * unit / (1 - depth * unit)


# -- the tiled path under device control: K6's tile round, graphs over NCCL ----------------

# Crops around the walk's strip widths and block rows, down to one pixel.
_CROP_SHAPES = [(1, 1), (5, 7), (19, 23), (31, 25), (70, 233), (135, 240)]


def _tile_inputs(rng, shape, window, dev, batch=None):
    """Extended tiles of a (h, w) tile at ``window`` and the tile's flow."""
    ext = window // 2 + 1
    lead = () if batch is None else (batch,)
    h, w = shape
    prev, curr = _smooth(rng, (*lead, h + 2 * ext, w + 2 * ext), dev)
    return prev, curr, _rand(rng, (*lead, h, w), -4, 4, dev), _rand(rng, (*lead, h, w), -4, 4, dev)


@pytest.mark.parametrize("shape", _CROP_SHAPES)
@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("latch", [0, 1])
def test_tile_round_kernel_matches_plain(cuda, shape, window, relaxed, latch):
    """K6's round on a halo-extended tile of an odd shape, at a tile
    origin whose crop meets the level's border: u, v and the control bit
    for bit the plain version's; a running round's sums within gamma_depth
    (kernels.lk.tile_round_depth) of the float64 sum of the same |du| and
    within twice that of the plain version's du.abs().sum(); a set latch
    leaves u, v and the control as they were."""
    rng = np.random.default_rng(sum(shape) + window + 7 * relaxed)
    prev, curr, u, v = _tile_inputs(rng, shape, window, cuda)
    kw = dict(gy0=shape[0], gx0=0, gh=3 * shape[0], gw=2 * shape[1], window_size=window,
              relaxed_order=relaxed)
    ctrl = torch.tensor([latch, 0, 2], dtype=torch.int32, device=cuda)
    u0, v0, ctrl_ref, ur, vr = u.clone(), v.clone(), ctrl.clone(), u.clone(), v.clone()
    before = launch_counts()["lk_fused_tile_round"]
    sums = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    want = lk.fused_tile_round_ref(prev, curr, ur, vr, ctrl_ref, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["lk_fused_tile_round"] == before + 1
    assert torch.equal(u, ur) and torch.equal(v, vr) and torch.equal(ctrl, ctrl_ref)
    if latch:
        assert torch.equal(u, u0) and torch.equal(v, v0) and ctrl.tolist() == [1, 0, 2]
        return
    assert ctrl.tolist() == [0, 0, 3]
    depth = lk.tile_round_depth(*prev.shape, window)
    gamma = depth * 2.0 ** -24 / (1 - depth * 2.0 ** -24)
    du, dv = lk.tile_round_delta_ref(prev, curr, **kw)
    exact = torch.stack([du.double().abs().sum(), dv.double().abs().sum()])
    assert float(((sums.double() - exact).abs() / exact.clamp_min(1e-30)).max()) <= gamma
    assert float(((sums - want).abs() / want.clamp_min(1e-30)).max()) <= 2 * gamma


# K6's tile round at 4K: the extended tiles of the three levels at NCCL
# world 1, on 1x4x1 and on a 2x1x2 batch slice, each with its walk rows and
# blocks (tile_round_rows: 32 rows, halved while the tile gives fewer than
# 264 blocks, 26 output columns a strip at window 5, 4 strips a block) and
# the depth of its in-kernel sums by hand (tile_round_depth_of).
_TILES_4K = {
    (2166, 3846): (32, 2516, 66), (1086, 1926): (32, 646, 52), (546, 966): (16, 350, 33),
    (546, 3846): (32, 666, 52), (276, 1926): (16, 342, 33), (141, 966): (4, 360, 21),
    (2166, 1926): (32, 1292, 57), (1086, 966): (32, 340, 49), (546, 486): (8, 345, 25),
}


@pytest.mark.parametrize("shape", list(_TILES_4K))
def test_tile_round_walk_and_depth_at_the_4k_tiles(cuda, shape):
    rows, blocks, depth = _TILES_4K[shape]
    lib = _build.load()
    assert lib.tpuflow_lk_tile_round_rows(*shape, 5) == rows
    assert lk.tile_round_blocks(*shape, 5) == blocks
    assert lk.tile_round_depth(*shape, 5) == depth
    assert lk.tile_round_depth_of(rows, lib.tpuflow_lk_walk_threads(), blocks) == depth


@pytest.mark.parametrize("shape", list(_TILES_4K)[:6])
@pytest.mark.parametrize("latch", [0, 1])
def test_tile_round_kernel_at_the_4k_tiles(cuda, shape, latch):
    """The round at a 4K extended tile, its crop an inner rank's (world 1:
    the whole level; 1x4x1: the second of four row bands), bit for bit the
    plain version; a running round's sums within gamma_depth of the
    float64 sum and twice that of du.abs().sum(); a set latch a no-op."""
    rng = np.random.default_rng(shape[0] + shape[1])
    h, w = shape[0] - 6, shape[1] - 6
    world_one = shape in list(_TILES_4K)[:3]
    gh, gw, gy0 = (h, w, 0) if world_one else (4 * h, w, h)
    prev, curr, u, v = _tile_inputs(rng, (h, w), 5, cuda)
    kw = dict(gy0=gy0, gx0=0, gh=gh, gw=gw, window_size=5)
    ctrl = torch.tensor([latch, 0, 1], dtype=torch.int32, device=cuda)
    u0, v0, ctrl_ref, ur, vr = u.clone(), v.clone(), ctrl.clone(), u.clone(), v.clone()
    before = launch_counts()["lk_fused_tile_round"]
    sums = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    want = lk.fused_tile_round_ref(prev, curr, ur, vr, ctrl_ref, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["lk_fused_tile_round"] == before + 1
    assert torch.equal(u, ur) and torch.equal(v, vr) and torch.equal(ctrl, ctrl_ref)
    if latch:
        assert torch.equal(u, u0) and torch.equal(v, v0) and ctrl.tolist() == [1, 0, 1]
        return
    assert ctrl.tolist() == [0, 0, 2]
    depth = _TILES_4K[shape][2]
    gamma = depth * 2.0 ** -24 / (1 - depth * 2.0 ** -24)
    du, dv = lk.tile_round_delta_ref(prev, curr, **kw)
    exact = torch.stack([du.double().abs().sum(), dv.double().abs().sum()])
    assert float(exact.min()) > 0
    assert float(((sums.double() - exact).abs() / exact).max()) <= gamma
    assert float(((sums - want).abs() / want).max()) <= 2 * gamma


def _device_kernels(run) -> list:
    """The device's kernel events (copies and fills left out) of one
    ``run()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("Mem")]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("latch", [0, 1])
def test_tile_round_is_one_launch(cuda, batch, latch):
    """A call of the tile round, running or skipped, a plane or a batch, is
    one kernel on the device (its sums are finished in it) and no copy or
    fill: the call captured in a CUDA graph holds one node, a kernel, and
    the graph's replay gives the eager call's u, v, control and sums."""
    rng = np.random.default_rng(11)
    prev, curr, u, v = _tile_inputs(rng, (70, 233), 5, cuda, batch)
    ctrl = torch.zeros((3,) if batch is None else (3, batch), dtype=torch.int32, device=cuda)
    ctrl[0] = latch
    kw = dict(gy0=0, gx0=0, gh=70, gw=233)
    want = [t.clone() for t in (u, v, ctrl)]
    sums_eager = lk.fused_tile_round(prev, curr, *want, **kw).clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # built and warm outside the capture
        lk.fused_tile_round(prev, curr, u.clone(), v.clone(), ctrl.clone(), **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        sums = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    assert graphed.graph_nodes(graph) == {"kernel": 1}
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(u, want[0]) and torch.equal(v, want[1]) and torch.equal(ctrl, want[2])
    if not latch:
        assert torch.equal(sums, sums_eager)


def test_tile_round_resets_its_ticket(cuda):
    """The ticket (ctrl row 1) is 0 again after a running round and after
    a skipped one, so the next round, and a graph's replay, finds it so:
    the same frames give the same sums round after round, each element's
    those of its plane's call."""
    rng = np.random.default_rng(5)
    prev, curr, u, v = _tile_inputs(rng, (135, 240), 5, cuda, batch=2)
    kw = dict(gy0=0, gx0=0, gh=135, gw=240)
    ctrl = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    first = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw).clone()
    assert ctrl[1].tolist() == [0, 0]
    again = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    assert torch.equal(again, first) and ctrl.tolist() == [[0, 0], [0, 0], [2, 2]]
    ctrl[0, 1] = 1
    third = lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    assert ctrl.tolist() == [[0, 1], [0, 0], [3, 2]]
    assert torch.equal(third[:, 0], first[:, 0])
    ctrl[0] = 1
    lk.fused_tile_round(prev, curr, u, v, ctrl, **kw)
    assert ctrl.tolist() == [[1, 1], [0, 0], [3, 2]]
    for b in range(2):
        one = lk.fused_tile_round(prev[b], curr[b], u[b].clone(), v[b].clone(),
                                  torch.zeros(3, dtype=torch.int32, device=cuda), **kw)
        assert torch.equal(one, first[:, b])


def test_tile_round_batch_latches_per_element(cuda):
    rng = np.random.default_rng(3)
    prev, curr, u, v = _tile_inputs(rng, (37, 61), 5, cuda, batch=2)
    ctrl = torch.tensor([[0, 1], [0, 0], [0, 0]], dtype=torch.int32, device=cuda)
    ur, vr, ctrl_ref = u.clone(), v.clone(), ctrl.clone()
    u0, v0 = u.clone(), v.clone()
    lk.fused_tile_round(prev, curr, u, v, ctrl, gy0=0, gx0=0, gh=37, gw=61)
    lk.fused_tile_round_ref(prev, curr, ur, vr, ctrl_ref, gy0=0, gx0=0, gh=37, gw=61)
    torch.cuda.synchronize()
    assert torch.equal(u, ur) and torch.equal(v, vr) and torch.equal(ctrl, ctrl_ref)
    assert torch.equal(u[1], u0[1]) and not torch.equal(u[0], u0[0])
    one_u, one_v = u0[0].clone(), v0[0].clone()
    lk.fused_tile_round(prev[0], curr[0], one_u, one_v,
                        torch.zeros(3, dtype=torch.int32, device=cuda),
                        gy0=0, gx0=0, gh=37, gw=61)
    assert torch.equal(one_u, u[0]) and torch.equal(one_v, v[0])


@pytest.fixture(scope="module")
def nccl_world_one(tmp_path_factory):
    """An NCCL process group of this process alone and its 1x1x1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from tpuflow_torch.sharding import initialize_multihost, make_flow_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    initialize_multihost(f"file://{store}", 1, 0, backend="nccl")
    yield make_flow_mesh(1, 1, 1, device=torch.device("cuda", 0))
    dist.destroy_process_group()


def _tiled_pair(dev, shape=(240, 320)):
    rng = np.random.default_rng(12)
    a = np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0)).astype(np.float32)
    b = np.roll(a, 2, axis=1)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("config", ["production_fullband", "default"])
def test_tiled_graphed_stream_equals_the_eager_step(nccl_world_one, config):
    """The tiled step captured at NCCL world 1 (its all-reduces in the
    graph) and replayed over alternating pairs and a still pair, bit for
    bit the eager device-controlled step with the same rounds, and the
    eager step bit for bit its host-steered twin."""
    from tpuflow_torch.flow import TiledGraphedStream
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    mesh = nccl_world_one
    cfg = PYRAMID_CONFIGS[config]
    a, b = _tiled_pair(mesh.device)
    eager = {}
    for p, c in ((a, b), (b, a), (a, a)):
        u, v = tp.tiled_lucas_kanade_pyramidal(p[None], c[None], mesh, config=cfg,
                                               backend="cuda")
        eager[(id(p), id(c))] = (u, v, tp.counters.level_rounds.clone())
        hu, hv = tp._tiled_solve(p[None], c[None], mesh, cfg, "cuda", device_control=False)
        assert torch.equal(u, hu) and torch.equal(v, hv)
    assert eager[(id(a), id(a))][2].tolist() == [[1] * cfg.levels]
    stream = TiledGraphedStream(a[None], cfg, mesh)
    prev = a
    for frame in (b, a, b, a, a):
        gu, gv = stream.step(frame[None])
        u, v, rounds = eager[(id(prev), id(frame))]
        assert torch.equal(gu, u) and torch.equal(gv, v)
        assert torch.equal(stream.level_rounds, rounds)
        prev = frame
    assert stream.launches["lk_fused_tile_round"] == cfg.levels * cfg.iterations


def test_tiled_graphed_replay_has_no_round_reductions(nccl_world_one, monkeypatch):
    """A TiledGraphedStream replay launches one kernel a tile round: the
    same step captured with a torch.sum of the round's block partials
    after each round (what a round cost before its sums moved into the
    kernel) holds levels x iterations kernel nodes more, counted in each
    captured graph through the driver API, and replays with the same flow
    and the same tile rounds. The kernels of a torch.profiler trace of
    each replay are printed beside the node counts, not held: on the
    card's torch 2.11 the trace once read 400 / 404 for graphs whose nodes
    differ by 9, and later 391 / 400 for nodes 391 / 400, so a trace does
    not count a replay's kernels reliably. The stream keeps its captured
    graph, and ``graphed.graph_nodes`` reads it again here."""
    from tpuflow_torch.flow import TiledGraphedStream

    mesh = nccl_world_one
    cfg = PYRAMID_CONFIGS["default"]
    a, b = _tiled_pair(mesh.device)
    rounds = cfg.levels * cfg.iterations

    def replay(stream):
        out = []
        events = _device_kernels(lambda: out.append(stream.step(b[None])))
        n_rounds = sum(e.count for e in events
                       if re.search(r"lk_walk_kernel<\d+, (true|false), \d+, 3>", e.key))
        kernels = graphed.graph_nodes(stream._graph)["kernel"]
        assert kernels == stream.nodes["kernel"]
        return kernels, n_rounds, sum(e.count for e in events), out[0]

    n_new, rounds_new, traced_new, flow_new = replay(TiledGraphedStream(a[None], cfg, mesh))
    fused = lk.fused_tile_round

    def with_reduction(*args, **kw):
        sums = fused(*args, **kw)
        kw["parts"][:, 0].sum(dim=1)
        return sums

    monkeypatch.setattr(lk, "fused_tile_round", with_reduction)
    n_old, rounds_old, traced_old, flow_old = replay(TiledGraphedStream(a[None], cfg, mesh))
    print(f"kernel nodes {n_new} / {n_old} (with the sums); torch.profiler's kernels a replay "
          f"{traced_new} / {traced_old}")
    assert rounds_new == rounds_old == rounds
    assert n_old - n_new == rounds
    assert torch.equal(flow_new[0], flow_old[0]) and torch.equal(flow_new[1], flow_old[1])


def test_tiled_graphed_stream_refuses_cpu_frames_and_gloo(nccl_world_one):
    import torch.distributed as dist

    from tpuflow_torch.flow import TiledGraphedStream
    from tpuflow_torch.sharding.mesh import FlowMesh

    mesh = nccl_world_one
    cfg = PYRAMID_CONFIGS["default"]
    with pytest.raises(ValueError, match="CUDA"):
        TiledGraphedStream(torch.zeros(1, 240, 320), cfg, mesh)
    gloo = dist.new_group([0], backend="gloo")
    gloo_mesh = FlowMesh(1, 1, 1, (0,), 0, mesh.device, gloo, gloo)
    with pytest.raises(ValueError, match="gloo"):
        TiledGraphedStream(torch.zeros(1, 240, 320, device=mesh.device), cfg, gloo_mesh)
    fe = device_loop.FrontEnd(backend="cuda", config=cfg, mesh=gloo_mesh)
    assert not fe.graphed(torch.zeros(2, 240, 320, device=mesh.device))
    dist.destroy_process_group(gloo)


def test_tiled_vo_front_end_graphed_at_nccl_world_one(nccl_world_one):
    """A mesh-tiled VO front end over NCCL replays its captured step: the
    same records as its eager steps."""
    mesh = nccl_world_one
    frames = torch.from_numpy(np.stack(_vo_frames(6))).to(mesh.device)
    sessions = []
    for graphed in (True, False):
        sess = OdometrySession((200.0, 200.0, 160.0, 120.0), grid_step=16, backend="cuda",
                               pyramid_config="default", mesh=mesh, device=mesh.device)
        assert sess._fe.graphed(frames)
        if graphed:
            sess.process_frames(frames)
        else:
            for f in frames:
                sess.process_frame(f)
        sessions.append(sess)
    for field in ("obs_uv", "obs_valid", "obs_lm"):
        assert np.array_equal(np.stack(getattr(sessions[0], field)),
                              np.stack(getattr(sessions[1], field)))
