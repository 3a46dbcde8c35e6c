"""The port's frame stream (``tpuflow_torch.io.stream``) on the CPU: the
read-ahead thread, the native one of ``FrameStream`` (``io.fastio``) and
its plain version ``read_frames_ref``, gives the frames of a plain read in
their order (and those of ``tpuflow.io.stream.FrameStream``), hands its
errors to the consumer after the frames read before them, and stops when
the consumer does; ``device_pairs`` asked for the
CPU is a pure transport, each frame passed once; ``flow.__main__.
stream_flow`` gives the flow of a plain per-pair loop, bit for bit. The
uploads to the card (pinned buffers, side stream, events) run in
``chip_smoke.py``'s ``[cli]`` phase.
"""

import threading

import numpy as np
import pytest
import torch

from tpuflow.io.stream import FrameStream as JaxFrameStream
from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal_step, lucas_kanade_single_scale
from tpuflow_torch.flow.__main__ import stream_flow
from tpuflow_torch.io import fastio
from tpuflow_torch.io import frames as fio
from tpuflow_torch.io import stream
from tpuflow_torch.kernels import launch_counts, torch_ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(tmp_path, n=5, shape=(24, 32), seed=5, integer=False):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        f = rng.uniform(0, 255, shape).astype(np.float32)
        p = tmp_path / f"frame_{i:02d}.bin"
        fio.save_frame_bin(p, np.round(f) if integer else f)
        paths.append(p)
    return paths


# The native reader (FrameStream) and its plain version, by name.
READERS = {
    "native": lambda paths, depth: iter(stream.FrameStream(paths, width=32, height=24,
                                                           depth=depth)),
    "plain": lambda paths, depth: stream.read_frames_ref(paths, width=32, height=24,
                                                         depth=depth),
}


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("depth", [0, 1, 3, 8])
def test_frame_stream_reads_ahead_in_order(tmp_path, depth, reader):
    paths = _frames(tmp_path, n=7)
    got = list(READERS[reader](paths, depth))
    plain = [fio.load_frame_bin_ref(p, 32, 24) for p in paths]
    ref = list(JaxFrameStream(paths, width=32, height=24))
    assert len(got) == len(plain) == len(ref) == 7
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_error_reaches_the_consumer(tmp_path, reader):
    paths = _frames(tmp_path, n=4)
    paths.insert(2, tmp_path / "missing.bin")
    it = READERS[reader](paths, 3)
    got = [next(it), next(it)]  # the frames read before the error come first
    np.testing.assert_array_equal(got[1], fio.load_frame_bin_ref(paths[1], 32, 24))
    with pytest.raises(FileNotFoundError):
        next(it)


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_stops_with_the_consumer(tmp_path, reader):
    def readers():
        if reader == "native":
            return fastio.live_workers()
        return sum(t.name == "frame-readahead" for t in threading.enumerate())

    paths = _frames(tmp_path, n=6)
    before = readers()
    it = READERS[reader](paths, 1)
    next(it)
    assert readers() == before + 1
    it.close()
    assert readers() == before


def test_device_pairs_matches_host_pairs(tmp_path):
    # tests/test_io.py's case, on the port: the transport changes nothing,
    # and consecutive pairs share the middle frame's single pass.
    paths = _frames(tmp_path)
    fs = stream.FrameStream(paths, width=32, height=24)
    host = list(stream.FrameStream(paths, width=32, height=24).pairs())
    dev = list(stream.device_pairs(fs, lookahead=2, device="cpu"))
    assert len(dev) == len(host) == 4
    for (hp, hc), (dp, dc) in zip(host, dev):
        assert isinstance(dp, torch.Tensor) and dp.device.type == "cpu"
        np.testing.assert_array_equal(dp.numpy(), hp)
        np.testing.assert_array_equal(dc.numpy(), hc)
    for (_, c0), (p1, _) in zip(dev, dev[1:]):
        assert c0 is p1
    assert len(list(fs.device_pairs(lookahead=0, device="cpu"))) == 4


def test_prefetch_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(stream.prefetch_to_device([np.zeros((2, 2), np.float32)]))


@pytest.mark.parametrize("config", ["production", "default", None])
def test_stream_flow_matches_a_plain_loop(tmp_path, config):
    paths = _frames(tmp_path, n=4, shape=(48, 64), integer=True)
    frames = [torch.from_numpy(fio.load_frame_bin(p, 64, 48)) for p in paths]
    cfg = PYRAMID_CONFIGS[config] if config else None
    before = launch_counts()
    got = list(stream_flow(stream.FrameStream(paths, 64, 48), cfg, "cuda", "cpu"))
    assert launch_counts() == before  # CPU tensors: the plain versions ran
    want = []
    if cfg is None:
        want = [lucas_kanade_single_scale(a, b, 5, backend="cuda")
                for a, b in zip(frames, frames[1:])]
    else:
        carry = torch_ref.build_gaussian_pyramid(frames[0], cfg.levels, cfg.scale_factor)
        for f in frames[1:]:
            u, v, carry = lucas_kanade_pyramidal_step(carry, f, cfg, backend="cuda")
            want.append((u, v))
    assert len(got) == len(want) == 3
    for (gu, gv), (wu, wv) in zip(got, want):
        assert torch.equal(gu, wu) and torch.equal(gv, wv)
