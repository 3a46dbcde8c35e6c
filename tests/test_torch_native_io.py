"""The port's native frame IO (``tpuflow_torch.io.fastio``, built from
``tpuflow_torch/native/fastio.cpp`` with the host's C++ compiler) on the
CPU, byte for byte against the JAX package's extension
(``tpuflow._fastio``) and against the port's plain numpy versions
(``io.frames.*_ref``, ``io.stream.read_frames_ref``): the ``.mem`` codec
(round trip, comment lines, a malformed file, the encoded bytes), the
``.bin`` loader's values, and the read-ahead thread (order at depths 1-3,
an error after the frames read before it, close, a wrong byte count, the
interpreter lock released while it waits).

One behaviour differs from the reference on purpose: the reference's
``FramePrefetcher.next_frame`` raises as soon as its worker has failed,
even while frames read before the failure are still queued
(native/fastio.cpp:288-297); the port hands those frames over first
(ROADMAP.md section 3, divergence h).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow import _fastio as ref_fastio
from tpuflow_torch.io import fastio
from tpuflow_torch.io import frames as fio
from tpuflow_torch.io import stream

torch.set_num_threads(1)

SHAPE = (24, 32)
REPO = Path(__file__).resolve().parents[1]


def _u8(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _bins(tmp_path, n=6, seed=3):
    paths = []
    for i in range(n):
        p = tmp_path / f"frame_{i:02d}.bin"
        _u8(seed + i).tofile(p)
        paths.append(p)
    return paths


def test_the_library_is_built_and_loaded():
    assert fio.have_native_io()
    path = fastio.library_path()
    assert path.exists() and path.parent == fastio.BUILD_DIR
    assert len(path.stem.rsplit("_", 1)[1]) == 16  # the source's and flags' hash


@pytest.mark.parametrize("shape", [(1, 1), (24, 32), (37, 53)])
def test_mem_round_trip(tmp_path, shape):
    frame = _u8(1, shape)
    fio.save_frame_mem(tmp_path / "f.mem", frame)
    got = fio.load_frame_mem(tmp_path / "f.mem", shape[1], shape[0])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, frame.astype(np.float32))
    np.testing.assert_array_equal(got, fio.load_frame_mem_ref(tmp_path / "f.mem", *shape[::-1]))


def test_encoded_file_is_the_reference_s(tmp_path):
    frame = _u8(2)
    fio.save_frame_mem(tmp_path / "port.mem", frame)
    ref_fastio.encode_mem(str(tmp_path / "ref.mem"), frame.tobytes())
    fio.save_frame_mem_ref(tmp_path / "plain.mem", frame)
    port = (tmp_path / "port.mem").read_bytes()
    assert port == (tmp_path / "ref.mem").read_bytes() == (tmp_path / "plain.mem").read_bytes()
    assert port[:6] == f"{frame[0, 0]:02x}\n{frame[0, 1]:02x}\n".encode()


def test_mem_comment_lines_are_skipped(tmp_path):
    frame = _u8(4, (3, 4))
    lines = ["// a $readmemh header", *(f"{v:02X}" for v in frame.ravel()[:6]), "// middle",
             *(f"{v:02x}" for v in frame.ravel()[6:]), ""]
    path = tmp_path / "c.mem"
    path.write_text("\n".join(lines))
    got = fastio.decode_mem(path)
    assert got.tobytes() == ref_fastio.decode_mem(str(path)) == frame.tobytes()
    np.testing.assert_array_equal(fio.load_frame_mem(path, 4, 3), fio.load_frame_mem_ref(path, 4, 3))


def test_malformed_mem_raises(tmp_path):
    path = tmp_path / "x.mem"
    path.write_text("00\nxx\n01\n")
    with pytest.raises(ValueError, match="malformed"):
        fio.load_frame_mem(path, 3, 1)
    with pytest.raises(ValueError):
        ref_fastio.decode_mem(str(path))
    with pytest.raises(FileNotFoundError):
        fio.load_frame_mem(tmp_path / "missing.mem", 3, 1)


def test_bin_values(tmp_path):
    path = _bins(tmp_path, n=1)[0]
    got = fio.load_frame_bin(path, SHAPE[1], SHAPE[0])
    want = np.frombuffer(ref_fastio.load_bin_f32(str(path)), np.float32).reshape(SHAPE)
    assert got.dtype == np.float32 and got.shape == SHAPE
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == fio.load_frame_bin_ref(path, SHAPE[1], SHAPE[0]).tobytes()


def test_wrong_byte_count_raises(tmp_path):
    path = tmp_path / "short.bin"
    path.write_bytes(bytes(SHAPE[0] * SHAPE[1] - 1))
    with pytest.raises(ValueError, match="767 bytes"):
        fio.load_frame_bin(path, SHAPE[1], SHAPE[0])
    with pytest.raises(ValueError):
        fio.load_frame_bin_ref(path, SHAPE[1], SHAPE[0])
    paths = _bins(tmp_path, n=2) + [path]
    it = iter(stream.FrameStream(paths, SHAPE[1], SHAPE[0]))
    assert next(it).shape == SHAPE and next(it).shape == SHAPE
    with pytest.raises(ValueError, match="height\\*width"):
        next(it)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_gives_frames_in_order(tmp_path, depth):
    paths = _bins(tmp_path, n=7)
    reader = fastio.Prefetcher(paths, SHAPE[0] * SHAPE[1])
    try:
        for _ in range(depth):
            reader.give(np.empty(SHAPE, np.float32))
        got = []
        while (frame := reader.next()) is not None:
            got.append(frame.copy())
            reader.give(frame)  # the consumer's buffer goes back once read
    finally:
        reader.close()
    ref = ref_fastio.FramePrefetcher([str(p) for p in paths], depth=depth)
    want = [np.frombuffer(b, np.float32).reshape(SHAPE)
            for b in iter(ref.next_frame, None)]
    ref.close()
    assert len(got) == len(want) == 7
    for g, w, p in zip(got, want, paths):
        assert g.tobytes() == w.tobytes() == fio.load_frame_bin_ref(p, SHAPE[1], SHAPE[0]).tobytes()


def test_prefetcher_error_comes_after_the_frames_read_before_it(tmp_path):
    paths = _bins(tmp_path, n=4)
    paths.insert(2, tmp_path / "missing.bin")
    reader = fastio.Prefetcher(paths, SHAPE[0] * SHAPE[1])
    try:
        for _ in range(4):  # room for every frame: the worker reaches the failure first
            reader.give(np.empty(SHAPE, np.float32))
        first, second = reader.next().copy(), reader.next().copy()
        with pytest.raises(FileNotFoundError, match="missing.bin"):
            reader.next()
        assert reader.next() is None  # the stream ends after a failure
    finally:
        reader.close()
    assert first.tobytes() == fio.load_frame_bin_ref(paths[0], SHAPE[1], SHAPE[0]).tobytes()
    assert second.tobytes() == fio.load_frame_bin_ref(paths[1], SHAPE[1], SHAPE[0]).tobytes()


def test_prefetcher_close_stops_the_thread(tmp_path):
    paths = _bins(tmp_path, n=5)
    before = fastio.live_workers()
    reader = fastio.Prefetcher(paths, SHAPE[0] * SHAPE[1])
    reader.give(np.empty(SHAPE, np.float32))
    assert reader.next() is not None
    assert fastio.live_workers() == before + 1  # it waits for a buffer now
    reader.close()
    assert fastio.live_workers() == before
    with pytest.raises(ValueError, match="closed"):
        reader.next()


def test_prefetcher_without_a_buffer_raises(tmp_path):
    reader = fastio.Prefetcher(_bins(tmp_path, n=2), SHAPE[0] * SHAPE[1])
    try:
        with pytest.raises(RuntimeError, match="no buffer"):
            reader.next()
        with pytest.raises(ValueError, match="768"):
            reader.give(np.empty((2, 2), np.float32))
    finally:
        reader.close()


def test_frame_stream_equals_the_plain_reader(tmp_path):
    paths = _bins(tmp_path, n=6)
    plain = list(stream.read_frames_ref(paths, SHAPE[1], SHAPE[0]))
    native = list(stream.FrameStream(paths, SHAPE[1], SHAPE[0], depth=2))
    # The stream's buffers may be torch tensors, as the pinned ones of the uploads.
    into = list(stream.FrameStream(paths, SHAPE[1], SHAPE[0], depth=2).read_into(
        lambda: torch.empty(SHAPE, dtype=torch.float32)))
    assert len(plain) == len(native) == len(into) == 6
    for p, n, t in zip(plain, native, into):
        assert isinstance(t, torch.Tensor)
        assert p.tobytes() == n.tobytes() == t.numpy().tobytes()


def test_next_releases_the_interpreter_lock(tmp_path):
    # The worker blocks opening a FIFO until a Python thread of the same
    # process writes it; that thread runs only if next() waits without the
    # interpreter lock. A separate process bounds the wait.
    script = textwrap.dedent(f"""
        import os, threading, time
        import numpy as np
        from tpuflow_torch.io import fastio
        fifo = {str(tmp_path / "pipe.bin")!r}
        os.mkfifo(fifo)
        frame = np.arange(6, dtype=np.uint8)
        def writer():
            time.sleep(0.2)
            with open(fifo, "wb") as f:
                f.write(frame.tobytes())
        reader = fastio.Prefetcher([fifo], 6)
        reader.give(np.empty(6, np.float32))
        thread = threading.Thread(target=writer)
        thread.start()
        got = reader.next()
        thread.join()
        reader.close()
        assert got.tolist() == frame.astype(np.float32).tolist(), got
        print("ok")
    """)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=60, cwd=REPO, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "fastio.cpp"
    broken.write_text("int this_does_not_compile( {\n")
    monkeypatch.setattr(fastio, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed") as info:
        fastio.build(tmp_path / "lib.so")
    assert "this_does_not_compile" in str(info.value)
    assert not (tmp_path / "lib.so").exists()
    assert not list(tmp_path.glob("*.tmp"))
