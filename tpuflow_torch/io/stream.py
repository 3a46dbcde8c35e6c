"""Frame streaming: a read-ahead thread on the host, then uploads to the
card that run ahead of the compute.

The port of ``tpuflow.io.stream``:

- ``FrameStream`` reads ``.bin`` frames in order, ``depth`` frames ahead,
  on the native read-ahead thread (``io.fastio.Prefetcher``, built from
  ``native/fastio.cpp``, the counterpart of the reference's
  ``_fastio.FramePrefetcher``): file IO and the widening to float32 run
  without the interpreter lock, each frame into a buffer the consumer
  gave. Iterating it yields a fresh array a frame. An error in the reader
  reaches the consumer after the frames read before it (the reference's
  prefetcher raises as soon as it fails, ahead of frames it had read); it
  never ends the stream quietly. ``read_frames_ref`` is its plain
  version: a Python thread over ``load_frame_bin_ref``.
- ``prefetch_to_device`` uploads each frame once, ``lookahead`` frames
  ahead of the consumer: a pinned host buffer, a ``non_blocking`` copy on
  a side CUDA stream, and an event that the consumer's stream waits on
  before the frame is handed over (``record_stream`` tells the caching
  allocator that the consumer's stream uses it). Given a ``FrameStream``,
  the native thread reads each frame straight into a pinned buffer, one
  host copy fewer; any other iterable's frames are copied into pinned
  buffers. A pinned buffer is written again only after its last copy's
  event has completed, so a reused buffer can never give a wrong frame.
  On the CPU, when asked for, the frames pass through as tensors (no
  copy).
- ``device_pairs``: consecutive (prev, curr) pairs of uploaded frames.

An upload's host work is timed by three spans (``telemetry``), one use a
frame each and back to back in ``prefetch_to_device``'s uploads (one
chain): ``tpuflow_torch.io.buffer_wait`` (the wait for a pinned buffer's
last copy), ``tpuflow_torch.io.pinned_copy`` (the copy into it, and its
allocation where one is made) and ``tpuflow_torch.io.enqueue`` (the
copy's launch on the side stream and the frame's hand-over).

The device is the card unless the caller names another
(``eval.timing.resolve_device``).
"""

from __future__ import annotations

import collections
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from tpuflow_torch import telemetry
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.io import fastio
from tpuflow_torch.io.frames import load_frame_bin_ref

_END = object()
_UPLOAD = telemetry.chain("tpuflow_torch.io.buffer_wait", "tpuflow_torch.io.pinned_copy",
                          "tpuflow_torch.io.enqueue")
_BUFFER_WAIT, _PINNED_COPY, _ENQUEUE = _UPLOAD.spans


def _readahead(frames: Iterable, depth: int = 3) -> Iterator:
    """Iterate ``frames`` with a background thread running up to ``depth``
    items ahead. The reader's exception is raised here, after the items
    read before it; closing the iterator stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def reader() -> None:
        try:
            for frame in frames:
                if not put((frame, None)):
                    return
        except BaseException as exc:  # handed to the consumer, raised there
            put((None, exc))
            return
        put((_END, None))

    thread = threading.Thread(target=reader, name="frame-readahead", daemon=True)
    thread.start()
    try:
        while True:
            frame, exc = q.get()
            if exc is not None:
                raise exc
            if frame is _END:
                return
            yield frame
    finally:
        stop.set()
        thread.join()


def read_frames_ref(
    paths: Sequence[str | Path], width: int = 320, height: int = 240, depth: int = 3
) -> Iterator[np.ndarray]:
    """The plain version of iterating a ``FrameStream``: a Python thread
    reading ``load_frame_bin_ref`` frames ``depth`` ahead."""
    return _readahead((load_frame_bin_ref(p, width, height) for p in paths), depth)


class FrameStream:
    """Iterate (H, W) float32 frames from .bin files, read ``depth`` ahead
    on the native read-ahead thread."""

    def __init__(
        self,
        paths: Sequence[str | Path],
        width: int = 320,
        height: int = 240,
        depth: int = 3,
    ):
        self.paths = [str(p) for p in paths]
        self.width = width
        self.height = height
        self.depth = depth

    def read_into(self, new_buffer) -> Iterator:
        """The frames in order, each read by the native thread into a
        buffer from ``new_buffer()`` (a float32 array or CPU tensor of
        height x width values), ``depth`` ahead. The yielded buffer is the
        caller's; the thread stops when the iterator is closed."""
        reader = fastio.Prefetcher(self.paths, self.height * self.width)
        try:
            for _ in range(max(self.depth, 1)):
                reader.give(new_buffer())
            while (frame := reader.next()) is not None:
                reader.give(new_buffer())
                yield frame
        finally:
            reader.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        shape = (self.height, self.width)
        return self.read_into(lambda: np.empty(shape, np.float32))

    def pairs(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Consecutive (prev, curr) frame pairs."""
        prev = None
        for frame in self:
            if prev is not None:
                yield prev, frame
            prev = frame

    def device_pairs(self, lookahead: int = 2, device: torch.device | str | None = None):
        """Consecutive (prev, curr) pairs as device tensors (see
        :func:`device_pairs`)."""
        return device_pairs(self, lookahead=lookahead, device=device)


def _as_tensor(frame) -> torch.Tensor:
    return frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.asarray(frame))


def _pinned(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _hand_over(frame: torch.Tensor, uploaded: torch.cuda.Event) -> torch.Tensor:
    """Order the consumer's stream after the frame's copy, and keep its
    memory from reuse until that stream is done with it."""
    consumer = torch.cuda.current_stream(frame.device)
    consumer.wait_event(uploaded)
    frame.record_stream(consumer)
    return frame


def _copy_out(pinned: torch.Tensor, dev: torch.device, copies: torch.cuda.Stream
              ) -> tuple[torch.Tensor, torch.cuda.Event]:
    """A ``non_blocking`` copy of a pinned buffer to ``dev`` on the side
    stream ``copies``, and the event recorded after it."""
    with torch.cuda.stream(copies):
        out = torch.empty(pinned.shape, dtype=pinned.dtype, device=dev)
        out.copy_(pinned, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copies)
    return out, done


def _enqueue(pinned: torch.Tensor, dev: torch.device, copies: torch.cuda.Stream,
             in_flight: collections.deque, lookahead: int
             ) -> tuple[torch.Tensor | None, torch.cuda.Event]:
    """Launch ``pinned``'s copy on ``copies``. Returns the oldest upload,
    handed over, once more than ``lookahead`` are in flight (else None),
    and the copy's event."""
    out, done = _copy_out(pinned, dev, copies)
    in_flight.append((out, done))
    ready = _hand_over(*in_flight.popleft()) if len(in_flight) > lookahead else None
    return ready, done


def _drain(in_flight: collections.deque) -> Iterator[torch.Tensor]:
    while in_flight:
        with _ENQUEUE:
            ready = _hand_over(*in_flight.popleft())
        yield ready


def _upload_ahead(frames: Iterable, lookahead: int, dev: torch.device) -> Iterator[torch.Tensor]:
    copies = torch.cuda.Stream(device=dev)
    # lookahead + 1 pinned buffers, used in turn: (buffer, its last copy's event).
    slots: list[tuple[torch.Tensor, torch.cuda.Event] | None] = [None] * (lookahead + 1)
    in_flight: collections.deque = collections.deque()
    for i, frame in enumerate(frames):
        host = _as_tensor(frame)
        k = i % len(slots)
        slot = slots[k]
        with _UPLOAD as spans:
            if slot is not None:
                slot[1].synchronize()  # the buffer's last copy has completed
            spans.next()  # the buffer wait ends, the pinned copy starts
            if slot is None or slot[0].shape != host.shape or slot[0].dtype != host.dtype:
                pinned = _pinned(host.shape, host.dtype)
            else:
                pinned = slot[0]
            pinned.copy_(host)
            spans.next()  # the enqueue starts
            ready, done = _enqueue(pinned, dev, copies, in_flight, lookahead)
        slots[k] = (pinned, done)
        if ready is not None:
            yield ready
    yield from _drain(in_flight)


def _upload_stream(stream: FrameStream, lookahead: int, dev: torch.device
                   ) -> Iterator[torch.Tensor]:
    """``_upload_ahead`` for a ``FrameStream``: the native thread reads each
    frame straight into a pinned buffer, and a buffer goes back to it only
    after its copy's event has completed."""
    copies = torch.cuda.Stream(device=dev)
    shape = (stream.height, stream.width)
    # The reader's depth, the copies in flight and the frame being copied.
    pool = max(stream.depth, 1) + lookahead + 1
    made = 0
    copied: collections.deque = collections.deque()  # (pinned, its copy's event), oldest first

    def buffer() -> torch.Tensor:
        nonlocal made
        if made < pool:
            made += 1
            with _PINNED_COPY:
                return _pinned(shape, torch.float32)
        pinned, done = copied.popleft()
        with _BUFFER_WAIT:
            done.synchronize()
        return pinned

    in_flight: collections.deque = collections.deque()
    for pinned in stream.read_into(buffer):
        with _ENQUEUE:
            ready, done = _enqueue(pinned, dev, copies, in_flight, lookahead)
        copied.append((pinned, done))
        if ready is not None:
            yield ready
    yield from _drain(in_flight)


def prefetch_to_device(
    frames: Iterable, lookahead: int = 2, device: torch.device | str | None = None
) -> Iterator[torch.Tensor]:
    """Stream frames to ``device`` ``lookahead`` ahead of consumption, each
    uploaded once: on the card the copies overlap the compute consuming
    the earlier frames (a ``FrameStream``'s frames are read straight into
    the pinned buffers); on the CPU (asked for) the frames pass through as
    tensors. Raises where the card is asked for, or defaulted to, and
    there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for frame in frames:
            yield _as_tensor(frame).to(dev)
        return
    if isinstance(frames, FrameStream):
        yield from _upload_stream(frames, max(int(lookahead), 0), dev)
        return
    yield from _upload_ahead(frames, max(int(lookahead), 0), dev)


def device_pairs(
    frames: Iterable, lookahead: int = 2, device: torch.device | str | None = None
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Consecutive (prev, curr) device-tensor pairs from a host frame
    iterable, with ``lookahead`` uploads in flight; each frame is uploaded
    once and shared by its two pairs."""
    prev = None
    for frame in prefetch_to_device(frames, lookahead=lookahead, device=device):
        if prev is not None:
            yield prev, frame
        prev = frame
