"""Frame streaming: a read-ahead thread on the host, then uploads to the
card that run ahead of the compute.

The port of ``tpuflow.io.stream``:

- ``FrameStream`` reads ``.bin`` frames in order, ``depth`` frames ahead,
  on a background thread (the reference's native prefetcher is the JAX
  package's own extension; this is its Python counterpart). The frames and
  their order are those of a plain read. An error in the reader reaches
  the consumer after the frames read before it; it never ends the stream
  quietly.
- ``prefetch_to_device`` uploads each frame once, ``lookahead`` frames
  ahead of the consumer: a pinned host buffer, a ``non_blocking`` copy on
  a side CUDA stream, and an event that the consumer's stream waits on
  before the frame is handed over (``record_stream`` tells the caching
  allocator that the consumer's stream uses it). A pinned buffer is
  written again only after its last copy's event has completed, so a
  reused buffer can never give a wrong frame. On the CPU, when asked for,
  the frames pass through as tensors (no copy).
- ``device_pairs``: consecutive (prev, curr) pairs of uploaded frames.

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

from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.io.frames import load_frame_bin

_END = object()


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


class FrameStream:
    """Iterate (H, W) float32 frames from .bin files, read ``depth`` ahead
    on a background thread."""

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

    def _read(self) -> Iterator[np.ndarray]:
        for p in self.paths:
            yield load_frame_bin(p, self.width, self.height)

    def __iter__(self) -> Iterator[np.ndarray]:
        return _readahead(self._read(), self.depth)

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


def _hand_over(frame: torch.Tensor, uploaded: torch.cuda.Event) -> torch.Tensor:
    """Order the consumer's stream after the frame's copy, and keep its
    memory from reuse until that stream is done with it."""
    consumer = torch.cuda.current_stream(frame.device)
    consumer.wait_event(uploaded)
    frame.record_stream(consumer)
    return frame


def _upload_ahead(frames: Iterable, lookahead: int, dev: torch.device) -> Iterator[torch.Tensor]:
    copies = torch.cuda.Stream(device=dev)
    # lookahead + 1 pinned buffers, used in turn: (buffer, its last copy's event).
    slots: list[tuple[torch.Tensor, torch.cuda.Event] | None] = [None] * (lookahead + 1)
    in_flight: collections.deque = collections.deque()
    for i, frame in enumerate(frames):
        host = _as_tensor(frame)
        k = i % len(slots)
        slot = slots[k]
        if slot is not None:
            slot[1].synchronize()  # the buffer's last copy has completed
        if slot is None or slot[0].shape != host.shape or slot[0].dtype != host.dtype:
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        else:
            pinned = slot[0]
        pinned.copy_(host)
        with torch.cuda.stream(copies):
            out = torch.empty(host.shape, dtype=host.dtype, device=dev)
            out.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copies)
        slots[k] = (pinned, done)
        in_flight.append((out, done))
        while len(in_flight) > lookahead:
            yield _hand_over(*in_flight.popleft())
    while in_flight:
        yield _hand_over(*in_flight.popleft())


def prefetch_to_device(
    frames: Iterable, lookahead: int = 2, device: torch.device | str | None = None
) -> Iterator[torch.Tensor]:
    """Stream frames to ``device`` ``lookahead`` ahead of consumption, each
    uploaded once: on the card the copies overlap the compute consuming
    the earlier frames; on the CPU (asked for) the frames pass through as
    tensors. Raises where the card is asked for, or defaulted to, and
    there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for frame in frames:
            yield _as_tensor(frame).to(dev)
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
