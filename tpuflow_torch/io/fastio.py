"""The port's native frame IO: ``native/fastio.cpp`` built at first use and
loaded with ``ctypes``.

The counterpart of ``tpuflow._fastio``, the JAX package's extension: the
``$readmemh`` codec, the ``.bin`` loader that widens u8 to float32, and a
read-ahead thread (``Prefetcher``) that reads frames in order into buffers
the caller gives it. The library has a plain C interface, so it is built
with the host compiler alone (``c++ -O2 -std=c++17 -fPIC -pthread
-shared``, a few seconds) and needs neither Python's nor PyTorch's
headers; ``ctypes`` releases the interpreter lock around each call, so the
file IO, the widening and the wait for the next frame run without it.

The build happens at the first call, never at import, into
``build/tpuflow_torch/`` beside the package. The library's file name
carries a hash of the source and the flags, and it is written under a
temporary name and renamed into place, so processes that build at once
(test workers) never load a partial file. A failed build raises with the
compiler's output; nothing falls back to the Python versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import weakref
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuflow_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

# The library's negative return codes (fastio.cpp); positive codes are errno.
MALFORMED = -1
WRONG_SIZE = -2
END = -3
NO_BUFFER = -4

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "tpuflow_io_decode_mem": ([ctypes.c_char_p, ctypes.POINTER(_P), ctypes.POINTER(_I64)],
                              ctypes.c_int),
    "tpuflow_io_free": ([_P], None),
    "tpuflow_io_encode_mem": ([ctypes.c_char_p, _P, _I64], ctypes.c_int),
    "tpuflow_io_load_bin_f32": ([ctypes.c_char_p, _P, _I64, ctypes.POINTER(_I64)],
                                ctypes.c_int),
    "tpuflow_io_prefetcher_open": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _I64], _P),
    "tpuflow_io_prefetcher_give": ([_P, _P], None),
    "tpuflow_io_prefetcher_next": ([_P, ctypes.POINTER(_P), ctypes.POINTER(_I64)],
                                   ctypes.c_int),
    "tpuflow_io_prefetcher_close": ([_P], None),
    "tpuflow_io_live_workers": ([], ctypes.c_int),
}

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpuflow_torch_fastio_{digest.hexdigest()[:16]}.so"


def build(path: Path) -> None:
    """Compile ``fastio.cpp`` into ``path``, through a temporary file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.name}.{os.getpid()}.tmp"
    cmd = ["c++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"the native frame IO needs a C++ compiler: {' '.join(cmd)}: {exc}") \
            from exc
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed ({done.returncode}):\n{' '.join(cmd)}\n{done.stdout}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The native IO library, built first if this checkout has none yet."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def _raise(code: int, path, size: int = 0, pixels: int = 0):
    path = os.fspath(path)
    if code == MALFORMED:
        raise ValueError(f"malformed .mem file: {path}")
    if code == WRONG_SIZE:
        raise ValueError(f"{path} holds {size} bytes, not the frame's {pixels} (height*width)")
    if code > 0:
        raise OSError(code, os.strerror(code), path)
    raise RuntimeError(f"native frame IO failed with code {code} on {path}")


def decode_mem(path) -> np.ndarray:
    """The bytes of a ``$readmemh`` file, as uint8."""
    lib = load()
    out, count = _P(), _I64()
    code = lib.tpuflow_io_decode_mem(os.fsencode(path), ctypes.byref(out), ctypes.byref(count))
    if code != 0:
        _raise(code, path)
    try:
        return np.frombuffer(ctypes.string_at(out, count.value), dtype=np.uint8)
    finally:
        lib.tpuflow_io_free(out)


def encode_mem(path, data: np.ndarray) -> None:
    """Write uint8 ``data`` as ``$readmemh`` text, one byte a line."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    code = load().tpuflow_io_encode_mem(os.fsencode(path), data.ctypes.data, data.size)
    if code != 0:
        _raise(code, path)


def load_bin_f32(path, out: np.ndarray) -> np.ndarray:
    """Read a raw u8 frame into the float32 C-contiguous ``out`` (its size
    is the frame's); a file of another byte count raises."""
    _check_buffer(out)
    size = _I64()
    code = load().tpuflow_io_load_bin_f32(os.fsencode(path), out.ctypes.data, out.size,
                                          ctypes.byref(size))
    if code != 0:
        _raise(code, path, size.value, out.size)
    return out


def _check_buffer(buf: np.ndarray) -> None:
    if buf.dtype != np.float32 or not buf.flags.c_contiguous or not buf.flags.writeable:
        raise ValueError("a frame buffer must be a writeable C-contiguous float32 array")


def live_workers() -> int:
    """Read-ahead threads running now in this process."""
    return load().tpuflow_io_live_workers()


def _close(lib: ctypes.CDLL, handle: int, held: dict) -> None:
    lib.tpuflow_io_prefetcher_close(handle)
    held.clear()


class Prefetcher:
    """A read-ahead thread over ``paths`` of ``pixels``-byte u8 frames.

    ``give(buffer)`` hands the thread a float32 buffer of ``pixels`` values
    (a numpy array, or a CPU torch tensor such as a pinned one) to read a
    frame into; ``next()`` blocks for the next frame in order and returns
    the buffer that holds it, or None after the last. A file that cannot be
    read, or holds another byte count, raises from ``next()`` in its
    frame's place, after the frames read before it. The thread writes only
    into buffers given and not yet returned; they are kept alive here until
    then, and ``close()`` (also on collection and at exit) stops the
    thread and waits for it."""

    def __init__(self, paths, pixels: int) -> None:
        self._lib = load()
        self.paths = [os.fspath(p) for p in paths]
        self.pixels = int(pixels)
        encoded = (ctypes.c_char_p * len(self.paths))(*(os.fsencode(p) for p in self.paths))
        self._held: dict[int, object] = {}  # address -> buffer the thread may write
        self._index = 0  # the frame next() hands over next
        self._handle = self._lib.tpuflow_io_prefetcher_open(encoded, len(self.paths), self.pixels)
        self._finalizer = weakref.finalize(self, _close, self._lib, self._handle, self._held)

    def give(self, buffer) -> None:
        if not self._finalizer.alive:
            raise ValueError("the prefetcher is closed")
        address = _address(buffer, self.pixels)
        if address in self._held:
            raise ValueError("this buffer was given already and not handed back")
        self._held[address] = buffer
        self._lib.tpuflow_io_prefetcher_give(self._handle, address)

    def next(self):
        if not self._finalizer.alive:
            raise ValueError("the prefetcher is closed")
        address, size = _P(), _I64()
        code = self._lib.tpuflow_io_prefetcher_next(self._handle, ctypes.byref(address),
                                                    ctypes.byref(size))
        if code == END:
            return None
        if code == NO_BUFFER:
            raise RuntimeError("no buffer given to read the next frame into")
        index = self._index
        self._index += 1
        if code != 0:
            _raise(code, self.paths[index], size.value, self.pixels)
        return self._held.pop(address.value)

    def close(self) -> None:
        self._finalizer()


def _address(buffer, pixels: int) -> int:
    if isinstance(buffer, np.ndarray):
        _check_buffer(buffer)
        n, address = buffer.size, buffer.ctypes.data
    else:  # a torch tensor
        import torch

        if (buffer.dtype != torch.float32 or buffer.device.type != "cpu"
                or not buffer.is_contiguous()):
            raise ValueError("a frame buffer must be a contiguous float32 CPU tensor")
        n, address = buffer.numel(), buffer.data_ptr()
    if n != pixels:
        raise ValueError(f"a frame buffer of {n} values, not the frame's {pixels}")
    return address

