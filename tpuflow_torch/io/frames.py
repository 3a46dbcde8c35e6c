"""Frame and flow-field IO in the reference's interchange formats.

- ``frame_*.bin``: raw row-major uint8;
- ``frame_*.mem``: one 2-hex-digit byte a line, for Verilog ``$readmemh``;
- the flow text dump: ``x y u v`` a line, header comments with ``#``.

The port of ``tpuflow.io.frames``. The ``.bin`` loader and the ``.mem``
codec go through the port's native frame IO (``io.fastio``, built from
``native/fastio.cpp`` at first use), as the reference's go through its
extension where it is built; the ``_ref`` functions are their plain numpy
versions, which the tests hold them against.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpuflow_torch.io import fastio


def have_native_io() -> bool:
    """Whether the native frame IO is loaded: it is built at the first call
    where this checkout has no library yet, and a failed build raises with
    the compiler's output."""
    return fastio.load() is not None


def load_frame_bin(path, width: int = 320, height: int = 240) -> np.ndarray:
    """Raw uint8 frame -> float32 (H, W), read and widened natively; a file
    of another byte count than ``height * width`` raises ``ValueError``."""
    return fastio.load_bin_f32(path, np.empty((height, width), np.float32))


def load_frame_bin_ref(path, width: int = 320, height: int = 240) -> np.ndarray:
    """The plain version of ``load_frame_bin``."""
    data = np.fromfile(path, dtype=np.uint8)
    return data.reshape((height, width)).astype(np.float32)


def save_frame_bin(path, frame: np.ndarray) -> None:
    np.asarray(frame).astype(np.uint8).tofile(path)


def load_frame_mem(path, width: int = 320, height: int = 240) -> np.ndarray:
    """$readmemh hex frame -> float32 (H, W), decoded natively."""
    return fastio.decode_mem(path).reshape((height, width)).astype(np.float32)


def load_frame_mem_ref(path, width: int = 320, height: int = 240) -> np.ndarray:
    """The plain version of ``load_frame_mem``."""
    vals = np.asarray(
        [
            int(line, 16)
            for line in Path(path).read_text().splitlines()
            if line.strip() and not line.startswith("//")
        ],
        np.uint8,
    )
    return vals.reshape((height, width)).astype(np.float32)


def save_frame_mem(path, frame: np.ndarray) -> None:
    """Write a frame as u8 ``$readmemh`` hex, one byte a line, natively."""
    fastio.encode_mem(path, np.asarray(frame).astype(np.uint8).ravel())


def save_frame_mem_ref(path, frame: np.ndarray) -> None:
    """The plain version of ``save_frame_mem``."""
    flat = np.asarray(frame).astype(np.uint8).flatten()
    with open(path, "w") as f:
        f.writelines(f"{v:02x}\n" for v in flat)


def save_flow_text(path, u: np.ndarray, v: np.ndarray, header: str = "") -> None:
    """Write the shared ``x y u v`` flow dump."""
    u = np.asarray(u)
    v = np.asarray(v)
    h, w = u.shape
    with open(path, "w") as f:
        if header:
            for line in header.splitlines():
                f.write(f"# {line}\n")
        f.write(f"# width={w} height={h}\n")
        f.write("# x y u v\n")
        for y in range(h):
            for x in range(w):
                f.write(f"{x} {y} {u[y, x]:.6f} {v[y, x]:.6f}\n")


def load_flow_text(path) -> tuple[np.ndarray, np.ndarray]:
    """Read an ``x y u v`` flow dump into dense (u, v) arrays."""
    xs, ys, us, vs = [], [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "//")):
            continue
        parts = line.split()
        if len(parts) < 4:
            continue
        xs.append(int(float(parts[0])))
        ys.append(int(float(parts[1])))
        us.append(float(parts[2]))
        vs.append(float(parts[3]))
    w = max(xs) + 1
    h = max(ys) + 1
    u = np.zeros((h, w), np.float32)
    v = np.zeros((h, w), np.float32)
    u[ys, xs] = us
    v[ys, xs] = vs
    return u, v
