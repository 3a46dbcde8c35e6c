"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at the first kernel launch, never at import, into
``build/tpuflow_torch/`` beside the package; the library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded.

``-fmad=false`` keeps every ``a*b + c`` as two rounded operations, as the
plain PyTorch versions compute them; ``--use_fast_math`` is never used
(IEEE division and reciprocal).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuflow_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns the cudaError_t of its launch.
_SIGNATURES = {
    # img, u, v, out, height, width, max_disp, max_disp_v, packing, stream
    "tpuflow_warp_banded": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # prev, warped, u, v, converged, u_out, v_out, part_du, part_dv,
    # height, width, det_threshold, max_disp, max_disp_v, stream
    "tpuflow_lk_refine": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpuflow_torch_{digest.hexdigest()[:16]}.so"


def is_loaded() -> bool:
    return _lib is not None


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this checkout has none yet."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tpuflow_lk_refine_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpuflow_lk_refine_blocks.restype = ctypes.c_int
    lib.tpuflow_error_string.argtypes = [ctypes.c_int]
    lib.tpuflow_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.tpuflow_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
