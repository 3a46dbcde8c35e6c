"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The build happens at the first kernel launch, never at import,
into ``build/tpuflow_torch/`` beside the package; the library's file name
carries a hash of the sources, headers and flags, so an edited source is
rebuilt and a stale library is never loaded. ``build_log`` keeps ptxas's
register and shared-memory report of the last build.

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
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Largest batch one launch takes: the batch is the grid's z dimension.
MAX_BATCH = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns the cudaError_t of its launch.
_SIGNATURES = {
    # img, u, v, out, batch, height, width, max_disp, max_disp_v, packing,
    # clamp_flow, stream
    "tpuflow_warp_banded": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # as tpuflow_warp_banded, with the block forced before the stream:
    # staged (1), gathering (0) or by plane size (-1); for measurement
    "tpuflow_warp_banded_as": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # img, u, v, out, latch, band, ladder (host i32[n]), n_ladder, batch,
    # height, width, max_disp, packing, stream: one round under device
    # control
    "tpuflow_warp_round": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # as tpuflow_warp_banded, with the rows a walk takes before the stream
    # (the walk ablation)
    "tpuflow_warp_walk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # prev, warped, u, v, converged, u_out, v_out, part_du, part_dv,
    # batch, height, width, window, relaxed, det_threshold, max_disp,
    # max_disp_v, stream
    "tpuflow_lk_refine": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # prev, warped, u, v, ctrl, band, ladder (host f32[n]), n_ladder, u_out,
    # v_out, part_du, part_dv, sums, batch, height, width, window, relaxed,
    # det_threshold, max_disp, thr, stream
    "tpuflow_lk_refine_round": (
        _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    "tpuflow_lk_refine_mxu": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # prev, curr, u_out, v_out, det_out (or null), batch, height, width,
    # window, relaxed, taps (host f32[window] or null), det_threshold, stream
    "tpuflow_lk_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P),
    # as tpuflow_lk_fused without taps
    "tpuflow_lk_fused_mxu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # a, out, in_cols, out_rows, out_cols, n_shifts, row offsets (host
    # i32[n_shifts]), column offsets (host i32[n_shifts]), stream
    "tpuflow_shift_ablation": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # x, off, out, rows, wp, mode, stream
    "tpuflow_warp_gather_ablation": (_P, _P, _P, _I, _I, _I, _P),
    # frame, predicate (device bool or null), taken (device i32 or null),
    # xy, alive, height, width, grid_step, margin, min_response, stream
    "tpuflow_seed_grid": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # mismatches (device u64), stream: the seed kernel's square root against
    # sqrtf over every non-negative float32
    "tpuflow_seed_sqrt_mismatches": (_P, _P),
    # samples, n, bias_jacobians, out, stream
    "tpuflow_imu_preintegrate": (_P, _I, _I, _P, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
build_log: str = ""


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
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpuflow_torch_{digest.hexdigest()[:16]}.so"


def is_loaded() -> bool:
    return _lib is not None


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this checkout has none yet."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        t0 = time.perf_counter()
        build_log = build(_sources(), path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tpuflow_lk_refine_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpuflow_lk_refine_blocks.restype = ctypes.c_int
    lib.tpuflow_lk_walk_threads.argtypes = []
    lib.tpuflow_lk_walk_threads.restype = ctypes.c_int
    lib.tpuflow_lk_refine_mxu_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpuflow_lk_refine_mxu_blocks.restype = ctypes.c_int
    lib.tpuflow_lk_mxu_mma.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpuflow_lk_mxu_mma.restype = ctypes.c_longlong
    lib.tpuflow_lk_mxu_smem.argtypes = [ctypes.c_int]
    lib.tpuflow_lk_mxu_smem.restype = ctypes.c_int
    lib.tpuflow_warp_geometry.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.tpuflow_warp_geometry.restype = None
    lib.tpuflow_empty.argtypes = [ctypes.c_void_p]
    lib.tpuflow_empty.restype = ctypes.c_int
    lib.tpuflow_error_string.argtypes = [ctypes.c_int]
    lib.tpuflow_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def build(sources: list[Path], path: Path) -> str:
    """Compile ``sources`` (one nvcc each, all started together) and link
    them into the shared library ``path``; returns ptxas's report."""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [path.parent / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]  # waits for every one
    for cmd, proc, log in zip(cmds, procs, logs):
        _check_nvcc(cmd, proc.returncode, log)
    tmp = path.parent / f"{tag}.tmp"
    link_cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    link = subprocess.run(link_cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _check_nvcc(link_cmd, link.returncode, link.stdout)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, path)
    return "".join(logs)


def _check_nvcc(cmd: list[str], code: int, log: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")


def launch_empty() -> None:
    """Launch one empty kernel of the library on the current stream: timed
    with ``eval.timing.device_ms``, the floor under any kernel's time."""
    import torch

    lib = load()
    check(lib, lib.tpuflow_empty(torch.cuda.current_stream().cuda_stream), "empty kernel")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.tpuflow_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
