"""K8: what shifted reads cost a stencil kernel on Hopper.

Counterpart of ``scripts/shift_ablation.py``, which asked what Mosaic pays
on the TPU for misaligned slices. The kernel (``csrc/ablation.cu``,
``tpuflow_shift_ablation``) computes what ``make_fn``'s kernel computes,
with its constants: from a (256, 2048) f32 input ``a``, the (64, 1024)
output ``a[r0:, c0:]``, then 15 row-shifted slices ``a[r_k:, c0:]``, then
15 column-shifted slices ``a[r0:, c_k:]``, added in that order, for the
four offset sets of ``offsets`` (aligned, misaligned, rows_only,
cols_only). ``shift_adds_ref`` is the same in torch slices, bit-exact:
there are only adds, in the same order.

What the ratio measures is set by the kernel's loads. One thread computes
one output and reads its 31 terms with plain read-only global loads
(``__ldg``, through L1); nothing is staged in shared memory. A warp reads
32 consecutive floats of one row: 4 sectors of one 128-B line when the
column offset is a multiple of 32 floats (every "aligned" offset is a
multiple of 128), 5 sectors over two lines otherwise. Row offsets never
misalign a load (rows start 8 KB apart), so on the card ``rows_only``
should cost what ``aligned`` does and ``cols_only`` what ``misaligned``
does. The 2 MB input stays in L2, and per block mostly in L1, so the
ratio reads L1 sector and line traffic, not the TPU's sublane and lane
shifts.

``main()`` prints each kind's device time per call (CUDA events around
back-to-back launches behind a GPU spin, ``eval.timing.device_ms``) and the
script's JSON line (``results_us`` and the three ratios, unrounded), with
the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from tpuflow_torch.kernels import _build

ROWS, COLS = 256, 2048  # input tile
OUT_R, OUT_C = 64, 1024  # output tile
N_SHIFTS = 16  # slices per axis, the first shared
KINDS = ("aligned", "misaligned", "rows_only", "cols_only")

# Kernel launches; incremented only where the kernel is launched.
launch_counts = {"shift_ablation": 0}


def offsets(kind: str) -> tuple[list[int], list[int]]:
    """Row and column offsets of the slices (scripts/shift_ablation.py:45-61)."""
    aligned_r = [8 * i for i in range(N_SHIFTS)]
    aligned_c = [128 * (i % 8) for i in range(N_SHIFTS)]
    shifted = [1 + i for i in range(N_SHIFTS)]
    table = {
        "aligned": (aligned_r, aligned_c),
        "misaligned": (shifted, shifted),
        "rows_only": (shifted, aligned_c),
        "cols_only": (aligned_r, shifted),
    }
    if kind not in table:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return table[kind]


def shift_adds_ref(a: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version: the slices added in the kernel's order."""
    r, c = offsets(kind)

    def sl(r0: int, c0: int) -> torch.Tensor:
        return a[r0 : r0 + OUT_R, c0 : c0 + OUT_C]

    acc = sl(r[0], c[0])
    for i in range(1, N_SHIFTS):
        acc = acc + sl(r[i], c[0])
    for i in range(1, N_SHIFTS):
        acc = acc + sl(r[0], c[i])
    return acc


def shift_adds(a: torch.Tensor, kind: str) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    r, c = offsets(kind)
    if a.shape != (ROWS, COLS) or a.dtype != torch.float32:
        raise ValueError(f"a must be a ({ROWS}, {COLS}) float32 tensor")
    if a.device.type == "cpu":
        return shift_adds_ref(a, kind)
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError("the CUDA kernel needs a contiguous CUDA tensor")
    lib = _build.load()
    out = torch.empty((OUT_R, OUT_C), dtype=torch.float32, device=a.device)
    ints = ctypes.c_int * N_SHIFTS
    code = lib.tpuflow_shift_ablation(
        a.data_ptr(), out.data_ptr(), COLS, OUT_R, OUT_C, N_SHIFTS, ints(*r), ints(*c),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, code, "shift_ablation")
    launch_counts["shift_ablation"] += 1
    return out


def make_input(device: torch.device, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (ROWS, COLS)).astype(np.float32)).to(device)


def measure(a: torch.Tensor) -> dict:
    """Device microseconds per call of each kind, and the ratios to
    ``aligned`` (the script's JSON object)."""
    from tpuflow_torch.eval.timing import device_ms

    results = {kind: 1000.0 * device_ms(lambda kind=kind: shift_adds(a, kind), reps=200)
               for kind in KINDS}
    base = results["aligned"]
    return {
        "results_us": results,
        "misaligned_over_aligned": results["misaligned"] / base,
        "rows_only_over_aligned": results["rows_only"] / base,
        "cols_only_over_aligned": results["cols_only"] / base,
    }


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, require_cuda

    dev = require_cuda()
    print(f"shift ablation on {card_label()}")
    doc = measure(make_input(dev))
    for kind, us in doc["results_us"].items():
        print(f"{kind:12s} {us:8.3f} us / call ({2 * (N_SHIFTS - 1) + 1} adds on {OUT_R}x{OUT_C})")
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
