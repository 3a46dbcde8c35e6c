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

What the ratio measures is set by the kernel's fetches. A block owns a
32x16 output tile and fetches, once, the distinct ranges its 31 slices
read: the row strip (rows r0..r15 + 31 of its columns) staged in shared
memory, and the column terms, staged as one window where neighbouring
columns share them (offsets 1..16) and loaded by each thread into its own
registers where no other thread reads them (the 128-column offsets). Each
thread sums two outputs of one column, spaced by the kind's row step so
that one staged row serves both. A row offset only sets how tall the
strip is; a column offset's alignment only how wide a 16-byte-aligned
range is (16 columns for multiples of 4, up to 20 otherwise). On the card
the kinds differ by the bytes a block fetches and the shared loads a
thread makes, not by the TPU's sublane and lane shifts; and since the
call's bound (0.37 us) lies below one kernel launch, each time reads
mostly the launch floor (``chip_smoke.py`` prints both).

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
    offsets(kind)  # raises on an unknown kind
    if a.shape != (ROWS, COLS) or a.dtype != torch.float32:
        raise ValueError(f"a must be a ({ROWS}, {COLS}) float32 tensor")
    if a.device.type == "cpu":
        return shift_adds_ref(a, kind)
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError("the CUDA kernel needs a contiguous CUDA tensor")
    out = _launch(_build.load(), a, kind)
    launch_counts["shift_ablation"] += 1
    return out


def _launch(lib, a: torch.Tensor, kind: str) -> torch.Tensor:
    """One launch of ``lib``'s ``tpuflow_shift_ablation`` on a checked
    (256, 2048) CUDA tensor (not counted: ``shift_adds`` counts its own)."""
    r, c = offsets(kind)
    out = torch.empty((OUT_R, OUT_C), dtype=torch.float32, device=a.device)
    ints = ctypes.c_int * N_SHIFTS
    code = lib.tpuflow_shift_ablation(
        a.data_ptr(), out.data_ptr(), COLS, OUT_R, OUT_C, N_SHIFTS, ints(*r), ints(*c),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(_build.load(), code, "shift_ablation")
    return out


def make_input(device: torch.device, seed: int = 0, spread: bool = False) -> torch.Tensor:
    """The script's input, uniform in [0, 1), from a numpy seed; with
    ``spread``, signed values whose magnitudes spread over 2^-20 .. 2^20,
    on which a sum taken in another order rounds differently."""
    rng = np.random.default_rng(seed)
    if spread:
        a = rng.uniform(1.0, 2.0, (ROWS, COLS)) * np.exp2(rng.integers(-20, 21, (ROWS, COLS)))
        a *= rng.choice([-1.0, 1.0], (ROWS, COLS))
    else:
        a = rng.uniform(0.0, 1.0, (ROWS, COLS))
    return torch.from_numpy(a.astype(np.float32)).to(device)


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
