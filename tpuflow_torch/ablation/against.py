"""The ablation kernels (K8, K9) of ``csrc/ablation.cu`` timed against
another body of the same C interface, in turns on one card.

Builds the other source alone with the package's nvcc flags into
``build/tpuflow_torch/against/``, checks that both bodies give the plain
versions' bits, then for each K8 kind and each K9 mode times the other
body, this one, this one, the other (``eval.timing.device_ms``, 200 calls a
batch), with an empty kernel's launch floor before and after. Prints one
line a case, ptxas's report of the other build, and one JSON object. Needs
a CUDA device. For example, against a variant kept under the gitignored
``build/``:

    python -m tpuflow_torch.ablation.against build/variant/ablation.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from tpuflow_torch.ablation import shift_ablation, warp_mxu_ablation
from tpuflow_torch.kernels import _build

ENTRIES = ("tpuflow_shift_ablation", "tpuflow_warp_gather_ablation")


def build_other(source: Path) -> tuple[ctypes.CDLL, str]:
    """The other source built alone into a shared library, and ptxas's log."""
    lib_path = _build.BUILD_DIR / "against" / f"lib{source.stem}_other.so"
    log = _build.build([source], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, log


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, device_ms, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another ablation.cu with the same C interface")
    args = parser.parse_args()
    dev = require_cuda()
    this, (other, log) = _build.load(), build_other(args.other)
    print(f"ablation bodies on {card_label()}: this tree's against {args.other}")
    print("other build, ptxas: " + " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
    a = shift_ablation.make_input(dev)
    x, off = warp_mxu_ablation.make_inputs(dev)
    # name -> (one launch of a library's body, the plain version's result)
    cases = {f"K8 {kind}": (lambda lib, kind=kind: shift_ablation._launch(lib, a, kind),
                            shift_ablation.shift_adds_ref(a, kind))
             for kind in shift_ablation.KINDS}
    for mode in warp_mxu_ablation.MODES:
        cases[f"K9 {mode}"] = (lambda lib, mode=mode: warp_mxu_ablation._launch(lib, x, off, mode),
                               warp_mxu_ablation.candidate_accumulate_ref(x, off, mode))
    for name, (run, want) in cases.items():
        for label, lib in (("this", this), ("other", other)):
            if not torch.equal(run(lib), want):
                raise AssertionError(f"{name}: the {label} body differs from the plain version")
    doc = {"floor_ms": [device_ms(_build.launch_empty, reps=200)]}
    for name, (run, _) in cases.items():
        times = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            lib = this if label == "this" else other
            times[label].append(device_ms(lambda lib=lib: run(lib), reps=200))
        doc[name] = times
        print(f"{name}: other {times['other'][0]:.5f} / {times['other'][1]:.5f} ms, this "
              f"{times['this'][0]:.5f} / {times['this'][1]:.5f} ms", flush=True)
    doc["floor_ms"].append(device_ms(_build.launch_empty, reps=200))
    print(f"launch floor {doc['floor_ms'][0]:.5f} / {doc['floor_ms'][1]:.5f} ms")
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
