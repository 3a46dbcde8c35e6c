"""The 4K (3840x2160) accuracy gate on the card: the port's counterpart of
the JAX package's ``scripts/check_4k.sh``, in the script's three steps.

1. Generate the 4-pattern subset (translation, vertical, rotation, exact
   zero: ``PATTERNS``) at 3840x2160 with the port's generator
   (``eval.patterns``, the warps on the card), every pattern written anew,
   and the ``suite_index.json`` the script writes (``suite_index``).
2. Run the verifier (``eval.verifier.run_suite``) over it under
   ``production``, the kernels (``backend="cuda"``) on the card, with the
   dense analytic ground truth (``dense_gt=True``).
3. Gate each pattern's pyramidal dense EPE against the committed 4K
   capture ``benchmarks/r04/verify_4k_production.json`` (read by path) by
   the script's rule (``gate``): a baseline under 1e-6 must stay under
   1e-6, any other within 10% of it. Exit 1 on a regression.

``--update PATH`` writes this run's results to PATH in place of the gate;
a PATH under ``benchmarks/`` (the JAX package's captures) is refused. The
suite and the verifier's report go under ``build/check_4k/`` by default.
The library functions take ``device="cpu"``, which runs the kernels'
plain versions on the CPU, for the CPU tests at small sizes.

Run on a card: ``python -m tpuflow_torch.eval.check_4k [--update PATH]``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from tpuflow_torch.eval import patterns, verifier
from tpuflow_torch.eval.timing import resolve_device

REPO = Path(__file__).resolve().parents[2]
CAPTURE = REPO / "benchmarks" / "r04" / "verify_4k_production.json"
WORK_DIR = REPO / "build" / "check_4k"
WIDTH, HEIGHT = 3840, 2160
PATTERNS = ("translate_medium", "translate_vertical", "rotate_small", "no_motion")
CONFIG = "production"
SUITE_NAME = "4K production bring-up subset"
TOLERANCE = 0.10  # relative, as the 13-pattern gate's 10%
ZERO = 1e-6  # a baseline under this is exact zero, and must stay under it


def suite_index(width: int = WIDTH, height: int = HEIGHT) -> Dict[str, Any]:
    """The subset's ``suite_index.json``, the fields check_4k.sh writes."""
    return {
        "suite_name": SUITE_NAME,
        "resolution": {"width": width, "height": height},
        "num_patterns": len(PATTERNS),
        "patterns": {
            n: {
                "name": n,
                "dx": patterns.TEST_PATTERNS[n].dx,
                "dy": patterns.TEST_PATTERNS[n].dy,
                "rotation": patterns.TEST_PATTERNS[n].rotation,
                "scale": patterns.TEST_PATTERNS[n].scale,
                "description": patterns.TEST_PATTERNS[n].description,
            }
            for n in PATTERNS
        },
    }


def generate_subset(suite_dir: Path, width: int = WIDTH, height: int = HEIGHT,
                    device: torch.device | str | None = None) -> Path:
    """Step 1: the subset's frames in the reference generator's layout, the
    warps on ``device`` (the card unless the caller names another), and
    its index. Returns the suite directory."""
    suite_dir = Path(suite_dir)
    for name in PATTERNS:
        patterns.generate_test_pattern(patterns.TEST_PATTERNS[name], width, height, suite_dir,
                                       device=device)
    (suite_dir / "suite_index.json").write_text(json.dumps(suite_index(width, height), indent=2))
    return suite_dir


def verify(suite_dir: Path, device: torch.device | str | None = None,
           verbose: bool = True) -> List[Dict[str, Any]]:
    """Step 2: the verifier's results over the subset, ``production`` on the
    kernels, with the dense ground truth."""
    return verifier.run_suite(pattern_names=list(PATTERNS), pyramid_config_name=CONFIG,
                              backend="cuda", verbose=verbose, dense_gt=True, device=device,
                              suite_dir=Path(suite_dir))


def dense_epe(doc: Dict[str, Any], pattern: str) -> float:
    return doc["patterns"][pattern]["pyramidal"]["dense_metrics"]["epe"]


def gate(run: Dict[str, Any], capture: Dict[str, Any]) -> List[Tuple[str, float, float, bool]]:
    """Step 3: (pattern, this run's pyramidal dense EPE, the capture's, ok)
    for every pattern of the capture, by check_4k.sh's rule."""
    out = []
    for pattern in capture["patterns"]:
        curr, base = dense_epe(run, pattern), dense_epe(capture, pattern)
        ok = curr < ZERO if base < ZERO else abs(curr - base) <= TOLERANCE * base
        out.append((pattern, curr, base, ok))
    return out


def report(rows: List[Tuple[str, float, float, bool]]) -> List[str]:
    lines = []
    for pattern, curr, base, ok in rows:
        change = f", {100 * (curr - base) / base:+.2f}%" if base >= ZERO else ""
        lines.append(f"{pattern:20s} pyramidal: dense EPE {curr:.6f} (baseline {base:.6f}"
                     f"{change}) {'OK' if ok else 'REGRESSION'}")
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="4K production accuracy gate: the dense-GT EPE of the 4-pattern subset "
        "against the committed 4K capture")
    parser.add_argument("--update", type=str, default=None, metavar="PATH",
                        help="write this run's results to PATH instead of gating (not under "
                        "benchmarks/)")
    parser.add_argument("--suite-dir", type=str, default=str(WORK_DIR / "suite_4k"))
    parser.add_argument("--output-dir", type=str, default=str(WORK_DIR / "verify_4k"))
    args = parser.parse_args(argv)
    if args.update and Path(args.update).resolve().is_relative_to(REPO / "benchmarks"):
        raise SystemExit(f"--update {args.update}: benchmarks/ holds the JAX package's "
                         "captures and is not written")
    dev = resolve_device(None)

    print(f"== 1/3 generate the 4K pattern subset -> {args.suite_dir} ==")
    suite = generate_subset(Path(args.suite_dir), device=dev)
    print(f"== 2/3 verifier ({CONFIG}, backend cuda on {dev}, dense analytic GT) ==")
    results = verify(suite, device=dev)
    out = Path(args.output_dir) / "verification_results.json"
    verifier.save_results_json(results, out)
    print(f"results -> {out}")
    if args.update:
        path = Path(args.update)
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(out, path)
        print(f"updated {path}")
        return

    print(f"== 3/3 gate dense-GT metrics against {CAPTURE.relative_to(REPO)} ==")
    rows = gate(json.loads(out.read_text()), json.loads(CAPTURE.read_text()))
    for line in report(rows):
        print(line)
    failures = [pattern for pattern, _, _, ok in rows if not ok]
    if failures:
        print("4K dense-GT regression:", failures)
        sys.exit(1)
    print("4K accuracy gate: OK")


if __name__ == "__main__":
    main()
