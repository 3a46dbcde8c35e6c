#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: for each seed one run of the cell (``run.run``, a short window)
whose kept steps are compared with the reference, and the control (the
reference in TF32, put in the program's place) on the same frames.

    python3 flowbench/calibrate.py --workload CELL --seconds 2 --seeds 11 12 13 ...

Prints one JSON line a seed (each number's worst element, the program's
and the control's) and a last line with the lower readings (the largest
of the program's over the seeds) and the upper ones (the smallest of the
control's, each read as a run reads it: its worst element). ``--device cpu`` runs the same at the rehearsal's size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402

from flowbench.harness.check import NUMBERS  # noqa: E402

READINGS = (*NUMBERS, "epe_mean_px", "share_over_0.1px")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    lower = {n: 0.0 for n in READINGS}
    upper = {n: float("inf") for n in READINGS}
    for seed in args.seeds:
        out = run.run(args.workload, seed, args.seconds, False, args.device, control=True)
        rows = out["rows"]
        prog = {n: max(r[n] for r in rows) for n in READINGS}
        ctrl = {n: min(r["control"][n] for r in rows) for n in READINGS}
        ctrl_worst = {n: max(r["control"][n] for r in rows) for n in READINGS}
        rounds = sorted({tuple(r["ref"]["rounds"]) for r in rows})
        near = sum(r["answers"] > 1 for r in rows)
        worst = max(rows, key=lambda r: r["epe_mean_px"])
        print(json.dumps({"seed": seed, "planes": len(rows), "program": prog,
                          "control_least": ctrl, "control_worst": ctrl_worst,
                          "ref_rounds": rounds, "near_decisions": near,
                          "worst_element": worst,
                          "metrics": out["metrics"]}), flush=True)
        for n in READINGS:
            lower[n] = max(lower[n], prog[n])
            upper[n] = min(upper[n], ctrl_worst[n])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
