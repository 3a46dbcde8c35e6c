#!/usr/bin/env python3
"""A traced run of one cell, with the traced window's idle time split by
cause (``harness.idle``): in-replay bubbles, queued work and host
starvation by span.

    python3 flowbench/idle_split.py --workload CELL --seed N --seconds S

Runs ``run.py``'s traced run unchanged and reads its profile as it is
reduced. Prints the run's result line, then one JSON line: the split,
the same window's idle by ``trace.reduce`` (``idle_s_reduce``), the
traced steps (the harness's ``flowbench.step`` spans), and the program's
span totals (``tpuflow_torch.telemetry``, where the program has them:
the uses no profiler recorded) as (count, mean us).

A stopgap until ``trace.reduce`` returns the split itself: it wraps
``trace.events`` to see the profile.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench import run  # noqa: E402
from flowbench.harness import idle, program, trace  # noqa: E402


def _means(totals: dict) -> dict:
    return {name: [count, seconds / count * 1e6]
            for name, (count, seconds) in totals.items() if count}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    found = {}
    events = trace.events

    def reading(prof):
        ops, calls, spans = idle.from_profile(prof)
        found["split"] = idle.split(ops, calls, spans)
        found["steps"] = sum(name == "flowbench.step" for name, _, _ in spans)
        kept = events(prof)
        reduced = trace.reduce(*kept)
        found["idle_s_reduce"] = reduced["window_s"] - reduced["busy_s"]
        return kept

    trace.events = reading
    out = run.run(args.workload, args.seed, args.seconds, traced=True)
    print(json.dumps(out))
    print(json.dumps(dict(found["split"], idle_s_reduce=found["idle_s_reduce"],
                          traced_steps=found["steps"], workload=args.workload,
                          seed=args.seed, spans=_means(program.span_totals()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
