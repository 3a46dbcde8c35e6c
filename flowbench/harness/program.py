"""What the program measures of itself, read after the run.

``tpuflow_torch.telemetry`` totals its host spans from the process's start,
over the uses made while no profiler records: the run's record does not
carry them, so a reader takes them from the program once the run is over,
and they then cover the warm-up's and the host clock's steps (the traced
steps add nothing). Each function gives None where the program lacks the
span (a checkout from before it had them), and never raises for that.
"""

from __future__ import annotations


def span_totals() -> dict:
    """The program's ``{span: (count, seconds)}``, else {}."""
    try:
        from tpuflow_torch import telemetry
    except ImportError:
        return {}
    return telemetry.totals()


def span_s_per_use(name: str):
    """Mean seconds of one use of the program's span ``name``, else None."""
    count, seconds = span_totals().get(name, (0, 0.0))
    return seconds / count if count else None
