"""Host spans of the served path: always-on totals, on the profiler's
timeline while one records.

``span(name)`` is the registered span of that name, a context manager:
each use adds its wall time (``time.perf_counter_ns`` at entry and exit)
and one to its totals, which ``totals()`` returns as ``{name: (count,
seconds)}`` since the start or the last ``reset()``. Memory is one small
object a name. ``chain(*names)`` is a context manager over spans used
back to back: ``next()`` closes the open span and opens the one after it
at one clock read, so a boundary they share is read once.

While a ``torch.profiler`` session records, a span (or a chain's open
span) opens a record function of its name on the profiler's host
timeline (the device trace's clock) and adds nothing to the totals: a
profiler's own cost (it traces each launch) is not the program's, so the
totals hold the uses made while none records. It is a function-scope
record, which puts no annotation interval on the device's timeline: an
annotation there would read as device work to a tool that sums that
timeline.

Names are the module path of the work: ``tpuflow_torch.io.*``
(``io.stream``'s uploads) and ``tpuflow_torch.flow.*`` (the graph
replays of ``flow.graphed``). A span or a chain is used by one thread at
a time and is never nested in itself; none is held open across a
``yield``.
"""

from __future__ import annotations

from time import perf_counter_ns

import torch
import torch.autograd.profiler as _profiler

# A function-scope record (a user-scope one, ``record_function``, also
# puts an annotation interval on the device's timeline).
_RecordFunction = torch._C._profiler._RecordFunctionFast


def _record(name: str):
    record = _RecordFunction(name)
    record.__enter__()
    return record


class Span:
    """A named span's totals; ``with`` it to time a piece of work."""

    __slots__ = ("name", "count", "ns", "_t0", "_record")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.ns = 0
        self._t0 = 0
        self._record = None

    def __enter__(self) -> None:
        if _profiler._is_profiler_enabled:
            self._record = _record(self.name)
        self._t0 = perf_counter_ns()

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._record is None:
            self.ns += perf_counter_ns() - self._t0
            self.count += 1
        else:
            self._record.__exit__(None, None, None)
            self._record = None


class Chain:
    """Spans used back to back, in order: ``with`` opens the first,
    ``next()`` closes the open one and opens the next at one clock read,
    and leaving the ``with`` closes the open one."""

    __slots__ = ("spans", "_i", "_t0", "_record")

    def __init__(self, spans: tuple[Span, ...]) -> None:
        self.spans = spans
        self._i = 0
        self._t0 = 0
        self._record = None

    def __enter__(self) -> Chain:
        self._i = 0
        if _profiler._is_profiler_enabled:
            self._record = _record(self.spans[0].name)
        self._t0 = perf_counter_ns()
        return self

    def next(self) -> None:
        t = perf_counter_ns()
        i = self._i
        if self._record is None:
            s = self.spans[i]
            s.ns += t - self._t0
            s.count += 1
        else:
            self._record.__exit__(None, None, None)
            self._record = _record(self.spans[i + 1].name)
        self._i = i + 1
        self._t0 = t

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._record is None:
            s = self.spans[self._i]
            s.ns += perf_counter_ns() - self._t0
            s.count += 1
        else:
            self._record.__exit__(None, None, None)
            self._record = None


_SPANS: dict[str, Span] = {}


def span(name: str) -> Span:
    """The span ``name``, registered at its first use."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = Span(name)
    return s


def chain(*names: str) -> Chain:
    """The spans ``names``, used back to back in that order."""
    return Chain(tuple(span(name) for name in names))


def totals() -> dict[str, tuple[int, float]]:
    """``{name: (count, seconds)}`` of every registered span."""
    return {name: (s.count, s.ns / 1e9) for name, s in _SPANS.items()}


def reset() -> None:
    """Zero every span's totals."""
    for s in _SPANS.values():
        s.count = 0
        s.ns = 0
