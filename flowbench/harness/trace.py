"""The traced window's device timeline, from ``torch.profiler``.

The profiler records the card's kernels, copies and fills (also those a
CUDA graph replays) and the harness's own host spans
(``record_function("flowbench.<phase>")``), all on one clock. ``reduce``
keeps what the per-layer metrics read: the device time by part and by
operation name (a metric of one kernel selects its names), the busy time (the union of every device interval inside the window), the device
operations that took most time, and the idle gaps by what the host was
doing. Times of kernels in graph replays are used; their counts are not
(the profiler's kernel counts in replays were seen to differ from the
graphs' nodes).

The parts, by a device event's name: ``h2d`` host-to-device copies;
``copies`` the other copies and fills; ``kernels`` the program's own
kernels (its CUDA sources' namespaces begin with ``tpuflow_``); ``gemm``
cuBLAS's GEMM kernels; ``other`` the rest (elementwise and reduction
kernels of the driver, the upsample and the frame copies).
"""

from __future__ import annotations

import re

WINDOW = "flowbench.window"
_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|splitk", re.IGNORECASE)
TOP = 10


def part(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if "tpuflow_" in name:
        return "kernels"
    if _GEMM.search(name):
        return "gemm"
    return "other"


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


def events(prof) -> tuple[list, list]:
    """(device intervals, host spans) of a finished profile: each a list
    of (name, start_ns, end_ns)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        if name.startswith("flowbench."):
            # The harness's spans; on the device's timeline as well, as
            # annotations, which are no device work.
            if not str(e.device_type()).endswith("CUDA"):
                host.append((name, start, end))
        elif str(e.device_type()).endswith("CUDA"):
            device.append((name, start, end))
    return device, host


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _segments(spans: list) -> list[tuple[int, int, str]]:
    """The host spans (nested, as one thread's are) cut into consecutive
    pieces, each named by the innermost span over it, in time order."""
    marks = sorted([(s, 1, -e, name) for name, s, e in spans]
                   + [(e, 0, 0, name) for name, s, e in spans])
    out, stack, t = [], [], None
    for at, is_start, _, name in marks:
        if stack and t is not None and at > t:
            out.append((t, at, stack[-1]))
        if is_start:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        t = at
    return out


def reduce(device: list, host: list) -> dict:
    """The traced window's device time by part, busy and window seconds,
    and the breakdown's two lists."""
    windows = [(s, e) for name, s, e in host if name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no flowbench.window span")
    w0, w1 = windows[0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    by_part = {p: 0 for p in ("h2d", "copies", "kernels", "gemm", "other")}
    by_name: dict[str, int] = {}
    for name, s, e in inside:
        by_part[part(name)] += e - s
        by_name[name] = by_name.get(name, 0) + e - s
    busy = _union([(s, e) for _, s, e in inside])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    idle: dict[str, int] = {}
    segments = _segments([(name, s, e) for name, s, e in host if name != WINDOW])
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(segments) and segments[i][1] <= mid:
            i += 1
        inside_span = i < len(segments) and segments[i][0] <= mid
        label = segments[i][2] if inside_span else "flowbench.between"
        idle[label] = idle.get(label, 0) + g1 - g0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "time_s": {p: v / 1e9 for p, v in by_part.items()},
        "by_name": {name: v / 1e9 for name, v in by_name.items()},
        "device_ops": [[name, v / 1e9] for name, v in top],
        "idle_gaps": [[name, v / 1e9]
                      for name, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "gaps": len(gaps),
    }
