"""The traced window's idle gaps by cause, from the runtime calls linked to
the device operations around each gap (kineto's correlation ids).

A gap between two device operations is:

- ``in-replay`` where both come from one ``cudaGraphLaunch``: a bubble
  between dependent nodes of one graph replay;
- ``queued`` where the operation after it had been launched on the host
  before the gap began: the card idled with work in its queue (a wait on
  another stream's event, or between two launched replays);
- ``starved`` otherwise: the card waited for the host, labelled by the
  innermost host span at the gap's midpoint (the harness's ``flowbench.*``
  or the program's ``tpuflow_torch.*``), else ``between``.

The window's edges count as starved. ``split`` works on plain tuples, so
synthetic events test it; ``from_profile`` reads them from a finished
``torch.profiler`` session.
"""

from __future__ import annotations

from flowbench.harness import trace

_HOST_SPANS = ("flowbench.", "tpuflow_torch.")
TOP = 10


def from_profile(prof) -> tuple[list, dict, list]:
    """(device operations as (start_ns, end_ns, correlation id), runtime
    calls as {correlation id: (name, start_ns)}, host spans as (name,
    start_ns, end_ns)) of a finished profile. The device operations are
    those ``trace.events`` keeps, so the idle time is ``trace.reduce``'s."""
    ops, calls, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start = trace._ns(e, "start")
        end = start + trace._ns(e, "duration")
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and not name.startswith("flowbench."):
            ops.append((start, end, int(e.correlation_id())))
        elif name.startswith("cu"):  # a runtime or driver call: cudaGraphLaunch, ...
            calls[int(e.correlation_id())] = (name, start)
        elif name.startswith(_HOST_SPANS) and not on_device:
            spans.append((name, start, end))
    return ops, calls, spans


def split(ops: list, calls: dict, spans: list) -> dict:
    """Idle seconds of the ``flowbench.window`` span by cause, the starved
    seconds by span, and the graph replays whose operations ran in the
    window."""
    windows = [(s, e) for name, s, e in spans if name == trace.WINDOW]
    if not windows:
        raise RuntimeError("no flowbench.window span")
    w0, w1 = windows[0]
    inside = sorted((max(s, w0), min(e, w1), c) for s, e, c in ops if e > w0 and s < w1)
    segments = trace._segments([(n, s, e) for n, s, e in spans if n != trace.WINDOW])
    out = {"in-replay": 0, "queued": 0, "starved": 0}
    starved: dict[str, int] = {}
    i = 0

    def starve(g0: int, g1: int) -> None:
        nonlocal i
        mid = (g0 + g1) // 2
        while i < len(segments) and segments[i][1] <= mid:
            i += 1
        label = segments[i][2] if i < len(segments) and segments[i][0] <= mid else "between"
        out["starved"] += g1 - g0
        starved[label] = starved.get(label, 0) + g1 - g0

    t, last = w0, None  # the busy front and the operation that reached it
    for s, e, c in inside:
        if s > t:
            if last is None:
                starve(t, s)
            elif c == last and "GraphLaunch" in calls.get(c, ("", 0))[0]:
                out["in-replay"] += s - t
            elif c in calls and calls[c][1] < t:
                out["queued"] += s - t
            else:
                starve(t, s)
        if e >= t:
            t, last = e, c
    if t < w1:
        starve(t, w1)
    replays = {c for _, _, c in inside if "GraphLaunch" in calls.get(c, ("", 0))[0]}
    return {
        "window_s": (w1 - w0) / 1e9,
        "idle_s": sum(out.values()) / 1e9,
        "replay_idle_s": out["in-replay"] / 1e9,
        "queued_idle_s": out["queued"] / 1e9,
        "starved_idle_s": out["starved"] / 1e9,
        "replays": len(replays),
        "idle_gaps": [[name, v / 1e9] for name, v in sorted(
            [("in-replay", out["in-replay"]), ("queued", out["queued"])]
            + list(starved.items()), key=lambda kv: -kv[1])[:TOP] if v],
    }
