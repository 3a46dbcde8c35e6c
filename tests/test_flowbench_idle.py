"""The benchmark's idle split (``flowbench/harness/idle.py``) on synthetic
device operations, runtime calls and host spans: each gap sorted into
in-replay, queued and starved, starved gaps named by the innermost host
span (the program's spans included), and the same idle time as
``harness.trace.reduce`` reads from the same events."""

from __future__ import annotations

import time

import pytest

from flowbench.harness import idle, trace

# Two replays of a graph (correlation ids 1, 2), an H2D copy (3) and a
# kernel launched alone (4), in a window of 1,000 ns.
OPS = [(0, 100, 1), (120, 200, 1), (260, 330, 2), (300, 400, 2), (500, 600, 3),
       (650, 680, 4)]
CALLS = {1: ("cudaGraphLaunch", -50), 2: ("cudaGraphLaunch", 150),
         3: ("cudaMemcpyAsync", 450), 4: ("cudaLaunchKernel", 640)}
SPANS = [(trace.WINDOW, 0, 1000), ("flowbench.input", 380, 470),
         ("tpuflow_torch.io.pinned_copy", 420, 460), ("flowbench.step", 610, 660),
         ("tpuflow_torch.flow.replay", 615, 645), ("flowbench.wait", 700, 900)]


def test_gaps_sort_into_in_replay_queued_and_starved():
    got = idle.split(OPS, CALLS, SPANS)
    # 100-120 inside replay 1; 200-260 before replay 2, launched at 150;
    # 400-500 before a copy launched at 450 (the pinned copy's span at
    # the midpoint); 600-650 before a kernel launched at 640 (inside the
    # replay span); 680-1000 to the window's end (flowbench.wait).
    assert got["replay_idle_s"] == pytest.approx(20e-9)
    assert got["queued_idle_s"] == pytest.approx(60e-9)
    assert got["starved_idle_s"] == pytest.approx((100 + 50 + 320) * 1e-9)
    assert got["replays"] == 2
    assert dict(got["idle_gaps"]) == pytest.approx({
        "flowbench.wait": 320e-9, "tpuflow_torch.io.pinned_copy": 100e-9,
        "queued": 60e-9, "tpuflow_torch.flow.replay": 50e-9, "in-replay": 20e-9})


def test_the_split_adds_up_to_the_reduced_idle_time():
    got = idle.split(OPS, CALLS, SPANS)
    reduced = trace.reduce([("op", s, e) for s, e, _ in OPS], SPANS)
    assert got["idle_s"] == pytest.approx(reduced["window_s"] - reduced["busy_s"])
    assert got["replay_idle_s"] + got["queued_idle_s"] + got["starved_idle_s"] == (
        pytest.approx(got["idle_s"]))


def test_a_gap_with_no_known_launch_is_starved_and_the_edges_too():
    ops = [(100, 200, 7), (300, 400, 8)]
    got = idle.split(ops, {}, [(trace.WINDOW, 0, 500)])
    assert got["replay_idle_s"] == 0 and got["queued_idle_s"] == 0
    assert got["starved_idle_s"] == pytest.approx(300e-9)
    assert got["idle_gaps"] == [["between", pytest.approx(300e-9)]]
    assert got["replays"] == 0


def test_no_window_raises():
    with pytest.raises(RuntimeError, match="window"):
        idle.split(OPS, CALLS, SPANS[1:])


def test_a_cpu_profile_reads_as_one_starved_window():
    """``from_profile`` on a CPU-only profile: the window and the spans
    inside it are read, no device operation, so the window is starved
    idle under its innermost span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpuflow_torch import telemetry

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with telemetry.span("tpuflow_torch.test.idle"):
                time.sleep(0.002)
    ops, calls, spans = idle.from_profile(prof)
    assert ops == [] and calls == {}
    assert {name for name, _, _ in spans} == {trace.WINDOW, "tpuflow_torch.test.idle"}
    got = idle.split(ops, calls, spans)
    assert got["starved_idle_s"] == pytest.approx(got["window_s"])
    assert got["idle_gaps"][0][0] == "tpuflow_torch.test.idle"
