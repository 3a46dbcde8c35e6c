"""The port's span registry (``tpuflow_torch.telemetry``), the spans of the
served step (``io.stream``'s uploads, ``flow.graphed``'s replay), the graph
replays' launch counters (``kernels.ReplayCounter``) and the benchmark's
readers of what the program measures (``flowbench/metrics``).

The uploads and the replay need a card; here their CUDA pieces are
stand-ins on the CPU (no copy stream, unpinned buffers, a graph whose
replay does nothing), so what is held is the spans' and the counters'
bookkeeping around them.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuflow_torch import telemetry
from tpuflow_torch.flow import graphed
from tpuflow_torch.io import stream
from tpuflow_torch.kernels import ReplayCounter, launch_counts, reset_launch_counts, warp

ROOT = Path(__file__).resolve().parents[1]
IO_SPANS = ("tpuflow_torch.io.buffer_wait", "tpuflow_torch.io.pinned_copy",
            "tpuflow_torch.io.enqueue")
STEP_SPANS = ("tpuflow_torch.flow.replay", "tpuflow_torch.flow.clone")


def _used(before: dict, name: str) -> tuple[int, float]:
    count, seconds = telemetry.totals()[name]
    count0, seconds0 = before.get(name, (0, 0.0))
    return count - count0, seconds - seconds0


def test_span_totals_count_and_seconds():
    s = telemetry.span("tpuflow_torch.test.sleep")
    assert telemetry.span("tpuflow_torch.test.sleep") is s
    before = telemetry.totals()
    for _ in range(3):
        with s:
            time.sleep(0.01)
    count, seconds = _used(before, "tpuflow_torch.test.sleep")
    assert count == 3
    assert 0.03 <= seconds < 1.0


def test_reset_zeroes_every_span():
    with telemetry.span("tpuflow_torch.test.a"):
        pass
    with telemetry.span("tpuflow_torch.test.b"):
        pass
    telemetry.reset()
    totals = telemetry.totals()
    assert totals["tpuflow_torch.test.a"] == (0, 0.0)
    assert all(v == (0, 0.0) for v in totals.values())
    with telemetry.span("tpuflow_torch.test.a"):
        pass
    assert telemetry.totals()["tpuflow_torch.test.a"][0] == 1


def test_span_opens_a_record_function_only_under_the_profiler(monkeypatch):
    opened = []

    class Recorded:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(telemetry, "_RecordFunction", Recorded)
    s = telemetry.span("tpuflow_torch.test.profiled")
    with s:
        pass
    assert opened == []
    before = telemetry.totals()
    with profile(activities=[ProfilerActivity.CPU]):
        with s:
            pass
    assert opened == ["tpuflow_torch.test.profiled"]
    # A use the profiler records is on its timeline and not in the totals.
    assert _used(before, "tpuflow_torch.test.profiled") == (0, 0.0)
    with s:
        pass
    assert opened == ["tpuflow_torch.test.profiled"]
    assert _used(before, "tpuflow_torch.test.profiled")[0] == 1


def test_chain_times_its_spans_back_to_back():
    names = ("tpuflow_torch.test.first", "tpuflow_torch.test.second",
             "tpuflow_torch.test.third")
    c = telemetry.chain(*names)
    assert c.spans == tuple(telemetry.span(name) for name in names)
    before = telemetry.totals()
    t0 = time.perf_counter_ns()
    for _ in range(2):
        with c as spans:
            time.sleep(0.002)
            spans.next()
            time.sleep(0.004)
            spans.next()
    elapsed = (time.perf_counter_ns() - t0) / 1e9
    used = [_used(before, name) for name in names]
    assert [count for count, _ in used] == [2, 2, 2]
    assert used[0][1] >= 0.004 and used[1][1] >= 0.008
    # One clock read at each shared boundary: the spans tile the chain's
    # time, so they sum to at most the time around the two uses.
    assert sum(seconds for _, seconds in used) <= elapsed
    assert used[2][1] < used[0][1]


def test_chain_closes_its_open_span_at_the_with_s_end():
    c = telemetry.chain("tpuflow_torch.test.only", "tpuflow_torch.test.unused")
    before = telemetry.totals()
    with pytest.raises(ValueError):
        with c:
            raise ValueError
    assert _used(before, "tpuflow_torch.test.only")[0] == 1
    assert _used(before, "tpuflow_torch.test.unused")[0] == 0
    with c as spans:
        spans.next()
    assert _used(before, "tpuflow_torch.test.only")[0] == 2
    assert _used(before, "tpuflow_torch.test.unused")[0] == 1


def test_chain_under_the_profiler_records_each_span_in_turn(monkeypatch):
    events = []

    class Recorded:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("open", self.name))
            return self

        def __exit__(self, *exc):
            events.append(("close", self.name))

    monkeypatch.setattr(telemetry, "_RecordFunction", Recorded)
    c = telemetry.chain("tpuflow_torch.test.p1", "tpuflow_torch.test.p2")
    before = telemetry.totals()
    with profile(activities=[ProfilerActivity.CPU]):
        with c as spans:
            spans.next()
    assert events == [("open", "tpuflow_torch.test.p1"), ("close", "tpuflow_torch.test.p1"),
                      ("open", "tpuflow_torch.test.p2"), ("close", "tpuflow_torch.test.p2")]
    assert _used(before, "tpuflow_torch.test.p1") == (0, 0.0)
    assert _used(before, "tpuflow_torch.test.p2") == (0, 0.0)
    with c as spans:
        spans.next()
    assert len(events) == 4
    assert _used(before, "tpuflow_torch.test.p2")[0] == 1


def test_span_is_a_host_event_and_no_user_annotation():
    """Under the profiler a span is a function-scope record on the host
    timeline: the kind that puts no annotation on a device's timeline
    (``record_function``'s user scope does)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("tpuflow_torch.test.host"):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "tpuflow_torch.test.host"]
    assert len(events) == 1
    assert str(events[0].device_type()).endswith("CPU")
    assert not events[0].is_user_annotation()


class _Done:
    """A copy's event that has completed."""

    waits = 0

    def synchronize(self):
        _Done.waits += 1


def _cpu_uploads(monkeypatch):
    """``io.stream``'s CUDA pieces as CPU stand-ins."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(stream, "_pinned", lambda shape, dtype: torch.empty(shape, dtype=dtype))
    monkeypatch.setattr(stream, "_copy_out", lambda pinned, dev, copies: (pinned.clone(), _Done()))
    monkeypatch.setattr(stream, "_hand_over", lambda frame, uploaded: frame)


def _frames(n: int) -> list[np.ndarray]:
    return [np.full((6, 8), i, np.float32) for i in range(n)]


@pytest.mark.parametrize("lookahead", [0, 2])
def test_uploads_use_each_io_span_once_a_frame(monkeypatch, lookahead):
    _cpu_uploads(monkeypatch)
    _Done.waits = 0
    before = telemetry.totals()
    got = list(stream._upload_ahead(iter(_frames(10)), lookahead, torch.device("cpu")))
    assert [float(f[0, 0]) for f in got] == list(range(10))
    assert _used(before, "tpuflow_torch.io.buffer_wait")[0] == 10
    assert _used(before, "tpuflow_torch.io.pinned_copy")[0] == 10
    # A copy's launch a frame, and the last lookahead frames' hand-overs
    # once the frames have run out.
    assert _used(before, "tpuflow_torch.io.enqueue")[0] == 10 + lookahead
    assert _Done.waits == 10 - (lookahead + 1)  # every buffer's reuse waited for its copy


def test_frame_stream_uploads_use_the_io_spans(monkeypatch, tmp_path):
    from tpuflow_torch.io import frames as fio

    _cpu_uploads(monkeypatch)
    frames = [np.full((6, 8), i, np.float32) for i in range(7)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(tmp_path / f"f{i}.bin")
        fio.save_frame_bin(paths[-1], f)
    source = stream.FrameStream(paths, width=8, height=6, depth=2)
    _Done.waits = 0
    before = telemetry.totals()
    got = list(stream._upload_stream(source, 1, torch.device("cpu")))
    assert [float(f[0, 0]) for f in got] == list(range(7))
    pool = 2 + 1 + 1
    assert _used(before, "tpuflow_torch.io.pinned_copy")[0] == pool  # the allocations
    assert _used(before, "tpuflow_torch.io.buffer_wait")[0] == _Done.waits > 0
    assert _used(before, "tpuflow_torch.io.enqueue")[0] == 7 + 1


class _Graph:
    def __init__(self, u):
        self.u = u

    def replay(self):
        self.u.add_(1)


def _replayed(launches: dict) -> graphed._Replayed:
    """A stream's replay around a stand-in graph that adds 1 to u."""
    u, v = torch.zeros(2, 3), torch.ones(2, 3)
    s = graphed._Replayed()
    s._take(graphed.Captured(_Graph(u), (u, v, torch.zeros(3, dtype=torch.int32)),
                             ReplayCounter(launches), (), {"kernel": 7, "memcpy": 2}))
    s._frame = torch.zeros(2, 3)
    return s


def test_replay_uses_each_step_span_once_and_counts_launches():
    name = next(iter(warp.launch_counts))
    s = _replayed({name: 3})
    assert s.launches == {name: 3} and s.nodes == {"kernel": 7, "memcpy": 2}
    before, counts0 = telemetry.totals(), launch_counts()
    frame = torch.full((2, 3), 5.0)
    for k in range(1, 5):
        u, v = s._replay(frame)
        assert torch.equal(u, torch.full((2, 3), float(k))) and torch.equal(v, torch.ones(2, 3))
        assert u.data_ptr() != s._u.data_ptr()  # the caller's own
    assert torch.equal(s._frame, frame)
    for span in STEP_SPANS:
        assert _used(before, span)[0] == 4, span
    assert launch_counts()[name] == counts0[name] + 12


def test_the_five_spans_appear_under_a_cpu_profiler(monkeypatch):
    _cpu_uploads(monkeypatch)
    s = _replayed({})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for frame in stream._upload_ahead(iter(_frames(4)), 2, torch.device("cpu")):
            s._replay(torch.from_numpy(np.zeros((2, 3), np.float32)) + frame[0, 0])
    host = {e.name() for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CPU")}
    assert set(IO_SPANS + STEP_SPANS) <= host


def test_replay_counters_reset_and_fold_when_freed():
    name = next(iter(warp.launch_counts))
    counter = ReplayCounter({name: 5})
    base = launch_counts()[name]
    counter.replays += 2
    assert launch_counts()[name] == base + 10
    reset_launch_counts()
    assert counter.replays == 0 and launch_counts()[name] == 0
    counter.replays += 3
    del counter  # its replays stay counted
    assert launch_counts()[name] == 15
    reset_launch_counts()
    assert launch_counts()[name] == 0


def _reader(metric: str):
    path = ROOT / "flowbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"test_reader_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


READERS = {
    "input_pinned_copy_ms_per_step": ("tpuflow_torch.io.pinned_copy", 1e3),
    "input_buffer_wait_ms_per_step": ("tpuflow_torch.io.buffer_wait", 1e3),
    "replay_launch_us": ("tpuflow_torch.flow.replay", 1e6),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_read_the_programs_totals(monkeypatch, metric):
    span, scale = READERS[metric]
    monkeypatch.setattr(telemetry, "_SPANS", {})
    s = telemetry.span(span)
    s.count, s.ns = 4, 2_000_000  # 0.5 ms a use
    read = _reader(metric)
    assert read({"trace": {"frames": 8}}) == pytest.approx(0.5e-3 * scale)
    assert read({"trace": None}) is None  # untraced and CPU runs
    monkeypatch.setattr(telemetry, "_SPANS", {})
    assert read({"trace": {"frames": 8}}) is None  # no such span


@pytest.mark.parametrize("metric,key", [("replay_idle_ms_per_frame", "replay_idle_s"),
                                        ("starved_idle_ms_per_frame", "starved_idle_s")])
def test_idle_split_readers_read_the_reduced_trace(metric, key):
    read = _reader(metric)
    assert read({"trace": {"frames": 8, key: 0.004}}) == pytest.approx(0.5)
    assert read({"trace": {"frames": 8}}) is None  # a reduce() without the split
    assert read({"trace": None}) is None  # untraced and CPU runs


def test_graph_kernels_reader_reads_the_stream_s_nodes():
    read = _reader("graph_kernels_per_step")
    assert read({"trace": {"frames": 8}, "graph": {"kernel": 391, "memcpy": 4}}) == 391
    assert read({"trace": {"frames": 8}, "graph": {}}) is None  # nothing captured
    assert read({"trace": {"frames": 8}}) is None  # a run that keeps no graph
