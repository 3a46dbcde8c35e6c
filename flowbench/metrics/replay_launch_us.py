"""Host us a step in the program's span ``tpuflow_torch.flow.replay``
(``flow.graphed``: the frame's copy into the graph, the replay's launch
and its count; the output clones are left out), one use a step, over the
run's steps that no profiler recorded (``harness.program``); traced runs
on the card only."""

from flowbench.harness import program


def read(record: dict):
    if not record["trace"]:
        return None
    s = program.span_s_per_use("tpuflow_torch.flow.replay")
    return None if s is None else s * 1e6
