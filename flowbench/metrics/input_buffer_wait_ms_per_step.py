"""Host ms a step in the program's span ``tpuflow_torch.io.buffer_wait``
(``io.stream``: the wait for a pinned buffer's last H2D copy before it is
written again), one use an upload, over the run's uploads that no
profiler recorded (``harness.program``); traced runs on the card only."""

from flowbench.harness import program


def read(record: dict):
    if not record["trace"]:
        return None
    s = program.span_s_per_use("tpuflow_torch.io.buffer_wait")
    return None if s is None else s * 1e3
