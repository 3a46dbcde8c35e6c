"""Host us a step in ``GraphedStream.step``: the frame copy, the replay's
launch and the two clones, enqueued; over the window's steps that no
profiler ran before."""

import numpy as np


def read(record: dict):
    if not record["step_host_s"]:
        return None
    return float(np.mean(record["step_host_s"])) * 1e6
