"""Host ms a step in the harness's ``next()`` on
``io.stream.prefetch_to_device``: the pinned copy and the H2D enqueue (a
live camera's wait for the previous step taken out), over the window's
steps that no profiler ran before."""

import numpy as np


def read(record: dict):
    if not record["input_host_s"]:
        return None
    return float(np.mean(record["input_host_s"])) * 1e3
