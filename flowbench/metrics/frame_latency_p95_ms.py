"""95th percentile over the window's frames of one frame's latency: from
its handover to the input path (host clock) until its step's end event
completed on the card (the event aligned to the host clock once, at the
window's start). Queue wait counts. A step's B frames share it."""

import numpy as np


def read(record: dict):
    if not record["latencies_s"]:
        return None
    return float(np.percentile(record["latencies_s"], 95)) * 1e3
