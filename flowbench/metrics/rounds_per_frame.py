"""Warp-and-refine rounds run a frame, summed over the levels: the graph's
own counter (``GraphedStream.level_rounds``) added into a device
accumulator after every step and read once after the window."""


def read(record: dict):
    if record["rounds"]["frames"] == 0:
        return None
    return record["rounds"]["total"] / record["rounds"]["frames"]
