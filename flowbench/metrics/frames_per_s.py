"""Camera frames whose flow was complete within the window, over the
window's seconds (B frames a step): all the work over all the time."""


def read(record: dict):
    if record["frames"] == 0:
        return None
    return record["frames"] / record["seconds"]
