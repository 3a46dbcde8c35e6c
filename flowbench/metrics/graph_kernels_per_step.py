"""Kernel nodes of the cell's captured step, child graphs included: the
program's count at capture through the driver API (``stream.nodes``, kept
by the run as ``record["graph"]``); one replay a step runs each once."""


def read(record: dict):
    nodes = record.get("graph")
    return None if not nodes or "kernel" not in nodes else nodes["kernel"]
