"""Device idle ms a frame inside graph replays: the gaps between two
operations launched by one ``cudaGraphLaunch`` (``harness.idle.split``'s
in-replay class, kept by ``trace.reduce`` as ``replay_idle_s``), over the
traced window's frames."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or "replay_idle_s" not in t:
        return None
    return t["replay_idle_s"] / t["frames"] * 1e3
