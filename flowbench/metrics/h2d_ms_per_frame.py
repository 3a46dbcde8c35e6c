"""Device ms a frame of host-to-device copies (torch.profiler, the traced
window)."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or t["time_s"]["h2d"] <= 0:
        return None
    return t["time_s"]["h2d"] / t["frames"] * 1e3
