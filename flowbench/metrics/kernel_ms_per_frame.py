"""Device ms a frame in the port's own kernels, the warp and refine rounds
running and skipped (torch.profiler, the traced window)."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or t["time_s"]["kernels"] <= 0:
        return None
    return t["time_s"]["kernels"] / t["frames"] * 1e3
