"""Device ms a frame outside the GEMMs, the port's kernels and the copies:
the pyramidal loop's and the upsample's elementwise and reduction kernels, the
frame's widening (torch.profiler, the traced window)."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or t["time_s"]["other"] <= 0:
        return None
    return t["time_s"]["other"] / t["frames"] * 1e3
