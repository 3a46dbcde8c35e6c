"""The round kernels' share of their roofline, in %: the running rounds'
bound (their bytes over 3.35 TB/s, ``harness.roofline``, counted from the
traced steps' ``level_rounds``) over the port's kernels' device time in
the traced window. A skipped round's time counts and its bound does not."""


def read(record: dict):
    t = record["trace"]
    if not t or t["time_s"]["kernels"] <= 0 or t["bound_s"] <= 0:
        return None
    return 100.0 * t["bound_s"] / t["time_s"]["kernels"]
