"""Device ms a frame in cuBLAS's GEMM kernels: the pyramid's banded
resample-and-blur and the flow upsample (torch.profiler, the traced
window)."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or t["time_s"]["gemm"] <= 0:
        return None
    return t["time_s"]["gemm"] / t["frames"] * 1e3
