"""The 13-pattern verifier of the port: suite, metrics and regression gate,
with no JAX, PIL or OpenCV (``python -m tpuflow_torch.eval.verifier``)."""

from tpuflow_torch.eval.metrics import compute_all_metrics
from tpuflow_torch.eval.patterns import TEST_PATTERNS, MotionParameters

__all__ = ["compute_all_metrics", "TEST_PATTERNS", "MotionParameters"]
