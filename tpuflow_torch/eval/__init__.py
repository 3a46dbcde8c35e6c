"""Evaluation: the 13-pattern verifier (``python -m
tpuflow_torch.eval.verifier``: suite, metrics, regression gate), the VO
trajectory verifier, the stage profilers (``profile``, ``profile_vo``),
the natural-frame generator (``natural``) and the plots (``visualize``).
PIL, PyYAML and matplotlib are optional, imported only by the flags that
need them."""

from tpuflow_torch.eval.metrics import compute_all_metrics
from tpuflow_torch.eval.patterns import TEST_PATTERNS, MotionParameters

__all__ = ["compute_all_metrics", "TEST_PATTERNS", "MotionParameters"]
