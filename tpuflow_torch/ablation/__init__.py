"""Measurement microkernels: ports of the JAX package's TPU ablation
scripts (``scripts/shift_ablation.py``, K8, and
``scripts/warp_mxu_ablation.py``, K9), each a hand-written CUDA kernel in
``csrc/ablation.cu`` with its plain PyTorch version and launch counter;
and ``warp_walk``, the banded warp as a ring walk (``csrc/warp_walk.cu``)
timed against the warp kernel's own blocks. Run on a card: ``python -m
tpuflow_torch.ablation.shift_ablation``, ``python -m
tpuflow_torch.ablation.warp_mxu_ablation`` and ``python -m
tpuflow_torch.ablation.warp_walk``.
"""
