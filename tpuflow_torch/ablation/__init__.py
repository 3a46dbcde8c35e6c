"""Measurement microkernels: ports of the JAX package's TPU ablation
scripts (``scripts/shift_ablation.py``, K8, and
``scripts/warp_mxu_ablation.py``, K9), each a hand-written CUDA kernel in
``csrc/ablation.cu`` with its plain PyTorch version and launch counter.
Run on a card: ``python -m tpuflow_torch.ablation.shift_ablation`` and
``python -m tpuflow_torch.ablation.warp_mxu_ablation``.
"""
