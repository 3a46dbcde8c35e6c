"""K9: gather against shift-select for the warp's candidate samples on
Hopper.

Counterpart of ``scripts/warp_mxu_ablation.py``, which asked on the TPU
whether building the warp's horizontal interpolation from shifted,
selected views (the form a per-row matrix would need) beats the hardware
gather. The kernel (``csrc/ablation.cu``, ``tpuflow_warp_gather_ablation``)
computes ``_build``'s kernel at the script's shape: for each pixel of a
(rows, wp) = (64, 1920) plane and each of ``ITERS`` = 18 candidate steps d,
a sample g is taken from the (rows, wp + 256) band x and accumulated as
``acc + g * f32(1 + 0.01 d)``, the product and the add rounded separately:

- ``gather``: within the pixel's 128-column block of ``x[:, 128:128+wp]``,
  at lane l, ``g = block[clip(l + off + d - 9, 0, 127)]``: one
  data-dependent load per step;
- ``shifts``: ``g`` is the view ``x[:, 128 + dx:]`` for the one dx in
  -9..10 with ``off == dx + d % 3 - 1``, picked by a chain of 20 selects
  per step, 0 where none matches.

``ITERS``, ``MAXD`` and the coefficients are the script's constants, and
the kernel has them compiled in (``_build(mode, rows, wp)`` takes neither),
so the CPU and the card take the same arguments. ``candidate_accumulate_ref``
is the same in plain PyTorch (``torch.gather`` and a ``torch.where``
chain), bit-exact against the kernel. On the card each block stages its
rows of the band once in shared memory: gather mode then makes 18
data-dependent shared loads a pixel, shifts mode loads a pixel's 20 views
into registers once and runs the 18 unrolled select chains over them (with
d unrolled only ``d % 3`` tells the chains apart, and the compiler may
merge them; ``chip_smoke.py`` prints the select instructions the SASS
holds). So the question reads on the card as 18 shared-memory gathers
against the select chains, not as global-memory traffic.

``main()`` prints the script's two lines, device microseconds per call of
each mode (CUDA events around back-to-back launches behind a GPU spin),
with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.kernels import _build

ITERS = 18  # candidate rows at the full +-8 band
MAXD = 8
ROWS, WP = 64, 1920
MODES = ("gather", "shifts")

# Kernel launches (both modes); incremented only where the kernel is launched.
launch_counts = {"warp_mxu_ablation": 0}


def coefficients() -> torch.Tensor:
    """f32(1 + 0.01 d) for each step, as JAX casts the Python float."""
    return torch.tensor([np.float32(1.0 + 0.01 * d) for d in range(ITERS)], dtype=torch.float32)


def _check(x: torch.Tensor, off: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    rows, wp = off.shape if off.ndim == 2 else (-1, -1)
    if rows < 1 or wp < 128 or wp % 128 or x.shape != (rows, wp + 256):
        raise ValueError("off must be (rows, wp), rows >= 1 and wp a positive multiple of 128, "
                         "x (rows, wp + 256)")
    if x.dtype != torch.float32 or off.dtype != torch.int32:
        raise TypeError("x must be float32 and off int32")
    if x.device != off.device:
        raise ValueError("x and off must lie on one device")


def candidate_accumulate_ref(x: torch.Tensor, off: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    rows, wp = off.shape
    coef = coefficients().to(x.device)
    if mode == "gather":
        n = rows * (wp // 128)
        base = x[:, 128 : 128 + wp].reshape(n, 128)
        lane = torch.arange(128, dtype=torch.int32, device=x.device).expand(n, 128)
        off_r = off.reshape(n, 128)
        acc = torch.zeros((n, 128), dtype=torch.float32, device=x.device)
        for d in range(ITERS):
            idx = (lane + off_r + (d - ITERS // 2)).clamp(0, 127)
            acc = acc + base.gather(1, idx.to(torch.int64)) * coef[d]
        return acc.reshape(rows, wp)
    acc = torch.zeros((rows, wp), dtype=torch.float32, device=x.device)
    for d in range(ITERS):
        part = torch.zeros_like(acc)
        for dx in range(-MAXD - 1, MAXD + 3):
            part = torch.where(off == dx + d % 3 - 1, x[:, 128 + dx : 128 + dx + wp], part)
        acc = acc + part * coef[d]
    return acc


def candidate_accumulate(x: torch.Tensor, off: torch.Tensor, mode: str) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    _check(x, off, mode)
    if x.device.type == "cpu":
        return candidate_accumulate_ref(x, off, mode)
    if x.device.type != "cuda" or not (x.is_contiguous() and off.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous CUDA tensors")
    out = _launch(_build.load(), x, off, mode)
    launch_counts["warp_mxu_ablation"] += 1
    return out


def _launch(lib, x: torch.Tensor, off: torch.Tensor, mode: str) -> torch.Tensor:
    """One launch of ``lib``'s ``tpuflow_warp_gather_ablation`` on checked
    CUDA tensors (not counted: ``candidate_accumulate`` counts its own)."""
    rows, wp = off.shape
    out = torch.empty((rows, wp), dtype=torch.float32, device=x.device)
    code = lib.tpuflow_warp_gather_ablation(
        x.data_ptr(), off.data_ptr(), out.data_ptr(), rows, wp, MODES.index(mode),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(_build.load(), code, "warp_mxu_ablation")
    return out


def make_inputs(device: torch.device, rows: int = ROWS, wp: int = WP, seed: int = 0):
    """The script's band and offsets: x uniform in [0, 255), off in
    [-MAXD, MAXD], from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (rows, wp + 256)).astype(np.float32)
    off = rng.integers(-MAXD, MAXD + 1, (rows, wp)).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(off).to(device)


def measure(x: torch.Tensor, off: torch.Tensor) -> dict[str, float]:
    """Device microseconds per call of each mode."""
    from tpuflow_torch.eval.timing import device_ms

    return {mode: 1000.0 * device_ms(lambda mode=mode: candidate_accumulate(x, off, mode),
                                     reps=200)
            for mode in MODES}


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, require_cuda

    dev = require_cuda()
    print(f"warp gather ablation on {card_label()}")
    rows, wp = ROWS, WP
    for mode, us in measure(*make_inputs(dev)).items():
        print(f"{mode:7s}: {us:8.2f} us per {rows}x{wp} tile ({ITERS} candidate iterations)",
              flush=True)


if __name__ == "__main__":
    main()
