"""The banded warp as a walk, against the warp kernel's own blocks.

The warp kernel (``csrc/warp.cu``, K1/K2/K4) stages the band's window in
shared memory on planes of 2**20 pixels and more, and reads its corners
through L1 on smaller ones (the coarse pyramid levels, where K2 runs). The
design proposed for the coarse levels was a block that walks down a column
strip and keeps the band's rows in a ring, paying the vertical halo once a
walk: ``csrc/warp_walk.cu`` is that block (64-column strips, 16 rows a step,
the window and the flow staged by ``cp.async`` two steps ahead, each staged
pixel decoded once), the same function bit for bit. This module answers,
on the card, whether it beats the kernel's blocks: ``measure`` times, at
one plane and band, the kernel's block by plane size, its other block
(forced), the walk at several walk lengths and an empty kernel's launch
floor, each checked against ``warp.warp_banded_ref`` first.

``warp_walk`` is the walk for a CUDA tensor and the plain version
(``warp_banded_ref``) for a CPU tensor. ``main()`` prints the readings at
the ``production`` pyramid's levels (band 8, random +-9 px flow) with the
card's name and power limit. Needs a CUDA device:
``python -m tpuflow_torch.ablation.warp_walk``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpuflow_torch.kernels import _build, warp

STEP = 16  # rows a step of the walk (csrc/warp_walk.cu)
WALKS = (16, 32, 64)  # walk lengths measure() times, in rows
# The production pyramid's levels (1080p, halved twice).
SHAPES = ((270, 480), (540, 960), (1080, 1920))

# Kernel launches; incremented only where the kernel is launched.
launch_counts = {"warp_walk_ablation": 0}


def warp_walk(image: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor,
              max_disp: int = 8, max_disp_v: int | None = None, packing: str = "u16",
              clamp_flow: bool = True, walk_rows: int = 32) -> torch.Tensor:
    """``warp.warp_banded``'s function, each CUDA block walking
    ``walk_rows`` output rows (a positive multiple of ``STEP``)."""
    if max_disp_v is None:
        max_disp_v = max_disp
    warp.check_args(image, flow_u, flow_v, max_disp, max_disp_v, packing, clamp_flow)
    if walk_rows < STEP or walk_rows % STEP:
        raise ValueError(f"walk_rows must be a positive multiple of {STEP}")
    if image.device.type == "cpu":
        return warp.warp_banded_ref(image, flow_u, flow_v, max_disp, clamp_flow=clamp_flow,
                                    max_disp_v=max_disp_v, packing=packing)
    lib = _build.load()
    h, w = image.shape[-2:]
    out = torch.empty_like(image)
    code = lib.tpuflow_warp_walk(
        image.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(), out.data_ptr(),
        image.shape[0] if image.ndim == 3 else 1, h, w, max_disp, max_disp_v,
        warp.PACKINGS[packing], int(clamp_flow), walk_rows,
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(lib, code, "warp_walk_ablation")
    launch_counts["warp_walk_ablation"] += 1
    return out


def warp_block(image: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor,
               max_disp: int, max_disp_v: int, packing: str, clamp_flow: bool,
               staged: bool) -> torch.Tensor:
    """The warp kernel with its block forced, staged or gathering, on
    contiguous CUDA tensors (the same output bit for bit)."""
    warp.check_args(image, flow_u, flow_v, max_disp, max_disp_v, packing, clamp_flow)
    if image.device.type != "cuda":
        raise ValueError("forcing the kernel's block needs CUDA tensors")
    lib = _build.load()
    h, w = image.shape[-2:]
    out = torch.empty_like(image)
    code = lib.tpuflow_warp_banded_as(
        image.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(), out.data_ptr(),
        image.shape[0] if image.ndim == 3 else 1, h, w, max_disp, max_disp_v,
        warp.PACKINGS[packing], int(clamp_flow), int(staged),
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(lib, code, "warp block")
    return out


def measure(image: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor,
            max_disp: int = 8, max_disp_v: int = 8, packing: str = "u16") -> dict:
    """Device ms per call on the card of the warp kernel (its block by
    plane size), its other block, the walk at each of ``WALKS`` and an
    empty kernel, each first checked bit for bit against the plain
    version. Raises if any differs."""
    from tpuflow_torch.eval.timing import device_ms

    args = (image, flow_u, flow_v, max_disp, max_disp_v, packing, True)
    kw = dict(clamp_flow=True, max_disp_v=max_disp_v, packing=packing)
    want = warp.warp_banded_ref(image, flow_u, flow_v, max_disp, **kw)
    geo = warp.tile_geometry(*image.shape[-2:], max_disp, max_disp_v)
    runs = {"kernel": lambda: warp.warp_banded(image, flow_u, flow_v, max_disp, **kw),
            "other_block": lambda: warp_block(*args, staged=not geo["staged"])}
    for walk in WALKS:
        runs[f"walk_{walk}"] = lambda walk=walk: warp_walk(*args, walk_rows=walk)
    out = {"block": "staged" if geo["staged"] else "gather"}
    for name, fn in runs.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} differs from the plain version at "
                                 f"{tuple(image.shape)} {packing}")
        out[f"{name}_ms"] = device_ms(fn)
    out["launch_floor_ms"] = device_ms(_build.launch_empty)
    return out


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, require_cuda

    dev = require_cuda()
    print(f"warp walk ablation on {card_label()}: band 8, random +-9 px flow")
    rng = np.random.default_rng(0)
    readings = {}
    for h, w in SHAPES:
        for packing in ("u16", "exact") if h < 1080 else ("u8", "exact"):
            img, u, v = (torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32)).to(dev)
                         for lo, hi in ((0, 255), (-9, 9), (-9, 9)))
            if packing == "u8":
                img = img.round()
            r = measure(img, u, v, 8, 8, packing)
            readings[f"{h}x{w} {packing}"] = r
            walks = ", ".join(f"{walk} rows {r[f'walk_{walk}_ms']:.4f}" for walk in WALKS)
            print(f"{h}x{w} {packing}: kernel ({r['block']}) {r['kernel_ms']:.4f} ms, other "
                  f"block {r['other_block_ms']:.4f}, walk {walks}; launch floor "
                  f"{r['launch_floor_ms']:.4f}", flush=True)
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
