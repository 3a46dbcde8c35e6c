"""Banded bilinear backward warp: the packed-corner kernels and their plain
PyTorch version.

Counterpart of ``tpuflow.kernels.pallas_warp.warp_image_banded`` with
``clamp_flow=True`` and ``packed_u8=True`` (K1, the finest pyramid level)
or ``packed_u16=True`` (K2, the coarse levels). The CUDA kernel is
``csrc/warp.cu``; ``warp_banded_ref`` is the same function in plain
PyTorch, in the same f32 expression order, and is what ``warp_banded``
runs for a tensor on the CPU.

out(x, y) = image(x + u, y + v) with u, v clipped to the band, the source
column clamped to [x - max_disp - 1, x + max_disp] and [0, W - 1], corners
outside the image read as 0, and samples outside [0, N - 1] giving 0.
Corner decoding: ``"u8"`` truncates to whole gray levels (exact for frames
of integer values in [0, 255]); ``"u16"`` rounds to 8.8 fixed point and
scales the result by 1/256 after the vertical lerp.
"""

from __future__ import annotations

import torch

from tpuflow_torch.kernels import _build

PACKINGS = {"u8": 8, "u16": 16}

# Kernel launches per variant; incremented only where a kernel is launched.
launch_counts = {"warp_packed_u8": 0, "warp_packed_u16": 0}


def _decode(image: torch.Tensor, packing: str) -> torch.Tensor:
    if packing == "u8":
        return image.to(torch.int32).to(torch.float32)
    q = (image * 256.0 + 0.5).to(torch.int32) & 0xFFFF
    return q.to(torch.float32)


def warp_banded_ref(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    max_disp: int = 8,
    max_disp_v: int | None = None,
    packing: str = "u8",
) -> torch.Tensor:
    """Plain PyTorch version of the packed banded warp kernel."""
    if max_disp_v is None:
        max_disp_v = max_disp
    h, w = image.shape
    dev = image.device
    u = flow_u.clamp(-float(max_disp), float(max_disp))
    v = flow_v.clamp(-float(max_disp_v), float(max_disp_v))
    xx_i = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    yy_i = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xf = xx_i.to(torch.float32) + u
    yf = yy_i.to(torch.float32) + v
    x0f = torch.floor(xf)
    y0f = torch.floor(yf)
    fx = xf - x0f
    fy = yf - y0f
    fxc = 1.0 - fx
    fyc = 1.0 - fy

    x0 = torch.minimum(torch.maximum(x0f.to(torch.int32), xx_i - (max_disp + 1)),
                       xx_i + max_disp)
    x0 = x0.clamp(0, w - 1).to(torch.int64)
    y0 = y0f.to(torch.int64)

    # Decoded image with zero rows above and below the band and one zero
    # column on the right: every corner the clipped flow can reach.
    pad = max_disp_v + 1
    dec = torch.nn.functional.pad(_decode(image, packing), (0, 1, pad, pad))
    flat = dec.reshape(-1)
    stride = w + 1

    def corner(r, c):
        return flat[(r + pad) * stride + c]

    c00 = corner(y0, x0)
    c01 = corner(y0, x0 + 1)
    c10 = corner(y0 + 1, x0)
    c11 = corner(y0 + 1, x0 + 1)
    up = c00 * fxc + c01 * fx
    low = c10 * fxc + c11 * fx
    out = up * fyc + low * fy
    if packing == "u16":
        out = out * (1.0 / 256.0)
    inside = (xf >= 0.0) & (xf <= float(w - 1)) & (yf >= 0.0) & (yf <= float(h - 1))
    return torch.where(inside, out, torch.zeros_like(out))


def warp_banded(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    max_disp: int = 8,
    max_disp_v: int | None = None,
    packing: str = "u8",
) -> torch.Tensor:
    """Packed banded warp: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Bands up to 31 px (the TPU kernel's limit)."""
    if max_disp_v is None:
        max_disp_v = max_disp
    if packing not in PACKINGS:
        raise ValueError(f"packing must be one of {sorted(PACKINGS)}, got {packing!r}")
    if not (0 <= max_disp <= 31 and 0 <= max_disp_v <= 31):
        raise ValueError("banded warp supports bands of 0..31 px")
    if image.ndim != 2 or flow_u.shape != image.shape or flow_v.shape != image.shape:
        raise ValueError("image, flow_u and flow_v must share one (H, W) shape")
    for t in (image, flow_u, flow_v):
        if t.dtype != torch.float32:
            raise TypeError(f"float32 expected, got {t.dtype}")
        if t.device != image.device:
            raise ValueError("image and flow must lie on one device")
    if image.device.type == "cpu":
        return warp_banded_ref(image, flow_u, flow_v, max_disp, max_disp_v, packing)
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    if not (image.is_contiguous() and flow_u.is_contiguous() and flow_v.is_contiguous()):
        raise ValueError("the CUDA warp needs contiguous tensors")

    lib = _build.load()
    h, w = image.shape
    out = torch.empty_like(image)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    code = lib.tpuflow_warp_banded(
        image.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(), out.data_ptr(),
        h, w, max_disp, max_disp_v, PACKINGS[packing], stream,
    )
    _build.check(lib, code, f"warp_packed_{packing}")
    launch_counts[f"warp_packed_{packing}"] += 1
    return out
