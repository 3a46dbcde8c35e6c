"""Banded bilinear backward warp: the CUDA kernels and their plain PyTorch
version.

Counterpart of ``tpuflow.kernels.pallas_warp.warp_image_banded``:
``packing="exact"`` is its unpacked branch (K4, f32 corners, with or
without ``clamp_flow``), ``"u8"`` its ``packed_u8`` variant (K1, the
finest pyramid level) and ``"u16"`` its ``packed_u16`` variant (K2, the
coarse levels). The CUDA kernel is ``csrc/warp.cu``; ``warp_banded_ref``
is the same function in plain PyTorch, in the same f32 expression order,
and is what ``warp_banded`` runs for a tensor on the CPU.

out(x, y) = image(x + u, y + v), with u, v clipped to the band when
``clamp_flow``; the source column x0 clamped to [x - max_disp - 1,
x + max_disp] and then [0, W - 1]; the second column x0 + 1 for the packed
variants (reading 0 past the last column) and, for ``"exact"``, int(x0f) + 1
clamped to [x - max_disp - 1, x + max_disp + 1] and then [0, W - 1]
(pallas_warp.py:92-96). With f = floor(yf) - y, the upper row's sample is
used only for f in [-max_disp_v, max_disp_v + 1] and the lower row's only
for f in [-max_disp_v, max_disp_v], else 0 (the TPU kernel's candidate-row
loop, pallas_warp.py:349-380; with ``clamp_flow`` f always lies inside).
Rows outside the image read 0, and samples with xf or yf outside [0, N - 1]
give 0. Corner decoding: ``"exact"`` uses the f32 value, ``"u8"`` truncates
to whole gray levels (exact for frames of integer values in [0, 255]),
``"u16"`` rounds to 8.8 fixed point and scales the result by 1/256 after
the vertical lerp.

Frames come as one (H, W) plane or a (B, H, W) batch (the TPU kernel's
batched entry, ``_warp_batched``); a batch is one kernel launch and each
element is warped exactly as the same plane alone.

``warp_banded`` and ``warp_banded_ref`` take ``warp_image_banded``'s
parameters, in its order and with its defaults (the exact warp, flow not
clamped): ``packed_u8`` / ``packed_u16`` choose the packing, and
``tile_rows`` is accepted and ignored (the TPU's tiling). The keyword-only
``packing`` names the packing instead; given with a packed flag that
disagrees, it raises.

``warp_round`` (and ``warp_round_ref``) is the same warp, flow clamped, as
one round of the pyramidal driver under device control: it reads the
round's skip flag (the level's converged latch) and the band index from
device memory, so the driver never reads either to the host. A skipped
round leaves ``out`` as it was. On the card the band switch is one launch
sized for the ladder's widest band (``csrc/warp.cu``). A batch of
independent streams passes one band index a plane: each plane warps at its
own band, as it would alone.
"""

from __future__ import annotations

import ctypes

import torch

from tpuflow_torch.kernels import _build, torch_ref

# Packing name -> the kernel's template value.
PACKINGS = {"exact": 0, "u8": 8, "u16": 16}
_COUNTER = {"exact": "warp_exact", "u8": "warp_packed_u8", "u16": "warp_packed_u16"}

# Kernel launches per variant; incremented only where a kernel is launched.
launch_counts = {name: 0 for name in _COUNTER.values()}

# Widest band, either way (the TPU kernel's limit).
MAX_BAND = 31
# Longest band ladder a round takes (csrc/warp.cuh kMaxLadder).
MAX_LADDER = 8
# The CUDA kernel's planes have sides under 2**24, where x + max_disp and
# y + max_disp_v are exact floats.
MAX_SIDE = 1 << 24


def tile_geometry(height: int, width: int, max_disp: int, max_disp_v: int) -> dict:
    """The CUDA kernel's block at a plane size and band: whether it stages
    the band in shared memory, its output columns and rows, its threads,
    the bytes of shared memory it stages and the consecutive columns a
    thread takes."""
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    lib.tpuflow_warp_geometry(height, width, max_disp, max_disp_v, out)
    return dict(zip(("staged", "tile_w", "rows", "threads", "smem_bytes", "cols"), out))


def launch_empty_on_grid(height: int, width: int, batch: int = 1,
                         geometry: dict | None = None) -> None:
    """Launch an empty kernel on the grid and block the warp takes on
    ``batch`` (height, width) planes (``geometry`` as ``tile_geometry``
    gives it, that plane's by default): what a launch of that grid costs
    before its body, timed with ``eval.timing.device_ms``."""
    g = geometry or tile_geometry(height, width, 8, 8)
    _build.launch_empty_grid(-(-width // g["tile_w"]), -(-height // g["rows"]), batch,
                             g["threads"])


def _decode(image: torch.Tensor, packing: str) -> torch.Tensor:
    if packing == "exact":
        return image
    if packing == "u8":
        return image.to(torch.int32).to(torch.float32)
    q = (image * 256.0 + 0.5).to(torch.int32) & 0xFFFF
    return q.to(torch.float32)


def resolve_packing(packed_u8: bool, packed_u16: bool, packing: str | None) -> str:
    """The packing named by the reference's flags or by ``packing``;
    raises if both flags are set or ``packing`` disagrees with a flag."""
    if packed_u8 and packed_u16:
        raise ValueError("pick one packing: packed_u8 or packed_u16")
    flagged = "u8" if packed_u8 else "u16" if packed_u16 else None
    if packing is None:
        return flagged or "exact"
    if flagged is not None and flagged != packing:
        raise ValueError(f"packing={packing!r} disagrees with packed_{flagged}=True")
    return packing


def warp_banded_ref(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    max_disp: int = 8,
    tile_rows: int | None = None,
    clamp_flow: bool = False,
    max_disp_v: int | torch.Tensor | None = None,
    packed_u8: bool = False,
    packed_u16: bool = False,
    *,
    packing: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the banded warp kernel, for (H, W) planes
    or (B, H, W) batches. ``max_disp_v`` may be a 0-d integer tensor on
    the image's device (a band read from the device, never to the host),
    or a (B, 1, 1) one for a batch, each plane at its own band."""
    packing = resolve_packing(packed_u8, packed_u16, packing)
    if max_disp_v is None:
        max_disp_v = max_disp
    h, w = image.shape[-2:]
    dev = image.device
    mdv_f = (max_disp_v.to(torch.float32) if isinstance(max_disp_v, torch.Tensor)
             else float(max_disp_v))
    u, v = flow_u, flow_v
    if clamp_flow:
        u = u.clamp(-float(max_disp), float(max_disp))
        v = v.clamp(-mdv_f, mdv_f)
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

    ix0 = x0f.to(torch.int32)
    x0 = torch.minimum(torch.maximum(ix0, xx_i - (max_disp + 1)), xx_i + max_disp)
    x0 = x0.clamp(0, w - 1)
    if packing == "exact":
        x1 = torch.minimum(torch.maximum(ix0 + 1, xx_i - (max_disp + 1)),
                           xx_i + (max_disp + 1))
        x1 = x1.clamp(0, w - 1)
    else:
        x1 = x0 + 1  # column w is the zero column below
    y0 = y0f.to(torch.int32)
    f = y0 - yy_i

    # Decoded image with one zero column on the right, each plane
    # flattened; rows outside the image are masked to 0.
    dec = torch.nn.functional.pad(_decode(image, packing), (0, 1)).flatten(-2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def take(idx):
        return dec.gather(-1, idx.flatten(-2)).reshape(idx.shape)

    def row(r):
        valid = (r >= 0) & (r < h)
        base = r.clamp(0, h - 1).to(torch.int64) * (w + 1)
        c0 = torch.where(valid, take(base + x0.to(torch.int64)), zero)
        c1 = torch.where(valid, take(base + x1.to(torch.int64)), zero)
        return c0 * fxc + c1 * fx

    up = torch.where((f >= -max_disp_v) & (f <= max_disp_v + 1), row(y0), zero)
    low = torch.where((f >= -max_disp_v) & (f <= max_disp_v), row(y0 + 1), zero)
    out = up * fyc + low * fy
    if packing == "u16":
        out = out * (1.0 / 256.0)
    inside = (xf >= 0.0) & (xf <= float(w - 1)) & (yf >= 0.0) & (yf <= float(h - 1))
    return torch.where(inside, out, zero)


def check_args(image: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor,
               max_disp: int, max_disp_v: int, packing: str, clamp_flow: bool) -> None:
    """Raise unless the warp takes these arguments: on a CUDA tensor, the
    kernel's (contiguous planes with sides under ``MAX_SIDE``)."""
    if packing not in PACKINGS:
        raise ValueError(f"packing must be one of {sorted(PACKINGS)}, got {packing!r}")
    if packing != "exact" and not clamp_flow:
        raise ValueError("the packed warps require clamp_flow=True")
    if not (0 <= max_disp <= MAX_BAND and 0 <= max_disp_v <= MAX_BAND):
        raise ValueError(f"banded warp supports bands of 0..{MAX_BAND} px")
    if image.ndim not in (2, 3) or flow_u.shape != image.shape or flow_v.shape != image.shape:
        raise ValueError("image, flow_u and flow_v must share one (H, W) or (B, H, W) shape")
    if image.ndim == 3 and not 1 <= image.shape[0] <= _build.MAX_BATCH:
        raise ValueError(f"batches of 1..{_build.MAX_BATCH} planes are supported")
    for t in (image, flow_u, flow_v):
        if t.dtype != torch.float32:
            raise TypeError(f"float32 expected, got {t.dtype}")
        if t.device != image.device:
            raise ValueError("image and flow must lie on one device")
    if image.device.type == "cpu":
        return
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    if not (image.is_contiguous() and flow_u.is_contiguous() and flow_v.is_contiguous()):
        raise ValueError("the CUDA warp needs contiguous tensors")
    if max(image.shape[-2:]) >= MAX_SIDE:
        raise ValueError(f"the CUDA warp takes planes with sides under {MAX_SIDE}")


def warp_banded(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    max_disp: int = 8,
    tile_rows: int | None = None,
    clamp_flow: bool = False,
    max_disp_v: int | None = None,
    packed_u8: bool = False,
    packed_u16: bool = False,
    *,
    packing: str | None = None,
) -> torch.Tensor:
    """Banded warp of an (H, W) plane or a (B, H, W) batch: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Bands up
    to ``MAX_BAND`` px (the TPU kernel's limit); the packed variants need
    ``clamp_flow`` (pallas_warp.py:598-601). The kernel takes planes with
    sides under ``MAX_SIDE``; it refuses, before it launches, a band whose
    staged rows exceed the card's shared memory a block, and the wrapper
    raises."""
    packing = resolve_packing(packed_u8, packed_u16, packing)
    if max_disp_v is None:
        max_disp_v = max_disp
    check_args(image, flow_u, flow_v, max_disp, max_disp_v, packing, clamp_flow)
    if image.device.type == "cpu":
        return warp_banded_ref(image, flow_u, flow_v, max_disp, clamp_flow=clamp_flow,
                               max_disp_v=max_disp_v, packing=packing)

    lib = _build.load()
    h, w = image.shape[-2:]
    batch = image.shape[0] if image.ndim == 3 else 1
    out = torch.empty_like(image)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    args = (image.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(), out.data_ptr(),
            batch, h, w, max_disp, max_disp_v, PACKINGS[packing], int(clamp_flow))
    code = lib.tpuflow_warp_banded(*args, stream)
    name = _COUNTER[packing]
    _build.check(lib, code, name)
    launch_counts[name] += 1
    return out


# The reference's name (``pallas_warp.warp_image_banded``): the same function.
warp_image_banded = warp_banded


def _check_round(image, flow_u, flow_v, out, latch, band, ladder, max_disp, packing) -> None:
    if not 1 <= len(ladder) <= MAX_LADDER:
        raise ValueError(f"a band ladder holds 1..{MAX_LADDER} bands, got {ladder}")
    if band is None and len(ladder) != 1:
        raise ValueError("a ladder of several bands needs a band index")
    check_args(image, flow_u, flow_v, max_disp, max(ladder), packing, True)
    if min(ladder) < 0:
        raise ValueError(f"banded warp supports bands of 0..{MAX_BAND} px")
    batch = image.shape[0] if image.ndim == 3 else 1
    if out.shape != image.shape or out.dtype != torch.float32 or out.device != image.device:
        raise ValueError("out must be a float32 tensor of the image's shape and device")
    if latch.dtype != torch.int32 or latch.numel() != batch or latch.device != image.device:
        raise ValueError("latch must hold one int32 flag per plane on the image's device")
    if band is not None and (band.dtype != torch.int32 or band.numel() not in (1, batch)
                             or band.device != image.device):
        raise ValueError("band must be an int32 tensor on the image's device holding one index, "
                         "or one a plane of the batch")
    if image.device.type == "cuda" and not (out.is_contiguous() and latch.is_contiguous()
                                            and (band is None or band.is_contiguous())):
        raise ValueError("the CUDA warp needs contiguous tensors")


def warp_round_ref(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    out: torch.Tensor,
    latch: torch.Tensor,
    *,
    max_disp: int,
    ladder: tuple[int, ...],
    band: torch.Tensor | None = None,
    packing: str = "exact",
) -> torch.Tensor:
    """Plain PyTorch version of ``warp_round``: the clamped warp at band
    ``ladder[band]`` (a plane's own where ``band`` holds one index a
    plane) written into ``out`` where ``latch`` is 0, ``out`` kept where it
    is set."""
    mdv = torch_ref.ladder_value(band, ladder, torch.int32, image.device)
    warped = warp_banded_ref(image, flow_u, flow_v, max_disp, clamp_flow=True, max_disp_v=mdv,
                             packing=packing)
    skip = (latch != 0).reshape((-1, 1, 1) if image.ndim == 3 else ())
    out.copy_(torch.where(skip, out, warped))
    return out


def warp_round(
    image: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    out: torch.Tensor,
    latch: torch.Tensor,
    *,
    max_disp: int,
    ladder: tuple[int, ...],
    band: torch.Tensor | None = None,
    packing: str = "exact",
) -> torch.Tensor:
    """One round's warp under device control, into ``out``: the flow
    clamped to ``max_disp`` and ``ladder[band]`` (``band`` an int32 tensor
    on the device, one index for every plane or, for a (B, H, W) batch of
    independent streams, a (B,) one, plane b at ``ladder[band[b]]``; None
    takes ``ladder[0]``), skipped where the int32 ``latch`` of a plane is
    set. The CUDA kernel for CUDA tensors (one launch), the plain version
    for CPU tensors. Neither reads a flag to the host."""
    _check_round(image, flow_u, flow_v, out, latch, band, ladder, max_disp, packing)
    if image.device.type == "cpu":
        return warp_round_ref(image, flow_u, flow_v, out, latch, max_disp=max_disp,
                              ladder=ladder, band=band, packing=packing)

    lib = _build.load()
    h, w = image.shape[-2:]
    batch = image.shape[0] if image.ndim == 3 else 1
    stream = torch.cuda.current_stream(image.device).cuda_stream
    bands = (ctypes.c_int * len(ladder))(*ladder)
    code = lib.tpuflow_warp_round(
        image.data_ptr(), flow_u.data_ptr(), flow_v.data_ptr(), out.data_ptr(),
        latch.data_ptr(), None if band is None else band.data_ptr(),
        0 if band is None else band.numel(), bands, len(ladder), batch, h, w, max_disp,
        PACKINGS[packing], stream)
    name = _COUNTER[packing]
    _build.check(lib, code, name)
    launch_counts[name] += 1
    return out
