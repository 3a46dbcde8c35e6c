"""The VO front end's grid seed: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``tpuflow.vo.tracking.seed_grid`` (jnp in the reference; no
Pallas kernel): one feature per ``grid_step`` cell at the cell's best
Shi-Tomasi corner (the minimum eigenvalue of the 5x5 structure tensor),
the cells in row-major order. ``margin`` excludes a border stripe: cells
straddling it pick their best corner outside it, cells inside it seed
nothing. Among a cell's maxima the smallest row-major index wins, so a
cell that is all ``-inf`` picks index 0.

``predicate`` is the reference's keyframe ``lax.cond`` (tpuflow/vo/
device_loop.py:258-301): a one-element bool tensor on the frame's device.
Where it is false the seed is not taken: every cell comes back with
``alive`` False, and ``xy`` is left undefined (the CUDA kernel reads no
frame and writes only ``alive``). ``taken``, a one-element int32 tensor
on the frame's device, gets 1 added by each call that seeds. Neither is
read to the host.

``seed_grid`` launches the CUDA kernel (``csrc/seed.cu``) for a CUDA
tensor and runs ``seed_grid_ref`` for a CPU tensor; ``seed_grid_ref``
computes the seed in plain PyTorch and applies the predicate as a select.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuflow_torch.core import ops
from tpuflow_torch.kernels import _build, torch_ref

# Kernel launches; incremented only where the kernel is launched.
launch_counts = {"seed_grid": 0}

WINDOW = 5  # the structure tensor's window (the CUDA kernel's kWindow)
# The CUDA kernel's widest cell: one block holds its columns plus the
# window's apron, 1024 threads.
MAX_GRID_STEP = 1024 - 2 * (WINDOW // 2)


def shi_tomasi_response(frame: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
    """Min-eigenvalue corner response of the window's structure tensor,
    zero on the ``window // 2`` border."""
    ix, iy, _ = torch_ref.compute_gradients(frame, frame)
    half = window // 2
    s_xx = ops.uniform_window_sum_valid(ix * ix, window)
    s_yy = ops.uniform_window_sum_valid(iy * iy, window)
    s_xy = ops.uniform_window_sum_valid(ix * iy, window)
    tr = s_xx + s_yy
    disc = torch.sqrt(torch.square(s_xx - s_yy) + 4.0 * torch.square(s_xy))
    min_eig = 0.5 * (tr - disc)
    return F.pad(min_eig, (half, half, half, half))


def seed_grid_ref(
    frame: torch.Tensor,
    grid_step: int = 16,
    min_response: float = 1.0,
    margin: int = 0,
    *,
    predicate: torch.Tensor | None = None,
    taken: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``seed_grid``: the (cells, 2) f32 corner
    positions (x, y) and the (cells,) bool ``response > min_response``,
    ``alive`` masked by ``predicate``."""
    h, w = frame.shape
    dev = frame.device
    resp = shi_tomasi_response(frame)
    if margin > 0:
        y = torch.arange(h, device=dev)[:, None]
        x = torch.arange(w, device=dev)[None, :]
        inside = (y >= margin) & (y < h - margin) & (x >= margin) & (x < w - margin)
        resp = torch.where(inside, resp, -torch.inf)
    s = grid_step
    gy, gx = h // s, w // s
    r4 = resp[: gy * s, : gx * s].reshape(gy, s, gx, s)
    cell_max = r4.amax(dim=(1, 3))
    local = torch.arange(s, device=dev)
    index = local.view(1, s, 1, 1) * s + local.view(1, 1, 1, s)
    is_max = r4 == cell_max[:, None, :, None]
    best = torch.where(is_max, index, s * s).amin(dim=(1, 3)).reshape(gy * gx)
    cell = torch.arange(gy * gx, device=dev)
    x = (cell % gx) * s + best % s
    y = (cell // gx) * s + best // s
    xy = torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=1)
    alive = cell_max.reshape(gy * gx) > min_response
    if predicate is not None:
        alive = alive & predicate.reshape(())
    if taken is not None:
        taken.add_(1 if predicate is None else predicate.reshape(taken.shape).to(torch.int32))
    return xy, alive


def _check(frame, grid_step, margin, predicate, taken) -> None:
    if frame.ndim != 2:
        raise ValueError(f"the seed takes one (H, W) frame, got shape {tuple(frame.shape)}")
    if not 1 <= grid_step <= MAX_GRID_STEP:
        raise ValueError(f"grid_step must lie in 1..{MAX_GRID_STEP}, got {grid_step}")
    if margin < 0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    if predicate is not None and (predicate.dtype != torch.bool or predicate.numel() != 1
                                  or predicate.device != frame.device):
        raise ValueError("predicate must be a one-element bool tensor on the frame's device")
    if taken is not None and (taken.dtype != torch.int32 or taken.numel() != 1
                              or taken.device != frame.device):
        raise ValueError("taken must be a one-element int32 tensor on the frame's device")
    if frame.device.type == "cpu":
        return
    if frame.device.type != "cuda":
        raise ValueError(f"unsupported device {frame.device}")
    if frame.dtype != torch.float32 or not frame.is_contiguous():
        raise ValueError("the CUDA seed needs a contiguous float32 frame")
    if min(frame.shape) < grid_step:
        raise ValueError(f"a {tuple(frame.shape)} frame holds no {grid_step}-px grid cell")
    for t in (predicate, taken):
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA seed needs contiguous predicate and taken tensors")


def seed_grid(
    frame: torch.Tensor,
    grid_step: int = 16,
    min_response: float = 1.0,
    margin: int = 0,
    *,
    predicate: torch.Tensor | None = None,
    taken: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One feature per grid cell at its best corner: (xy, alive), (cells,
    2) f32 and (cells,) bool. The CUDA kernel for a CUDA tensor (one
    launch, gated on ``predicate`` in device memory), the plain version for
    a CPU tensor; a launch that fails raises."""
    _check(frame, grid_step, margin, predicate, taken)
    if frame.device.type == "cpu":
        return seed_grid_ref(frame, grid_step, min_response, margin, predicate=predicate,
                             taken=taken)
    lib = _build.load()
    h, w = frame.shape
    cells = (h // grid_step) * (w // grid_step)
    xy = torch.empty((cells, 2), dtype=torch.float32, device=frame.device)
    alive = torch.empty((cells,), dtype=torch.bool, device=frame.device)
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    code = lib.tpuflow_seed_grid(
        frame.data_ptr(), None if predicate is None else predicate.data_ptr(),
        None if taken is None else taken.data_ptr(), xy.data_ptr(), alive.data_ptr(),
        h, w, grid_step, margin, float(min_response), stream)
    _build.check(lib, code, "seed_grid")
    launch_counts["seed_grid"] += 1
    return xy, alive
