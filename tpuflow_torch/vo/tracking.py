"""Flow-based feature tracking (the VO front end).

Counterpart of ``tpuflow.vo.tracking``: features are seeded one per grid
cell at the cell's best Shi-Tomasi corner (the minimum eigenvalue of the
5x5 structure tensor the LK solve builds) and advanced each frame by
bilinear sampling of the dense flow. Every shape is static (a fixed track
table with a validity mask), so a step reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpuflow_torch.core import ops
from tpuflow_torch.kernels import torch_ref


class Tracks(NamedTuple):
    """A fixed-capacity track table."""

    xy: torch.Tensor        # (N, 2) float32 current positions (x, y)
    start_xy: torch.Tensor  # (N, 2) positions at spawn time
    age: torch.Tensor       # (N,) int32 frames tracked
    alive: torch.Tensor     # (N,) bool validity


def shi_tomasi_response(frame: torch.Tensor, window: int = 5) -> torch.Tensor:
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


def seed_grid(
    frame: torch.Tensor,
    grid_step: int = 16,
    min_response: float = 1.0,
    margin: int = 0,
) -> Tracks:
    """Seed one feature per grid cell at the cell's best corner.

    ``margin`` excludes a border stripe: cells straddling it pick their
    best corner outside it, cells inside it seed nothing. The argmax keeps
    the reference's first-occurrence tie-break: the smallest row-major
    index in the cell among its maxima, so a cell that is all ``-inf``
    picks index 0.
    """
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
    best_resp = cell_max.reshape(gy * gx)
    cell = torch.arange(gy * gx, device=dev)
    x = (cell % gx) * s + best % s
    y = (cell // gx) * s + best // s
    xy = torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=1)
    return Tracks(
        xy=xy,
        start_xy=xy,
        age=torch.zeros(gy * gx, dtype=torch.int32, device=dev),
        alive=best_resp > min_response,
    )


def sample_flow(flow_u: torch.Tensor, flow_v: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear flow sample at (N, 2) positions -> (N, 2) (du, dv).

    ``ops.map_coordinates_bilinear``'s values (clamped corners, its lerp
    order, zero outside the plane) from one flattened gather per plane."""
    h, w = flow_u.shape
    x, y = xy[:, 0], xy[:, 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f).to(flow_u.dtype)[:, None]
    fy = (y - y0f).to(flow_u.dtype)[:, None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    cx0 = x0.clamp(0, w - 1)
    cx1 = (x0 + 1).clamp(0, w - 1)
    cy0 = y0.clamp(0, h - 1)
    cy1 = (y0 + 1).clamp(0, h - 1)
    idx = torch.cat([cy0 * w + cx0, cy0 * w + cx1, cy1 * w + cx0, cy1 * w + cx1])
    n = xy.shape[0]
    gu = flow_u.reshape(-1)[idx].reshape(4, n)
    gv = flow_v.reshape(-1)[idx].reshape(4, n)
    g = torch.stack([gu, gv], dim=2)  # (4, N, 2)
    top = g[0] * (1.0 - fx) + g[1] * fx
    bot = g[2] * (1.0 - fx) + g[3] * fx
    val = top * (1.0 - fy) + bot * fy
    inside = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    return torch.where(inside[:, None], val, 0.0)


def advance(
    tracks: Tracks, flow_u: torch.Tensor, flow_v: torch.Tensor, margin: int = 3
) -> Tracks:
    """Move tracks by the dense flow; kill tracks that leave the frame."""
    h, w = flow_u.shape
    xy = tracks.xy + sample_flow(flow_u, flow_v, tracks.xy)
    inside = (
        (xy[:, 0] >= margin)
        & (xy[:, 0] <= w - 1 - margin)
        & (xy[:, 1] >= margin)
        & (xy[:, 1] <= h - 1 - margin)
    )
    alive = tracks.alive & inside
    return Tracks(
        xy=torch.where(alive[:, None], xy, tracks.xy),
        start_xy=tracks.start_xy,
        age=torch.where(alive, tracks.age + 1, tracks.age),
        alive=alive,
    )


def forward_backward_check(
    tracks: Tracks,
    prev_xy: torch.Tensor,
    flow_bwd_u: torch.Tensor,
    flow_bwd_v: torch.Tensor,
    threshold: float = 1.0,
) -> Tracks:
    """Kill tracks whose round trip (forward flow, then the backward flow
    sampled at the new position) misses the start by more than
    ``threshold`` px."""
    back = sample_flow(flow_bwd_u, flow_bwd_v, tracks.xy)
    d = tracks.xy + back - prev_xy
    err = torch.sqrt((d * d).sum(dim=1))
    return tracks._replace(alive=tracks.alive & (err <= threshold))
