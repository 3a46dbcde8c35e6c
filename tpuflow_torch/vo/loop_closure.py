"""Appearance-based loop closure for the VO back end.

Counterpart of ``tpuflow.vo.loop_closure``. Keyframes get a compact
appearance descriptor (a mean-pooled, zero-mean, unit-norm thumbnail);
revisits are found by cosine similarity with a temporal-separation guard;
each accepted pair adds a measured relative-pose edge to the pose graph
(``vo.pose_graph``), which is what cancels accumulated drift.

``keyframe_descriptor`` and ``detect_loops`` are numpy, copies of the
reference's. ``loop_edge`` runs the port's flow and tracking on the
frames' device and reads back only what the host decides on: the alive
mask and the two position tables, then, on the essential branch, the
relative pose and its vote.

Monocular scale: a loop edge's translation magnitude is not observable
from the pair alone; it comes from the median flow shift at the session's
depth gauge (``depth / f``), exact for fronto-parallel structure and a
good approximation for the small-baseline revisits loop closure catches.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.kernels import seed
from tpuflow_torch.vo import epipolar, tracking


def keyframe_descriptor(frame: np.ndarray, size: int = 16) -> np.ndarray:
    """(H, W) grayscale -> (size*size,) L2-normalized thumbnail descriptor:
    mean-pooled to a size x size thumbnail (remainder cropped), then zero
    mean and unit norm, so matching ignores global gain and offset."""
    f = np.asarray(frame, np.float32)
    h, w = f.shape
    by, bx = max(h // size, 1), max(w // size, 1)
    gy, gx = h // by, w // bx
    pooled = f[: gy * by, : gx * bx].reshape(gy, by, gx, bx).mean(axis=(1, 3))
    # Center-crop the pooled grid to exactly (size, size).
    oy = max((gy - size) // 2, 0)
    ox = max((gx - size) // 2, 0)
    pooled = pooled[oy : oy + size, ox : ox + size]
    d = pooled.reshape(-1)
    d = d - d.mean()
    n = np.linalg.norm(d)
    return (d / n if n > 1e-9 else d).astype(np.float32)


def detect_loops(
    descriptors: np.ndarray,
    min_separation: int = 4,
    threshold: float = 0.95,
    max_pairs: int = 8,
) -> list[tuple[int, int, float]]:
    """Up to ``max_pairs`` revisit candidates (i, j, similarity) among (K, D)
    descriptors, j - i >= ``min_separation`` and cosine similarity at least
    ``threshold``: each j matched to its best earlier i, sorted by
    similarity."""
    k = len(descriptors)
    if k < min_separation + 1:
        return []
    sim = descriptors @ descriptors.T
    pairs: list[tuple[int, int, float]] = []
    for j in range(min_separation, k):
        cands = sim[j, : j - min_separation + 1]
        i = int(np.argmax(cands))
        s = float(cands[i])
        if s >= threshold:
            pairs.append((i, j, s))
    pairs.sort(key=lambda p: -p[2])
    return pairs[:max_pairs]


def loop_edge(
    frame_i,
    frame_j,
    intrinsics,
    flow_fn,
    depth: float = 5.0,
    grid_step: int = 16,
    fb_threshold: float = 1.5,
    min_baseline_px: float = 2.0,
    *,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """The relative pose (R_ij, t_ij, support) of a loop pair, or None.

    Dense flow i -> j (``flow_fn``, on ``device``: the card unless the
    caller names another), grid-seeded tracks advanced and culled by a
    forward-backward check, then:

    - median displacement < ``min_baseline_px``: a near-zero-baseline
      revisit, whose essential rotation is degenerate: R = I and t = the
      median shift lifted through ``depth``;
    - otherwise rotation and translation direction from the essential
      pipeline (``vo.epipolar``), magnitude from the median shift.

    None when fewer than 16 tracks survive, or too few support the
    essential decomposition.
    """
    dev = resolve_device(device)
    fi, fj = (torch.as_tensor(f if isinstance(f, torch.Tensor) else np.asarray(f, np.float32),
                              dtype=torch.float32, device=dev) for f in (frame_i, frame_j))
    u, v = flow_fn(fi, fj)
    tracks = tracking.tracks_at(*seed.seed_grid(fi, grid_step=grid_step))
    prev_xy = tracks.xy
    adv = tracking.advance(tracks, u, v)
    ub, vb = flow_fn(fj, fi)
    adv = tracking.forward_backward_check(adv, prev_xy, ub, vb, threshold=fb_threshold)
    # One read: the alive mask as floats beside both position tables.
    host = torch.cat([prev_xy, adv.xy, adv.alive[:, None].to(torch.float32)], dim=1).cpu().numpy()
    uv1, uv2, alive = host[:, :2], host[:, 2:4], host[:, 4] > 0
    n_alive = int(alive.sum())
    if n_alive < 16:
        return None
    fx, fy = float(intrinsics[0]), float(intrinsics[1])
    med = np.median((uv2 - uv1)[alive], axis=0)
    shift = float(np.hypot(*med))
    # Content shifting by (dx, dy) at depth Z <=> t_ij = +(dx Z / fx, dy Z / fy)
    # (world->camera convention: x_j = R x_i + t).
    t_flow = np.asarray([med[0] * depth / fx, med[1] * depth / fy, 0.0], np.float32)
    if shift < min_baseline_px:
        return np.eye(3, dtype=np.float32), t_flow, n_alive
    intr = torch.as_tensor([float(x) for x in intrinsics[:4]], dtype=torch.float32, device=dev)
    init = epipolar.two_view_init(prev_xy, adv.xy, adv.alive, intr)
    n_good = int(init.n_good)
    if n_good < max(16, 0.5 * n_alive):
        return None
    mag = float(np.linalg.norm(t_flow))
    return init.r.cpu().numpy(), (init.t.cpu().numpy() * mag).astype(np.float32), n_good
