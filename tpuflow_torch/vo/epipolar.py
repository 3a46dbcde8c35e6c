"""Essential-matrix relative-pose initialization for the VO back end.

Counterpart of ``tpuflow.vo.epipolar``: a Hartley-normalized weighted
8-point estimate with Cauchy IRLS on Sampson residuals, the 4-way
decomposition with a cheirality vote, midpoint triangulation, and
multi-view linear triangulation of every landmark. Pose convention as in
``ba``: world->camera, ``x_cam = R X + t``; the relative pose (R, t) of a
pair maps camera-1 to camera-2 coordinates, ``E = [t]x R``.

Eigenvectors and singular vectors carry a sign that LAPACK and cuSOLVER
choose differently, so E is defined up to sign. Everything downstream is
invariant to it: the Sampson residuals enter squared or as magnitudes,
``decompose_essential`` fixes det(U) = det(V) = +1, and the cheirality
vote picks the same (R, t) from the four candidates in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuflow_torch.vo._precision import pin_matmul_precision
from tpuflow_torch.vo.ba import segment_sum


class TwoViewInit(NamedTuple):
    r: torch.Tensor        # (3, 3) relative rotation cam1 -> cam2
    t: torch.Tensor        # (3,) unit-norm relative translation
    depths1: torch.Tensor  # (N,) triangulated depths in camera-1 frame
    good: torch.Tensor     # (N,) bool: positive depth in both cameras
    n_good: torch.Tensor   # () int32 cheirality vote of the winner


def normalize_pixels(uv: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(N, 2) pixel coords -> (N, 2) normalized camera coords."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=1)


def _constraint_rows(x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted (N, 9) rows of x2^T E x1 = 0, E row-major."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    a = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=1
    )
    return a * weights[:, None]


def _to_essential(e: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    uu, ss, vt = torch.linalg.svd(e)
    s = 0.5 * (ss[0] + ss[1])
    return (uu * torch.stack([s, s, torch.zeros_like(s)])) @ vt


def essential_from_correspondences(
    x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Weighted 8-point essential matrix from normalized correspondences:
    the eigenvector of A^T A with the smallest eigenvalue, projected onto
    the essential manifold."""
    a = _constraint_rows(x1, x2, weights)
    _, vecs = torch.linalg.eigh(a.T @ a)  # ascending eigenvalues
    return _to_essential(vecs[:, 0].reshape(3, 3))


def sampson_residuals(e: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar residual per match."""
    ones = torch.ones((x1.shape[0], 1), dtype=x1.dtype, device=x1.device)
    h1 = torch.cat([x1, ones], dim=1)
    h2 = torch.cat([x2, ones], dim=1)
    ex1 = h1 @ e.T   # rows E x1
    etx2 = h2 @ e    # rows E^T x2
    num = (h2 * ex1).sum(dim=1)
    den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    return num / torch.sqrt(den.clamp(min=1e-18))


def _hartley_transform(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(3, 3) similarity moving the weighted centroid to 0 and the RMS
    radius to sqrt(2)."""
    wn = w / w.sum().clamp(min=1e-6)
    c = (x * wn[:, None]).sum(dim=0)
    d = x - c
    rms = torch.sqrt((wn * (d * d).sum(dim=1)).sum() + 1e-18)
    s = 2.0 ** 0.5 / rms.clamp(min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * c[0]]),
        torch.stack([zero, s, -s * c[1]]),
        torch.stack([zero, zero, one]),
    ])


def _fundamental_ls(x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Rank-2-projected least-squares fundamental matrix."""
    a = _constraint_rows(x1, x2, weights)
    _, vecs = torch.linalg.eigh(a.T @ a)
    uu, ss, vt = torch.linalg.svd(vecs[:, 0].reshape(3, 3))
    return (uu * torch.cat([ss[:2], torch.zeros_like(ss[2:])])) @ vt


def essential_irls(
    x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, iterations: int = 6
) -> torch.Tensor:
    """Hartley-normalized 8-point plus Cauchy IRLS on Sampson residuals,
    a fixed number of rounds."""
    w0 = valid.to(x1.dtype)
    t1 = _hartley_transform(x1, w0)
    t2 = _hartley_transform(x2, w0)
    x1n = x1 * t1[0, 0] + t1[:2, 2]
    x2n = x2 * t2[0, 0] + t2[:2, 2]

    def estimate(w):
        return t2.T @ _fundamental_ls(x1n, x2n, torch.sqrt(w)) @ t1

    w = w0 / w0.sum().clamp(min=1.0)
    f = estimate(w)
    for _ in range(iterations):
        r = sampson_residuals(f, x1, x2)
        # Robust scale: 1.4826 x weighted mean |r|, a cheap MAD proxy.
        sigma = 1.4826 * (w0 * r.abs()).sum() / w0.sum().clamp(min=1.0)
        sigma = sigma.clamp(min=1e-8)
        wi = w0 * (1.0 / (1.0 + (r / (2.0 * sigma)) ** 2))
        wi = wi / wi.sum().clamp(min=1e-6)
        f = estimate(wi)
    return _to_essential(f)


def decompose_essential(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> 4 candidate (R, t): (4, 3, 3) rotations, (4, 3) unit t."""
    uu, _, vt = torch.linalg.svd(e)
    # det(U), det(V) = +1 so the candidates are proper rotations.
    uu = uu * torch.sign(torch.linalg.det(uu))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.zeros((3, 3), dtype=e.dtype, device=e.device)
    w[0, 1], w[1, 0], w[2, 2] = -1.0, 1.0, 1.0
    r1 = uu @ w @ vt
    r2 = uu @ w.T @ vt
    t = uu[:, 2]
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def triangulate(
    r: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Two-view midpoint triangulation in camera-1 coordinates (the 2x2
    normal equations of the closest points of the two rays, per point)."""
    ones = torch.ones((x1.shape[0], 1), dtype=x1.dtype, device=x1.device)
    d1 = torch.cat([x1, ones], dim=1)
    d2 = torch.cat([x2, ones], dim=1) @ r  # rows: R^T d2
    c2 = -(r.T @ t)
    a11 = (d1 * d1).sum(dim=1)
    a22 = (d2 * d2).sum(dim=1)
    a12 = -(d1 * d2).sum(dim=1)
    rhs1 = d1 @ c2
    rhs2 = -(d2 @ c2)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() > 1e-12, det, 1e-12)
    alpha = (rhs1 * a22 - a12 * rhs2) / det
    beta = (a11 * rhs2 - a12 * rhs1) / det
    p1 = alpha[:, None] * d1
    p2 = c2 + beta[:, None] * d2
    return 0.5 * (p1 + p2)


@pin_matmul_precision
def two_view_init(
    uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor, intrinsics: torch.Tensor
) -> TwoViewInit:
    """Closed-form relative pose from matched pixel observations: the
    essential matrix, its 4-way decomposition, and the candidate placing
    the most points in front of both cameras (the first such on a tie)."""
    x1 = normalize_pixels(uv1, intrinsics)
    x2 = normalize_pixels(uv2, intrinsics)
    rs, ts = decompose_essential(essential_irls(x1, x2, valid))
    points, goods = [], []
    for r, t in zip(rs, ts):
        p1 = triangulate(r, t, x1, x2)
        z2 = (p1 @ r.T + t)[:, 2]
        points.append(p1)
        goods.append((p1[:, 2] > 1e-6) & (z2 > 1e-6) & valid)
    goods_t = torch.stack(goods)
    votes = goods_t.sum(dim=1)
    best = torch.argmax(votes)
    return TwoViewInit(
        r=rs[best],
        t=ts[best],
        depths1=torch.stack(points)[best][:, 2],
        good=goods_t[best],
        n_good=votes[best].to(torch.int32),
    )


@pin_matmul_precision
def triangulate_landmarks(
    poses_r: torch.Tensor,    # (K, 3, 3) world->camera
    poses_t: torch.Tensor,    # (K, 3)
    obs_uv: torch.Tensor,     # (N, 2)
    obs_cam: torch.Tensor,    # (N,) int
    obs_lm: torch.Tensor,     # (N,) int
    obs_valid: torch.Tensor,  # (N,) bool
    intrinsics: torch.Tensor,
    n_landmarks: int,
    fallback: torch.Tensor,   # (M, 3) where triangulation is degenerate
) -> torch.Tensor:
    """Multi-view linear triangulation of every landmark (world frame).

    Each valid observation adds its two DLT rows to its landmark's 3x3
    normal system (sorted segment sums, ``ba.segment_sum``). Landmarks
    whose system is near-singular or that land behind an observing camera
    take ``fallback``."""
    x = normalize_pixels(obs_uv, intrinsics)
    cam = obs_cam.to(torch.int64)
    lm = obs_lm.to(torch.int64)
    r = poses_r[cam]
    t = poses_t[cam]
    row1 = x[:, 0:1] * r[:, 2] - r[:, 0]
    row2 = x[:, 1:2] * r[:, 2] - r[:, 1]
    c1 = x[:, 0] * t[:, 2] - t[:, 0]
    c2 = x[:, 1] * t[:, 2] - t[:, 1]
    w = obs_valid.to(x.dtype)[:, None]

    def outer(rows, c):
        return rows[:, :, None] * rows[:, None, :] * w[:, :, None], -rows * c[:, None] * w

    a1, b1 = outer(row1, c1)
    a2, b2 = outer(row2, c2)
    ata = segment_sum(a1 + a2, lm, n_landmarks)
    atb = segment_sum(b1 + b2, lm, n_landmarks)

    # Solvable: smallest eigenvalue away from zero relative to the largest.
    evals = torch.linalg.eigvalsh(ata)
    ok = evals[:, 0] > 1e-4 * evals[:, 2].clamp(min=1e-12)
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    sol = torch.linalg.solve_ex(ata + 1e-9 * eye, atb[:, :, None])[0][:, :, 0]

    # Cheirality: every observing camera must see z > 0.
    z_obs = (r[:, 2] * sol[lm]).sum(dim=1) + t[:, 2]
    bad_obs = (z_obs <= 1e-3) & obs_valid
    n_bad = segment_sum(bad_obs.to(x.dtype), lm, n_landmarks)
    ok = ok & (n_bad == 0) & torch.isfinite(sol).all(dim=1)
    return torch.where(ok[:, None], sol, fallback)
