"""Keyframe pose-graph optimization over SE(3) relative-pose constraints.

Counterpart of ``tpuflow.vo.pose_graph``: Gauss-Newton over keyframe poses
with edges that measure relative transforms (odometry, loop closures,
gyro rotations), dense normal equations (6K x 6K: keyframe counts are
small) and the gauge fixed by exact elimination of node 0.

- The per-edge Jacobians are taken at the identity tangent by forward-mode
  differentiation (``torch.func.jvp`` under ``torch.func.vmap``), as the
  reference's ``jax.jacfwd``. At a perfect edge ``se3.so3_log`` takes
  ``arccos`` at exactly 1, whose derivative is infinite; that tangent
  lives only in the small-angle branch's unselected side, and forward
  mode carries a ``torch.where``'s selected tangent alone, so the
  Jacobian stays finite (the tests hold it to JAX's).
- The normal matrix and the gradient are sorted segment sums
  (``ba.segment_sum``) over the (node, node) blocks, not scatter-adds:
  on the card ``index_add_`` adds by atomics in an order that changes
  from run to run, and two solves must give the same bits.
- The solve runs with TF32 off (``pin_matmul_precision``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.vo import se3
from tpuflow_torch.vo._precision import pin_matmul_precision
from tpuflow_torch.vo.ba import segment_sum


class PoseGraph(NamedTuple):
    poses_r: torch.Tensor   # (K, 3, 3)
    poses_t: torch.Tensor   # (K, 3)
    edge_i: torch.Tensor    # (E,) int source node
    edge_j: torch.Tensor    # (E,) int target node
    edge_r: torch.Tensor    # (E, 3, 3) measured R_ij (i -> j)
    edge_t: torch.Tensor    # (E, 3) measured t_ij
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) float32 information scale
    # Optional (E, 6) per-component residual mask in (t, rot) tangent
    # order; None = every component constrained. Rotation-only factors
    # (gyro edges, ``vo.imu``) use [0, 0, 0, 1, 1, 1].
    edge_mask: torch.Tensor | None = None


def to_device(g: PoseGraph, device: torch.device) -> PoseGraph:
    """The graph's tensors on ``device`` (no copy where they are there)."""
    return PoseGraph(*(None if x is None else x.to(device) for x in g))


def _mask_of(g: PoseGraph) -> torch.Tensor:
    if g.edge_mask is None:
        return torch.ones((g.edge_i.shape[0], 6), dtype=torch.float32, device=g.poses_r.device)
    return g.edge_mask


def _edge_residual(xi_i, xi_j, ri, ti, rj, tj, rm, tm) -> torch.Tensor:
    """log(Z_ij^-1 T_i^-1 T_j) with tangent perturbations applied (leading
    batch dimensions allowed)."""
    ri2, ti2 = se3.retract(ri, ti, xi_i)
    rj2, tj2 = se3.retract(rj, tj, xi_j)
    rrel, trel = se3.compose(*se3.inverse(ri2, ti2), rj2, tj2)
    rerr, terr = se3.compose(*se3.inverse(rm, tm), rrel, trel)
    return torch.cat([terr, se3.so3_log(rerr)], dim=-1)


def _edge_args(g: PoseGraph):
    ei, ej = g.edge_i.long(), g.edge_j.long()
    return g.poses_r[ei], g.poses_t[ei], g.poses_r[ej], g.poses_t[ej], g.edge_r, g.edge_t


def residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) constraint residuals (invalid edges read 0)."""
    args = _edge_args(g)
    zero = args[1].new_zeros(args[1].shape[0], 6)
    r = _edge_residual(zero, zero, *args) * _mask_of(g)
    return torch.where(g.edge_valid[:, None], r, 0.0)


def edge_jacobians(g: PoseGraph) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-edge residual (E, 6) and its (E, 6, 6) Jacobians with respect to
    the tangents of node i and node j, at the identity tangent, unmasked.

    An edge's residual depends on its own two tangents only, so one
    forward-mode product with the same basis direction on every edge gives
    that column of every edge's Jacobian: twelve products, batched by
    ``vmap``. (``jacfwd`` of a single edge under ``vmap`` would take
    ``arccos`` of 0-d tensors, whose forward derivative PyTorch promotes
    to float64.)"""
    args = _edge_args(g)
    zero = args[1].new_zeros(args[1].shape[0], 6)

    def column(d):
        return jvp(lambda a, b: _edge_residual(a, b, *args), (zero, zero),
                   (d[:6].expand_as(zero), d[6:].expand_as(zero)))[1]

    cols = vmap(column)(torch.eye(12, dtype=zero.dtype, device=zero.device))  # (12, E, 6)
    jac = cols.permute(1, 2, 0)
    return _edge_residual(zero, zero, *args), jac[..., :6], jac[..., 6:]


@pin_matmul_precision
def gauss_newton_step(
    g: PoseGraph, damping: float = 1e-6, num_nodes: int | None = None
) -> PoseGraph:
    k = num_nodes or g.poses_r.shape[0]
    res, ji, jj = edge_jacobians(g)
    mask = _mask_of(g)
    res = res * mask
    ji = ji * mask[:, :, None]
    jj = jj * mask[:, :, None]
    w = torch.where(g.edge_valid, g.edge_weight, 0.0)[:, None, None]

    jit, jjt = ji.transpose(1, 2), jj.transpose(1, 2)
    hii = (jit @ ji) * w
    hjj = (jjt @ jj) * w
    hij = (jit @ jj) * w
    bi = -(jit @ res[..., None])[..., 0] * w[:, :, 0]
    bj = -(jjt @ res[..., None])[..., 0] * w[:, :, 0]

    # The four block sets of the reference's scatter-adds, summed by
    # (row node, column node) key in a fixed order.
    ei, ej = g.edge_i.long(), g.edge_j.long()
    keys = torch.cat([ei * k + ei, ej * k + ej, ei * k + ej, ej * k + ei])
    blocks = torch.cat([hii, hjj, hij, hij.transpose(1, 2)])
    h = segment_sum(blocks, keys, k * k).reshape(k, k, 6, 6).permute(0, 2, 1, 3)
    b = segment_sum(torch.cat([bi, bj]), torch.cat([ei, ej]), k)

    eye = torch.eye(6 * k, dtype=h.dtype, device=h.device)
    hd = h.reshape(6 * k, 6 * k) + damping * eye
    # Gauge fixing by exact elimination: node 0 gets dx = 0.
    hd[:6, :] = 0.0
    hd[:, :6] = 0.0
    hd[:6, :6] = eye[:6, :6]
    bb = b.reshape(6 * k).clone()
    bb[:6] = 0.0

    dx = torch.linalg.solve(hd, bb).reshape(k, 6)
    new_r, new_t = se3.retract(g.poses_r, g.poses_t, dx)
    return g._replace(poses_r=new_r, poses_t=new_t)


def solve(
    g: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    *,
    device: torch.device | str | None = None,
) -> PoseGraph:
    """``iterations`` Gauss-Newton steps on ``device``: the card unless the
    caller names another; raises without a card. The graph is moved there
    first."""
    g = to_device(g, resolve_device(device))
    for _ in range(iterations):
        g = gauss_newton_step(g, damping=damping)
    return g


def constant_velocity_edges(g: PoseGraph, weight: float = 0.25) -> PoseGraph:
    """Append soft constant-velocity motion-prior edges.

    For each consecutive node triple (k-1, k, k+1) an edge (k, k+1) whose
    measurement is the current estimate of ``T_{k-1}^-1 T_k``: the camera
    keeps doing what it just did. Append after initializing the poses and
    before ``solve`` (the measurement anchors to the estimate now)."""
    k = g.poses_r.shape[0]
    if k < 3:
        return g
    dev = g.poses_r.device
    pred_r, pred_t = se3.compose(*se3.inverse(g.poses_r[:-2], g.poses_t[:-2]),
                                 g.poses_r[1:-1], g.poses_t[1:-1])
    idx = torch.arange(k - 2, dtype=g.edge_i.dtype, device=dev)
    return g._replace(
        edge_i=torch.cat([g.edge_i, idx + 1]),
        edge_j=torch.cat([g.edge_j, idx + 2]),
        edge_r=torch.cat([g.edge_r, pred_r]),
        edge_t=torch.cat([g.edge_t, pred_t]),
        edge_valid=torch.cat([g.edge_valid, torch.ones(k - 2, dtype=torch.bool, device=dev)]),
        edge_weight=torch.cat(
            [g.edge_weight, torch.full((k - 2,), float(weight), dtype=torch.float32, device=dev)]
        ),
        edge_mask=None if g.edge_mask is None else torch.cat(
            [g.edge_mask, torch.ones((k - 2, 6), dtype=torch.float32, device=dev)]
        ),
    )
