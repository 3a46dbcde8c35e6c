"""SE(3) / SO(3) utilities for the visual-odometry back end.

Counterpart of ``tpuflow.vo.se3``: rotations as 3x3 matrices, tangent
vectors as (6,) = (rho, phi) with translation first. Every function takes
leading batch dimensions (the reference ``vmap``s its single-pose
versions). The small-angle branches are ``torch.where`` selects whose
unselected side stays finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _angle(phi: torch.Tensor):
    """(theta^2, theta, big, theta^2 where big else 1) as (..., 1, 1)."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS)
    big = theta2 > _EPS
    return theta2, theta, big, torch.where(big, theta2, torch.ones_like(theta2))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix,
    Taylor-guarded near zero."""
    theta2, theta, big, safe2 = _angle(phi)
    k = hat(phi)
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / safe2, 0.5 - theta2 / 24.0)
    return _eye(phi) + a * k + b * (k @ k)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1
    )
    scale = torch.where(theta > 1e-6, theta / (2.0 * torch.sin(theta) + _EPS), 0.5)
    return scale[..., None] * w


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6) = (rho, phi) -> (R, t). First-order-exact V matrix."""
    rho, phi = xi[..., :3], xi[..., 3:]
    r = so3_exp(phi)
    theta2, theta, big, safe2 = _angle(phi)
    k = hat(phi)
    b = torch.where(big, (1.0 - torch.cos(theta)) / safe2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (safe2 * theta), 1.0 / 6.0)
    v = _eye(phi) + b * k + c * (k @ k)
    return r, (v @ rho[..., None])[..., 0]


def compose(ra, ta, rb, tb) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ra, ta) * (Rb, tb)."""
    return ra @ rb, (ra @ tb[..., None])[..., 0] + ta


def inverse(r, t) -> tuple[torch.Tensor, torch.Tensor]:
    rt = r.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def transform(r, t, points: torch.Tensor) -> torch.Tensor:
    """Apply one (R, t) to (..., 3) points."""
    return points @ r.transpose(-1, -2) + t


def retract(r, t, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-multiplicative update: exp(xi) * (R, t)."""
    dr, dt = se3_exp(xi)
    return compose(dr, dt, r, t)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), Taylor-guarded near zero (I - 0.5 hat(phi))."""
    theta2, theta, big, _ = _angle(phi)
    k = hat(phi)
    a = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5)
    b = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta + _EPS), 1.0 / 6.0)
    return _eye(phi) - a * k + b * (k @ k)
