"""Optical-flow accuracy metrics (MAE / RMSE / EPE / AAE).

A copy of ``tpuflow.eval.metrics`` (numpy only), so the port scores flow
without importing ``tpuflow``, whose package imports JAX. Same masking and
edge-case semantics as the reference metrics library (reference:
python/flow_metrics.py:14-201), so the regression gate compares like with
like.
"""

from __future__ import annotations

import numpy as np


def _masked(u_pred, v_pred, mask):
    u = np.asarray(u_pred, dtype=np.float32)
    v = np.asarray(v_pred, dtype=np.float32)
    if mask is None:
        return u.ravel(), v.ravel()
    return u[mask], v[mask]


def mean_absolute_error(u_pred, v_pred, u_true, v_true, mask=None):
    """Per-component MAE (reference: flow_metrics.py:14-40)."""
    u, v = _masked(u_pred, v_pred, mask)
    return float(np.mean(np.abs(u - u_true))), float(np.mean(np.abs(v - v_true)))


def root_mean_square_error(u_pred, v_pred, u_true, v_true, mask=None):
    """RMSE of flow error magnitude (reference: flow_metrics.py:43-70)."""
    u, v = _masked(u_pred, v_pred, mask)
    sq = (u - u_true) ** 2 + (v - v_true) ** 2
    return float(np.sqrt(np.mean(sq)))


def endpoint_error(u_pred, v_pred, u_true, v_true, mask=None):
    """Average endpoint error (reference: flow_metrics.py:73-103)."""
    u, v = _masked(u_pred, v_pred, mask)
    epe = np.sqrt((u - u_true) ** 2 + (v - v_true) ** 2)
    return float(np.mean(epe))


def angular_error(u_pred, v_pred, u_true, v_true, mask=None):
    """Average angular error in (u, v, 1) space, degrees (reference:
    flow_metrics.py:106-163), including the both-near-zero early return."""
    u, v = _masked(u_pred, v_pred, mask)

    mag_true = np.sqrt(u_true**2 + v_true**2)
    mag_pred = np.sqrt(u**2 + v**2)
    if mag_true < 1e-6 and np.all(mag_pred < 1e-6):
        return 0.0

    norm_pred = np.sqrt(u**2 + v**2 + 1.0)
    norm_true = np.sqrt(u_true**2 + v_true**2 + 1.0)
    dot = (u * u_true + v * v_true + 1.0) / (norm_pred * norm_true)
    dot = np.clip(dot, -1.0, 1.0)
    return float(np.mean(np.rad2deg(np.arccos(dot))))


def compute_all_metrics(u_pred, v_pred, u_true, v_true, mask=None):
    """All standard metrics as a dict (reference: flow_metrics.py:166-201)."""
    mae_u, mae_v = mean_absolute_error(u_pred, v_pred, u_true, v_true, mask)
    return {
        "mae_u": mae_u,
        "mae_v": mae_v,
        "rmse": root_mean_square_error(u_pred, v_pred, u_true, v_true, mask),
        "epe": endpoint_error(u_pred, v_pred, u_true, v_true, mask),
        "aae": angular_error(u_pred, v_pred, u_true, v_true, mask),
    }


def compute_all_metrics_dense(u_pred, v_pred, u_true, v_true, mask=None):
    """Metrics against a dense per-pixel ground-truth field.

    Same formulas as :func:`compute_all_metrics` with (u_true, v_true)
    as (H, W) arrays (tpuflow.eval.patterns.dense_ground_truth) —
    the exact spatially-varying field for rotation/zoom/combined
    patterns, where the suite's scalar ground truth only holds at the
    frame center. No reference counterpart (the reference scores those
    patterns on a center crop instead); extra opt-in column, not part of
    the baseline regression gate.
    """
    u, v = _masked(u_pred, v_pred, mask)
    ut, vt = _masked(u_true, v_true, mask)
    du = u - ut
    dv = v - vt
    epe = np.sqrt(du**2 + dv**2)

    mag_true = np.sqrt(ut**2 + vt**2)
    mag_pred = np.sqrt(u**2 + v**2)
    if np.all(mag_true < 1e-6) and np.all(mag_pred < 1e-6):
        aae = 0.0
    else:
        norm_pred = np.sqrt(u**2 + v**2 + 1.0)
        norm_true = np.sqrt(ut**2 + vt**2 + 1.0)
        dot = np.clip(
            (u * ut + v * vt + 1.0) / (norm_pred * norm_true), -1.0, 1.0
        )
        aae = float(np.mean(np.rad2deg(np.arccos(dot))))
    return {
        "mae_u": float(np.mean(np.abs(du))),
        "mae_v": float(np.mean(np.abs(dv))),
        "rmse": float(np.sqrt(np.mean(du**2 + dv**2))),
        "epe": float(np.mean(epe)),
        "aae": aae,
    }
