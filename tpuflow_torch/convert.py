"""Carry configuration and stream state over from the JAX package.

The flow system has no learned weights; what crosses over is a
``PyramidConfig`` and the pyramid a stream carries from one frame to the
next. With both, a stream started in ``tpuflow`` continues here:
``np.asarray`` each level of ``tpuflow``'s ``build_gaussian_pyramid`` and
hand the list to ``pyramid_from_numpy``. A VO session's front-end state
(``front_end_state_from_reference``), a bundle-adjustment problem
(``ba_problem_from_reference``), a pose graph
(``pose_graph_from_reference``) and an IMU increment
(``imu_increment_from_reference``) cross over the same way, field by
field; a whole session crosses over from its ``meta_dict()`` and
``state_dict()`` (``session_from_reference``) and continues here.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch

from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.eval.timing import resolve_device

_FIELDS = tuple(f.name for f in dataclasses.fields(PyramidConfig))


def config_from_reference(cfg: Any) -> PyramidConfig:
    """This package's ``PyramidConfig`` from any object or mapping that has
    ``PyramidConfig``'s fields (such as ``tpuflow.core.config.PyramidConfig``).
    Missing fields raise."""
    if isinstance(cfg, Mapping):
        missing = [f for f in _FIELDS if f not in cfg]
        values = {f: cfg[f] for f in _FIELDS if f in cfg}
    else:
        missing = [f for f in _FIELDS if not hasattr(cfg, f)]
        values = {f: getattr(cfg, f) for f in _FIELDS if hasattr(cfg, f)}
    if missing:
        raise ValueError(f"config lacks PyramidConfig fields: {missing}")
    if values["adaptive_v_bands"] is not None:
        values["adaptive_v_bands"] = tuple(values["adaptive_v_bands"])
    return PyramidConfig(**values)


def pyramid_from_numpy(
    levels: Sequence[np.ndarray], device: torch.device | str | None = None
) -> list[torch.Tensor]:
    """A pyramid carry from (H, W) arrays ordered coarse first, or from
    (B, H, W) ones (a batched JAX pyramid, e.g. ``jax.vmap`` of
    ``build_gaussian_pyramid``: B streams, carried on together): float32,
    contiguous, on ``device``: the card unless the caller names another;
    raises without a card."""
    device = resolve_device(device)
    out = []
    for i, level in enumerate(levels):
        a = np.asarray(level)
        if a.ndim not in (2, 3) or (out and (a.ndim != out[-1].ndim
                                             or a.shape[:-2] != tuple(out[-1].shape[:-2]))):
            raise ValueError(f"level {i} has shape {a.shape}; (H, W), or (B, H, W) with one B "
                             "for every level, expected")
        if out and (out[-1].shape[-2] > a.shape[-2] or out[-1].shape[-1] > a.shape[-1]):
            raise ValueError("levels must be ordered coarse first")
        out.append(torch.from_numpy(np.array(a, np.float32)).to(device))
    return out


def _tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(device=device, dtype=dtype)


def front_end_state_from_reference(arrays: Any, device: torch.device | str | None = None):
    """``vo.device_loop.FrontEndState`` from a ``tpuflow`` ``FrontEndState``
    whose fields are given as arrays (``np.asarray`` each, the pyramid carry
    a sequence of levels, coarse first), or any object or mapping with those
    fields, on ``device``: the card unless the caller names another."""
    from tpuflow_torch.vo.device_loop import FrontEndState

    device = resolve_device(device)
    fields = FrontEndState._fields
    get = _getter(arrays)
    dtypes = {"xy": torch.float32, "start_xy": torch.float32, "alive": torch.bool,
              "tracking_lost": torch.bool}
    values = {
        f: _tensor(get(f), device, dtypes.get(f, torch.int32)) for f in fields if f != "carry"
    }
    return FrontEndState(carry=tuple(pyramid_from_numpy(get("carry"), device)), **values)


def ba_problem_from_reference(arrays: Any, device: torch.device | str | None = None):
    """``vo.ba.BAProblem`` from a ``tpuflow`` ``BAProblem`` whose fields are
    given as arrays (or any object or mapping with those fields), on
    ``device``: the card unless the caller names another."""
    from tpuflow_torch.vo.ba import BAProblem

    device = resolve_device(device)
    get = _getter(arrays)
    dtypes = {"obs_cam": torch.int64, "obs_lm": torch.int64, "obs_valid": torch.bool}
    return BAProblem(
        **{f: _tensor(get(f), device, dtypes.get(f, torch.float32)) for f in BAProblem._fields}
    )


def session_from_reference(meta: Mapping, state: Mapping, device: torch.device | str | None = None,
                           mesh=None):
    """``vo.pipeline.OdometrySession`` from a ``tpuflow`` session's
    ``meta_dict()`` and ``state_dict()`` (arrays, or anything ``np.asarray``
    takes), on ``device``: the card unless the caller names another. The
    reference's backend names map to this package's (``jnp`` -> ``torch``,
    ``pallas`` -> ``cuda``). A mesh-tiled session (``"tiled": true``)
    continues tiled over ``mesh``, a ``sharding.FlowMesh``, which it needs."""
    from tpuflow_torch.vo.pipeline import OdometrySession

    return OdometrySession.from_state(
        dict(meta), {k: np.asarray(v) for k, v in state.items()}, mesh=mesh, device=device
    )


def pose_graph_from_reference(arrays: Any, device: torch.device | str | None = None):
    """``vo.pose_graph.PoseGraph`` from a ``tpuflow`` ``PoseGraph`` whose
    fields are given as arrays (or any object or mapping with those fields;
    ``edge_mask`` may be absent or None), on ``device``: the card unless the
    caller names another."""
    from tpuflow_torch.vo.pose_graph import PoseGraph

    device = resolve_device(device)
    get = _getter(arrays)
    dtypes = {"edge_i": torch.int64, "edge_j": torch.int64, "edge_valid": torch.bool}
    values = {f: _tensor(get(f), device, dtypes.get(f, torch.float32))
              for f in PoseGraph._fields if f != "edge_mask"}
    mask = get("edge_mask", None)
    return PoseGraph(**values, edge_mask=None if mask is None
                     else _tensor(mask, device, torch.float32))


def imu_increment_from_reference(arrays: Any, device: torch.device | str | None = None):
    """``vo.imu.ImuIncrement`` from a ``tpuflow`` ``ImuIncrement`` whose
    fields are given as arrays (or any object or mapping with those fields;
    the bias Jacobians may be absent or None), on ``device``: the card
    unless the caller names another."""
    from tpuflow_torch.vo.imu import ImuIncrement

    device = resolve_device(device)
    get = _getter(arrays)
    values = {}
    for f in ImuIncrement._fields:
        v = get(f, None)
        if f == "n_samples":
            values[f] = int(0 if v is None else v)
        elif v is not None:
            values[f] = _tensor(v, device, torch.float32)
    return ImuIncrement(**values)


def _getter(arrays: Any):
    """``get(field, *default)`` over a mapping or an object's attributes."""
    if isinstance(arrays, Mapping):
        return lambda f, *default: arrays.get(f, *default) if default else arrays[f]
    return lambda f, *default: getattr(arrays, f, *default)
