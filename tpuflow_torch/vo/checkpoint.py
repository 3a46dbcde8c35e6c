"""Checkpoint and resume for the VO session.

Counterpart of ``tpuflow.vo.checkpoint``, with ``torch.save`` in place of
Orbax. A streaming session carries runtime state (the track table, the
keyframe observation records, the last frame, the marginalization state)
that must survive an interruption at any frame boundary with results
bit-identical to a session that was never interrupted. Layout on disk:

    <path>/meta.json   static configuration (``OdometrySession.meta_dict``)
    <path>/state.pt    ``state_dict()`` as CPU tensors, one ``torch.save``

``load`` reads the tensors with ``torch.load(weights_only=True)``, which
unpickles tensors and containers only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpuflow_torch.vo.pipeline import OdometrySession

META = "meta.json"
STATE = "state.pt"


def save(session: OdometrySession, path: str) -> None:
    """Write a resumable checkpoint of ``session`` to directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {k: torch.from_numpy(np.array(v)) for k, v in session.state_dict().items()}
    torch.save(state, os.path.join(path, STATE))
    with open(os.path.join(path, META), "w") as f:
        json.dump(session.meta_dict(), f, indent=2)


def load(path: str, mesh=None, *, device: torch.device | str | None = None) -> OdometrySession:
    """Restore a session written by :func:`save` on ``device``: the card
    unless the caller names another; raises without a card. ``mesh``: the
    ``sharding.FlowMesh`` of a tiled session, a runtime context that is not
    serialized; a tiled checkpoint needs it and an untiled one refuses it
    (``ValueError``)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, STATE), map_location="cpu", weights_only=True)
    return OdometrySession.from_state(meta, {k: v.numpy() for k, v in state.items()},
                                      mesh=mesh, device=device)
