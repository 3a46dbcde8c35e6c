"""Whether the timed steps' flow is right: each kept step's flow, every
element of its batch, against the plain reference run on the same raw
8-bit frames that the harness handed to the program.

For each element the endpoint error e = |(u, v) - (u_ref, v_ref)| is taken
at every pixel; the numbers compared are the worst element's readings:

- ``epe_p99_px``: the 99th percentile of e over the frame;
- ``epe_mean_inner_px``: the mean of e over the frame without its
  ``INNER_MARGIN_PX`` border.

Each has a limit in the configuration's file (``checks``); a run is
correct where it compared at least one element and every number is within
its limit. Two more readings are kept for the calibration and not
compared: ``epe_mean_px`` (the whole frame's mean) and ``share_over_0.1px``.
Both swing from seed to seed with a few hundred border pixels where the
flow is ill-posed (the warp reads zeros past the frame's edge; vectors of
up to 36 px were seen within 28 px of an edge) and where a float32
rounding difference sends the solve elsewhere; the two compared numbers
are steady.
"""

from __future__ import annotations

import numpy as np
import torch

from flowbench.harness.frames import ring_index

NUMBERS = ("epe_p99_px", "epe_mean_inner_px")
INNER_MARGIN_PX = 32


def readings(u: torch.Tensor, v: torch.Tensor, u_ref: torch.Tensor,
             v_ref: torch.Tensor) -> dict[str, float]:
    plane = torch.sqrt((u - u_ref) ** 2 + (v - v_ref) ** 2)
    m = INNER_MARGIN_PX
    e = plane.flatten()
    # The percentile by sorting (torch.quantile refuses large inputs).
    p99 = torch.sort(e).values[min(int(0.99 * (e.numel() - 1) + 0.5), e.numel() - 1)]
    return {
        "epe_p99_px": float(p99),
        "epe_mean_inner_px": float(plane[m:-m, m:-m].mean()),
        "epe_mean_px": float(e.mean()),
        "share_over_0.1px": float((e > 0.1).to(torch.float32).mean()),
    }


def _nearest(u: torch.Tensor, v: torch.Tensor, answers: list) -> dict:
    """The readings against the reference's answer nearest to (u, v): the
    reference returns more than one only where a latch or band decision lay
    within rounding of its threshold."""
    rows = [dict(readings(u, v, u_ref, v_ref), ref=info) for u_ref, v_ref, info in answers]
    best = min(rows, key=lambda r: (r["epe_mean_inner_px"], r["epe_p99_px"]))
    return dict(best, answers=len(rows))


def compare(kept: list, ring: np.ndarray, pyr: dict, ref, device: torch.device,
            control: bool = False) -> list[dict]:
    """One reading a (step, element) of ``kept``: (global step, u, v) as
    the timed path returned them; the step's frames are ring frames
    ``ring_index(step - 1)`` and ``ring_index(step)``. ``control`` adds the
    control's readings: the reference in TF32 against the reference."""
    out = []
    n = ring.shape[0]
    for k, u, v in kept:
        for b in range(ring.shape[1]):
            prev = torch.from_numpy(ring[ring_index(k - 1, n), b]).to(device, torch.float32)
            curr = torch.from_numpy(ring[ring_index(k, n), b]).to(device, torch.float32)
            answers = ref.flows(prev, curr, pyr)
            ub, vb = (u[b], v[b]) if u.ndim == 3 else (u, v)
            row = dict(_nearest(ub.to(device), vb.to(device), answers), step=k, element=b)
            if control:  # the reference in TF32 put in the program's place
                u_c, v_c, _ = ref.flow(prev, curr, pyr, control=True)
                row["control"] = _nearest(u_c, v_c, answers)
            out.append(row)
    return out


def judge(rows: list[dict], limits: dict[str, float]) -> dict:
    """The worst reading of each number beside its limit, whether every one
    holds, and the elements that fail one."""
    numbers = {}
    for name in NUMBERS:
        worst = max((r[name] for r in rows), default=None)
        numbers[name] = {"value": worst, "limit": limits[name]}
    failed = sum(any(r[name] > limits[name] for name in NUMBERS) for r in rows)
    correct = bool(rows) and failed == 0
    return {"correct": correct, "failed": failed, "numbers": numbers}
