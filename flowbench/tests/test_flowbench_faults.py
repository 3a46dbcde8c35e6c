"""The harness sees ``correct`` come out false when the timed path is
broken underneath it: the rest of a run (the CPU rehearsal, which skips
the look for a card) driven with the program's step replaced by a faulty
one, once for each fault that a flow cell can have:

- a step that returns its state unchanged: the carry (the previous frame's
  pyramid) is never replaced, so every flow is taken from the first frame;
- half of the batch left out: the second half of the cameras' flows are
  never computed (zeros);
- an answer altered where it is produced: one camera's u moved by 0.5 px
  over a quarter of its frame.

One chip holds the whole state, so no exchange between chips can be left
out. The unbroken run passes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench import run as fbrun  # noqa: E402


def _stale_carry(step):
    def broken(pyr_prev, frame, cfg, **kw):
        u, v, _ = step(pyr_prev, frame, cfg, **kw)
        return u, v, pyr_prev
    return broken


def _half_batch(step):
    def broken(pyr_prev, frame, cfg, **kw):
        u, v, pyr = step(pyr_prev, frame, cfg, **kw)
        half = u.shape[0] // 2
        u, v = u.clone(), v.clone()
        u[half:] = 0.0
        v[half:] = 0.0
        return u, v, pyr
    return broken


def _altered(step):
    def broken(pyr_prev, frame, cfg, **kw):
        u, v, pyr = step(pyr_prev, frame, cfg, **kw)
        u = u.clone()
        h, w = u.shape[-2:]
        u[0, : h // 2, : w // 2] += 0.5
        return u, v, pyr
    return broken


@pytest.mark.parametrize("fault", [None, _stale_carry, _half_batch, _altered],
                         ids=["sound", "state_unchanged", "half_batch", "answer_altered"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    from tpuflow_torch.flow import pyramidal

    if fault is not None:
        monkeypatch.setattr(pyramidal, "lucas_kanade_pyramidal_step",
                            fault(pyramidal.lucas_kanade_pyramidal_step))
    torch.manual_seed(0)
    out = fbrun.run("prod1080-b16-motion", 2147484101, 1.0, False, "cpu")
    assert out["correct"] is (fault is None), out["checks"]
    if fault is not None:
        assert out["failed"] > 0
