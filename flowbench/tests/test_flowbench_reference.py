"""The benchmark's plain reference and its roofline arithmetic, on the CPU.

- The reference (``flowbench/reference/pyramidal_lk.py``) against the
  port's eager fast path (``backend="cuda"`` on CPU tensors runs the
  kernels' plain versions) at 320x240, both configurations, B=1 and B=3.
  The reference copies the equations in the same float32 expression order;
  only the pyramid's matmuls are blocked otherwise (dense here, banded row
  and column blocks in the port), which moves a flow by float32 rounding
  at most: 1e-4 px is ~100 ulps of a 1-8 px flow.
- The control (the reference with TF32 matmuls, emulated on the CPU) is
  refused by the cell's limits, and the reference itself passes them.
- The frozen bytes model against ``tpuflow_torch.eval.bounds`` at the
  1080p and 4K plane sizes.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench import run as fbrun  # noqa: E402
from flowbench.harness import check, frames, roofline, spec  # noqa: E402

CONFIGS = {"lk-production-1080p": "b16-motion", "lk-default-4k": "b1-motion"}
FLOW_TOL_PX = 1e-4


def _config(name: str) -> dict:
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def _ring(traffic: str, streams: int, height: int, width: int, seed: int) -> np.ndarray:
    t = dict(spec.load_json(spec.BENCH_DIR / "traffic" / f"{traffic}.json"), streams=streams)
    return frames.make_ring(t, height, width, seed, torch.device("cpu"))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("batch", [1, 3])
def test_reference_matches_eager_fast_path(config, batch):
    from tpuflow_torch.flow import pyramidal

    conf = _config(config)
    ring = _ring(CONFIGS[config], 3, 240, 320, seed=2147483659)
    ref = spec.reference(conf)
    for a, b in ((0, 1), (5, 4)):
        prev = torch.from_numpy(ring[a, :batch]).to(torch.float32)
        curr = torch.from_numpy(ring[b, :batch]).to(torch.float32)
        if batch == 1:
            prev, curr = prev[0], curr[0]
        u, v = pyramidal.lucas_kanade_pyramidal(prev, curr, config=fbrun._pyramid_config(conf),
                                                backend="cuda")
        for i in range(batch):
            ui, vi = (u[i], v[i]) if batch > 1 else (u, v)
            pi, ci = (prev[i], curr[i]) if batch > 1 else (prev, curr)
            ur, vr, info = ref.flow(pi, ci, conf["pyramid"])
            err = torch.sqrt((ui - ur) ** 2 + (vi - vr) ** 2)
            assert float(err.max()) <= FLOW_TOL_PX, (config, batch, i, float(err.max()))
            assert info["rounds"] == [3, 3, 3]  # moving pairs run every round


def test_config_files_are_the_named_pyramids():
    from tpuflow_torch.core.config import PYRAMID_CONFIGS

    for name, named in (("lk-production-1080p", "production"), ("lk-default-4k", "default")):
        got = fbrun._pyramid_config(_config(name))
        assert dataclasses.replace(got, description="") == dataclasses.replace(
            PYRAMID_CONFIGS[named], description="")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_fails_the_limits(config):
    """The control (TF32 matmuls) against the reference at 240x320 fails a
    limit of the cell; the reference against itself passes all."""
    conf = _config(config)
    ring = _ring(CONFIGS[config], 2, 240, 320, seed=2147483677)
    ref = spec.reference(conf)
    rows, exact = [], []
    for k in (1, 2, 3):
        for b in range(2):
            prev = torch.from_numpy(ring[frames.ring_index(k - 1, 16), b]).to(torch.float32)
            curr = torch.from_numpy(ring[frames.ring_index(k, 16), b]).to(torch.float32)
            ur, vr, _ = ref.flow(prev, curr, conf["pyramid"])
            uc, vc, _ = ref.flow(prev, curr, conf["pyramid"], control=True)
            rows.append(check.readings(uc, vc, ur, vr))
            exact.append(check.readings(ur, vr, ur, vr))
    assert not check.judge(rows, conf["checks"])["correct"]
    assert check.judge(exact, conf["checks"])["correct"]


def test_tf32_rounding():
    from flowbench.reference import pyramidal_lk

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 1.0 + 3 * 2**-11])
    got = pyramidal_lk._to_tf32(x)
    # Ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9.
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-10, -3.0, 1.0 + 2**-9])
    assert torch.equal(got, want)


@pytest.mark.parametrize("height,width", [(1080, 1920), (2160, 3840)])
def test_bytes_model_matches_bounds(height, width):
    from tpuflow_torch.eval import bounds

    shapes = roofline.level_shapes(height, width, 3, 0.5)
    for h, w in shapes:
        for warp in ("warp_packed_u8", "warp_packed_u16", "warp_exact"):
            assert roofline.WARP_BYTES_PER_PIXEL * h * w == bounds.call_bytes(warp, 1, h, w)
        for refine in ("lk_refine", "lk_refine_exact"):
            assert roofline.REFINE_BYTES_PER_PIXEL * h * w == bounds.call_bytes(refine, 1, h, w)
        assert roofline.HBM_BYTES_PER_S == bounds.HBM_GBPS * 1e9
    rounds = np.array([[3, 2, 1]])
    want = sum(n * (bounds.bound_ms("warp_packed_u8", 1, h, w)
                    + bounds.bound_ms("lk_refine", 1, h, w)) / 1e3
               for n, (h, w) in zip(rounds[0], shapes))
    assert roofline.bound_s(rounds, shapes) == pytest.approx(want, rel=1e-12)


@pytest.mark.gpu
def test_control_fails_on_the_card_at_the_cells_size():
    """On the card, at the cell's own size: one seed's short run of the
    production cell passes its limits, and the control (the reference in
    TF32 put in the program's place) fails one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = fbrun.run("prod1080-b16-motion", 2147483801, 2.0, False, "cuda", control=True)
    rows = out["rows"]
    limits = spec.cell("prod1080-b16-motion").config["checks"]
    assert out["correct"]
    assert not check.judge([r["control"] for r in rows], limits)["correct"]
