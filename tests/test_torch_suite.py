"""The 13-pattern regression gate on the port: single scale through the
parity path (``backend="torch"``) and pyramidal through the fast path
(``backend="cuda"``, the kernels' plain versions on CPU tensors), scored by
the JAX package's verifier against the committed baselines at their 10%
threshold: ``pallas_production_baseline.json`` and
``pallas_production_fullband_baseline.json``. That includes the
production no_motion floor: the packed-u16 coarse warp quantizes to 1/256
gray, so identical frames read about 3.65e-4 px of pyramidal mae_u, by
design."""

from pathlib import Path

import pytest
import torch

from tpuflow.eval import patterns, verifier
from tpuflow_torch import PYRAMID_CONFIGS, lucas_kanade_pyramidal, lucas_kanade_single_scale

DATA = Path(verifier.__file__).parent / "data"
CONFIGS = ("production", "production_fullband")


def _runners(cfg):
    def single(prev, curr):
        u, v = lucas_kanade_single_scale(
            torch.from_numpy(prev), torch.from_numpy(curr), cfg.window_size, backend="torch"
        )
        return u.numpy(), v.numpy()

    def pyramidal(prev, curr):
        u, v = lucas_kanade_pyramidal(
            torch.from_numpy(prev), torch.from_numpy(curr), config=cfg, backend="cuda"
        )
        return u.numpy(), v.numpy()

    return single, pyramidal


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, params in patterns.TEST_PATTERNS.items():
        f0, f1 = patterns.generate_test_pattern(params, 320, 240, output_dir=None)
        data = {
            "frame_prev": f0.astype("float32"),
            "frame_curr": f1.astype("float32"),
            "metadata": {"motion_parameters": params.to_dict()},
        }
        for config in CONFIGS:
            out[config, name] = verifier.verify_pattern(
                name, data, _runners(PYRAMID_CONFIGS[config]), config, verbose=False
            )
    return out


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", sorted(patterns.TEST_PATTERNS))
def test_pattern_within_committed_baseline(results, config, name):
    assert verifier.compare_against_baseline(
        [results[config, name]], DATA / f"pallas_{config}_baseline.json",
        threshold_percent=10.0, verbose=True,
    )


@pytest.mark.parametrize("config", CONFIGS)
def test_no_motion_floor(results, config):
    nm = results[config, "no_motion"]
    assert nm["single_scale"]["metrics"]["epe"] == 0.0
    mae_u = nm["pyramidal"]["metrics"]["mae_u"]
    assert 0.0 < mae_u < 1e-3, mae_u
