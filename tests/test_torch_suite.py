"""The 13-pattern regression gate on the port, on the CPU: the port's own
verifier (``tpuflow_torch.eval.verifier.run_suite`` on the committed suite
fixture) with ``backend="cuda"``, whose kernels run their plain versions
on CPU tensors (single scale through the fused kernel, pyramidal through
the warp and refine kernels), for every config with a committed Pallas
baseline. Each pattern is scored against the baseline at its 10%
threshold by both the port's and the JAX package's
``compare_against_baseline``, which must agree.

no_motion must be exactly 0 in both modes wherever the coarse warp is not
packed. The production configs have a floor by design: the packed-u16
coarse warp quantizes to 1/256 gray, so identical frames read about
3.7e-4 px of pyramidal mae_u (ROADMAP queue 3, item e).
"""

import pytest
import torch

from tpuflow.eval import patterns
from tpuflow.eval import verifier as jverifier
from tpuflow_torch.eval import verifier

CONFIGS = tuple(verifier.PALLAS_BASELINES)
PACKED_U16 = ("production", "production_fullband")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results():
    out = {}
    for config in CONFIGS:
        for r in verifier.run_suite(pyramid_config_name=config, backend="cuda", verbose=False,
                                    device="cpu"):
            out[config, r["pattern_name"]] = r
    return out


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", sorted(patterns.TEST_PATTERNS))
def test_pattern_within_committed_baseline(results, config, name):
    path = verifier.BASELINE_DIR / verifier.PALLAS_BASELINES[config]
    result = [results[config, name]]
    ours = verifier.compare_against_baseline(result, path, 10.0, verbose=True, backend="cuda")
    theirs = jverifier.compare_against_baseline(result, path, 10.0, verbose=True,
                                                backend="pallas")
    assert ours == theirs
    assert ours


@pytest.mark.parametrize("config", CONFIGS)
def test_no_motion_floor(results, config):
    nm = results[config, "no_motion"]
    assert nm["single_scale"]["metrics"]["epe"] == 0.0
    mae_u = nm["pyramidal"]["metrics"]["mae_u"]
    if config in PACKED_U16:
        assert 0.0 < mae_u < 1e-3, mae_u
    else:
        assert nm["pyramidal"]["metrics"]["epe"] == 0.0
