"""The port's stage profiler (``tpuflow_torch.eval.profile``) against the
JAX package's (``tpuflow.eval.profile``) on the CPU: the same rows, stage
for stage, with the same bytes model, and the committed natural frame
byte-equal to the JAX profiler's.

The JAX profiler is run with its two timers replaced by a constant, so it
builds its rows without running a kernel; the port's runs its plain
versions under the host clock (``device="cpu"``), at 64x200. The JAX
profiler's ``(pallas)`` rows are the port's ``(cuda)`` rows. The natural
frame exists at 1080x1920 only, so at 64x200 the port leaves the benign
row out, with a note.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tpuflow.eval import profile as jax_profile
from tpuflow_torch.eval import profile

SHAPE = (64, 200)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rows(monkeypatch, config, shape=SHAPE):
    monkeypatch.setattr(jax_profile, "_marginal_seconds", lambda *a, **k: 1e-3)
    monkeypatch.setattr(jax_profile, "_stream_marginal_seconds", lambda *a, **k: 1e-3)
    return jax_profile.profile_pipeline(*shape, config)


@pytest.mark.parametrize("config", ["default", "production", "adaptive_vertical"])
def test_profile_rows_match_jax(monkeypatch, capsys, config):
    want = [r for r in _jax_rows(monkeypatch, config) if r["stage"] != "pyramidal total (benign)"]
    got = profile.profile_pipeline(*SHAPE, config, device="cpu")
    assert [r["stage"] for r in got] == [r["stage"].replace("(pallas)", "(cuda)") for r in want]
    assert [r["bytes_model"] for r in got] == [r["bytes_model"] for r in want]
    for r in got:
        assert np.isfinite(r["ms"]) and r["ms"] > 0
        # Host-clock readings carry no device metric.
        assert "effective_gbps" not in r and "hbm_fraction" not in r
    noted = "benign" in capsys.readouterr().out
    assert noted == (config != "default")
    report = profile.format_report(got, *SHAPE, "cpu")
    assert report.count("\n") == len(got) + 1 and "pyramidal total (fast)" in report


def test_profile_needs_a_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.profile_pipeline(*SHAPE, "default")


def test_natural_frame_matches_jax_pair():
    f0, f1 = profile.natural_pair(device="cpu")
    j0, j1 = jax_profile._natural_pair(1080, 1920)
    np.testing.assert_array_equal(f0.numpy(), j0)
    assert np.load(profile.NATURAL)["frame"].tobytes() == j0.astype(np.uint8).tobytes()
    np.testing.assert_array_equal(f1.numpy(), j1)
    np.testing.assert_array_equal(
        f1.numpy(), nd_shift(j0, (0.0, 2.0), order=1, mode="constant", cval=128.0))
