"""The port's VO stage profiler (``tpuflow_torch.eval.profile_vo``)
against ``tpuflow.eval.profile_vo`` on the CPU: the same six rows in the
same order, the accounting row's arithmetic, and the JSON snapshot's keys
(the port's adds ``device``, the card's label or ``cpu``).

The JAX profiler runs with its timer replaced by a constant, as
``tests/test_torch_profile.py`` does, so it builds its rows without timing
anything; the port's runs each body once under the host clock
(``device="cpu"``), at 120x160.
"""

import json

import numpy as np
import pytest
import torch

from tpuflow.eval import profile_vo as jax_profile_vo
from tpuflow_torch.eval import profile_vo

SHAPE = (120, 160)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does, for
    the module's fixtures and tests alike. Under the six-worker run each
    small op's OpenMP region otherwise waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_stubbed(monkeypatch):
    monkeypatch.setattr(jax_profile_vo, "_marginal_seconds", lambda *a, **k: 1e-3)


def test_rows_match_the_reference(jax_stubbed):
    want = jax_profile_vo.profile_vo(*SHAPE, "production")
    got = profile_vo.profile_vo(*SHAPE, "production", device="cpu")
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    assert len(got) == 6
    for r in got:
        assert r["clock"] == profile_vo.HOST_CLOCK and np.isfinite(r["ms"])
        assert "device_ms" not in r  # no device time on the CPU
    ms = {r["stage"]: r["ms"] for r in got}
    assert ms["unexplained (full - flow - seed - advance)"] == pytest.approx(
        ms["full VO step"] - ms["flow step (build+solve)"] - ms["seed_grid (Shi-Tomasi)"]
        - ms["advance (track gathers)"])
    for line, r in zip(profile_vo.format_rows(got), got):
        assert line.strip().startswith(r["stage"]) and "(host clock)" in line


def test_json_keys_match_the_reference(jax_stubbed, tmp_path, capsys):
    from cli_harness import run_cli_main

    argv = ["--height", str(SHAPE[0]), "--width", str(SHAPE[1]), "--json"]
    run_cli_main(jax_profile_vo.main, argv + [str(tmp_path / "jax.json")], capsys)
    out = run_cli_main(profile_vo.main, argv + [str(tmp_path / "port.json"), "--device", "cpu"],
                       capsys)
    assert "on cpu" in out.splitlines()[0]
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert [r["stage"] for r in got["stages"]] == [r["stage"] for r in want["stages"]]
    assert {k: got[k] for k in ("height", "width", "config", "grid_step", "fb_check")} == {
        k: want[k] for k in ("height", "width", "config", "grid_step", "fb_check")}


def test_profile_vo_needs_a_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_vo.profile_vo(*SHAPE)


def test_natural_frames_match_the_reference():
    from tpuflow.eval.profile import _natural_pair

    f0, f1 = profile_vo.natural_frames(*SHAPE, torch.device("cpu"))
    j0, j1 = _natural_pair(*SHAPE)
    np.testing.assert_array_equal(f0.numpy(), j0)
    np.testing.assert_array_equal(f1.numpy(), j1)
