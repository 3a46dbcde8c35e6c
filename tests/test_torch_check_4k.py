"""The port's 4K accuracy gate (``tpuflow_torch.eval.check_4k``, the
counterpart of ``scripts/check_4k.sh``) on the CPU.

- The gate's rule on doctored results documents: within 10% of the
  capture passes, 10.1% off fails, a zero baseline passes an exact zero and
  fails 2e-6; the CLI exits 0 on a pass and 1 on a regression, ``--update``
  writes its PATH and refuses one under ``benchmarks/``.
- ``suite_index`` is the index check_4k.sh writes, built from
  ``tpuflow.eval.patterns.TEST_PATTERNS``.
- The gate's pipeline at 240x320 with ``device="cpu"`` (the subset
  generated by the port, in the reference's layout, and the port's
  verifier under ``production`` with the dense ground truth) against
  ``tpuflow.eval.verifier.run_suite(dense_gt=True)`` on the same files,
  each path against its counterpart: the port's kernels (their plain
  versions here) against the JAX package's Pallas path in interpret mode,
  and the port's parity path against ``backend="jnp"``. Every pyramidal
  dense EPE passes the gate's own rule with JAX's as the baseline (10%,
  the 13-pattern gate's limit; an exact zero stays under 1e-6). The jnp
  path is not the fast path's counterpart: it reads 0.742 / 6.793 px on
  translate_medium / translate_vertical here, the Pallas path and the port's
  kernels 0.440 / 2.922.
- The 4K subset the port generates equals ``tpuflow.eval.patterns``'
  (Pillow's resize, OpenCV 5.0.0's warp) at 3840x2160 on every pixel of all
  four patterns (0 differ; divergence o holds at other sizes).
"""

import json
import shutil

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpuflow.eval import patterns as jp
from tpuflow.eval import verifier as jverifier
from tpuflow_torch.eval import check_4k, patterns, verifier

torch.set_num_threads(1)


def _doc(epes: dict) -> dict:
    return {"patterns": {n: {"pyramidal": {"dense_metrics": {"epe": e}}}
                         for n, e in epes.items()}}


@pytest.fixture(scope="module")
def capture():
    return json.loads(check_4k.CAPTURE.read_text())


def test_gate_passes_within_ten_percent_of_the_capture(capture):
    base = {n: check_4k.dense_epe(capture, n) for n in check_4k.PATTERNS}
    assert base["no_motion"] > check_4k.ZERO  # the packed-u16 floor (divergence e)
    for scale in (1.0, 0.91, 1.099):
        rows = check_4k.gate(_doc({n: e * scale for n, e in base.items()}), capture)
        assert [r[0] for r in rows] == list(check_4k.PATTERNS)
        assert all(ok for *_, ok in rows), rows


@pytest.mark.parametrize("pattern", check_4k.PATTERNS)
@pytest.mark.parametrize("scale", [1.101, 0.899])
def test_gate_fails_a_pattern_ten_point_one_percent_off(capture, pattern, scale):
    epes = {n: check_4k.dense_epe(capture, n) for n in check_4k.PATTERNS}
    epes[pattern] *= scale
    rows = check_4k.gate(_doc(epes), capture)
    assert [r[0] for r in rows if not r[3]] == [pattern]


@pytest.mark.parametrize("epe,ok", [(0.0, True), (9e-7, True), (2e-6, False)])
def test_gate_holds_a_zero_baseline_under_1e_6(epe, ok):
    zero = _doc({"translate_medium": 0.2458, "no_motion": 0.0})
    rows = check_4k.gate(_doc({"translate_medium": 0.2458, "no_motion": epe}), zero)
    assert rows[1] == ("no_motion", epe, 0.0, ok) and rows[0][3]


def test_suite_index_is_the_scripts():
    names = ["translate_medium", "translate_vertical", "rotate_small", "no_motion"]
    want = {
        "suite_name": "4K production bring-up subset",
        "resolution": {"width": 3840, "height": 2160},
        "num_patterns": len(names),
        "patterns": {
            n: {
                "name": n,
                "dx": jp.TEST_PATTERNS[n].dx,
                "dy": jp.TEST_PATTERNS[n].dy,
                "rotation": jp.TEST_PATTERNS[n].rotation,
                "scale": jp.TEST_PATTERNS[n].scale,
                "description": jp.TEST_PATTERNS[n].description,
            }
            for n in names
        },
    }
    assert list(check_4k.PATTERNS) == names
    assert json.dumps(check_4k.suite_index(), indent=2) == json.dumps(want, indent=2)


def _fake_results(epes: dict) -> list:
    metrics = {"mae_u": 0.0, "mae_v": 0.0, "rmse": 0.0, "epe": 0.0, "aae": 0.0}
    return [{"pattern_name": n, "ground_truth": {"u": 0.0, "v": 0.0}, "num_test_pixels": 1,
             "single_scale": {"metrics": metrics, "status": "Pass"},
             "pyramidal": {"metrics": metrics, "status": "Pass", "config": "production",
                           "dense_metrics": dict(metrics, epe=e)},
             "flow_fields": None} for n, e in epes.items()]


def test_cli_exit_codes_and_update(monkeypatch, tmp_path, capture, capsys):
    base = {n: check_4k.dense_epe(capture, n) for n in check_4k.PATTERNS}
    calls = []
    monkeypatch.setattr(check_4k, "generate_subset",
                        lambda d, **kw: calls.append(("generate", d, kw)) or d)
    monkeypatch.setattr(check_4k, "resolve_device", lambda device: torch.device("cpu"))
    common = ["--suite-dir", str(tmp_path / "suite"), "--output-dir", str(tmp_path / "out")]

    def run(epes, *extra):
        monkeypatch.setattr(check_4k, "verify", lambda d, **kw: _fake_results(epes))
        try:
            check_4k.main(common + list(extra))
        except SystemExit as exc:
            return exc.code
        return 0

    assert run(base) == 0
    assert "4K accuracy gate: OK" in capsys.readouterr().out
    assert run(dict(base, rotate_small=base["rotate_small"] * 1.2)) == 1
    assert "4K dense-GT regression: ['rotate_small']" in capsys.readouterr().out
    assert calls[0][2] == {"device": torch.device("cpu")}
    update = tmp_path / "snap" / "verify_4k.json"
    assert run(dict(base, rotate_small=9.0), "--update", str(update)) == 0
    assert check_4k.dense_epe(json.loads(update.read_text()), "rotate_small") == 9.0
    n_calls = len(calls)
    refused = run(base, "--update", str(check_4k.CAPTURE))
    assert isinstance(refused, str) and "benchmarks/" in refused and len(calls) == n_calls
    assert json.loads(check_4k.CAPTURE.read_text()) == capture


def test_cli_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(check_4k, "generate_subset", lambda d, **kw: pytest.fail("generated"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_4k.main(["--suite-dir", str(tmp_path / "suite"),
                       "--output-dir", str(tmp_path / "out")])


@pytest.fixture(scope="module")
def subset_240x320(tmp_path_factory):
    suite = check_4k.generate_subset(tmp_path_factory.mktemp("subset") / "suite_4k", 320, 240,
                                     device="cpu")
    yield suite
    shutil.rmtree(suite)


@pytest.mark.parametrize("backend,jax_backend", [("cuda", "pallas"), ("torch", "jnp")])
def test_gate_pipeline_at_240x320_matches_jax(subset_240x320, backend, jax_backend):
    index = json.loads((subset_240x320 / "suite_index.json").read_text())
    assert index == check_4k.suite_index(320, 240)
    if backend == "cuda":  # the gate's own step 2
        got = check_4k.verify(subset_240x320, device="cpu", verbose=False)
    else:
        got = verifier.run_suite(list(check_4k.PATTERNS), check_4k.CONFIG, backend,
                                 verbose=False, dense_gt=True, device="cpu",
                                 suite_dir=subset_240x320)
    with pltpu.force_tpu_interpret_mode():
        want = jverifier.run_suite(subset_240x320, list(check_4k.PATTERNS), "production",
                                   jax_backend, verbose=False, dense_gt=True)
    rows = check_4k.gate(verifier.results_document(got), verifier.results_document(want))
    assert [r[0] for r in rows] == list(check_4k.PATTERNS)
    assert all(ok for *_, ok in rows), rows
    nm = rows[-1]
    assert (nm[1] > check_4k.ZERO) == (backend == "cuda")  # the packed-u16 floor
    for g, w in zip(got, want):
        assert g["num_test_pixels"] == w["num_test_pixels"]


def test_4k_subset_equals_the_reference_generator():
    base = patterns.load_base_texture(check_4k.WIDTH, check_4k.HEIGHT)
    np.testing.assert_array_equal(base, jp.load_base_texture(check_4k.WIDTH, check_4k.HEIGHT))
    differing = 0
    for name in check_4k.PATTERNS:
        got = patterns.apply_motion(base, patterns.TEST_PATTERNS[name], device="cpu")
        want = jp.apply_motion(base, jp.TEST_PATTERNS[name])
        differing += int(np.count_nonzero(got != want))
    assert differing == 0
