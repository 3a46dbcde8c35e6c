"""The port's verifier (``tpuflow_torch.eval``) against ``tpuflow.eval``.

- The committed suite fixture holds exactly the frames that
  ``tpuflow.eval.patterns.generate_test_pattern`` makes (PIL and OpenCV).
  Regenerate it from the repository root with:

      python -c "import numpy as np; from tpuflow.eval import patterns as p; f0 = p.load_base_texture(); np.savez_compressed('tpuflow_torch/eval/data/suite_320x240.npz', base=f0, **{n: p.apply_motion(f0, m) for n, m in p.TEST_PATTERNS.items()})"

- Metrics, test regions, classification, the regression comparison with
  its baseline-zero rule and provenance guard, the reports and
  ``verify_pattern`` give the JAX package's answers on the same inputs,
  exactly (both are the same numpy on the same arrays).
- The CLI, in-process on two patterns with the parity backend: an unknown
  pattern and a tampered baseline each exit 1.
"""

import json

import numpy as np
import pytest
import torch

from tpuflow.eval import metrics as jmetrics
from tpuflow.eval import patterns as jpatterns
from tpuflow.eval import verifier as jverifier
from tpuflow_torch.eval import metrics, patterns, verifier

NAMES = sorted(jpatterns.TEST_PATTERNS)


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
def suite():
    return patterns.load_suite()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_generated_pattern(suite, name):
    f0, f1 = jpatterns.generate_test_pattern(
        jpatterns.TEST_PATTERNS[name], 320, 240, output_dir=None
    )
    data = suite[name]
    np.testing.assert_array_equal(data["frame_prev"], f0.astype(np.float32))
    np.testing.assert_array_equal(data["frame_curr"], f1.astype(np.float32))
    assert data["metadata"]["motion_parameters"] == jpatterns.TEST_PATTERNS[name].to_dict()


def test_patterns_and_ground_truth_match():
    assert list(patterns.TEST_PATTERNS) == list(jpatterns.TEST_PATTERNS)
    for name, params in patterns.TEST_PATTERNS.items():
        assert params.to_dict() == jpatterns.TEST_PATTERNS[name].to_dict()
        for got, want in zip(patterns.dense_ground_truth(params, 96, 64),
                             jpatterns.dense_ground_truth(jpatterns.TEST_PATTERNS[name], 96, 64)):
            np.testing.assert_array_equal(got, want)


def test_metrics_match(rng):
    u = rng.uniform(-3, 3, (40, 60)).astype(np.float32)
    v = rng.uniform(-3, 3, (40, 60)).astype(np.float32)
    mask = rng.uniform(size=(40, 60)) > 0.3
    zero = np.zeros_like(u)
    for args in [(u, v, 2.0, 0.5, mask), (u, v, 0.0, 0.0, None), (zero, zero, 0.0, 0.0, mask)]:
        assert metrics.compute_all_metrics(*args) == jmetrics.compute_all_metrics(*args)
    gu, gv = u * 0.9, v + 0.1
    for args in [(u, v, gu, gv, mask), (zero, zero, zero, zero, None)]:
        assert metrics.compute_all_metrics_dense(*args) == jmetrics.compute_all_metrics_dense(*args)


def test_mask_and_classify_match():
    for name in NAMES + ["custom"]:
        np.testing.assert_array_equal(
            verifier.get_test_region_mask((240, 320), name),
            jverifier.get_test_region_mask((240, 320), name),
        )
        for mae_u in (0.0, 0.4, 0.9, 1.5, 2.5, 4.0, 6.0):
            for mae_v in (0.1, 3.0):
                assert (verifier.classify_result(mae_u, mae_v, name)
                        == jverifier.classify_result(mae_u, mae_v, name))


def test_compare_metrics_matches():
    base = {"mae_u": 0.5, "mae_v": 0.0, "epe": 0.6}
    for cur in [dict(base), {"mae_u": 0.56, "mae_v": 0.0, "epe": 0.6},
                {"mae_u": 0.5, "mae_v": 2e-6, "epe": 0.6}, {"mae_u": 0.44, "epe": 0.7}]:
        for thr in (5.0, 10.0):
            assert verifier.compare_metrics(cur, base, thr) == jverifier.compare_metrics(cur, base, thr)


def _fake_results(config="default"):
    out = []
    for i, name in enumerate(["translate_medium", "no_motion"]):
        m = {"mae_u": 0.1 * i, "mae_v": 0.05 * i, "rmse": 0.2 * i, "epe": 0.12 * i, "aae": 1.0 * i}
        out.append({
            "pattern_name": name, "ground_truth": {"u": 2.0, "v": 0.0}, "num_test_pixels": 10,
            "single_scale": {"metrics": dict(m), "status": "Pass"},
            "pyramidal": {"metrics": dict(m), "status": "Pass", "config": config},
        })
    return out


def test_provenance_guard_maps_backend_names(tmp_path, capsys):
    path = tmp_path / "base.json"
    jverifier.update_baseline(_fake_results(), path, backend="pallas")
    for port_backend, jax_backend in [("cuda", "pallas"), ("torch", "jnp"), (None, None)]:
        for config in ("default", "narrow_vertical"):
            results = _fake_results(config)
            assert verifier.compare_against_baseline(results, path, backend=port_backend) == \
                jverifier.compare_against_baseline(results, path, backend=jax_backend)
    assert verifier.compare_against_baseline(_fake_results(), path, backend="cuda")
    assert not verifier.compare_against_baseline(_fake_results(), path, backend="torch")
    # A baseline written by the port records the JAX package's name.
    verifier.update_baseline(_fake_results(), tmp_path / "port.json", backend="cuda")
    assert json.loads((tmp_path / "port.json").read_text())["backend"] == "pallas"
    assert jverifier.compare_against_baseline(_fake_results(), tmp_path / "port.json",
                                              backend="pallas")
    capsys.readouterr()


def test_verify_pattern_and_report_match_jax(suite):
    runners = verifier._make_runners(verifier.PYRAMID_CONFIGS["default"], "torch", device="cpu")
    for name in ("rotate_small", "translate_medium"):
        got = verifier.verify_pattern(name, suite[name], runners, verbose=False, dense_gt=True)
        want = jverifier.verify_pattern(name, suite[name], runners, verbose=False, dense_gt=True)
        assert verifier._strip_arrays(got) == jverifier._strip_arrays(want)
        assert verifier.generate_markdown_table([got]) == jverifier.generate_markdown_table([want])


def _cli(argv):
    """The exit status ``python -m tpuflow_torch.eval.verifier argv`` gives:
    a SystemExit message is printed and exits 1."""
    with pytest.raises(SystemExit) as exc:
        verifier.main(argv)
    code = exc.value.code
    if isinstance(code, str):
        print(code)
        return 1
    return code or 0


def test_cli_exit_codes(tmp_path, capsys):
    out = tmp_path / "out"
    base = tmp_path / "base.json"
    common = ["--pattern", "translate_medium", "no_motion", "--backend", "torch",
              "--device", "cpu", "--no-visualizations", "--output-dir", str(out),
              "--baseline", str(base)]
    assert _cli(["--pattern", "bogus", "--output-dir", str(out)]) == 1
    assert "Unknown pattern(s): bogus" in capsys.readouterr().out
    assert _cli(["--pyramid-config", "bogus", "--output-dir", str(out)]) == 1
    assert "Unknown pyramid config 'bogus'" in capsys.readouterr().out

    verifier.main(common + ["--update-baseline"])
    verifier.main(common + ["--compare-baseline"])  # returns: no regression
    report = json.loads((out / "verification_results.json").read_text())
    assert set(report["patterns"]) == {"translate_medium", "no_motion"}
    assert (out / "verification_results.md").exists()

    doc = json.loads(base.read_text())
    doc["patterns"]["translate_medium"]["pyramidal"]["metrics"]["mae_u"] *= 1.5
    base.write_text(json.dumps(doc))
    assert _cli(common + ["--compare-baseline"]) == 1
    assert "REGRESSION translate_medium (pyramidal)" in capsys.readouterr().out

    # The committed jnp reference baseline refuses a cuda run outright.
    ref = ["--baseline", str(verifier.REFERENCE_BASELINE)]
    assert _cli(common[:-2] + ref + ["--backend", "cuda", "--compare-baseline"]) == 1
    assert "PROVENANCE MISMATCH" in capsys.readouterr().out


def test_run_suite_on_the_cpu_runs_plain_versions():
    # Asked for the CPU, the suite's tensors lie there and the kernels'
    # plain versions run; no launch is counted.
    from tpuflow_torch.kernels import launch_counts

    before = launch_counts()
    results = verifier.run_suite(["no_motion"], "default", backend="cuda", verbose=False,
                                 device="cpu")
    assert launch_counts() == before
    assert results[0]["single_scale"]["metrics"]["epe"] == 0.0
    assert results[0]["pyramidal"]["metrics"]["epe"] == 0.0


def test_verifier_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path, capsys):
    # Without a card, no entry point of the verifier falls back to the CPU
    # by itself: the library calls and the CLI's default raise.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = verifier.PYRAMID_CONFIGS["default"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier._make_runners(cfg, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.run_suite(["no_motion"], "default", backend="cuda", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.main(["--pattern", "no_motion", "--backend", "cuda",
                       "--output-dir", str(tmp_path)])
    assert not (tmp_path / "verification_results.json").exists()
    verifier.main(["--pattern", "no_motion", "--backend", "cuda", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert "backend=cuda on cpu" in capsys.readouterr().out
