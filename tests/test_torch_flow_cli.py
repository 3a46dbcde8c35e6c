"""The port's user-facing CLIs against ``tpuflow``'s on the CPU: the flow
CLI (``python -m tpuflow_torch.flow``, ``--device cpu``) beside ``python -m
tpuflow.flow``, the frame converter and natural-pair generator, and the
verifier's ``--suite-dir``, ``--config`` and plots.

The flow CLI cases are those of ``tests/test_flow_cli.py``, each run
through both CLIs (``tests/cli_harness.py``) and compared on the printed
region statistics (four decimals):

- ``--backend rtl`` against ``rtl``: the statistics and the exported dump
  identical (the S8.7 datapath is bit-exact, tests/test_torch_fixed_point.py);
- ``torch`` against ``jnp``: the statistics within 1e-4 (one unit of the
  last printed digit; measured 0 in every case) and, in single scale, the
  dumps within 5e-5 px, the single-scale limit of ROADMAP §3 "Measured
  differences";
- the stream's printed mean magnitude within 1e-3 (its last printed
  digit; the pyramidal solve's one-ulp differences stay far below it);
- ``--compare``'s printed means within 1e-4 and its maxima within 2e-3
  px, the pyramidal finest level's limit (measured 5e-4 px at one pixel).
"""

import json
import sys

import numpy as np
import pytest
import torch

from cli_harness import run_cli_main
from tpuflow.eval import patterns as jax_patterns
from tpuflow.eval import verifier as jax_verifier
from tpuflow.flow.__main__ import main as jax_main
from tpuflow_torch.eval import patterns, verifier
from tpuflow_torch.flow.__main__ import main as port_main
from tpuflow_torch.io import frames as fio

SINGLE_SCALE_ATOL = 5e-5


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
def pattern_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_suite")
    jax_patterns.generate_test_pattern(
        jax_patterns.TEST_PATTERNS["translate_medium"], output_dir=d, save_png=False)
    return d / "translate_medium"


def run_port(argv, capsys):
    return run_cli_main(port_main, list(argv) + ["--device", "cpu"], capsys)


def run_jax(argv, capsys):
    return run_cli_main(jax_main, argv, capsys)


def stats(out):
    """The printed region statistics: name -> value."""
    rows = [line.split() for line in out.splitlines() if line.startswith("  ")]
    return {k: float(v) for k, v in rows}


def _backend(argv, jax_name):
    return [jax_name if a in ("torch", "cuda") else a for a in argv]


def assert_stats_match(argv, capsys, atol):
    """Run ``argv`` through both CLIs (the port's backend names mapped to
    the JAX package's); return both outputs."""
    out = run_port(argv, capsys)
    want = run_jax(_backend(argv, "jnp"), capsys)
    got_s, want_s = stats(out), stats(want)
    assert list(got_s) == list(want_s) and len(got_s) == 6
    for k in want_s:
        assert abs(got_s[k] - want_s[k]) <= atol, (k, got_s[k], want_s[k])
    return out, want


def test_cli_single_scale_stats_and_export(pattern_dir, tmp_path, capsys):
    dump, jdump = tmp_path / "flow.txt", tmp_path / "jflow.txt"
    out, _ = assert_stats_match([str(pattern_dir), "--export", str(dump)], capsys, 1e-4)
    run_jax([str(pattern_dir), "--export", str(jdump)], capsys)
    assert "single-scale" in out and "mean_u" in out
    u, v = fio.load_flow_text(dump)
    assert u.shape == (240, 320)
    assert u[105:135, 55:85].mean() > 0.5
    assert abs(v[105:135, 55:85].mean()) < 0.5
    ju, jv = fio.load_flow_text(jdump)
    np.testing.assert_allclose(u, ju, atol=SINGLE_SCALE_ATOL, rtol=0)
    np.testing.assert_allclose(v, jv, atol=SINGLE_SCALE_ATOL, rtol=0)


def test_cli_pyramidal_compare(pattern_dir, tmp_path, capsys):
    dump = tmp_path / "single.txt"
    run_port([str(pattern_dir), "--export", str(dump)], capsys)
    argv = [str(pattern_dir), "--pyramidal", "--compare", str(dump)]
    out, want = assert_stats_match(argv, capsys, 1e-4)
    assert "pyramidal[default]" in out
    assert "mae_u=" in out
    # The comparison line: its means to their last printed digit, its
    # maxima to the finest level's 2e-3 px (measured 5e-4).
    got_cmp, want_cmp = (
        [float(t.split("=")[1]) for t in o.split("\nvs ")[1].splitlines()[0].split()[1:]]
        for o in (out, want))
    np.testing.assert_allclose(got_cmp[:2], want_cmp[:2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_cmp[2:], want_cmp[2:], atol=2e-3, rtol=0)


def test_cli_missing_frames(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        run_port([str(tmp_path)], capsys)
    assert e.value.code == 1


def test_cli_sequence_streaming(tmp_path, capsys):
    from scipy.ndimage import shift as nd_shift

    base = jax_patterns.load_base_texture(160, 120).astype(np.float32)
    for i in range(4):
        f = nd_shift(base, (0.0, 2.0 * i), order=1, mode="nearest")
        fio.save_frame_bin(tmp_path / f"frame_{i:02d}.bin", f)
    argv = [str(tmp_path), "--sequence", "--width", "160", "--height", "120"]
    out = run_port(argv, capsys)
    assert "pairs: 3" in out
    assert "throughput:" in out
    mag = float(out.split("mean flow magnitude:")[1].split("px")[0])
    assert 0.3 < mag < 3.0
    want = run_jax(argv, capsys)
    assert abs(mag - float(want.split("mean flow magnitude:")[1].split("px")[0])) <= 1e-3
    # The pyramid carried over the stream: the parity paths agree; the fast
    # path (its kernels' plain versions here) runs the same loop.
    pyr = argv + ["--pyramidal", "--pyramid-config", "production"]
    out, want = run_port(pyr, capsys), run_jax(pyr, capsys)
    assert "pyramidal[production]" in out and "pairs: 3" in out
    assert abs(float(out.split("mean flow magnitude:")[1].split("px")[0])
               - float(want.split("mean flow magnitude:")[1].split("px")[0])) <= 1e-3
    out = run_port(pyr + ["--backend", "cuda"], capsys)
    assert "pyramidal[production]  backend: cuda  device: cpu" in out and "pairs: 3" in out
    assert 0.3 < float(out.split("mean flow magnitude:")[1].split("px")[0]) < 3.0


def test_cli_sequence_too_few_frames(tmp_path, capsys):
    with pytest.raises(SystemExit):
        run_port([str(tmp_path), "--sequence"], capsys)


def test_cli_rtl_backend(pattern_dir, tmp_path, capsys):
    dump, jdump = tmp_path / "flow_field_rtl.txt", tmp_path / "jax_rtl.txt"
    out, _ = assert_stats_match(
        [str(pattern_dir), "--backend", "rtl", "--export", str(dump)], capsys, 0.0)
    run_jax([str(pattern_dir), "--backend", "rtl", "--export", str(jdump)], capsys)
    assert "S8.7 RTL" in out
    mean_u = float(out.split("mean_u")[1].split("\n")[0])
    assert 0.3 < mean_u < 1.6, out
    for got, want in zip(fio.load_flow_text(dump), fio.load_flow_text(jdump)):
        np.testing.assert_array_equal(got, want)


def test_cli_rtl_rejects_pyramidal(pattern_dir, tmp_path, capsys):
    for extra in (["--pyramidal"], ["--sequence"]):
        with pytest.raises(SystemExit) as e:
            run_port([str(pattern_dir), "--backend", "rtl", *extra], capsys)
        assert e.value.code == 2


def test_cli_needs_a_card_unless_the_cpu_is_asked_for(pattern_dir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--sequence", "--glob", "frame_*.bin"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli_main(port_main, [str(pattern_dir), *extra], capsys)


def test_cli_plots(pattern_dir, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = run_port([str(pattern_dir), "--pyramidal", "--plot", str(tmp_path / "q.png"),
                    "--per-level-plots", str(tmp_path / "levels")], capsys)
    assert "quiver plot ->" in out and (tmp_path / "q.png").stat().st_size > 1000
    assert sorted(p.name for p in (tmp_path / "levels").iterdir()) == [
        f"pyramid_level_{i}.png" for i in range(3)]


# tests/test_aux_clis.py's cases on the port's converter and generator.


def test_convert_bin_and_mem_to_png(tmp_path, rng, capsys):
    from PIL import Image

    from tpuflow_torch.io.convert import main

    frame = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    b, m = tmp_path / "f.bin", tmp_path / "f.mem"
    fio.save_frame_bin(b, frame)
    fio.save_frame_mem(m, frame)
    run_cli_main(main, [str(b), str(m), "--width", "32", "--height", "24"], capsys)
    for stem in ("f.bin", "f.mem"):
        assert (tmp_path / stem).with_suffix(".png").exists()
    back = np.asarray(Image.open(tmp_path / "f.png").convert("L"))
    np.testing.assert_array_equal(back, frame)


def test_convert_rejects_unknown_format(tmp_path, capsys):
    from tpuflow_torch.io.convert import main

    p = tmp_path / "f.xyz"
    p.write_bytes(b"\x00")
    with pytest.raises(SystemExit):
        run_cli_main(main, [str(p)], capsys)


def test_natural_generator_cli_matches_jax(tmp_path, capsys):
    from tpuflow.eval.natural import main as jax_natural_main
    from tpuflow_torch.eval.natural import main

    argv = ["--displacement-x", "2", "--width", "64", "--height", "48", "--output-dir"]
    run_cli_main(main, argv + [str(tmp_path / "port")], capsys)
    run_cli_main(jax_natural_main, argv + [str(tmp_path / "jax")], capsys)
    for name in ("frame_00.bin", "frame_01.bin", "frame_00.mem", "frame_01.mem"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    f0 = fio.load_frame_bin(tmp_path / "port" / "frame_00.bin", 64, 48)
    f1 = fio.load_frame_bin(tmp_path / "port" / "frame_01.bin", 64, 48)
    np.testing.assert_allclose(f1[10:-10, 12:50], f0[10:-10, 10:48], atol=2.0)


# The verifier's --suite-dir, --config and plots.


def _metrics(results):
    return {r["pattern_name"]: verifier._strip_arrays(r) for r in results}


def test_suite_dir_reads_the_reference_layout(tmp_path):
    # A two-pattern suite written by tpuflow.eval.patterns gives the same
    # metrics as the committed suite.
    names = ["translate_medium", "rotate_small"]
    for name in names:
        jax_patterns.generate_test_pattern(jax_patterns.TEST_PATTERNS[name], output_dir=tmp_path)
    index = {"patterns": {n: jax_patterns.TEST_PATTERNS[n].to_dict() for n in names}}
    (tmp_path / "suite_index.json").write_text(json.dumps(index))
    kw = dict(pyramid_config_name="default", backend="torch", verbose=False, device="cpu")
    got = verifier.run_suite(suite_dir=tmp_path, **kw)
    want = verifier.run_suite(names, **kw)
    assert [r["pattern_name"] for r in got] == names
    assert _metrics(got) == _metrics(want)
    with pytest.raises(SystemExit, match="Unknown pattern"):
        verifier.run_suite(["no_motion"], suite_dir=tmp_path, **kw)


def test_suite_dir_is_written_in_the_reference_layout(tmp_path):
    # Where the directory has no index, the committed suite is written
    # there, file for file as tpuflow.eval.patterns writes it.
    results = verifier.run_suite(["no_motion"], "default", "torch", verbose=False,
                                 device="cpu", suite_dir=tmp_path / "port")
    assert results[0]["pyramidal"]["metrics"]["epe"] == 0.0
    port = tmp_path / "port"
    assert sorted(p.name for p in port.iterdir() if p.is_dir()) == sorted(patterns.TEST_PATTERNS)
    index = json.loads((port / "suite_index.json").read_text())
    assert index["patterns"] == {n: p.to_dict() for n, p in jax_patterns.TEST_PATTERNS.items()}
    for name in ("translate_medium", "zoom_in"):
        jax_patterns.generate_test_pattern(jax_patterns.TEST_PATTERNS[name],
                                           output_dir=tmp_path / "jax")
        for f in ("frame_00.bin", "frame_01.bin", "frame_00.mem", "frame_01.mem"):
            assert (port / name / f).read_bytes() == (tmp_path / "jax" / name / f).read_bytes()
        assert (json.loads((port / name / "metadata.json").read_text())
                == json.loads((tmp_path / "jax" / name / "metadata.json").read_text()))
        got = patterns.load_test_pattern(port / name)
        want = jax_patterns.load_test_pattern(tmp_path / "jax" / name)
        np.testing.assert_array_equal(got["frame_curr"], want["frame_curr"])
        assert got["metadata"] == want["metadata"]


@pytest.fixture
def fresh_globals(monkeypatch):
    """Let apply_config mutate copies of both verifiers' tables."""
    for mod in (verifier, jax_verifier):
        monkeypatch.setattr(mod, "THRESHOLDS", dict(mod.THRESHOLDS))
        monkeypatch.setattr(mod, "PATTERN_CATEGORIES", dict(mod.PATTERN_CATEGORIES))
        monkeypatch.setattr(mod, "PYRAMID_CONFIGS", dict(mod.PYRAMID_CONFIGS))
        monkeypatch.setattr(mod, "CENTER_CROP", mod.CENTER_CROP)
        monkeypatch.setattr(mod, "BORDER", mod.BORDER)


def test_config_yaml_matches_the_reference(tmp_path, fresh_globals, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "thresholds:\n  translation: [0.1, 0.2]\n"
        "test_region:\n  center_crop: 40\n  border: 5\n"
        "pyramid_configs:\n  tiny:\n    levels: 2\n    window_size: 3\n"
        "  production:\n    iterations: 2\n"
        "regression:\n  threshold_percent: 25.0\n"
    )
    parsed = verifier.apply_config(cfg)
    assert parsed == jax_verifier.apply_config(cfg)
    assert verifier.THRESHOLDS == jax_verifier.THRESHOLDS
    assert verifier.PATTERN_CATEGORIES == jax_verifier.PATTERN_CATEGORIES
    assert (verifier.CENTER_CROP, verifier.BORDER) == (40, 5)
    assert (jax_verifier.CENTER_CROP, jax_verifier.BORDER) == (40, 5)
    for name in ("tiny", "production"):
        got, want = verifier.PYRAMID_CONFIGS[name], jax_verifier.PYRAMID_CONFIGS[name]
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}
    assert verifier.PYRAMID_CONFIGS["tiny"].levels == 2
    for name in ("translate_small", "rotate_small"):
        assert np.array_equal(verifier.get_test_region_mask((240, 320), name),
                              jax_verifier.get_test_region_mask((240, 320), name))
    assert verifier.classify_result(0.15, 0.0, "translate_small") == "Warning"
    # The defaults, read from the JAX package's YAML by path, restore the
    # reference values.
    verifier.apply_config(verifier.DEFAULT_CONFIG)
    assert verifier.THRESHOLDS["translation"] == (0.5, 2.0) and verifier.CENTER_CROP == 80

    # The CLI: the added config runs, and the file's regression threshold
    # is the gate's.
    verifier.apply_config(cfg)
    out = tmp_path / "out"
    base = tmp_path / "base.json"
    argv = ["--config", str(cfg), "--pyramid-config", "tiny", "--pattern", "translate_medium",
            "--device", "cpu", "--no-visualizations", "--output-dir", str(out),
            "--baseline", str(base)]
    verifier.main(argv + ["--update-baseline"])
    doc = json.loads(base.read_text())
    assert doc["patterns"]["translate_medium"]["pyramidal"]["config"] == "tiny"
    doc["patterns"]["translate_medium"]["pyramidal"]["metrics"]["mae_u"] *= 1.2
    base.write_text(json.dumps(doc))
    verifier.main(argv + ["--compare-baseline"])  # +-20% is inside the file's 25%
    assert "all patterns within threshold" in capsys.readouterr().out
    assert not (out / "plots").exists()


def test_visualizations_are_written_or_their_skip_printed(tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    argv = ["--pattern", "translate_medium", "no_motion", "--device", "cpu"]
    verifier.main(argv + ["--output-dir", str(tmp_path / "a")])
    plots = tmp_path / "a" / "plots" / "translate_medium"
    assert sorted(p.name for p in plots.iterdir()) == [
        "error_pyramidal.png", "error_single.png", "flow_pyramidal.png", "flow_single.png",
        "levels"]
    assert len(list((plots / "levels").iterdir())) == 3
    assert not (tmp_path / "a" / "plots" / "no_motion").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    verifier.main(argv + ["--output-dir", str(tmp_path / "b")])
    assert "(visualizations skipped: plots need matplotlib" in capsys.readouterr().out
    assert (tmp_path / "b" / "verification_results.json").exists()
    assert not (tmp_path / "b" / "plots").exists()
