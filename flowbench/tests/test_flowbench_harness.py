"""The harness on the CPU: its rehearsal path (``--device cpu``, a tiny
frame size, the program's plain versions), its result line, its guards,
and what it finds by name.

Each run is a fresh interpreter, as the benchmark's runs are.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
RUN = ["flowbench/run.py"]
CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "checks"}
TIMEOUT = 300


def _env(tmp_path: Path) -> dict:
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        path = tmp_path / var.lower()
        path.mkdir(exist_ok=True)
        env[var] = str(path)
    env.pop("PYTHONPATH", None)
    # Few intra-op threads: beside other test processes, spinning OpenMP
    # threads slowed a rehearsal run past its time limit.
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(args: list[str], cwd: Path, env: dict, prefix: list[str] | None = None):
    return subprocess.run([sys.executable, *(prefix or []), *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [0, 1])
def test_last_line_has_the_contract_keys(tmp_path, traced):
    proc = _run([*RUN, "--workload", "prod1080-b16-motion", "--seed", "2147483999",
                 "--seconds", "2", "--trace", str(traced), "--device", "cpu"],
                ROOT, _env(tmp_path))
    out = _result(proc)
    want = CONTRACT | ({"breakdown"} if traced else set())
    assert set(out) <= want and CONTRACT <= set(out), sorted(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if traced:
        # The CPU writes no device metric: only the host clock's and the counter's.
        assert names == {"input_host_ms_per_step", "step_host_us", "rounds_per_frame"}
    else:
        assert names == {"frames_per_s", "frame_latency_p95_ms", "setup_s"}
    # The compared numbers are the last lines on standard error.
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_no_card_no_result(tmp_path):
    proc = _run([*RUN, "--workload", "default4k-b1-motion", "--seed", "1", "--seconds", "1",
                 "--trace", "0"], ROOT, _env(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


GUARD = """
import json, runpy, sys
sys.argv = ["flowbench/run.py"] + sys.argv[1:]
try:
    runpy.run_path("flowbench/run.py", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"rc": code, "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_run_loads_no_jax_and_no_jax_package(tmp_path):
    proc = _run(["-c", GUARD, "--workload", "default4k-b1-motion", "--seed", "7",
                 "--seconds", "1", "--trace", "0", "--device", "cpu"], ROOT, _env(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["rc"] == 0
    assert not set(report["top"]) & {"jax", "jaxlib", "flax", "tpuflow"}
    assert "tpuflow_torch" in report["top"]


def test_guard_refuses_a_loaded_jax(tmp_path):
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    code = ("import sys, runpy; import jax; "
            "sys.argv = ['flowbench/run.py'] + sys.argv[1:]; "
            "runpy.run_path('flowbench/run.py', run_name='__main__')")
    env = _env(tmp_path)
    env["PYTHONPATH"] = str(fake)
    proc = _run(["-c", code, "--workload", "default4k-b1-motion", "--seed", "7", "--seconds", "1",
                 "--trace", "0", "--device", "cpu"], ROOT, env)
    assert proc.returncode == 3 and proc.stdout.strip() == ""
    assert "jax" in proc.stderr


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program(tmp_path):
    for path in sorted((ROOT / "flowbench" / "reference").glob("*.py")):
        assert not _top_level_imports(path) & {"tpuflow_torch", "tpuflow", "jax", "jaxlib"}
    code = ("import importlib.util, json, sys; "
            "s = importlib.util.spec_from_file_location('r', 'flowbench/reference/pyramidal_lk.py');"
            " m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    proc = _run(["-c", code], ROOT, _env(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert not set(json.loads(proc.stdout)) & {"tpuflow_torch", "tpuflow", "jax"}


def _checkout(tmp_path: Path, program: bool = True) -> Path:
    """A checkout of BENCHMARK.json and flowbench/ (and the program)."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "flowbench", root / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if program:
        shutil.copytree(ROOT / "tpuflow_torch", root / "tpuflow_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_no_result_without_the_program(tmp_path):
    root = _checkout(tmp_path, program=False)
    proc = _run([*RUN, "--workload", "default4k-b1-motion", "--seed", "3", "--seconds", "1",
                 "--trace", "0", "--device", "cpu"], root, _env(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_config_traffic_and_metric_found_by_name(tmp_path):
    root = _checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "flowbench/configs/lk-production-1080p.json").read_text())
    config["name"] = "lk-later"
    (root / "flowbench/configs/lk-later.json").write_text(json.dumps(config))
    traffic = json.loads((root / "flowbench/traffic/b16-motion.json").read_text())
    traffic["streams"] = 2
    (root / "flowbench/traffic/b2-later.json").write_text(json.dumps(traffic))
    (root / "flowbench/metrics/frames_per_step_later.py").write_text(
        'def read(record):\n'
        '    return record["streams"]\n')
    bench["configs"].append({"name": "lk-later", "source": "https://example.org/later",
                             "file": "flowbench/configs/lk-later.json", "reduced": [],
                             "why": "a later deployment"})
    bench["workloads"].append({"name": "later-b2", "config": "lk-later", "traffic": "b2-later",
                               "chips": 1, "why": "a later cell"})
    bench["end_to_end"].append({"name": "frames_per_step_later", "unit": "frames",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["later-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _result(_run([*RUN, "--workload", "later-b2", "--seed", "5", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"], root, _env(tmp_path)))
    assert out["metrics"]["frames_per_step_later"]["value"] == 2
    assert out["attempted"] % 2 == 0


AUDIT = """
import json, os, runpy, sys
written = set()
def hook(event, args):
    if event == "open" and args[0] is not None and not isinstance(args[0], int):
        mode, flags = args[1] or "", args[2] or 0
        if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            written.add(os.path.abspath(os.fsdecode(args[0])))
    elif event in ("os.mkdir", "os.remove", "os.rmdir", "os.truncate", "shutil.rmtree"):
        written.add(os.path.abspath(os.fsdecode(args[0])))
    elif event in ("os.rename", "shutil.copyfile", "shutil.move"):
        written.add(os.path.abspath(os.fsdecode(args[1])))
sys.addaudithook(hook)
sys.argv = ["flowbench/run.py"] + sys.argv[1:]
try:
    runpy.run_path("flowbench/run.py", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"rc": code, "written": sorted(written)}))
"""


def test_run_writes_only_inside_its_places(tmp_path):
    root = _checkout(tmp_path)
    env = _env(tmp_path)
    proc = _run(["-c", AUDIT, "--workload", "prod1080-b16-still", "--seed", "11", "--seconds",
                 "1", "--trace", "1", "--device", "cpu"], root, env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0
    allowed = [Path(p).resolve() for p in (root, env["HOME"], env["XDG_CACHE_HOME"],
                                           env["TMPDIR"])] + [Path(os.devnull)]
    outside = [p for p in report["written"]
               if not any(Path(p) == a or a in Path(p).parents for a in allowed)]
    assert not outside, outside


def test_trace_reduce_keeps_device_time_by_part_and_by_name():
    sys.path.insert(0, str(ROOT))
    from flowbench.harness import trace

    ms = 1_000_000
    device = [("Memcpy HtoD (Pageable -> Device)", 0, 1 * ms),
              ("void tpuflow_lk::refine<3>(...)", 1 * ms, 4 * ms),
              ("sm80_xmma_gemm_f32f32", 2 * ms, 5 * ms),
              ("void tpuflow_lk::refine<3>(...)", 7 * ms, 8 * ms),
              ("elementwise_kernel", 12 * ms, 20 * ms)]  # ends after the window
    host = [(trace.WINDOW, 0, 10 * ms), ("flowbench.input", 5 * ms, 7 * ms)]
    out = trace.reduce(device, host)
    assert out["window_s"] == 0.01 and out["busy_s"] == 0.006
    assert out["time_s"] == {"h2d": 0.001, "copies": 0.0, "kernels": 0.004, "gemm": 0.003,
                             "other": 0.0}
    assert out["by_name"] == {"Memcpy HtoD (Pageable -> Device)": 0.001,
                              "void tpuflow_lk::refine<3>(...)": 0.004,
                              "sm80_xmma_gemm_f32f32": 0.003}
    assert out["idle_gaps"] == [["flowbench.input", 0.002], ["flowbench.between", 0.002]]
