"""What a cell is made of, found by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration and traffic mix, and its
metrics; each is a file of its own under ``flowbench/``:

- ``configs/<config>.json``: the deployment (frame size, the pyramid's
  settings under ``pyramid``, the reference module under ``reference``);
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``metrics/<metric>.py``: one reader a metric, ``read(record)`` -> a
  number or None where the record holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its config and traffic
    read from their files, with the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "flowbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``flowbench/metrics/<metric>.py``."""
    path = root / "flowbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"flowbench_metric_{metric.replace('-', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference(config: dict, root: Path = ROOT):
    """The module of ``flowbench/reference/<config['reference']>.py``."""
    name = config["reference"]
    path = root / "flowbench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"flowbench_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
