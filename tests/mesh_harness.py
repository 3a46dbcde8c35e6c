"""Run the port's mesh cases in gloo worker processes on the CPU
(tests/torch_mesh_worker.py): one subprocess per rank, a ``FileStore``
rendezvous under the test's temporary directory, inputs and results as
.npz files. Each run has a wall limit, and a rank that fails or hangs
fails the run with its stderr."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

WORKER = Path(__file__).with_name("torch_mesh_worker.py")


def run_ranks(workdir: Path, world: int, tiling: str, cases: list[str], inputs: dict,
              timeout: float = 240.0) -> list[dict]:
    """Every rank's results (``{"case/key": array}``), rank order."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    argv = [str(workdir / "store"), tiling, ",".join(cases), str(workdir / "inputs.npz"),
            str(workdir)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"mesh workers ({tiling}) ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]
