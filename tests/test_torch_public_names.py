"""Every public function and class of the JAX package has a counterpart of
the same name in the port.

The reference's names are listed from its source by AST (no module of it
is imported, so no JAX), one case a module of ``tpuflow/``; the matching
``tpuflow_torch`` module must have an attribute of each name. The port
renames three modules: ``kernels.jnp_ref`` is ``kernels.torch_ref``,
``kernels.pallas_lk`` is ``kernels.lk`` and ``kernels.pallas_warp`` is
``kernels.warp``.

Exceptions: none. What ROADMAP.md section 1 says not to port (the
``custom_vmap`` helpers ``_make_fused``, ``_make_refine`` and
``_make_warp``, ``_interpret_ctx``, the Mosaic workarounds, the marginal
timing) is private to its module, so the listing does not name it; the
benchmark scripts ``bench.py``, ``bench_vo.py`` and ``bench_scaling.py``
lie outside the package.
"""

import ast
import importlib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parents[1] / "tpuflow"
RENAMED = {"jnp_ref": "torch_ref", "pallas_lk": "lk", "pallas_warp": "warp"}
# (reference module, name) -> why the port has no such name. Empty: see the
# module docstring.
EXCEPTIONS: dict[tuple[str, str], str] = {}


def _modules() -> list[str]:
    out = []
    for path in sorted(REFERENCE.rglob("*.py")):
        parts = list(path.relative_to(REFERENCE.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def _public_names(module: str) -> list[str]:
    rel = Path(*module.split("."))
    path = REFERENCE.parent / rel.with_suffix(".py")
    if not path.exists():
        path = REFERENCE.parent / rel / "__init__.py"
    tree = ast.parse(path.read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


def _port_module(module: str) -> str:
    parts = module.split(".")
    return ".".join(["tpuflow_torch", *(RENAMED.get(p, p) for p in parts[1:])])


@pytest.mark.parametrize("module", _modules())
def test_every_public_name_has_a_counterpart(module):
    port = importlib.import_module(_port_module(module))
    missing = [name for name in _public_names(module)
               if not hasattr(port, name) and (module, name) not in EXCEPTIONS]
    assert not missing, f"{_port_module(module)} lacks {missing} of {module}"


def test_the_listing_reads_the_reference():
    # The listing sees the names this check was written for.
    assert "warp_image_banded" in _public_names("tpuflow.kernels.pallas_warp")
    assert {"apply_motion", "generate_test_pattern", "generate_full_suite", "main"} <= set(
        _public_names("tpuflow.eval.patterns"))
    assert "have_native_io" in _public_names("tpuflow.io.frames")
    assert len(_modules()) == 49


def test_warp_image_banded_is_warp_banded():
    from tpuflow_torch.kernels import warp

    assert warp.warp_image_banded is warp.warp_banded
