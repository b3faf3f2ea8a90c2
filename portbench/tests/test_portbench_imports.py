"""The import guard: no module under portbench/ imports the JAX side, and
the plain references import nothing of the program.  Top-level names are
compared whole, since the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FOREIGN = {"jax", "jaxlib", "flax", "partitionedarrays_tpu"}
PROGRAM = "partitionedarrays_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(PB)) for p in MODULES])
def test_no_module_imports_the_jax_side(path):
    assert not (_top_level_imports(path) & FOREIGN)


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import partitionedarrays_tpu_torch.psparse\nfrom jax import numpy\n")
    assert _top_level_imports(f) == {"partitionedarrays_tpu_torch", "jax"}
    assert _top_level_imports(f) & FOREIGN == {"jax"}


def test_the_run_guard_names_loaded_modules_of_the_jax_side(monkeypatch):
    import sys
    import types

    sys.path.insert(0, str(PB.parent))
    from portbench import run

    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    monkeypatch.setitem(sys.modules, "partitionedarrays_tpu_torch_x", types.ModuleType("x"))
    found = run.foreign_modules()
    assert "flax" in found and "partitionedarrays_tpu_torch_x" not in found
    assert "partitionedarrays_tpu_torch" not in found
