"""What the benchmark may import: no module under benchmark/ imports
jax, jaxlib, flax or the JAX package cassandra_tpu (top-level names
compared whole: cassandra_tpu_torch is the program), and the plain
reference and the generator import nothing of the program."""
import ast
import os

import pytest

import _paths

FORBIDDEN = {"jax", "jaxlib", "flax", "cassandra_tpu"}
FILES = sorted(
    os.path.join(d, f) for d, _s, fs in os.walk(_paths.BENCH)
    for f in fs if f.endswith(".py"))
# what stands apart from the program
INDEPENDENT = [f for f in FILES
               if os.sep + "reference" + os.sep in f
               or f.endswith(os.path.join("harness", "stress.py"))
               or f.endswith(os.path.join("harness", "costs.py"))]


def top_level_imports(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, _paths.BENCH))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", INDEPENDENT,
                         ids=lambda p: os.path.relpath(p, _paths.BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "cassandra_tpu_torch" not in top_level_imports(path)


def test_names_compared_whole():
    assert "cassandra_tpu_torch" not in FORBIDDEN
    assert not {"cassandra_tpu_torch"} & FORBIDDEN


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    import run
    monkeypatch.setitem(sys.modules, "cassandra_tpu",
                        types.ModuleType("cassandra_tpu"))
    assert run.forbidden_modules() == ["cassandra_tpu"]
    monkeypatch.delitem(sys.modules, "cassandra_tpu")
    assert "cassandra_tpu" not in run.forbidden_modules()
