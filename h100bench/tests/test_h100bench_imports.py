"""What the harness may import and read: nothing whose whole top-level
module name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package), no file of the JAX era's benchmark, and in the references
nothing of the program under test."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "torch"}
