"""The import guard: nothing under bench/ imports JAX or the JAX package,
nothing under bench/reference/ imports the port; top-level names compared
whole (the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    # nor through the harness modules it uses
    for mod in top_level_imports(path):
        assert mod in {"bench", "math", "torch", "__future__", "numpy", "statistics",
                       "importlib"}


@pytest.mark.parametrize("path", [BENCH / "harness" / "inputs.py", BENCH / "harness" / "counts.py",
                                  *sorted((BENCH / "families").glob("*.py"))],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_helpers_import_nothing_of_the_port(path):
    """The modules the reference and the yardstick's counts use: the
    inputs, the counts and the family layouts."""
    assert "repro_torch" not in top_level_imports(path)


def test_the_guard_sees_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jax import numpy\nimport reprox\n")
    assert top_level_imports(f) & JAX_SIDE == {"jax"}


def test_nothing_reads_the_jax_benchmark():
    word = "bench" + "marks"
    for path in SOURCES:
        assert word not in path.read_text(), path
