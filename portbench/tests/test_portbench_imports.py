"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under ``portbench/``, and nothing of the program in the
reference.  Top-level names are compared whole: ``repro_torch`` is the
program, ``repro`` the JAX package."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_checker_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.serving\nfrom reprolib import x\n")
    assert imported(src) == {"repro_torch", "reprolib"}
    src.write_text("from repro.models import x\nimport jax.numpy\n")
    assert imported(src) & FORBIDDEN == {"repro", "jax"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert "repro_torch" not in imported(path), path
