"""Nothing under slambench/ imports JAX or the JAX package, and the
reference and the generator's yardstick import nothing of the port.
Module names are compared whole, so `voxelslam_tpu_torch` is not
`voxelslam_tpu`."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "voxelslam_tpu"}
FILES = sorted(HERE.rglob("*.py"))
STANDALONE = [f for f in FILES
              if "reference" in f.relative_to(HERE).parts
              or f.name == "simref.py"]


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_files_are_found():
    assert len(FILES) > 20 and len(STANDALONE) >= 5


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", STANDALONE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "voxelslam_tpu_torch" not in top_names(path)


def test_whole_names():
    assert "voxelslam_tpu_torch".split(".")[0] not in FORBIDDEN
