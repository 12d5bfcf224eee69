"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port (top-level names compared whole)."""

import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "oct_image_segmentation_models_tpu"}
PORT = "oct_image_segmentation_models_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    names = top_level_imports(path)
    assert PORT not in names and "portbench" not in names
    assert not any(n.startswith(PORT) for n in names)


def test_the_names_are_compared_whole():
    # The port's name begins with the JAX package's stem; neither is the other.
    assert PORT not in FORBIDDEN and PORT.split(".")[0] != "oct_image_segmentation_models_tpu"
