"""Nothing under cardbench/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast

import pytest

from cardbench import harness
from conftest import ROOT

FILES = sorted((ROOT / "cardbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((ROOT / "cardbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & {"psulvsb_tpu_torch", "psulvsb_tpu"}
    assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch"}


def test_the_check_compares_whole_names():
    import sys

    sys.modules.setdefault("psulvsb_tpu_torch_like", sys)
    try:
        assert "psulvsb_tpu_torch_like" not in harness.forbidden_loaded()
    finally:
        del sys.modules["psulvsb_tpu_torch_like"]
