"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level names are compared
whole: ``torch_asg_tpu_torch`` begins with ``torch_asg_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path.read_text()) & {"jax", "jaxlib", "flax", "torch_asg_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "torch_asg_tpu_torch" not in top_level_imports(path.read_text())


def test_the_check_compares_whole_names():
    src = "import torch_asg_tpu_torch.models\nfrom torch_asg_tpu.x import y\n"
    assert top_level_imports(src) == {"torch_asg_tpu_torch", "torch_asg_tpu"}
