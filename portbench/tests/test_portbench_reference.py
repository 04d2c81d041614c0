"""The plain reference stands alone: no module under portbench/reference
imports jax, the JAX package or the program, compared by whole top-level
names."""

import ast

import pytest

from portbench.tests import helpers

FORBIDDEN = {"jax", "jaxlib", "flax", "music_generator_tpu",
             "music_generator_tpu_torch"}
REF = sorted((helpers.ROOT / "portbench" / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REF, ids=lambda p: p.name)
def test_reference_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch", "portbench"}
