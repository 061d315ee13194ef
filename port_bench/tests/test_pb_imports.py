"""What the benchmark may import, by the top-level name of every import,
compared whole: nothing of JAX or the JAX package anywhere, nothing of the
port in the reference, and never the root ``bench.py``."""

import ast
from pathlib import Path

import pytest

from port_bench import run, spec

JAX = {"jax", "jaxlib", "flax", "rvgrt_tpu"}
MODULES = sorted(spec.HERE.rglob("*.py"))
REFERENCE = spec.HERE / "reference"


def top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_pb_no_jax_anywhere(path):
    names = top_names(path)
    assert not names & JAX, names & JAX
    assert "bench" not in names
    if REFERENCE in path.parents:
        assert "rvgrt_tpu_torch" not in names
        assert names <= {"torch", "numpy", "math", "dataclasses", "typing",
                         "__future__", "os", "struct", "zlib", "pathlib",
                         "functools", "statistics", "sys", "time",
                         "collections"}, names


def test_pb_the_guard_compares_whole_names():
    assert top_names.__doc__ is None  # the test's own helper
    assert run.forbidden_modules(["rvgrt_tpu_torch", "rvgrt_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["rvgrt_tpu.world", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "rvgrt_tpu"]


def test_pb_no_module_is_named_bench():
    assert not [p for p in MODULES if p.stem == "bench"]
