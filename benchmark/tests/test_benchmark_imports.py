"""What the benchmark may import: never JAX nor the JAX package, anywhere;
and in the reference, nothing of the program.  Names are compared by their
whole top-level part (``doppler_tpu_torch`` is not ``doppler_tpu``)."""

from __future__ import annotations

import ast

import pytest

from benchmark.cell import HERE
from benchmark.run import forbidden_modules

NEVER = {"jax", "jaxlib", "flax", "doppler_tpu"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "doppler_tpu_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "math", "dataclasses",
                              "fractions", "calendar", "time", "numpy",
                              "torch", "benchmark"}


def test_the_run_time_check_compares_whole_top_level_names():
    assert forbidden_modules(["doppler_tpu_torch", "doppler_tpu_torch.cli",
                              "numpy", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["doppler_tpu.ops.nco", "jax.numpy", "jaxlib",
                              "flax.linen", "torch"]) == [
        "doppler_tpu", "flax", "jax", "jaxlib"]
