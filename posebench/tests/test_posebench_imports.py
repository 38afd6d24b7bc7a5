"""Nothing under posebench/ imports JAX or the JAX package, by whole
top-level module names; the reference imports nothing of the program."""

from __future__ import annotations

import ast
import pathlib

import pytest

from posebench.harness.device import FORBIDDEN, forbidden_modules

from conftest import CHECKOUT

BENCH = CHECKOUT / "posebench"


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not imported(path) & {"dino_pose_tpu_torch", *FORBIDDEN}


def test_names_compared_whole():
    assert forbidden_modules(["dino_pose_tpu_torch", "dino_pose_tpu_torch.ops", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "flax", "dino_pose_tpu.models"]) == [
        "dino_pose_tpu", "flax", "jax"]
