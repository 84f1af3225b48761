"""Nothing under benchmark/ imports JAX or the JAX package (each
import's top-level name compared whole, so karpenter_tpu_torch is not
karpenter_tpu), and nothing under benchmark/reference/ imports the
program."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "karpenter_tpu"}


def sources(sub=""):
    base = os.path.join(ROOT, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert "karpenter_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_the_comparison_is_by_whole_names():
    assert "karpenter_tpu_torch".split(".")[0] not in FORBIDDEN
