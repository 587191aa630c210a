"""No module under ``bench/`` imports JAX, flax or the JAX package
``repro``, and the plain reference imports nothing of the program
(``repro_torch``) either. Top-level names are compared whole, so
``repro_torch`` is not taken for ``repro``. Scanned with ``ast``, so an
import inside a function counts."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub=""):
    out = []
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not set(_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_plain(path):
    roots = set(_roots(path))
    assert roots <= {"math", "torch", "numpy", "__future__"}, roots
