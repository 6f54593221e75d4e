# SPDX-License-Identifier: Apache-2.0
"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "nvalchemiops_tpu"}


def _modules(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not FORBIDDEN & set(_imported(path))


@pytest.mark.parametrize("path", sorted(_modules("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imported(path))
    assert "nvalchemiops_torch" not in names
    assert not FORBIDDEN & names


def test_the_walk_sees_through_a_prefix(tmp_path):
    # the port's top-level name starts with the JAX package's: only a whole
    # name is forbidden
    p = tmp_path / "probe.py"
    p.write_text("import nvalchemiops_tpu.grid\nfrom jax import numpy\n"
                 "import nvalchemiops_torch.grid\n")
    assert set(_imported(str(p))) & FORBIDDEN == {"nvalchemiops_tpu", "jax"}
    assert "nvalchemiops_torch" not in FORBIDDEN
