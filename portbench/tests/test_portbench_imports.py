"""No file of the benchmark imports JAX or the JAX package (`repro`),
top-level names compared whole; the yardstick imports nothing of the port.
"""
import ast
import os

import pytest

from portbench.tests.small import ROOT

HERE = os.path.join(ROOT, "portbench")
BANNED = {"jax", "jaxlib", "flax", "repro"}
#: The yardstick: the reference, the generators, the arithmetic and the
#: check, which may not import the port.
YARDSTICK = ("reference.py", "roofline.py", "check.py", "trace.py",
             "generators/hpcg.py", "generators/kronecker.py",
             "generators/__init__.py")


def _files():
    for dirpath, _, names in os.walk(HERE):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, name), HERE)


def top_level_imports(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", list(_files()))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_names_compared():
    assert "repro" in BANNED and "repro_torch" not in BANNED
