"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Names are compared whole, by the part
before the first dot: the port's name begins with the JAX package's."""

import ast
import os

import pytest

from perfbench.harness import HERE, forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "reprover_tpu"}


def _sources(sub=""):
    root = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_perfbench_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    assert not any(n.startswith("reprover_tpu_torch.benchmarks") for n in _imports(path))


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_perfbench_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "reprover_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_perfbench_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "reprover_tpu_torch_like", types.ModuleType("x"))
    assert "reprover_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "reprover_tpu.ops", types.ModuleType("x"))
    assert "reprover_tpu" in forbidden_modules()
