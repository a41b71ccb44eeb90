"""What the benchmark's files import, by top-level module name compared whole."""

import ast
import os
import subprocess
import sys

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = {"jax", "jaxlib", "flax", "patrol_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            out.add("__import__")
    return out


def sources(sub=""):
    root = os.path.join(PKG, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not top_level_imports(path) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not top_level_imports(path) & (JAX_SIDE | {"patrol_tpu_torch", "torch"}), path


@pytest.mark.parametrize("module", ["peers", "dv2", "streams"])
def test_the_peer_processes_import_neither_torch_nor_the_program(module):
    assert not top_level_imports(os.path.join(PKG, module + ".py")) & (
        JAX_SIDE | {"patrol_tpu_torch", "torch"})
    code = (f"import sys; sys.path.insert(0, {os.path.dirname(PKG)!r}); import portbench.{module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True).stdout
    for name in ("torch", "patrol_tpu_torch", "patrol_tpu", "jax"):
        assert f"'{name}'" not in loaded


def test_the_names_are_compared_whole():
    # The port's name begins with the JAX package's: a prefix test would
    # take one for the other.
    assert "patrol_tpu_torch" not in JAX_SIDE
    assert "patrol_tpu_torch.ops".split(".")[0] not in JAX_SIDE
