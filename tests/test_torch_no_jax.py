"""The PyTorch port must run where JAX is not installed: importing every
module of ``lambda_elliptic_curves_tpu_torch`` pulls in neither ``jax``
nor the JAX package (checked in a fresh interpreter in which importing
either raises), and no module reads a file of the JAX package by path."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = pathlib.Path(ROOT) / "lambda_elliptic_curves_tpu_torch"

_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "lambda_elliptic_curves_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"the port imported {name}")
            return None

    before = set(sys.modules)
    sys.meta_path.insert(0, Block())
    import lambda_elliptic_curves_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = [m for m in set(sys.modules) - before if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    assert "jax" not in sys.modules
    print(len(names))
""")


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    # every module of the slice was imported (the package has more than 20)
    assert int(r.stdout.split()[-1]) > 20


_JAX_PKG = re.compile(r"\blambda_elliptic_curves_tpu\b")


def _docstring_nodes(tree) -> set:
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                found.add(id(first.value))
    return found


def test_port_builds_no_path_into_the_jax_package():
    """No string in the port's code names the JAX package's directory, so
    no path into it can be built.  Docstrings may name a counterpart."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = _docstring_nodes(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and _JAX_PKG.search(node.value)):
                offenders.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not offenders, offenders


def test_host_keccak_is_built_from_the_ports_own_source():
    from lambda_elliptic_curves_tpu_torch import native

    src = pathlib.Path(native.HOST_KECCAK_SRC).resolve()
    assert src.is_file() and src.is_relative_to(PORT.resolve())
