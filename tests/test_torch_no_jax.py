"""The PyTorch port must run where JAX is not installed: importing every
module of ``lambda_elliptic_curves_tpu_torch`` pulls in neither ``jax``
nor the JAX package.  Checked in a fresh interpreter in which importing
either raises."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
