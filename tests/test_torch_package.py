"""The torch port imports no jax.  Checked in a subprocess, because this
test process (tests/conftest.py) has imported jax already."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import sailfish_tpu_torch
mods = []
for m in pkgutil.walk_packages(sailfish_tpu_torch.__path__,
                               "sailfish_tpu_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 12 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_reaches_the_jax_package_through_host_only():
    """sailfish_tpu_torch/host.py is the port's one import of the JAX
    package's host modules; no other module of the port imports
    sailfish_tpu, so callers of the port need not either."""
    pkg = os.path.join(ROOT, "sailfish_tpu_torch")
    importers = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module or ""]
                else:
                    continue
                if any(m == "sailfish_tpu" or m.startswith("sailfish_tpu.")
                       for m in mods):
                    importers.append(os.path.relpath(path, ROOT))
    assert sorted(set(importers)) == [os.path.join("sailfish_tpu_torch",
                                                   "host.py")]


def test_kernel_build_is_not_triggered_by_import():
    """Importing the port builds nothing: the CUDA library is compiled at
    first use only (there is no nvcc on a CPU-only machine)."""
    probe = ("import sailfish_tpu_torch.map.scan, sailfish_tpu_torch._ext "
             "as e; print(e._LOADED is None)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"
