"""The torch port imports neither jax nor the JAX package.  Checked in
a subprocess, because this test process (tests/conftest.py) has imported
jax already."""

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
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sailfish_tpu"))
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 30 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


def test_port_reaches_the_jax_package_through_host_only():
    """No file of the port, nor chip_smoke.py, imports jax or the JAX
    package (the port keeps its own copy of every host module it needs;
    sailfish_tpu_torch/host.py, once the one bridge, is gone), and the
    port loads no binary from sailfish_tpu/."""
    pkg = os.path.join(ROOT, "sailfish_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    assert len(files) > 30
    importers = sorted({
        os.path.relpath(path, ROOT) for path in files
        for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "sailfish_tpu")})
    assert importers == []
    assert not os.path.exists(os.path.join(pkg, "host.py"))
    for path in files:
        with open(path) as fh:
            assert "_native.so" not in fh.read(), path


def test_kernel_build_is_not_triggered_by_import():
    """Importing the port builds nothing: the CUDA library is compiled at
    first use only (there is no nvcc on a CPU-only machine)."""
    probe = ("import sailfish_tpu_torch.map.scan, sailfish_tpu_torch.ubench,"
             " sailfish_tpu_torch.io.native as n, sailfish_tpu_torch._ext "
             "as e; print(e._LOADED is None and not n._TRIED)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"
