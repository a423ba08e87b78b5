"""The torch port imports neither jax nor the JAX package.  Checked in
a subprocess, because this test process (tests/conftest.py) has imported
jax already."""

import ast
import os
import subprocess
import sys
from torch_port import one_torch_thread  # noqa: F401  (autouse)

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


def _extern_c_functions(source):
    """{name: [parameter type, ...]} of the functions a .cu file defines
    inside `extern "C" { ... }`, read from the source text."""
    import re

    body = source[source.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^[\w \*]+?\b(\w+)\(([^)]*)\)\s*\{", body, re.M):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = [p.rsplit(None, 1)[0].replace(" ", "")
                           if not p.endswith("*") else p.replace(" ", "")
                           for p in params if p != "void"]
    return out


def test_ctypes_binding_follows_the_c_interface():
    """Nothing compiles on a CPU-only machine, so the sources are read:
    every extern "C" function of csrc/*.cu is bound in `_ext._bind` with
    one argtype per C parameter, of the matching kind (pointer, int,
    long long), and no kernel source includes a PyTorch header."""
    import ctypes
    import glob

    from sailfish_tpu_torch import _ext

    class FakeFn:
        argtypes = None
        restype = None

    class FakeLib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, FakeFn())

    lib = FakeLib()
    _ext._bind(lib)
    kinds = {"int": ctypes.c_int, "longlong": ctypes.c_longlong,
             "constvoid*": ctypes.c_void_p, "void*": ctypes.c_void_p}
    sources = sorted(glob.glob(os.path.join(
        ROOT, "sailfish_tpu_torch", "csrc", "*.cu")))
    assert [os.path.basename(p) for p in sources] == [
        p.name for p in sorted(_ext.SOURCES)]
    declared = {}
    for path in sources:
        with open(path) as fh:
            src = fh.read()
        for header in ("torch/", "ATen/", "c10/", "pybind11"):
            assert f"#include <{header}" not in src \
                and f'#include "{header}' not in src, (path, header)
        declared.update(_extern_c_functions(src))
    assert {"sf_mmp_scan", "sf_ubench", "sf_ubench_num_variants",
            "sf_cuda_error_string"} <= set(declared)
    assert set(lib.fns) == set(declared)
    for name, params in declared.items():
        fn = lib.fns[name]
        assert fn.restype is not None, name
        assert fn.argtypes is not None, name
        assert [kinds[p] for p in params] == list(fn.argtypes), name


def test_smoke_carries_the_tests_risk_reads():
    """chip_smoke.py imports nothing from tests/, so it carries a copy of
    tests/torch_port.py `risk_reads`: the two must be the same code (the
    docstrings may differ)."""
    def body(path):
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        fn, = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "risk_reads"]
        assert ast.get_docstring(fn)
        return ast.dump(ast.Module(body=fn.body[1:], type_ignores=[]))

    assert body(os.path.join(ROOT, "chip_smoke.py")) == body(
        os.path.join(ROOT, "tests", "torch_port.py"))
