"""Nothing the benchmark runs loads JAX or the JAX package, compared by
the whole top-level name; the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "sailfish_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in d.split(os.sep) or ".bench_cache" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        got = set(_imports(path))
        assert "sailfish_tpu_torch" not in got, path
        assert not got & FORBIDDEN, path


def test_a_run_loads_no_jax(toy_root):
    """A toy run in a fresh process, then its modules, by whole
    top-level name (sailfish_tpu_torch begins with sailfish_tpu)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import toy_run\n"
        "toy_run(%r, 'toy_gencode.map')\n"
        "toy_run(%r, 'toy_gencode.em')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (ROOT, os.path.dirname(__file__), toy_root, toy_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "sailfish_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_process_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.mapper, benchmark.reference.em\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & (FORBIDDEN | {"sailfish_tpu_torch"})


def test_a_run_that_holds_jax_fails(toy_root, monkeypatch):
    import types

    import pytest
    from conftest import toy_run

    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.JaxLoaded, match="jax"):
        toy_run(toy_root, "toy_gencode.em")
