"""The command fails, and prints no result, where there is no card, and
in a directory that holds only BENCHMARK.json and the benchmark's
files; on a card it runs a cell (marked `card`)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT


def _run(cwd, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout)


def _no_card():
    import torch

    return not torch.cuda.is_available()


def test_no_card_no_result():
    if not _no_card():
        pytest.skip("a CUDA card is present")
    p = _run(ROOT, "--workload", "ecoli.map", "--seed", "3",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".bench_cache", "__pycache__"))
    p = _run(str(tmp_path), "--workload", "ecoli.map", "--seed",
             "2147483659", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.card
def test_card_runs_a_cell():
    if _no_card():
        pytest.skip("no CUDA card")
    p = _run(ROOT, "--workload", "ecoli.map", "--seed", "2147483659",
             "--seconds", "2", "--trace", "0", timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
