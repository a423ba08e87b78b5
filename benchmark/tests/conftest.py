"""Toy cells for the benchmark's CPU tests: a copy of the benchmark's
data files under a temporary root, with small configurations and
traffic beside them, run in-process on the CPU."""

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def toy_files(root: str) -> dict:
    """Write toy configurations, traffic and a BENCHMARK.json under
    `root`; returns the spec."""
    src = os.path.join(ROOT, "benchmark")
    dst = os.path.join(root, "benchmark")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(src, d), os.path.join(dst, d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(src, "configs", "ecoli.json")) as f:
        eco = json.load(f)
    with open(os.path.join(src, "configs", "gencode.json")) as f:
        gen = json.load(f)
    eco = dict(eco, name="toy_ecoli", transcripts=40)
    gen = dict(gen, name="toy_gencode", transcripts=60)
    traffic = {}
    for name in ("map_pool12", "map_sample10m", "em_sample10m"):
        with open(os.path.join(src, "traffic", name + ".json")) as f:
            traffic[name] = json.load(f)
    toy = {
        "toy_map_pool": dict(traffic["map_pool12"], batches=3, batch=256,
                             check_fragments=300),
        "toy_map_sample": dict(traffic["map_sample10m"], batches=3,
                               batch=256, check_fragments=300),
        "toy_em": dict(traffic["em_sample10m"], fragments=20_000),
    }
    for name, c in (("toy_ecoli", eco), ("toy_gencode", gen)):
        with open(os.path.join(dst, "configs", name + ".json"), "w") as f:
            json.dump(c, f)
    for name, t in toy.items():
        with open(os.path.join(dst, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    spec = copy.deepcopy(spec)
    spec["configs"] += [
        dict(spec["configs"][1], name="toy_ecoli",
             file="benchmark/configs/toy_ecoli.json"),
        dict(spec["configs"][0], name="toy_gencode",
             file="benchmark/configs/toy_gencode.json")]
    cells = [("toy_ecoli.map", "toy_ecoli", "toy_map_pool"),
             ("toy_gencode.map", "toy_gencode", "toy_map_sample"),
             ("toy_gencode.em", "toy_gencode", "toy_em")]
    spec["workloads"] += [dict(name=n, config=c, traffic=t, chips=1,
                               why="a toy cell for the CPU tests")
                          for n, c, t in cells]
    # each toy cell reports the metrics of the cell whose driver it runs
    like = {"toy_ecoli.map": "ecoli.map", "toy_gencode.map": "ecoli.map",
            "toy_gencode.em": "gencode.em"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                t for t, w in like.items() if w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    toy_files(root)
    return root


def toy_run(root, cell, seed=12345, seconds=1.5, traced=False, **kw):
    from benchmark import harness

    run = harness.make_run(root, cell, seed, seconds, traced, "cpu",
                           workers=kw.pop("workers", 1), **kw)
    return run, harness.run_cell(run)
