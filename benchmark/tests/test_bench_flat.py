"""A toy copy of `gencode_flat` under `map_polyester10m` (the GENCODE
laws, every transcript expressed), added as files and entries beside
the toy cells: correct against the reference, it reports the rate and
the set-up, its fold metrics read numbers, and the control fails it."""

import json
import math
import os

import pytest
from conftest import toy_files, toy_run

CELL = "toy_gencode_flat.map"
FOLD = ("fold_pull_ms", "fold_host_ms", "labels_ms", "fold_classes",
        "label_mb")


@pytest.fixture(scope="module")
def flat_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flat"))
    spec = toy_files(root)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "gencode_flat.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bdir, "traffic", "map_polyester10m.json")) as f:
        tr = json.load(f)
    with open(os.path.join(bdir, "configs", "toy_gencode_flat.json"),
              "w") as f:
        json.dump(dict(cfg, name="toy_gencode_flat", transcripts=60), f)
    with open(os.path.join(bdir, "traffic", "toy_map_polyester.json"),
              "w") as f:
        json.dump(dict(tr, batches=4, batch=256, check_fragments=300), f)
    entry = next(c for c in spec["configs"] if c["name"] == "gencode_flat")
    cell = next(w for w in spec["workloads"]
                if w["name"] == "gencode_flat.map")
    spec["configs"].append(dict(entry, name="toy_gencode_flat",
                                file="benchmark/configs/toy_gencode_flat.json"))
    spec["workloads"].append(dict(cell, name=CELL, config="toy_gencode_flat",
                                  traffic="toy_map_polyester"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gencode_flat.map" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def test_flat_cell_is_correct(flat_root):
    _, out = toy_run(flat_root, CELL)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frags_per_s", "setup_s"}
    assert out["metrics"]["frags_per_s"]["value"] > 0


def test_flat_cell_traced_reads_the_fold(flat_root):
    from sailfish_tpu_torch import trace

    trace.reset()
    run, out = toy_run(flat_root, CELL, traced=True)
    assert out["correct"], out["checks"]
    got = {n: out["metrics"][n]["value"] for n in FOLD}
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["fold_classes"] > 0 and got["label_mb"] > 0
    assert got["fold_pull_ms"] > 0 and got["fold_host_ms"] > 0
    # the fold's parts lie inside the fold that the benchmark times
    parts = got["fold_pull_ms"] + got["fold_host_ms"]
    assert parts < max(run.spans.ms("fold"))


def test_flat_control_is_not_correct(flat_root):
    _, out = toy_run(flat_root, CELL, control=True)
    assert not out["correct"], out["checks"]
