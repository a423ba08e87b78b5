"""Toy cells run end to end on the CPU through the port's `--device cpu`
path and agree with the reference; cells, configurations and per-layer
metrics added as data files alone are found and run."""

import json
import os

import pytest
from conftest import toy_files, toy_run

CELLS = ["toy_ecoli.map", "toy_gencode.map", "toy_gencode.em"]


@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_is_correct(toy_root, cell):
    _, out = toy_run(toy_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_traced(toy_root, cell):
    _, out = toy_run(toy_root, cell, traced=True)
    assert out["correct"], out["checks"]
    assert "setup_s" not in out["metrics"]
    layer = {"toy_gencode.em": "em_iter_ms"}.get(cell, "fold_ms")
    assert out["metrics"][layer]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_added_data_files_are_found_and_run(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and entries only."""
    root = str(tmp_path)
    spec = toy_files(root)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "toy_ecoli.json")) as f:
        cfg = json.load(f)
    cfg = dict(cfg, name="toy_added", transcripts=25,
               world=dict(cfg["world"], seed=5))
    with open(os.path.join(bdir, "configs", "toy_added.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "toy_map_pool.json")) as f:
        tr = json.load(f)
    with open(os.path.join(bdir, "traffic", "toy_added_mix.json"), "w") as f:
        json.dump(dict(tr, batches=2, substitution_rate=0.01), f)
    with open(os.path.join(bdir, "metrics", "submits.py"), "w") as f:
        f.write("def read(run):\n    return len(run.spans.ms('submit'))\n")
    spec["configs"].append(dict(spec["configs"][1], name="toy_added",
                                file="benchmark/configs/toy_added.json"))
    spec["workloads"].append(dict(name="toy_added.map", config="toy_added",
                                  traffic="toy_added_mix", chips=1,
                                  why="added as data"))
    spec["per_layer"].append(dict(name="submits", unit="batches",
                                  better="higher", source="host_clock",
                                  layer="map/pipeline.py submit_pe",
                                  moves="frags_per_s",
                                  workloads=["toy_added.map"]))
    for m in spec["end_to_end"]:
        if "workloads" in m and "toy_ecoli.map" in m["workloads"]:
            m["workloads"].append("toy_added.map")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    _, out = toy_run(root, "toy_added.map", traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["submits"]["value"] >= 1
    _, out = toy_run(root, "toy_added.map")
    assert out["metrics"]["frags_per_s"]["value"] > 0


def test_unknown_quant_key_raises(tmp_path):
    """A misspelled option in a configuration's `quant` group is an
    error, not a silent default."""
    root = str(tmp_path)
    toy_files(root)
    path = os.path.join(root, "benchmark", "configs", "toy_ecoli.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["quant"]["hit_capacty"] = 32
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(TypeError, match="hit_capacty"):
        toy_run(root, "toy_ecoli.map")
