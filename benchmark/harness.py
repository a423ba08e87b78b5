"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell needs is found by name from `BENCHMARK.json`:
`benchmark/configs/<config>.json` (the file the entry names),
`benchmark/traffic/<traffic>.json` (whose `kind` names the driver,
`benchmark/drivers/<kind>.py`) and, for each per-layer metric,
`benchmark/metrics/<name>.py`, whose `read(run)` returns the number or
None.  A driver has `setup(run)`, `window(run)` and `check(run)`; the
window's end-to-end numbers go to `run.e2e`, the compared numbers to
`run.checks` as (name, value, limit).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback

from .tracing import Spans, breakdown, reduce_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "sailfish_tpu")


class JaxLoaded(RuntimeError):
    """The process that measured holds JAX or the JAX package."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- spec
def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def end_to_end_for(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_for(spec: dict, cell: str) -> list:
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def metric_reader(root: str, name: str):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def require_no_jax() -> None:
    """Raise when this process holds JAX or the JAX package, compared
    by whole top-level module names."""
    leaked = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if leaked:
        raise JaxLoaded("the measuring process holds " + ", ".join(leaked))


# ---------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    root: str
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: object
    cache: str
    control: bool = False
    workers: int = 1
    spans: Spans = None
    e2e: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    state: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    trace: dict | None = None


def make_run(root: str, cell_name: str, seed: int, seconds: float,
             traced: bool, device, control: bool = False,
             workers: int | None = None) -> Run:
    spec = load_spec(root)
    cell = by_name(spec["workloads"], cell_name, "workload")
    entry = by_name(spec["configs"], cell["config"], "configuration")
    cfg_path = os.path.join(root, entry["file"])
    with open(cfg_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    cfg = load_json(cfg_path)
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     cell["traffic"] + ".json"))
    import torch

    return Run(root=root, cell=cell, cfg=cfg, traffic=traffic, seed=seed,
               seconds=seconds, traced=traced, device=torch.device(device),
               cache=os.path.join(root, "benchmark", ".bench_cache",
                                  f"{cfg['name']}-{digest}"),
               control=control,
               workers=workers or min(8, os.cpu_count() or 1),
               spans=Spans(traced))


def run_cell(run: Run, t0: float | None = None) -> dict:
    """Set up, measure and check `run`; returns the result object."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(run.root)
    name = run.cell["name"]
    driver = importlib.import_module(
        f"benchmark.drivers.{run.traffic['kind']}")
    cuda = run.device.type == "cuda"
    driver.setup(run)
    log("setup: " + ", ".join(f"{n} {sum(b - a for a, b in iv):.3f} s"
                             for n, iv in run.spans.t.items()))
    if cuda:
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    prof = None
    if run.traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    w0 = time.perf_counter()
    run.setup_s = w0 - t0
    with run.spans("window"):
        driver.window(run)
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = reduce_trace(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    require_no_jax()
    driver.check(run)
    metrics = {}
    if run.traced:
        for m in per_layer_for(spec, name):
            v = metric_reader(run.root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in end_to_end_for(spec, name):
            v = (run.setup_s if m["name"] == "setup_s"
                 else run.e2e[m["name"]])
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": all(v <= lim for _, v, lim in run.checks)
           and bool(run.checks),
           "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in run.checks}
    require_no_jax()
    return out


def main(argv, t0: float, root: str) -> int:
    ap = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="one measured run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = by_name(load_spec(root)["workloads"], args.workload,
                       "workload")
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            log(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
                f"torch sees {torch.cuda.device_count()} "
                f"(available: {torch.cuda.is_available()}); no result")
            return 2
        run = make_run(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda")
        out = run_cell(run, t0)
    except Exception:
        traceback.print_exc()
        log("benchmark: the run failed; no result")
        return 1
    print(json.dumps(out), flush=True)
    for n, c in out["checks"].items():
        log(f"check {n}: {c['value']} (limit {c['limit']})")
    return 0
