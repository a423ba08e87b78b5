"""Readings for the limits: the cell's compared numbers from the
program and from the control, in one process, seed by seed, on the
card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

One JSON line a run on standard output: the seed, the compared numbers
and whether they passed.  The control is the cell's own (`control` in a
map traffic: the port's compacted scan; in an EM cell the float32
reference in the program's place).  The program's own readings are the
benchmark's runs, which never run the control.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse
    import gc
    import json

    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.make_run(ROOT, args.workload, seed, args.seconds,
                               False, "cuda", control=True)
        out = harness.run_cell(run)
        print(json.dumps({"seed": seed, "side": "control",
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
        del run, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
