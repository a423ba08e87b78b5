"""The benchmark's command: one run of one cell on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object; the compared numbers and their limits are the last lines
of standard error.  Without a CUDA card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.  Build and kernel caches
stay inside `benchmark/.bench_cache/` and the port's own build directory.

This module imports only the standard library at its top, because the
reference's worker processes (spawned) import it again.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    cache = os.path.join(HERE, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    # the script's own directory is not a package root
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    from benchmark import harness

    return harness.main(argv, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
