"""Window ms over all EM iterations of the window's solves."""


def read(run):
    its = run.counters.get("em_iters")
    if not its:
        return None
    return 1e3 * run.counters["em_window_s"] / sum(its)
