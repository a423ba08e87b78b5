"""The scan kernel's share of its roofline: the least time of one launch
on the window's first batch (`benchmark/roofline.py`, from the work
those inputs need) over the mean time of a `mmp_scan_kernel` launch in
the traced window."""


def read(run):
    tr, bound = run.trace, run.counters.get("scan_bound_ms")
    if not tr or bound is None:
        return None
    k = [v for n, v in tr["ops"].items() if "mmp_scan_kernel" in n]
    launches = sum(v["launches"] for v in k)
    if not launches:
        return None
    ms = 1e3 * sum(v["seconds"] for v in k) / launches
    return 100.0 * bound / ms
