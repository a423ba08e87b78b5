"""The window's batch folds as the port records them in a traced run
(sailfish_tpu_torch/trace.py): for each batch its `map.fold` record and
the records that carry its id, for the fold's per-layer metrics.  Each
function returns None where the port keeps no such records or counts."""


def folds(run):
    """{batch id: (the batch's own `map.fold` record, the batch's
    records by name)} for the folds inside the window, or None."""
    try:
        from sailfish_tpu_torch import trace
    except ImportError:
        return None
    w = run.spans.t.get("window")
    if not w:
        return None
    lo, hi = (int(1e9 * t) for t in w[0])
    recs = [r for r in trace.records() if lo <= r.start and r.end <= hi]
    out = {}
    # records are in the order their spans opened, so a batch's own fold
    # comes before the escalation pass's fold nested in it
    for r in recs:
        if r.name == "map.fold" and r.ident not in out:
            out[r.ident] = (r, {})
    for r in recs:
        if r.ident in out:
            out[r.ident][1].setdefault(r.name, []).append(r)
    return out or None


def span_ms(run, name: str):
    """Host ms a batch in its `name` spans (0 where it opened none)."""
    f = folds(run)
    if f is None:
        return None
    return [1e-6 * sum(r.ns for r in by.get(name, ())) for _, by in f.values()]


def counts(run, name: str):
    """The count `name` made inside each batch's fold (0 where none), or
    None where the port counts no `map.fold_classes` in its folds."""
    f = folds(run)
    if f is None or not any("map.fold_classes" in r.counts
                            for r, _ in f.values()):
        return None
    return [r.counts.get(name, 0) for r, _ in f.values()]
