"""Spans the benchmark takes around its calls into the port, and the
reduction of a `torch.profiler` trace of the window.

A span is a host-clock interval named after the call it wraps; in a
traced run it is also a `record_function` range named `bench.<name>`,
so the trace can say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import time

SPAN_PREFIX = "bench."


class Spans:
    """Named host-clock intervals, in `time.perf_counter` seconds."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.t: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(SPAN_PREFIX + name)
        else:
            rf = contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.t.setdefault(name, []).append(
                    (t0, time.perf_counter()))

    def ms(self, name: str) -> list:
        return [1e3 * (b - a) for a, b in self.t.get(name, [])]


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(prof) -> dict:
    """From a finished `torch.profiler.profile` of the window (whose
    `bench.window` span marks it): the device's busy seconds (the union
    of every kernel, copy and fill on the device), the window's seconds,
    device time and launches by operation name, and the idle gaps, each
    named by the innermost span the host was in at its middle."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a span's range on the device's timeline is no device work
            if not e.name().startswith(SPAN_PREFIX):
                dev.append((a, b, e.name()))
        elif e.name().startswith(SPAN_PREFIX):
            host.append((a, b, e.name()[len(SPAN_PREFIX):]))
    win = [(a, b) for a, b, n in host if n == "window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = win[0]
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in dev if b > a])
    ops: dict[str, list] = {}
    for a, b, n in dev:
        o = ops.setdefault(n, [0, 0.0])
        o[0] += 1
        o[1] += (b - a) * 1e-9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    inner = sorted((b - a, a, b, n) for a, b, n in host if n != "window")

    def doing(t):
        for _, a, b, n in inner:
            if a <= t <= b:
                return n
        return "other"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "ops": {n: {"launches": c, "seconds": s} for n, (c, s) in ops.items()},
        "launches": sum(c for c, _ in ops.values()),
        "gaps": [(f"host in {doing((a + b) / 2)}", (b - a) * 1e-9)
                 for a, b in gaps[:10]],
    }


def breakdown(tr: dict) -> dict:
    """The result line's `breakdown`: the 10 device operations that took
    most time, and the 10 longest idle gaps."""
    top = sorted(tr["ops"].items(), key=lambda kv: -kv[1]["seconds"])[:10]
    return {"device_ops": [[n[:120], v["seconds"]] for n, v in top],
            "idle_gaps": [[n, s] for n, s in tr["gaps"]]}
