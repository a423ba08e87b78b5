"""Seconds of `index/builder.py::load_index` and the backend's upload of
the index to the device (`make_backend`), in set-up."""


def read(run):
    t = run.spans.t.get("index_load")
    return t[0][1] - t[0][0] if t else None
