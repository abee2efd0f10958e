"""filter_span_ms: the program's own `filter` span (`pipeline.lio.
preprocess_scan`: the voxel filter of the raw scan), host time, mean a call
over the window. Unlike `filter_ms` it is not fenced: it ends when the
filter's work is enqueued, not when the card has done it."""


def read(record):
    c = record.get("counters", {})
    ns, calls = c.get("filter.ns", 0), c.get("filter.calls", 0)
    return ns * 1e-6 / calls if ns and calls else None
