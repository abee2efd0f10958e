"""record_ms: the program's `record` span (the engine's pull of the pose to
the host, which waits for the scan's work on the card, and the health
update), host time over the window, per scan."""


def read(record):
    ns, scans = record.get("counters", {}).get("record.ns", 0), record.get("window_scans", 0)
    return ns * 1e-6 / scans if ns and scans else None
