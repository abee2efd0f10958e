"""sync_wait_ms: the time the host spent blocked on the card (the `sync`
span's host time, every blocking read of the program) over the window, per
scan."""


def read(record):
    ns, scans = record.get("counters", {}).get("sync.ns", 0), record.get("window_scans", 0)
    return ns * 1e-6 / scans if ns and scans else None
