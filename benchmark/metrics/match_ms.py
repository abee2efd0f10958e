"""match_ms: the program's `match` span (the prior pose from the filter's
nominal, then the Gauss-Newton loop with its host reads of the stop flag),
host time over the window, per scan."""


def read(record):
    ns, scans = record.get("counters", {}).get("match.ns", 0), record.get("window_scans", 0)
    return ns * 1e-6 / scans if ns and scans else None
