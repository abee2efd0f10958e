"""gn_iters_per_scan: the program's count of `gn_step` launches over the
window (one a Gauss-Newton iteration on every path), per scan."""


def read(record):
    n, scans = record.get("counters", {}).get("gn_step", 0), record.get("window_scans", 0)
    return n / scans if n and scans else None
