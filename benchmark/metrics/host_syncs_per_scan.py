"""host_syncs_per_scan: the program's blocking reads of the card (the
`sync` span's calls: the GN stop flag, the keyframe test, the pose's pull,
the IMU packet ring's event wait) over the window, per scan."""


def read(record):
    n, scans = record.get("counters", {}).get("sync.calls", 0), record.get("window_scans", 0)
    return n / scans if n and scans else None
