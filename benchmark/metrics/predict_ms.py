"""predict_ms: the program's `predict` span (the ESKF's propagation through
the scan's IMU packet, `eskf.predict_scan` in the engine's `step_measure`),
host time over the window, per scan."""


def read(record):
    ns, scans = record.get("counters", {}).get("predict.ns", 0), record.get("window_scans", 0)
    return ns * 1e-6 / scans if ns and scans else None
