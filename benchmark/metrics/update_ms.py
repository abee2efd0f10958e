"""update_ms: the program's `update` span (the ESKF's update by the matched
pose, the nominal's compose, and the decision on the target: LIO's keyframe
test with its host read, Loc's box-edge test), host time over the window,
per scan."""


def read(record):
    ns, scans = record.get("counters", {}).get("update.ns", 0), record.get("window_scans", 0)
    return ns * 1e-6 / scans if ns and scans else None
