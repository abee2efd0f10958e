"""track_scan_ms: the engine call's span, fenced by synchronisation, mean
over the window's scans that rebuilt nothing: the tracking step alone (the
filter's prediction, the GN match, the update, the pose's pull)."""


def read(record):
    ms = [e for _, e, rebuilt in record.get("spans") or [] if not rebuilt]
    return sum(ms) / len(ms) if ms else None
