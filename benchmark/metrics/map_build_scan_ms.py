"""map_build_scan_ms: the engine call's span, fenced by synchronisation,
mean over the window's scans after which the engine rebuilt its target (a
keyframe pushed, or the local map re-cropped)."""


def read(record):
    ms = [e for _, e, rebuilt in record.get("spans") or [] if rebuilt]
    return sum(ms) / len(ms) if ms else None
