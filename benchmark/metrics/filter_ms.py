"""filter_ms: the scan filter's span (`pipeline.lio.preprocess_scan`: the
voxel filter of the raw scan), fenced by synchronisation, mean over the
window's scans."""


def read(record):
    spans = record.get("spans") or []
    return sum(f for f, _, _ in spans) / len(spans) if spans else None
