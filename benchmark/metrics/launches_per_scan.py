"""launches_per_scan: the device events (kernels, copies, fills) of the
profiled slice, per scan."""


def read(record):
    sl = record.get("slice")
    if sl is None or not sl.events:
        return None
    return len(sl.events) / sl.scans
