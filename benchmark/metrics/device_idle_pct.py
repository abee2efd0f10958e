"""device_idle_pct: the share of the time in which no kernel or copy ran on
the card over the profiled slice: one minus the union of the device events'
intervals (overlaps count once) over the time the slice's scans take
without the profiler (its scans times the fenced window's seconds a scan).
The profiler's own cost a launch stretches the slice's host time, not the
device's work, so the slice's own length would count that cost as idle."""

from yardstick import trace


def read(record):
    sl, per_scan = record.get("slice"), record.get("s_per_scan")
    if sl is None or not sl.events or not per_scan:
        return None
    busy = trace.union_s([(s, e) for _, s, e in sl.events])
    return 100.0 * (1.0 - busy / (sl.scans * per_scan))
