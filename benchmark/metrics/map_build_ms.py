"""map_build_ms: the program's `map_build` span (LIO's keyframe push and
local-map target, Loc's re-crop and its target), host time, mean a build
over the window (a build, not a scan)."""


def read(record):
    c = record.get("counters", {})
    ns, calls = c.get("map_build.ns", 0), c.get("map_build.calls", 0)
    return ns * 1e-6 / calls if ns and calls else None
