"""map_build_replay_share: the share of the window's map builds that ran as
one CUDA graph replay (LIO, matcher "icp"): the program's
`map_build.replays` counter over the `map_build` span's calls. Nothing
where the program keeps no such counter (a checkout from before the graph)
or made no build."""


def read(record):
    c = record.get("counters", {})
    replays, calls = c.get("map_build.replays"), c.get("map_build.calls", 0)
    return replays / calls if replays is not None and calls else None
