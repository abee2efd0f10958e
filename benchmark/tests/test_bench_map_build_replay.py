"""The reader of the map build's graph replays: `map_build.replays` over the
`map_build` span's calls in the window, and nothing where the program keeps
no such counter or made no build."""

import json

from conftest import BENCH

from yardstick import cell

COUNTERS = {"map_build.ns": 16.0e6, "map_build.calls": 8, "map_build.replays": 6,
            "gn_step": 40}


def test_the_reader_gives_replays_a_build_and_nothing_without_its_counter():
    read = cell.load_module("metrics", "map_build_replay_share").read
    assert read({"counters": COUNTERS}) == 0.75
    assert read({"counters": {**COUNTERS, "map_build.replays": 0}}) == 0.0
    # the parent's record: the span, no replay counter
    assert read({"counters": {k: v for k, v in COUNTERS.items()
                              if k != "map_build.replays"}}) is None
    assert read({"counters": {**COUNTERS, "map_build.calls": 0}}) is None
    assert read({}) is None


def test_the_manifest_lists_it_for_the_lio_cells():
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in manifest["per_layer"]}["map_build_replay_share"]
    assert (m["layer"], m["source"], m["better"], m["moves"]) == (
        "map build", "program_counter", "higher", "scans_per_s")
    assert m["workloads"] == ["lio_hdl64.drive", "lio_hdl64.walk"]
