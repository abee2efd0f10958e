"""The readers of the program's spans and counters: each gives its number
from a traced run's record (`counters` over the window, `window_scans`),
and nothing where its counter is absent or zero, as in a checkout of the
program from before the spans."""

import pytest

from yardstick import cell

MS = 1e6          # nanoseconds a millisecond

COUNTERS = {"filter.ns": 4.5 * MS, "filter.calls": 3, "predict.ns": 0.3 * MS,
            "predict.calls": 3, "match.ns": 1.5 * MS, "match.calls": 3, "update.ns": 0.6 * MS,
            "update.calls": 3, "map_build.ns": 16.0 * MS, "map_build.calls": 2,
            "record.ns": 0.9 * MS, "record.calls": 3, "sync.ns": 1.2 * MS, "sync.calls": 10,
            "step.ns": 20.0 * MS, "step.calls": 3, "gn_step": 4}

# metric -> (its value from COUNTERS over 4 window scans, the counter it needs)
EXPECTED = {
    "filter_span_ms": (1.5, "filter.ns"),          # a call
    "predict_ms": (0.075, "predict.ns"),           # a scan
    "match_ms": (0.375, "match.ns"),
    "update_ms": (0.15, "update.ns"),
    "map_build_ms": (8.0, "map_build.ns"),         # a build
    "record_ms": (0.225, "record.ns"),
    "host_syncs_per_scan": (2.5, "sync.calls"),
    "sync_wait_ms": (0.3, "sync.ns"),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_gives_its_number_and_nothing_without_its_counter(name):
    read = cell.load_module("metrics", name).read
    value, key = EXPECTED[name]
    assert read({"counters": COUNTERS, "window_scans": 4}) == pytest.approx(value)
    assert read({"counters": {k: v for k, v in COUNTERS.items() if k != key},
                 "window_scans": 4}) is None
    assert read({"counters": {**COUNTERS, key: 0}, "window_scans": 4}) is None
    # the parent's record: launch counts only, no span
    assert read({"counters": {"gn_step": 4}, "window_scans": 4}) is None
    assert read({"window_scans": 4}) is None and read({}) is None
    if name not in ("filter_span_ms", "map_build_ms"):
        assert read({"counters": COUNTERS, "window_scans": 0}) is None


def test_the_manifest_lists_each_reader_for_every_cell():
    import json

    from conftest import BENCH

    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in manifest["workloads"]]
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert m["source"] == "program_counter" and m["moves"] == "scans_per_s"
        assert m["workloads"] == cells and m["better"] == "lower"
