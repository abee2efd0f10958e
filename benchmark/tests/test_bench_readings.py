"""The result line, the tail over every scan, the idle share of a timeline,
the roofline arithmetic's copy, the guard against JAX, and a closed-loop
run through the harness's inner functions on the CPU while the measuring
entry refuses to run without a card."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny

import run as runmod
from yardstick import cell as cellmod, replay, trace

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def cpu_run():
    cell = tiny(cellmod.load_cell("loc_hdl64.drive"))
    return cell, replay.run_cell(cell, 2 ** 31 + 99, 2.0, False, "cpu", 0.0)


def test_a_closed_loop_run_on_the_cpu_gives_the_result_line(cpu_run):
    cell, res = cpu_run
    line = runmod.result_line(cell, res, "cpu", 1)
    assert list(line) == RESULT_KEYS                       # checks last
    assert set(line["metrics"]) == {"scans_per_s", "scan_p95_ms", "setup_s"}
    assert line["attempted"] > 5 and line["failed"] == 0 and line["correct"]
    assert set(line["checks"]) == set(cell.config["limits"])
    json.dumps(line)


def test_the_traced_line_carries_the_per_layer_metrics_found():
    cell = tiny(cellmod.load_cell("lio_hdl64.walk"))
    res = replay.run_cell(cell, 7, 2.0, True, "cpu", 0.0)
    line = runmod.result_line(cell, res, "cpu", 1)
    assert list(line) == RESULT_KEYS
    # no card: the device readers find nothing and leave their metrics out, as does the
    # reader of gn_step launches (the CPU's GN loop counts none) and of graph replays (none
    # on the CPU); the program's spans are read there as on the card
    assert set(line["metrics"]) == {
        "filter_ms", "map_build_scan_ms", "track_scan_ms", "filter_span_ms", "predict_ms",
        "match_ms", "update_ms", "map_build_ms", "record_ms", "host_syncs_per_scan",
        "sync_wait_ms"}


def test_the_tail_is_taken_over_every_scan(cpu_run):
    _, res = cpu_run
    lat = res["latencies_ms"]
    assert len(lat) == res["attempted"]
    assert res["end_to_end"]["scan_p95_ms"] == float(np.percentile(lat, 95))
    assert res["end_to_end"]["scans_per_s"] == res["attempted"] / res["window_s"]


def test_idle_share_takes_the_union_of_overlapping_events():
    from yardstick import cell

    sl = trace.Slice(scans=2, window_s=10e-6,
                     events=[("a", 0.0, 4.0), ("b", 2.0, 6.0), ("c", 8.0, 9.0)], cpu=[])
    assert trace.union_s([(s, e) for _, s, e in sl.events]) == pytest.approx(7e-6)
    idle = cell.load_module("metrics", "device_idle_pct")
    assert idle.read({"slice": sl, "s_per_scan": 5e-6}) == pytest.approx(30.0)
    # the denominator is the scans' time without the profiler, not the slice's own length
    assert idle.read({"slice": sl, "s_per_scan": 7e-6}) == pytest.approx(50.0)
    assert idle.read({"slice": sl}) is None
    assert cell.load_module("metrics", "launches_per_scan").read({"slice": sl}) == 1.5
    assert trace.gaps([(0.0, 4.0), (2.0, 6.0), (8.0, 9.0)]) == [(6.0, 8.0)]


def test_idle_gaps_lie_between_the_devices_work_and_not_its_annotations():
    ev = lambda name, s, e, dev, note=False: types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=s, end=e), is_user_annotation=note,
        device_type=torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU)
    dev, cpu, notes = trace.split_events([
        ev("k1", 0.0, 2.0, True), ev("bench.engine", 0.0, 20.0, True, note=True),
        ev("k2", 12.0, 14.0, True), ev("bench.engine", 0.0, 20.0, False),
        ev("aten::mm", 3.0, 8.0, False)])
    assert [n for n, _, _ in dev] == ["k1", "k2"] and [n for n, _, _ in notes] == ["bench.engine"]
    sl = trace.Slice(1, 20e-6, dev, cpu, notes)
    # one gap, 2-12 us, labelled by the stage and the host operation at its middle
    assert trace.idle_gaps(sl) == [["bench.engine / aten::mm", pytest.approx(10e-6)]]
    assert trace.union_s([(s, e) for _, s, e in sl.events]) == pytest.approx(4e-6)


def test_the_roofline_copy_counts_the_bytes_the_smoke_run_counts():
    sys.path.insert(0, str(BENCH.parent))
    import chip_smoke
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels
    from loc_lib_tpu_torch.ops.pointcloud import PointCloud

    from yardstick import cell, reference

    roof = cell.load_module("metrics", "_roofline")
    g = torch.Generator().manual_seed(3)
    # a target of planes on a lattice of voxel centres, a source near it
    cells = torch.stack(torch.meshgrid(torch.arange(12), torch.arange(12), torch.arange(3),
                                       indexing="ij"), -1).reshape(-1, 3).float()
    pts = (cells[:, None, :] + 0.5 + 0.3 * (torch.rand((len(cells), 8, 3), generator=g) - 0.5)
           * torch.tensor([1.0, 1.0, 0.02])).reshape(-1, 3)
    opts = icp.IcpOptions(method="p2plane_vox")
    origin = torch.zeros(3)
    tgt = icp.set_target(PointCloud(xyz=pts, mask=torch.ones(len(pts), dtype=torch.bool)), opts,
                         origin)
    q = cells[::5] + 0.5 + 0.1 * torch.rand((len(cells[::5]), 3), generator=g)
    mask = torch.rand(len(q), generator=g) > 0.2
    R, t = torch.eye(3), torch.tensor([0.05, -0.02, 0.0])
    index = kernels.TargetIndex(tgt.dense.table, tgt.dense.lo, tgt.grid.origin, tgt.grid.inv_leaf,
                                opts.dense_dims)
    want = int(chip_smoke._k2_target_bytes(q, mask, R, t, index))
    ref_t = reference.build_target(pts, origin.double(), reference.Prec(), 1.0, opts.dense_dims,
                                   5, 0.01)
    got = roof.k2_bytes(q, mask, R, t, ref_t.origin, ref_t.leaf, ref_t.lo, ref_t.dims,
                        ref_t.table)
    assert got == want
    assert roof.k2_flops(len(q)) == chip_smoke.FLOPS_K2_TARGET * len(q)
    assert (roof.H100_BYTES_PER_S, roof.H100_FP32_FLOPS) == (chip_smoke.H100_BYTES_PER_S,
                                                             chip_smoke.H100_FP32_FLOPS)


def test_the_guard_refuses_jax_and_the_jax_package_by_top_level_name(monkeypatch):
    assert "loc_lib_tpu_torch" not in runmod.FORBIDDEN
    monkeypatch.setitem(sys.modules, "loc_lib_tpu_torch_probe", types.ModuleType("x"))
    runmod.guard("probe")                                  # a name that only begins alike passes
    for name in ("jax", "jaxlib.xla_client", "flax", "loc_lib_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        with pytest.raises(SystemExit, match=name.split(".")[0]):
            runmod.guard("probe")
        monkeypatch.delitem(sys.modules, name)


def test_the_measuring_entry_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "loc_hdl64.drive",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=BENCH.parent,
                       env=env, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_a_tree_of_the_benchmark_alone_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "loc_hdl64.drive",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
