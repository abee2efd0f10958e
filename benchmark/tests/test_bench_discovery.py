"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and manifest entries only; an engine with
a back end too (its reference and its faults, and a mix that renders the
lap twice)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, TOY_CELL, toy_checkout


def test_new_files_add_a_cell_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    # every file already there stays as it is; the manifest only gains entries
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    cfg = json.loads((root / "benchmark/configs/lio_hdl64.json").read_text())
    cfg["name"] = "lio_hdl32"
    cfg["sensor"]["raw_points"] = 65536
    (root / "benchmark/configs/lio_hdl32.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/walk.json").read_text())
    mix["name"], mix["speed_mps"] = "jog", 3.0
    (root / "benchmark/traffic/jog.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/scans_rebuilt_pct.py").write_text(
        "def read(record):\n"
        "    spans = record.get('spans') or []\n"
        "    return 100.0 * sum(r for _, _, r in spans) / len(spans) if spans else None\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "lio_hdl32", "source": "x", "reduced": [], "why": "x",
                                "file": "benchmark/configs/lio_hdl32.json"})
    manifest["workloads"].append({"name": "lio_hdl32.jog", "config": "lio_hdl32",
                                  "traffic": "jog", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "scans_rebuilt_pct", "unit": "%", "better": "higher",
                                  "source": "host_clock", "layer": "map build",
                                  "moves": "scans_per_s", "workloads": ["lio_hdl32.jog"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    probe = (
        "import sys; sys.path[:0] = ['benchmark', '.']\n"
        "from yardstick import cell, world\n"
        "c = cell.load_cell('lio_hdl32.jog')\n"
        "r = world.make_route(c.traffic, c.config['sensor'])\n"
        "m = cell.load_module('metrics', c.per_layer[-1]['name'])\n"
        "print(c.config['sensor']['raw_points'], r.speed, [x['name'] for x in c.per_layer][-1],\n"
        "      m.read({'spans': [(1.0, 2.0, True), (1.0, 2.0, False)]}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["65536", "3.0", "scans_rebuilt_pct", "50.0"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_new_files_add_a_cell_with_a_back_end_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    before = toy_checkout(root)
    # run from the checkout, the program found beside it
    probe = (
        "import json, sys; sys.path[:0] = ['benchmark', '.']; sys.path.append(sys.argv[1])\n"
        "import run\n"
        "from yardstick import cell, faults, replay\n"
        f"c = cell.load_cell({TOY_CELL!r})\n"
        "res = replay.run_cell(c, 43, 2.0, False, 'cpu', 0.0)\n"
        "print(json.dumps({'renders': c.traffic['renders'], 'faults': sorted(faults.for_engine(\n"
        "    c.config['engine'])), 'line': run.result_line(c, res, 'cpu', 1)}))\n")
    p = subprocess.run([sys.executable, "-c", probe, str(BENCH.parent)], cwd=root,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.splitlines()[-1])
    line = out["line"]
    assert line["correct"], line["checks"]
    assert {"reg_pose_rms_m", "solve_gap_m", "correction_gap_m"} <= set(line["checks"])
    assert out["renders"] == 2 and "gn_count_over_the_call" in out["faults"]
    assert "back end: " in p.stderr and "(2 renders)" in p.stderr
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


def test_every_cell_of_the_manifest_finds_its_files():
    from yardstick import cell

    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        c = cell.load_cell(w["name"])
        cell.load_module("engines", c.config["engine"])
        cell.load_module("references", c.config["engine"])
        for m in c.per_layer:
            assert callable(cell.load_module("metrics", m["name"]).read)
    for cfg in manifest["configs"]:
        assert Path(BENCH.parent / cfg["file"]).is_file()
