"""Finding a cell's parts by name: `BENCHMARK.json` at the checkout's root
names the cell, its configuration and its traffic mix; each of those, and
each per-layer metric, sits in a file of its own under the benchmark's
folder:

    configs/<config>.json     the deployment: sizes, options, limits of the check
    traffic/<mix>.json        the parameters the generator reads
    engines/<engine>.py       drives the program for configurations of that engine
    references/<engine>.py    the plain reference's part for that engine (what the
                              target is built from, the initial state)
    metrics/<metric>.py       reads one per-layer metric from a traced run's record

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list       # the manifest's metric entries that this cell reports
    per_layer: list


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (not put on sys.path)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    mod_name = f"_bench_{kind}_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    manifest = json.loads(Path(manifest_path).read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path}; there are {sorted(cells)}")
    w = cells[name]
    return Cell(name=name, config=_json("configs", w["config"]),
                traffic=_json("traffic", w["traffic"]), chips=int(w["chips"]),
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])
