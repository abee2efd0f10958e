"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It measures the PyTorch and CUDA package
(`loc_lib_tpu_torch`) on the card, and only it: it refuses to run without a
card, and it fails if the JAX package or JAX itself is loaded once set-up
or the window is over. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), `device`, with
--trace 1 `breakdown`, and last `checks`, each number the comparison with
the plain reference read beside its limit (also the last lines of standard
error).
"""

import os
import time

T_PROCESS = time.perf_counter()

# one process, one thread of host compute: no pool of spinning BLAS or OpenMP workers
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "loc_lib_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise SystemExit(f"{when}: the process has loaded {found}; the benchmark measures the "
                         "PyTorch and CUDA package alone")


def card_or_exit(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def result_line(cell, res: dict, device_kind: str, count: int) -> dict:
    """The result's fields from a run's output."""
    from yardstick import cell as cellmod, trace

    limits = cell.config["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in res["checks"].items()}
    correct = (res["attempted"] > 0 and res["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"])}
    if "record" in res:
        rec = res["record"]
        metrics = {}
        for m in cell.per_layer:
            v = cellmod.load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        sl = rec.get("slice")
        if sl is not None:
            device["busy_s"] = trace.union_s([(s, e) for _, s, e in sl.events])
            device["window_s"] = sl.window_s
        line["device"] = device
        if sl is not None:
            line["breakdown"] = {"device_ops": trace.device_ops(sl),
                                 "idle_gaps": trace.idle_gaps(rec["labelled"])}
    else:
        e2e = res["end_to_end"]
        line["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                           for m in cell.end_to_end}
        line["device"] = device
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from yardstick import cell as cellmod

    cell = cellmod.load_cell(args.workload)
    device = card_or_exit(cell.chips)
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import loc_lib_tpu_torch  # noqa: F401  (fails here in a tree without the program)

    from yardstick import replay

    res = replay.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS,
                          on_setup=lambda: guard("after set-up"))
    guard("after the window")
    line = result_line(cell, res, torch.cuda.get_device_name(0), cell.chips)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
