"""Readings that the check's limits are set from, for one cell, in one
process: for each seed a run of the program (set-up, warm-up, a short
window at the cell's load), then the comparison of its sample with the
plain reference (the lower reading) and of the same sample with the
reference computed in TF32 in the program's place (the control, the upper
reading).

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
                                   [--fault <name>]

One JSON line per seed on standard output: {"seed", "program": {...},
"control": {...}}; with --fault the program's numbers with that fault
planted: one of `yardstick/faults.py`, or of `faults/<engine>.py` for the
cell's engine. The benchmark's own runs never run these.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def readings(cell, seed: int, seconds: float, device, fault=None) -> dict:
    """The program's and the control's numbers for one seed; with `fault`
    (a name in `yardstick.faults.for_engine` of the cell's engine) the
    program runs with that fault planted and the control is not read."""
    from yardstick import faults, replay, stepcheck

    out = {}

    def grab(run, refmod):
        out["control"] = stepcheck.compare(run, refmod, device, tf32=True)

    res = replay.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                          fault=faults.for_engine(cell.config["engine"])[fault] if fault else None,
                          after_check=None if fault else grab)
    out["program"] = res["checks"]
    out["attempted"], out["failed"] = res["attempted"], res["failed"]
    out["end_to_end"] = res["end_to_end"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None,
                    help="a fault to plant: of yardstick/faults.py or faults/<engine>.py")
    args = ap.parse_args()
    import torch

    from yardstick import cell as cellmod

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cellmod.load_cell(args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0), args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
