"""Readings that the limits of ``correct`` are set from: the program's on
many seeds, the control's (the reference in the program's place, in the
nearest precision below the configuration's) and each planted fault's, all
at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload dtu.eval --seeds 1-12 \\
        --control-seeds 1-3 --faults "stale answer,missed tile" \\
        --fault-seeds 1-3 --seconds 2 --out build/calibrate.jsonl

``--faults`` names faults that the cell's loop can plant (its ``FAULTS``).
One JSON line a run goes to ``--out`` and a summary to standard output.
The benchmark's own runs never run the control or a fault.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.lib import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    min_items = cell["mix"].get("check_within", 0)
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.control_seeds]
    runs += [(f, s, f) for f in filter(None, args.faults.split(","))
             for s in args.fault_seeds]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for kind, seed, fault in runs:
            t0 = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                   t0, control=kind == "control",
                                   fault=fault, min_items=min_items)
            check = res["check"]
            line = {"workload": args.workload, "run": kind, "seed": seed,
                    "readings": check["readings"],
                    "items": res["host"]["items"],
                    "setup_s": res["setup_s"], "phases": res["phases"],
                    "peak_mib": res["peak"] / 2 ** 20,
                    "seconds": time.perf_counter() - t0}
            line.update({k: check[k] for k in ("worst_leaves", "excluded",
                                               "losses", "reference_losses")
                         if k in check})
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps({k: line[k] for k in ("run", "seed", "readings",
                                                   "items", "seconds")}),
                  flush=True)
            torch.cuda.empty_cache()
    if harness.forbidden_modules():
        print(f"calibrate: loaded {harness.forbidden_modules()}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
