#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on this machine's card.

    python3 benchmark/control.py --workload <name> --program-seeds 1 2 ... \
        --control-seeds 7 8 9 --seconds <s> --control-steps <n>

For each program seed it runs the cell as ``run.py`` does (set-up, a
window of ``--seconds``, the comparison) and prints the compared
numbers; it does the same for each fault of ``--faults``
(``faults.py``) planted (a training fault from the first step after
set-up's warm steps), on each of ``--fault-seeds``; for each control
seed it puts the reference, computed in TF32, in the program's place
(``--control-steps`` steps where the cell's work carries from step to
step) and prints the same numbers against the reference.
One JSON line each, on standard output. The benchmark's own runs never
run this."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.run import CACHE, log  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-steps", type=int, default=1)
    ap.add_argument("--faults", nargs="*", default=[],
                    help="faults of benchmark/faults.py to plant, each run "
                         "on every --fault-seeds seed")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from benchmark import harness
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 3
    dev = torch.device("cuda", 0)
    from benchmark.faults import planted
    runs = [(None, s) for s in args.program_seeds] + \
        [(f, s) for f in args.faults for s in args.fault_seeds]
    for fault, seed in runs:
        t0 = time.perf_counter()
        if fault:
            with planted(cell.traffic["driver"], fault,
                         int(cell.traffic.get("warm_steps", 0))):
                line = json.loads(harness.run_cell(
                    cell, seed, args.seconds, False, dev, t0,
                    CACHE / "kernels", log))
        else:
            line = json.loads(harness.run_cell(
                cell, seed, args.seconds, False, dev, t0, CACHE / "kernels",
                log))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "kind": fault or "program",
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "readings": {k: v["value"] for k, v in
                                       line["checks"].items()},
                          "metrics": line["metrics"],
                          "peak": line["device"]["memory_peak_bytes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        drv = harness.driver_class(cell.traffic)(
            cell.config, cell.traffic, seed, dev, CACHE / "kernels")
        readings = drv.control_readings(args.control_steps)
        del drv
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "kind": "control", "readings": readings,
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
