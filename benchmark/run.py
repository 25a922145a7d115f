#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It loads and warms up the cell (set-up),
measures for ``--seconds`` in a closed loop, checks what the timed path
produced against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics from the
device trace), ``device`` and, last, ``checks`` (each compared number
beside its limit, also printed as the last lines of standard error).
Without a CUDA card, or with fewer than the cell asks for, it exits 3
and prints no result; if JAX or the JAX package was loaded, it exits 4."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".benchcache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible")
        return 3
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START,
                            CACHE / "kernels", log)
    bad = harness.forbidden_loaded()
    if bad:
        log(f"loaded in the measuring process: {', '.join(bad)}")
        return 4
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
