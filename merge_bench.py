#!/usr/bin/env python3
"""Time and check the port's merge-path kernel on one NVIDIA H100.

    python3 merge_bench.py [--root DIR] [--reps N]

Builds seeded fold-step inputs on the card at the three widths the device
merge fold runs (``chip_smoke.py``'s captured last fold steps): W = 25,
waved_ordered's TeraSort rows (A ``[8, 1368456, 25]``, B ``[8, 560520,
25]``, out_cap 1,368,456, 10,485,760 valid rows); W = 6, waved_combine's
group-by-sum rows; W = 130, waved_int8_combine's full-width rows (2 key
words and 128 float32 lanes). Each side is sorted by (partition, key)
over 200 partitions, with sentinel rows of zero words past its valid
count. At each width the kernel is held bit for bit against
``merge_plain`` (every output row and partition id), then timed:
``kernel_ms``, the CUDA-event median of one call over ``--reps`` calls
after one warm-up call (the definition of ``chip_smoke.py``'s
``merge_at_main_shapes``); ``back_to_back_ms``, 10 calls in a row over
the count (the wrapper's host work hidden); ``device_ms``, each kernel's
mean device time per call from torch.profiler; ``host_ms``, the host
wall of one call on an idle device. ``bound_ms`` counts
out_cap rows of W + 1 words read and written per shard at 3.35 TB/s;
``share_of_bound`` is bound / kernel_ms.

``--root`` names the checkout whose ``sparkucx_tpu_torch`` is imported
(default: this script's directory), so two versions of the kernel can be
compared on one card, run in turns (parent, change, change, parent). Prints one JSON line, with the card's name and
power limit as nvidia-smi reports them. Exits non-zero without a CUDA
device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from chip_smoke import (HBM_BYTES_PER_S, PROFILER_LEAD_S, back_to_back_ms,
                        card_line, host_ms, median_ms)

SEED = 20261018
R = 200
P = 8
# (ca, valid A rows, cb, valid B rows, out_cap) per shard, from the last
# fold step chip_smoke.py captures in each waved phase
# (chip_smoke.py on an H100: W = 6 holds 3,384,589 valid rows, 2,059,043
# of them in A; W = 130 595,689, 454,941 in A; spread evenly over shards)
SHAPES = {25: (1_368_456, 1_048_576, 560_520, 262_144, 1_368_456),
          6: (875_816, 257_380, 560_520, 165_694, 875_816),
          130: (94_040, 56_868, 117_552, 17_594, 94_040)}


def side(gen, cap: int, n: int, width: int, dev):
    """[P, cap, W] rows sorted by (partition, signed key) and [P, cap]
    partitions: n valid rows per shard, then sentinel rows of zeros."""
    import torch
    u, _ = torch.sort(torch.randint(0, R << 40, (P, n), generator=gen,
                                    device=dev), dim=1)
    key = (u & ((1 << 40) - 1)) - (1 << 39)
    rows = torch.zeros((P, cap, width), dtype=torch.int32, device=dev)
    part = torch.full((P, cap), R, dtype=torch.int32, device=dev)
    part[:, :n] = (u >> 40).to(torch.int32)
    lo = ((key & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    rows[:, :n, 0] = lo.to(torch.int32)
    rows[:, :n, 1] = (key >> 32).to(torch.int32)
    if width > 2:
        rows[:, :n, 2:] = torch.empty((P, n, width - 2), dtype=torch.int32,
                                      device=dev).random_(generator=gen)
    return rows, part


def device_ms(fn, calls: int = 5) -> dict:
    """Mean device time per call of every kernel ``fn`` launches, by
    name, over ``calls`` calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace can lack the first launches made in it
        time.sleep(PROFILER_LEAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                "merge" in evt.name:
            name = evt.name.replace("(anonymous namespace)::", "")
            spans.setdefault(name.split("(")[0], []).append(
                (evt.time_range.end - evt.time_range.start) / 1e3)
    # the mean over the launches the trace holds
    return {name: float(np.mean(v)) for name, v in spans.items()}


def bench_width(sg, width: int, reps: int, dev) -> dict:
    import torch
    ca, na, cb, nb, out_cap = SHAPES[width]
    gen = torch.Generator(device=dev).manual_seed(SEED + width)
    a, ap = side(gen, ca, na, width, dev)
    b, bp = side(gen, cb, nb, width, dev)

    def kernel():
        return sg.merge_kernel(a, ap, b, bp, out_cap)

    kr, kp = kernel()
    pr, pp = sg.merge_plain(a, ap, b, bp, out_cap)
    torch.cuda.synchronize()
    if not (torch.equal(kr, pr) and torch.equal(kp, pp)):
        raise AssertionError(f"merge W={width}: kernel != merge_plain")
    del kr, kp, pr, pp
    bound = 2 * P * out_cap * (width + 1) * 4 / HBM_BYTES_PER_S * 1e3
    ms = median_ms(kernel, reps, warmup=1)
    return {"a_shape": [P, ca, width], "b_shape": [P, cb, width],
            "out_cap": out_cap, "valid_rows": P * (na + nb),
            "kernel_ms": ms, "back_to_back_ms": back_to_back_ms(kernel),
            "device_ms": device_ms(kernel),
            "host_ms": host_ms(kernel, reps), "bound_ms": bound,
            "share_of_bound": bound / ms, "bit_exact": True}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("merge_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops import segmented as sg
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    backend.kernel_library()
    build_s = time.perf_counter() - t0
    widths = {str(w): bench_width(sg, w, args.reps, dev) for w in SHAPES}
    print(json.dumps({"root": os.path.abspath(args.root),
                      "card": card_line(), "reps": args.reps,
                      "build_s": build_s, "widths": widths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
