"""Does a torch.profiler trace keep the first launches made in it?

On the card, every 20 s for SECONDS (default 200), with the card busy
between samples: five calls of the merge kernel at the int8 combine
fold's shapes, traced four ways: with no host wait in the trace
(``none``), with ``chip_smoke.PROFILER_LEAD_S`` of host wait after the
profiler starts (``lead``), with that wait before it stops (``trail``),
and with both (``both``); then ``chip_smoke.device_kernel_ms`` on the
same calls (``smoke``: a lead wait and PROFILER_BUSY_S of calls). Prints
one JSON line a sample: for each way, the launches made, the launches
the trace holds, and the positions (in launch order) of those it lacks;
for ``smoke``, its calls and the launches its trace holds.

    python3 tools/profiler_margin_probe.py [SECONDS]

Run it from the repository's root on a machine with one CUDA card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.ops import segmented as sg

P, CA, CB, W, PARTS = 8, 94040, 117552, 130, 200
WAYS = {"none": (0, 0), "lead": (1, 0), "trail": (0, 1), "both": (1, 1)}


def sorted_block(dev, rng, cap):
    """Zero rows, partition ids sorted per shard, the last quarter
    invalid (the sentinel ``PARTS``)."""
    rows = torch.zeros((P, cap, W), dtype=torch.int32, device=dev)
    pid = np.sort(rng.integers(0, PARTS, size=(P, cap)), axis=1)
    pid[:, cap - cap // 4:] = PARTS
    return rows, torch.from_numpy(pid.astype(np.int32)).to(dev)


def traced(fn, lead: int, trail: int) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead * cs.PROFILER_LEAD_S)
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        time.sleep(trail * cs.PROFILER_LEAD_S)
    ev = list(prof.profiler.kineto_results.events())
    gpu = {e.correlation_id() for e in ev
           if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = [c for _, c in sorted((e.start_ns(), e.correlation_id())
                                     for e in ev
                                     if "LaunchKernel" in e.name())]
    return {"launches": len(launches),
            "seen": sum(c in gpu for c in launches),
            "missing_at": [i for i, c in enumerate(launches)
                           if c not in gpu]}


def main() -> int:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 200.0
    dev = cs.card_device()
    print(cs.card_line(), flush=True)
    backend.kernel_library()
    rng = np.random.default_rng(0)
    a, ap = sorted_block(dev, rng, CA)
    b, bp = sorted_block(dev, rng, CB)

    def fn():
        return sg.merge_kernel(a, ap, b, bp, CA)

    big = torch.randn(8192, 8192, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        row = {"t_s": round(time.perf_counter() - t0, 1)}
        for way, (lead, trail) in WAYS.items():
            row[way] = traced(fn, lead, trail)
        dk = cs.device_kernel_ms(fn, cs.MERGE_DEVICE_KERNELS)
        row["smoke"] = {"calls": dk["calls"],
                        "seen": dk["launches_seen"]}
        print(json.dumps(row), flush=True)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 20:
            for _ in range(20):
                big @ big
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
