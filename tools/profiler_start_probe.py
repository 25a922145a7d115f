"""How long does a process's torch.profiler session take to open and close
on the card, the first time and the next, from the main thread and from
another thread (where the doctor watcher opens its window)?

Runs TRIALS (default 2) fresh processes for each of the two threads; each
process makes the card ready (one small op), then opens a session
recording CPU and CUDA activity, launches one small kernel, closes it,
and does the same again. Prints one JSON line a process: the seconds
each session took to open (``__enter__``) and to close (``__exit__``),
the CUDA kernels its trace holds, and the thread.

    python3 tools/profiler_start_probe.py [TRIALS]

Run it from the repository's root on a machine with one CUDA card.
"""
import json
import subprocess
import sys
import threading
import time

import torch


def session(dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    prof.__enter__()
    t1 = time.perf_counter()
    (torch.ones(1 << 20, device=dev) * 2).sum().item()
    t2 = time.perf_counter()
    prof.__exit__(None, None, None)
    t3 = time.perf_counter()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"open_s": t1 - t0, "close_s": t3 - t2, "cuda_events": kernels}


def one_process(where: str) -> dict:
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev).sum().item()
    out = {"thread": where}

    def run():
        out["first"] = session(dev)
        out["second"] = session(dev)

    if where == "main":
        run()
    else:
        th = threading.Thread(target=run)
        th.start()
        th.join()
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in ("main", "other"):
        print(json.dumps(one_process(sys.argv[1])), flush=True)
        return 0
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for _ in range(trials):
        for where in ("main", "other"):
            r = subprocess.run([sys.executable, __file__, where],
                               capture_output=True, text=True, timeout=600)
            line = r.stdout.strip().splitlines()[-1:] or [
                json.dumps({"thread": where, "error": r.stderr[-500:]})]
            print(line[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
