"""Does a held copy stream hold up the others? Eight streams taken from
PyTorch's pool in a row, as ``LazyShuffleReaderResult.partitions_ready``
takes one per shard: stream 0 sleeps HOLD_MS (``torch.cuda._sleep``),
then each stream copies one shard of ``chip_smoke``'s main read (1,310,720
rows of 25 int32) to page-locked memory. Prints, for each of TRIALS
trials, the ms from a base event to the end of each stream's copy, and
the streams other than 0 whose copy ended after the hold.

Runs once in a child under the CUDA default (``CUDA_DEVICE_MAX_CONNECTIONS``
unset: 8 hardware queues) and once in a child under 32, CUDA's most.

    python3 tools/stream_queue_probe.py [HOLD_MS] [TRIALS]

Run it from the repository's root on a machine with one CUDA card.
"""
import json
import os
import subprocess
import sys

ROWS, WIDTH, STREAMS = 1_310_720, 25, 8


def probe(hold_ms: float, trials: int) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    khz = getattr(torch.cuda.get_device_properties(dev), "clock_rate", 0)
    if not khz:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        khz = float(out.stdout.split()[0]) * 1e3
    cycles = int(hold_ms * khz)
    srcs = [torch.randint(0, 100, (ROWS, WIDTH), dtype=torch.int32,
                          device=dev) for _ in range(STREAMS)]
    dsts = [torch.empty((ROWS, WIDTH), dtype=torch.int32, pin_memory=True)
            for _ in range(STREAMS)]
    for s, d in zip(srcs, dsts):
        d.copy_(s)
    torch.cuda.synchronize()
    ends_ms = []
    for _ in range(trials):
        base = torch.cuda.Event(enable_timing=True)
        base.record()
        ends = []
        for i in range(STREAMS):
            st = torch.cuda.Stream(dev)
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                if i == 0:
                    torch.cuda._sleep(cycles)
                dsts[i].copy_(srcs[i], non_blocking=True)
            e = torch.cuda.Event(enable_timing=True)
            e.record(st)
            ends.append(e)
        torch.cuda.synchronize()
        ends_ms.append([base.elapsed_time(e) for e in ends])
    return {"connections": os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS",
                                          "default"),
            "hold_ms": hold_ms, "end_ms": ends_ms,
            "held_with_0": [[i for i in range(1, STREAMS) if t[i] > hold_ms]
                            for t in ends_ms],
            "torch": torch.__version__}


def main() -> int:
    hold_ms = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    trials = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    if len(sys.argv) > 3 and sys.argv[3] == "--child":
        print(json.dumps(probe(hold_ms, trials)), flush=True)
        return 0
    base = {k: v for k, v in os.environ.items()
            if k != "CUDA_DEVICE_MAX_CONNECTIONS"}
    for env in (base, {**base, "CUDA_DEVICE_MAX_CONNECTIONS": "32"}):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            str(hold_ms), str(trials), "--child"],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
