"""Main's host walk under two checkouts, in turns on one card.

For PAIRS pairs, fresh processes alternate between the two checkouts
(A B, B A, A B, ...). Each writes ``chip_smoke``'s main records
(RECORDS rows, MAPS maps, SHARDS shards, its seed) once under
``a2a.impl=pallas`` and reads them READS times, walking ``partition(r)``
for every r in index order, as the smoke's main does: it times the read,
the first partition and the whole walk (the first read is cold, the
others warm). Then one more read whose shards are all pulled first
(``_materialize``, timed) and walked on the host alone, and one walk
under cProfile (the functions that took the most time of their own).
Each process keeps the CUDA default (``CUDA_DEVICE_MAX_CONNECTIONS``
unset).

    python3 tools/views_walk_ab.py ROOT_A ROOT_B [--pairs 10] [--reads 4]
        [--out FILE]

Each ROOT is the root of a checkout (its ``chip_smoke.py`` and
``sparkucx_tpu_torch/``). Run it from this repository's root on a
machine with one CUDA card. Prints one JSON line a process (also
appended to ``--out``) and a summary as the last line: each checkout's
warm walks, their median, and each pair's difference of medians.
"""
import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time


def child(root: str, reads: int) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from sparkucx_tpu_torch import backend, connect
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    backend.kernel_library()
    keys, values = cs.make_records(cs.RECORDS, zipf=False, seed=cs.SEED)
    out = {"root": root, "read_ms": [], "first_ms": [], "walk_ms": [],
           "connections": os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS",
                                         "default"),
           "torch": torch.__version__}
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"},
                 num_shards=cs.SHARDS, use_env=False) as svc:
        h = cs.write_maps(svc, 2, keys, values, cs.MAPS)
        del keys, values

        def read():
            t = time.perf_counter()
            res = svc.read(h)
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t) * 1e3

        digests = None
        for i in range(reads):
            res, ms = read()
            out["read_ms"].append(ms)
            t = time.perf_counter()
            parts = [res.partition(0)]
            out["first_ms"].append((time.perf_counter() - t) * 1e3)
            parts += [res.partition(r) for r in range(1, cs.PARTITIONS)]
            out["walk_ms"].append((time.perf_counter() - t) * 1e3)
            if i in (0, reads - 1):
                got = cs.partition_digests(parts)
                if digests is not None and got != digests:
                    raise AssertionError("two reads of one shuffle differ")
                digests = got
            del res, parts
        # the pulls first, then the walk over host blocks alone
        res, _ = read()
        t = time.perf_counter()
        res._materialize()
        out["drain_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        parts = [res.partition(r) for r in range(cs.PARTITIONS)]
        out["host_walk_ms"] = (time.perf_counter() - t) * 1e3
        del res, parts
        # one walk under cProfile: where its host time goes
        res, _ = read()
        prof = cProfile.Profile()
        t = time.perf_counter()
        prof.enable()
        parts = [res.partition(r) for r in range(cs.PARTITIONS)]
        prof.disable()
        out["profiled_walk_ms"] = (time.perf_counter() - t) * 1e3
        del res, parts
        st = pstats.Stats(prof)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
        out["top_own_ms"] = [
            {"fn": f"{os.path.basename(f)}:{line}({name})", "calls": nc,
             "own_ms": tt * 1e3, "cum_ms": ct * 1e3}
            for (f, line, name), (_, nc, tt, ct, _) in rows]
        svc.unregister_shuffle(2)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reads", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None)
    a = ap.parse_args()
    if a.child is not None:
        print(json.dumps(child(a.child, a.reads)), flush=True)
        return 0
    if len(a.roots) != 2:
        ap.error("give two checkout roots")
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_DEVICE_MAX_CONNECTIONS"}
    runs = {r: [] for r in a.roots}
    pairs = []
    for i in range(a.pairs):
        order = a.roots if i % 2 == 0 else a.roots[::-1]
        med = {}
        for root in order:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--reads", str(a.reads)], capture_output=True, text=True,
                env=env, timeout=600)
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-4000:])
                return 1
            doc = json.loads(r.stdout.strip().splitlines()[-1])
            doc["pair"] = i
            line = json.dumps(doc)
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
            runs[root].append(doc)
            med[root] = statistics.median(doc["walk_ms"][1:])
        pairs.append(med[a.roots[1]] - med[a.roots[0]])
    summary = {"pairs": a.pairs, "reads": a.reads,
               "b_minus_a_warm_median_ms": pairs}
    for root, docs in runs.items():
        warm = [w for d in docs for w in d["walk_ms"][1:]]
        summary[root] = {
            "warm_walk_ms": warm, "warm_median_ms": statistics.median(warm),
            "cold_walk_ms": [d["walk_ms"][0] for d in docs],
            "warm_first_ms_median": statistics.median(
                [x for d in docs for x in d["first_ms"][1:]]),
            "drain_ms": [d["drain_ms"] for d in docs],
            "host_walk_ms": [d["host_walk_ms"] for d in docs]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
