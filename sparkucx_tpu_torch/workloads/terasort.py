"""TeraSort — range-partition by key, shuffle, sort each partition;
concatenating the partitions in order yields the globally sorted dataset
(HiBench Terasort's shape).

:func:`terasort_pipeline` is the external-memory sort of a dataset ten
times a memory budget:

* a sampling pass runs the replayable :func:`keystream` through a
  :class:`~sparkucx_tpu_torch.ops.partition.ReservoirSampler` for the
  split points (memory of the reservoir, not of the dataset);
* the dataset streams through budget-sized rounds, each a whole
  shuffle: chunked ingest into the staging pool, ``spill.threshold``
  and the pool valve (:class:`~sparkucx_tpu_torch.workloads.
  MemoryBudget`) sealing staged bytes to spill files, then a waved
  ``ordered=True`` host-sink read returning every partition key-sorted;
* each round appends partition r's sorted keys as one run to r's
  :class:`RunStore` file (sealed like the spill files, mapped back), so
  host memory holds one round at most;
* :func:`merge_sorted_runs` merges each partition's runs through a
  bounded window, emitting the globally sorted stream in partition
  order.

The oracle is per-chunk monotonicity, the order across partition
boundaries and the value-sampled multiset digest against ingest
(:func:`~sparkucx_tpu_torch.workloads.sampled_key_digest`); the exact
host sort runs only up to ``exact_threshold`` rows.

:func:`run_terasort` is the in-memory formulation: split points from a
``ReservoirSampler``, then either ``mode="range"`` — the device routes by
range and key-sorts every partition (``read(ordered=True)``) — or
``mode="direct"`` — the map side computes partition ids itself and the
reduce side sorts on the host.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional

import numpy as np

from sparkucx_tpu_torch.ops.partition import ReservoirSampler, range_partition
from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
from sparkucx_tpu_torch.shuffle.writer import SpillFiles
from sparkucx_tpu_torch.workloads import (MemoryBudget, PhaseWalls,
                                          WorkloadReport, _program_count,
                                          _spill_counters, sampled_key_digest)

ROW_BYTES = 8                      # key-only staging: one int64 per row


def keystream(seed: int, start: int, n: int) -> np.ndarray:
    """Deterministic 62-bit uniform keys for global row indices
    [start, start+n) — splitmix64 of the index stream, so a sampling pass
    and an oracle can replay the dataset instead of storing it."""
    from sparkucx_tpu_torch.shuffle.integrity import _mix64
    with np.errstate(over="ignore"):       # the seed's offset wraps mod 2**64
        idx = np.arange(start, start + n, dtype=np.uint64) \
            + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
    return (_mix64(idx) >> np.uint64(2)).astype(np.int64)


class RunStore:
    """Per-partition sealed sorted-run files, on the
    :class:`~sparkucx_tpu_torch.shuffle.writer.SpillFiles` append, seal
    and map lifecycle (atomic rename, lengths checked before mapping).
    One file per partition; each round appends one run; :meth:`seal`
    freezes them and :meth:`runs` returns partition r's runs as views
    over one mapping."""

    def __init__(self, directory: str, num_partitions: int,
                 store_id: int = 0):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.num_partitions = num_partitions
        self._files = [SpillFiles(directory, store_id, r)
                       for r in range(num_partitions)]
        self._run_rows: List[List[int]] = [[] for _ in
                                           range(num_partitions)]
        self._views: List[Optional[np.ndarray]] = [None] * num_partitions

    def append_run(self, r: int, keys: np.ndarray) -> int:
        """Append one sorted run (int64 keys) to partition r; an empty
        run is dropped. Returns the bytes written."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        if keys.shape[0] == 0:
            return 0
        self._files[r].append(keys, None)
        self._run_rows[r].append(int(keys.shape[0]))
        return int(keys.nbytes)

    def seal(self) -> None:
        for f in self._files:
            f.finish(None, None)

    def runs(self, r: int) -> List[np.ndarray]:
        """Partition r's sealed runs as zero-copy int64 views over one
        mapping (the merge streams the file; it never loads it)."""
        if self._views[r] is None:
            keys, _ = self._files[r].load()
            self._views[r] = keys
        keys = self._views[r]
        out, off = [], 0
        for n in self._run_rows[r]:
            out.append(keys[off:off + n])
            off += n
        return out

    def rows(self, r: int) -> int:
        return sum(self._run_rows[r])

    def close(self) -> None:
        """Close and delete every partition's file."""
        for f in self._files:
            f.close()
        self._views = [None] * self.num_partitions


def merge_sorted_runs(runs: List[np.ndarray],
                      chunk_rows: int = 65536) -> Iterator[np.ndarray]:
    """K-way merge of sorted int64 runs, streamed as sorted chunks with
    O(k × chunk) working memory.

    Each step's bound is the least, over the runs still open, of the key
    ``chunk_rows`` ahead of the run's cursor: every key up to it, in
    every run, goes out in one sorted block (one sort over at most
    k × chunk rows). At least one run advances a whole window per step,
    so the merge ends in O(total / chunk) steps without holding a
    partition."""
    runs = [r for r in runs if r.shape[0]]
    if not runs:
        return
    if len(runs) == 1:
        r = runs[0]
        for off in range(0, r.shape[0], chunk_rows):
            yield np.array(r[off:off + chunk_rows])
        return
    heads = [0] * len(runs)
    while True:
        alive = [i for i, r in enumerate(runs) if heads[i] < r.shape[0]]
        if not alive:
            return
        if len(alive) == 1:
            i = alive[0]
            r = runs[i]
            for off in range(heads[i], r.shape[0], chunk_rows):
                yield np.array(r[off:off + chunk_rows])
            return
        bound = min(
            runs[i][min(heads[i] + chunk_rows, runs[i].shape[0]) - 1]
            for i in alive)
        parts = []
        for i in alive:
            r = runs[i]
            end = heads[i] + int(np.searchsorted(
                r[heads[i]:min(heads[i] + 2 * chunk_rows, r.shape[0])],
                bound, side="right"))
            if end > heads[i]:
                parts.append(np.asarray(r[heads[i]:end]))
                heads[i] = end
        merged = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if len(parts) > 1:
            merged = np.sort(merged, kind="stable")
        yield merged


def terasort_pipeline(manager: ShuffleManager, *,
                      budget_bytes: int, scale: float = 1.0,
                      total_rows: Optional[int] = None,
                      num_mappers: int = 8, num_partitions: int = 32,
                      shuffle_id: int = 9200, seed: int = 0,
                      digest_stride: int = 16,
                      exact_threshold: int = 200_000,
                      chunk_rows: int = 65536,
                      run_dir: Optional[str] = None,
                      arrow: bool = False) -> WorkloadReport:
    """External-memory terasort (module docstring); ``arrow=True`` also
    builds every emitted chunk into an Arrow RecordBatch
    (``io/arrow.kv_to_batch``) and reports its buffer bytes as
    ``extra["arrow_egress_bytes"]``. Returns the
    :class:`~sparkucx_tpu_torch.workloads.WorkloadReport` with the
    per-phase walls, the spill figures, the rounds and the oracle
    verdict."""
    pool = manager.node.pool
    metrics = manager.node.metrics
    if total_rows is None:
        total_rows = max(num_mappers * num_partitions,
                         int(10.0 * scale * budget_bytes) // ROW_BYTES)
    round_rows = min(total_rows,
                     max(num_mappers * 64, budget_bytes // (2 * ROW_BYTES)))
    rounds = math.ceil(total_rows / round_rows)
    # rounds within one row of each other: every round lands on the same
    # capacity bucket
    edges = [round(i * total_rows / rounds) for i in range(rounds + 1)]
    rep = WorkloadReport("terasort", rows_in=total_rows,
                         bytes_in=total_rows * ROW_BYTES,
                         budget_bytes=budget_bytes,
                         backend=manager.node.device.type,
                         oracle="exact" if total_rows <= exact_threshold
                         else "digest")
    walls = PhaseWalls("terasort", metrics)
    budget = MemoryBudget(pool, budget_bytes)
    pool.reset_peak_bytes()
    spill_b0, spill_c0 = _spill_counters(metrics)
    prog0 = _program_count()

    # -- sampling pass: a reservoir over the replayed key stream --------
    with walls.phase("ingest"):
        sampler = ReservoirSampler(
            capacity=max(4096, 128 * num_partitions), seed=seed)
        for start in range(0, total_rows, max(chunk_rows, 1)):
            sampler.add(keystream(seed, start,
                                  min(chunk_rows, total_rows - start)))
        bounds = sampler.bounds(num_partitions)

    tmp_dir = run_dir or tempfile.mkdtemp(prefix="sparkucx_tpu_torch_runs_")
    store = RunStore(tmp_dir, num_partitions, store_id=shuffle_id)
    digest_in, digest_n_in = 0, 0
    waves = exchanges = 0
    try:
        for t in range(rounds):
            r0, r1 = edges[t], edges[t + 1]
            per_map = (r1 - r0) // num_mappers
            h = manager.register_shuffle(
                shuffle_id, num_mappers, num_partitions,
                partitioner="range", bounds=bounds)
            writers = [manager.get_writer(h, m)
                       for m in range(num_mappers)]
            # chunked ingest: generate, digest, stage; the valve
            # force-spills every writer once the pool crosses its line
            with walls.phase("ingest"):
                for m in range(num_mappers):
                    m0 = r0 + m * per_map
                    m1 = r1 if m == num_mappers - 1 else m0 + per_map
                    for c0 in range(m0, m1, chunk_rows):
                        keys = keystream(seed, c0,
                                         min(chunk_rows, m1 - c0))
                        d, n = sampled_key_digest(keys, digest_stride)
                        digest_in = (digest_in + d) & 0xFFFFFFFFFFFFFFFF
                        digest_n_in += n
                        writers[m].write(keys)
                        with walls.phase("spill"):
                            budget.maybe_spill(writers)
                for w in writers:
                    w.commit(num_partitions)
            # the waved ordered exchange (the wave conf is the manager's)
            with walls.phase("exchange"):
                res = manager.read(h, ordered=True, sink="host")
            rrep = manager.report(shuffle_id)
            if rrep is not None:
                waves = max(waves, int(rrep.waves or 0))
            exchanges += 1
            # seal this round's sorted runs, then drop the round
            with walls.phase("merge"):
                for r in range(num_partitions):
                    keys_r, _ = res.partition(r)
                    store.append_run(r, keys_r)
            del res
            manager.unregister_shuffle(shuffle_id)
        rep.warm_programs = _program_count() - prog0

        with walls.phase("merge"):
            store.seal()

        # -- emit: the k-way merge of the sealed runs, checked as it streams
        rows_out = 0
        digest_out, digest_n_out = 0, 0
        arrow_bytes = 0
        exact_keys: List[np.ndarray] = []
        prev_last = None
        boundary_ok = monotonic_ok = True
        with walls.phase("emit"):
            for r in range(num_partitions):
                for chunk in merge_sorted_runs(store.runs(r),
                                               chunk_rows=chunk_rows):
                    if chunk.shape[0] == 0:
                        continue
                    if prev_last is not None and chunk[0] < prev_last:
                        boundary_ok = False
                    if chunk.shape[0] > 1 and (np.diff(chunk) < 0).any():
                        monotonic_ok = False
                    prev_last = chunk[-1]
                    d, n = sampled_key_digest(chunk, digest_stride)
                    digest_out = (digest_out + d) & 0xFFFFFFFFFFFFFFFF
                    digest_n_out += n
                    rows_out += int(chunk.shape[0])
                    if arrow:
                        from sparkucx_tpu_torch.io.arrow import kv_to_batch
                        batch = kv_to_batch(chunk, None,
                                            key_column="key")
                        arrow_bytes += sum(
                            buf.size for col in batch.columns
                            for buf in col.buffers() if buf is not None)
                    if rep.oracle == "exact":
                        exact_keys.append(chunk)

        digest_ok = (digest_out == digest_in
                     and digest_n_out == digest_n_in)
        rep.oracle_ok = bool(boundary_ok and monotonic_ok and digest_ok
                             and rows_out == total_rows)
        if rep.oracle == "exact" and rep.oracle_ok:
            # the exact oracle replays the stream: it never stores it
            want = np.sort(keystream(seed, 0, total_rows))
            got = np.concatenate(exact_keys) if exact_keys else \
                np.zeros(0, np.int64)
            rep.oracle_ok = bool(np.array_equal(got, want))
    finally:
        # rounds unregister as they seal; this covers a round that raised
        manager.unregister_shuffle(shuffle_id)
        store.close()
        if run_dir is None:
            shutil.rmtree(tmp_dir, ignore_errors=True)

    # the spill wall nests inside the ingest loop: subtract it, so the
    # phase walls partition the wall
    walls.ms["ingest"] = max(0.0, walls.ms["ingest"] - walls.ms["spill"])
    spill_b1, spill_c1 = _spill_counters(metrics)
    rep.rows_out = rows_out
    rep.spill_bytes = spill_b1 - spill_b0
    rep.spill_count = spill_c1 - spill_c0
    rep.pool_peak_bytes = int(pool.stats()["peak_bytes"])
    rep.programs = _program_count() - prog0
    rep.exchanges = exchanges
    rep.waves = waves
    rep.phases = dict(walls.ms)
    rep.extra = {
        "rounds": rounds, "round_rows": round_rows,
        "num_mappers": num_mappers, "num_partitions": num_partitions,
        "digest_stride": digest_stride,
        "digest_rows_checked": digest_n_in,
        "boundary_ok": boundary_ok, "monotonic_ok": monotonic_ok,
        "digest_ok": digest_ok,
        "forced_spills": budget.forced_spills,
        "forced_spill_bytes": budget.forced_bytes,
    }
    if arrow:
        rep.extra["arrow_egress_bytes"] = arrow_bytes
    rep.finalize(total_rows)
    walls.publish(total_rows)
    return rep


def run_terasort(manager: ShuffleManager, *, num_mappers: int = 8,
                 rows_per_mapper: int = 2000, num_partitions: int = 32,
                 shuffle_id: int = 9002, seed: int = 0,
                 mode: str = "range") -> Dict[str, int]:
    """Distributed sort of random uint keys; verifies global order.
    Returns {'rows', 'partitions'}."""
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 1 << 40, size=rows_per_mapper).astype(np.int64)
              for _ in range(num_mappers)]
    # sampled split points (the RangePartitioner reservoir-sampling role)
    sampler = ReservoirSampler(capacity=max(512, 64 * num_partitions),
                               seed=seed)
    for s in shards:
        sampler.add(s)
    bounds = sampler.bounds(num_partitions)

    if mode == "range":
        h = manager.register_shuffle(shuffle_id, num_mappers,
                                     num_partitions, partitioner="range",
                                     bounds=bounds)
    else:
        h = manager.register_shuffle(shuffle_id, num_mappers,
                                     num_partitions, partitioner="direct")
    try:
        for m, keys in enumerate(shards):
            w = manager.get_writer(h, m)
            if mode == "range":
                w.write(keys)                      # the key IS the payload
            else:
                part = np.asarray(range_partition(keys, bounds),
                                  dtype=np.int64)
                w.write(part, keys.reshape(-1, 1))
            w.commit(num_partitions)
        res = manager.read(h, ordered=(mode == "range"), sink="host")

        out = []
        rows = 0
        for r in range(num_partitions):
            if mode == "range":
                local, _ = res.partition(r)
                if (np.diff(local) < 0).any():
                    raise AssertionError(
                        f"device-sorted partition {r} is out of order")
            else:
                pid, v = res.partition(r)
                assert (pid == r).all(), "direct routing misplaced rows"
                local = np.sort(v[:, 0])
            # range invariant: partition r's keys fall inside its bounds
            if local.size:
                if r > 0:
                    assert local[0] >= bounds[r - 1]
                if r < num_partitions - 1:
                    assert local[-1] <= bounds[r]
            out.append(local)
            rows += local.size
        merged = np.concatenate(out)
        want = np.sort(np.concatenate(shards))
        if not np.array_equal(merged, want):
            raise AssertionError("terasort output is not globally sorted")
        return {"rows": rows, "partitions": num_partitions}
    finally:
        manager.unregister_shuffle(shuffle_id)
