"""GroupBy — Spark's ``GroupByTest``: mappers generate random KV pairs,
the shuffle groups them by key, the job counts distinct keys.

* :func:`run_groupby` — the host-contract job (numpy partition views).
  The key-set oracle is ``np.unique`` over every written and every read
  key, where the JAX runner builds Python sets.
* :func:`run_groupby_device` — the group-by-aggregate on the device
  combiner: ``read(combine="sum", sink="device")`` lands one combined,
  key-sorted row per distinct key per partition on the device, and a
  torch step (:func:`make_device_groupby_step`) aggregates the rows the
  consumer is handed. No payload byte comes back: only the per-shard
  aggregates.
* :func:`groupby_pipeline` — the same aggregate over a dataset ten times
  a memory budget: spilled chunked ingest, one waved combine read whose
  waves fold on the device, and an exact O(key_space) oracle.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
from sparkucx_tpu_torch.utils.metrics import C_D2H
from sparkucx_tpu_torch.workloads import (MemoryBudget, PhaseWalls,
                                          WorkloadReport, _program_count,
                                          _spill_counters)


def run_groupby(manager: ShuffleManager, *, num_mappers: int = 8,
                pairs_per_mapper: int = 1000, num_partitions: int = 32,
                key_space: int = 500, value_width: int = 4,
                shuffle_id: int = 9001, seed: int = 0) -> Dict[str, int]:
    """Returns {'distinct_keys', 'rows'} after verifying grouping."""
    rng = np.random.default_rng(seed)
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        expected_rows = 0
        written = []
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            keys = rng.integers(0, key_space,
                                size=pairs_per_mapper).astype(np.int64)
            vals = rng.normal(
                size=(pairs_per_mapper, value_width)).astype(np.float32)
            w.write(keys, vals)
            w.commit(num_partitions)
            expected_rows += pairs_per_mapper
            written.append(keys)
        truth_keys = np.unique(np.concatenate(written))
        res = manager.read(h, sink="host")
        got = []
        rows = 0
        for r, (k, v) in res.partitions():
            assert v is not None and v.shape[0] == k.shape[0]
            got.append(k)
            rows += k.shape[0]
        distinct = np.unique(np.concatenate(got))
        if rows != expected_rows:
            raise AssertionError(f"row loss: {rows} != {expected_rows}")
        if not np.array_equal(distinct, truth_keys):
            raise AssertionError("key set mismatch after grouping")
        return {"distinct_keys": int(distinct.size), "rows": rows}
    finally:
        manager.unregister_shuffle(shuffle_id)


def _groupby_step(num_shards: int, cap: int, width: int, value_width: int,
                  as_float: bool):
    def step(rows: torch.Tensor, totals: torch.Tensor):
        if tuple(rows.shape) != (num_shards, cap, width):
            raise ValueError(f"rows {tuple(rows.shape)}, want "
                             f"{(num_shards, cap, width)}")
        valid = torch.arange(cap, device=rows.device)[None, :] \
            < totals[:, None]
        vals = rows[:, :, 2:2 + value_width]
        if as_float:
            vals = vals.view(torch.float32)
            zero = torch.zeros((), dtype=torch.float32, device=rows.device)
        else:
            vals = vals.to(torch.int64)
            zero = torch.zeros((), dtype=torch.int64, device=rows.device)
        sums = torch.where(valid[:, :, None], vals, zero).sum(dim=(1, 2))
        return totals.to(torch.int64), sums
    return step


def make_device_groupby_step(num_shards: int, cap: int, width: int,
                             value_width: int):
    """The device combiner's consumer step over one delivered wave
    (``rows`` [P, cap, width] int32 combined transport rows, ``totals``
    [P] valid rows): per shard, the count of valid (distinct-key) rows
    and the float32 sum of the decoded value lanes. Only the [P]
    aggregates are meant for the host."""
    return _groupby_step(num_shards, cap, width, value_width, True)


def make_device_groupby_int_step(num_shards: int, cap: int, width: int,
                                 value_width: int):
    """The int32-value twin of :func:`make_device_groupby_step` for the
    pipeline: the transport words are the value lanes, summed exactly
    (in int64), so the pipeline's oracle can ask for exact sums."""
    return _groupby_step(num_shards, cap, width, value_width, False)


def run_groupby_device(manager: ShuffleManager, *,
                       num_mappers: int = 8,
                       pairs_per_mapper: int = 1000,
                       num_partitions: int = 32, key_space: int = 500,
                       value_width: int = 4, shuffle_id: int = 9002,
                       seed: int = 0,
                       check_d2h: bool = True) -> Dict[str, float]:
    """GroupBy-aggregate on the device combiner: one combined row per
    distinct key lands on, and is consumed on, the device; the device
    aggregates are held against a host oracle over the staged pairs.
    Returns {'distinct_keys', 'rows_staged', 'value_sum', 'd2h_bytes'}."""
    rng = np.random.default_rng(seed)
    metrics = manager.node.metrics
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        written = []
        truth_sum = np.float64(0.0)
        staged = 0
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            keys = rng.integers(0, key_space,
                                size=pairs_per_mapper).astype(np.int64)
            vals = rng.normal(
                size=(pairs_per_mapper, value_width)).astype(np.float32)
            w.write(keys, vals)
            w.commit(num_partitions)
            written.append(keys)
            # the oracle sums in float64 only to bound the float32 drift
            truth_sum += np.float64(vals.sum(dtype=np.float64))
            staged += pairs_per_mapper
        truth_distinct = int(np.unique(np.concatenate(written)).size)

        res = manager.read(h, combine="sum", sink="device")
        d0 = metrics.get(C_D2H)
        rows_dev = res.device_rows()
        step = make_device_groupby_step(
            manager.node.num_shards, rows_dev.shape[1], rows_dev.shape[2],
            value_width)
        del rows_dev

        def fold(carry, rows, nv):
            c, s = step(rows, nv)
            return (c, s) if carry is None else (carry[0] + c, carry[1] + s)

        counts, sums = res.consume(fold)
        distinct = int(counts.sum())
        value_sum = float(sums.to(torch.float64).sum())
        d2h = metrics.get(C_D2H) - d0
        if check_d2h and d2h != 0:
            raise AssertionError(
                f"device groupby pulled {d2h} payload bytes D2H — the "
                f"combine path must be zero-D2H")
        if distinct != truth_distinct:
            raise AssertionError(
                f"distinct-key mismatch: device combiner produced "
                f"{distinct} rows, oracle has {truth_distinct} keys")
        denom = max(abs(truth_sum), 1.0)
        if abs(value_sum - float(truth_sum)) / denom > 1e-3:
            raise AssertionError(
                f"value-sum mismatch: device {value_sum} vs oracle "
                f"{float(truth_sum)}")
        return {"distinct_keys": distinct, "rows_staged": staged,
                "value_sum": value_sum, "d2h_bytes": int(d2h)}
    finally:
        manager.unregister_shuffle(shuffle_id)


def groupby_pipeline(manager: ShuffleManager, *,
                     budget_bytes: int, scale: float = 1.0,
                     total_rows: Optional[int] = None,
                     num_mappers: int = 8, num_partitions: int = 32,
                     key_space: int = 20000, value_width: int = 4,
                     shuffle_id: int = 9300, seed: int = 0,
                     sink: str = "device", warm_reads: int = 1,
                     chunk_rows: int = 65536) -> WorkloadReport:
    """External-memory group-by-aggregate at ten times the budget:

    * chunked ingest of (key, int32 value lanes) pairs, the pool valve
      sealing staged bytes to spill files;
    * one waved ``combine="sum"`` read: each wave combines on the device
      and the waves fold there (merge + segment reduce), landing one
      key-sorted row per distinct key on the device; the consumer moves
      no payload byte D2H (``sink="host"`` is the verification arm: each
      key's sums exactly against the host oracle);
    * ``warm_reads`` more reads of the same shuffle.

    The oracle is O(key_space): per-key int64 counts and lane sums
    accumulated during ingest. Returns a
    :class:`~sparkucx_tpu_torch.workloads.WorkloadReport`."""
    pool = manager.node.pool
    metrics = manager.node.metrics
    row_bytes = 8 + 4 * value_width
    if total_rows is None:
        total_rows = max(num_mappers * num_partitions,
                         int(10.0 * scale * budget_bytes) // row_bytes)
    rep = WorkloadReport("groupby", rows_in=total_rows,
                         bytes_in=total_rows * row_bytes,
                         budget_bytes=budget_bytes,
                         backend=manager.node.device.type, oracle="exact")
    walls = PhaseWalls("groupby", metrics)
    budget = MemoryBudget(pool, budget_bytes)
    pool.reset_peak_bytes()
    spill_b0, spill_c0 = _spill_counters(metrics)
    prog0 = _program_count()

    rng = np.random.default_rng(seed)
    truth_count = np.zeros(key_space, dtype=np.int64)
    truth_vsum = np.zeros(key_space, dtype=np.int64)   # per-key lane sum
    truth_sum = np.int64(0)

    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    writers = [manager.get_writer(h, m) for m in range(num_mappers)]
    try:
        with walls.phase("ingest"):
            per_map = total_rows // num_mappers
            for m in range(num_mappers):
                m_rows = per_map if m < num_mappers - 1 else \
                    total_rows - per_map * (num_mappers - 1)
                for c0 in range(0, m_rows, chunk_rows):
                    n = min(chunk_rows, m_rows - c0)
                    keys = rng.integers(0, key_space,
                                        size=n).astype(np.int64)
                    # small magnitudes: the int32 device sums stay exact
                    vals = rng.integers(0, 4, size=(n, value_width)
                                        ).astype(np.int32)
                    truth_count += np.bincount(keys, minlength=key_space)
                    truth_vsum += np.bincount(
                        keys, weights=vals.sum(axis=1, dtype=np.int64),
                        minlength=key_space).astype(np.int64)
                    truth_sum += vals.sum(dtype=np.int64)
                    writers[m].write(keys, vals)
                    with walls.phase("spill"):
                        budget.maybe_spill(writers)
            for w in writers:
                w.commit(num_partitions)

        truth_distinct = int((truth_count > 0).sum())
        d2h_delta = 0
        distinct = value_sum = None
        reads = 1 + max(0, int(warm_reads))
        waves = 0
        for _ in range(reads):
            with walls.phase("exchange"):
                res = manager.read(h, combine="sum", sink=sink)
            rrep = manager.report(shuffle_id)
            if rrep is not None:
                waves = max(waves, int(rrep.waves or 0))
                # the device fold is timed inside the read: move its
                # wall from exchange to merge
                if rrep.merge_ms:
                    walls.ms["exchange"] = max(
                        0.0, walls.ms["exchange"] - rrep.merge_ms)
                    walls.add("merge", rrep.merge_ms)
            with walls.phase("emit"):
                if sink == "device":
                    d0 = metrics.get(C_D2H)
                    rows_dev = res.device_rows()
                    step = make_device_groupby_int_step(
                        manager.node.num_shards, rows_dev.shape[1],
                        rows_dev.shape[2], value_width)
                    del rows_dev

                    def fold(carry, rows, nv):
                        c, s = step(rows, nv)
                        return (c, s) if carry is None \
                            else (carry[0] + c, carry[1] + s)

                    counts, sums = res.consume(fold)
                    distinct = int(counts.sum())
                    value_sum = int(sums.sum())
                    d2h_delta += int(metrics.get(C_D2H) - d0)
                else:
                    # host arm: each key's sums exactly against the oracle
                    distinct = 0
                    value_sum = 0
                    for r, (k, v) in res.partitions():
                        if not k.shape[0]:
                            continue
                        distinct += k.shape[0]
                        value_sum += int(v.sum(dtype=np.int64))
                        if (truth_count[k] <= 0).any():
                            raise AssertionError(
                                "combined key never ingested")
                        got_rows = v.astype(np.int64).sum(axis=1)
                        if not np.array_equal(got_rows, truth_vsum[k]):
                            raise AssertionError(
                                f"partition {r}: per-key sums diverge "
                                f"from the ingest oracle")
            del res
        rep.warm_programs = _program_count() - prog0
        rep.exchanges = reads
        rep.waves = waves

        rep.oracle_ok = bool(distinct == truth_distinct
                             and value_sum == int(truth_sum))
        if sink == "device" and d2h_delta != 0:
            rep.oracle_ok = False
        rep.rows_out = int(distinct or 0)
        rep.extra = {
            "distinct_keys": int(distinct or 0),
            "truth_distinct": truth_distinct,
            "value_sum": int(value_sum or 0),
            "truth_sum": int(truth_sum),
            "d2h_bytes": d2h_delta, "sink": sink,
            "key_space": key_space, "value_width": value_width,
            "num_mappers": num_mappers,
            "num_partitions": num_partitions,
            "forced_spills": budget.forced_spills,
            "forced_spill_bytes": budget.forced_bytes,
        }
    finally:
        manager.unregister_shuffle(shuffle_id)

    walls.ms["ingest"] = max(0.0, walls.ms["ingest"] - walls.ms["spill"])
    spill_b1, spill_c1 = _spill_counters(metrics)
    rep.spill_bytes = spill_b1 - spill_b0
    rep.spill_count = spill_c1 - spill_c0
    rep.pool_peak_bytes = int(pool.stats()["peak_bytes"])
    rep.programs = _program_count() - prog0
    rep.phases = dict(walls.ms)
    rep.finalize(total_rows)
    walls.publish(total_rows)
    return rep
