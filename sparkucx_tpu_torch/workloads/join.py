"""Shuffle hash join — the TPC-DS-style skew stressor.

TPC-DS's shuffle-heavy joins (q64, q95) are repartition joins: both sides
hash-partitioned on the join key through the shuffle, then joined
partition by partition. Skew (a few hot keys owning most rows) is what
breaks static provisioning: the hot partitions overflow their receive
capacity and the exchange regrows. :func:`run_join` joins int64 keys with
a Zipf-ish hot head; :func:`run_join_varchar` joins on string keys whose
exact bytes ride beside a side marker. Both verify the join's output row
count against a numpy oracle on the unshuffled data.
:func:`join_pipeline` is the external-memory repartition join: both sides
ten times a memory budget, spilled at ingest, read as waved host reads
and joined partition by partition.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
from sparkucx_tpu_torch.workloads import (MemoryBudget, PhaseWalls,
                                          WorkloadReport, _program_count,
                                          _spill_counters)


def join_pipeline(manager: ShuffleManager, *,
                  budget_bytes: int, scale: float = 1.0,
                  total_rows: Optional[int] = None,
                  num_mappers: int = 8, num_partitions: int = 32,
                  key_space: int = 20000, hot_keys: int = 8,
                  hot_fraction: float = 0.3, shuffle_id: int = 9400,
                  seed: int = 0,
                  chunk_rows: int = 65536) -> WorkloadReport:
    """External-memory repartition join at ten times the budget: both
    sides hash-partition on the join key through the shuffle (two
    same-shaped exchanges), with chunked ingest and the pool valve on
    both sides and a hot head of ``hot_keys`` keys owning
    ``hot_fraction`` of each side's rows (the TPC-DS skew stressor). The
    partition-local join streams partition by partition, releasing each
    block behind itself (``release_partition``). The oracle is
    O(key_space): per-key build and probe counts accumulated at ingest
    give the exact output-row count. Returns a
    :class:`~sparkucx_tpu_torch.workloads.WorkloadReport`."""
    pool = manager.node.pool
    metrics = manager.node.metrics
    row_bytes = 8 + 8                  # key + [key_lo32, marker] lanes
    if total_rows is None:
        total_rows = max(2 * num_mappers * num_partitions,
                         int(10.0 * scale * budget_bytes) // row_bytes)
    side_rows = total_rows // 2        # equal sides: one plan shape
    total_rows = side_rows * 2
    rep = WorkloadReport("join", rows_in=total_rows,
                         bytes_in=total_rows * row_bytes,
                         budget_bytes=budget_bytes,
                         backend=manager.node.device.type, oracle="exact")
    walls = PhaseWalls("join", metrics)
    budget = MemoryBudget(pool, budget_bytes)
    pool.reset_peak_bytes()
    spill_b0, spill_c0 = _spill_counters(metrics)
    prog0 = _program_count()

    rng = np.random.default_rng(seed)
    truth = {1: np.zeros(key_space, dtype=np.int64),
             2: np.zeros(key_space, dtype=np.int64)}

    def gen_chunk(n: int) -> np.ndarray:
        n_hot = int(n * hot_fraction)
        keys = np.concatenate([
            rng.integers(0, hot_keys, size=n_hot),
            rng.integers(hot_keys, key_space, size=n - n_hot),
        ]).astype(np.int64)
        rng.shuffle(keys)
        return keys

    handles = {}
    try:
        with walls.phase("ingest"):
            for marker, sid in ((1, shuffle_id), (2, shuffle_id + 1)):
                h = manager.register_shuffle(sid, num_mappers,
                                             num_partitions)
                handles[marker] = h
                writers = [manager.get_writer(h, m)
                           for m in range(num_mappers)]
                per_map = side_rows // num_mappers
                for m in range(num_mappers):
                    m_rows = per_map if m < num_mappers - 1 else \
                        side_rows - per_map * (num_mappers - 1)
                    for c0 in range(0, m_rows, chunk_rows):
                        n = min(chunk_rows, m_rows - c0)
                        keys = gen_chunk(n)
                        truth[marker] += np.bincount(keys,
                                                     minlength=key_space)
                        vals = np.stack(
                            [keys.astype(np.int32),
                             np.full(n, marker, np.int32)], axis=1)
                        writers[m].write(keys, vals)
                        with walls.phase("spill"):
                            budget.maybe_spill(writers)
                for w in writers:
                    w.commit(num_partitions)

        with walls.phase("exchange"):
            build_res = manager.read(handles[1], sink="host")
            probe_res = manager.read(handles[2], sink="host")
        rep.warm_programs = _program_count() - prog0
        waves = 0
        for sid in (shuffle_id, shuffle_id + 1):
            rrep = manager.report(sid)
            if rrep is not None:
                waves = max(waves, int(rrep.waves or 0))
        rep.waves = waves
        rep.exchanges = 2

        out_rows = 0
        max_part = 0
        with walls.phase("merge"):
            for r in range(num_partitions):
                bk, bv = build_res.partition(r)
                pk, pv = probe_res.partition(r)
                if bk.shape[0] and not (
                        bv[:, 0] == bk.astype(np.int32)).all():
                    raise AssertionError(f"partition {r}: build row "
                                         f"corruption")
                if pk.shape[0] and not (
                        pv[:, 0] == pk.astype(np.int32)).all():
                    raise AssertionError(f"partition {r}: probe row "
                                         f"corruption")
                bu, bc = np.unique(bk, return_counts=True)
                pu, pc = np.unique(pk, return_counts=True)
                _, bi, pi = np.intersect1d(bu, pu, assume_unique=True,
                                           return_indices=True)
                out_rows += int((bc[bi] * pc[pi]).sum())
                max_part = max(max_part, bk.shape[0] + pk.shape[0])
                # streaming emit: drop each partition's blocks behind us
                build_res.release_partition(r)
                probe_res.release_partition(r)

        with walls.phase("emit"):
            want = int((truth[1] * truth[2]).sum())
            rep.oracle_ok = bool(out_rows == want)
            rep.rows_out = out_rows
        mean_part = total_rows / num_partitions
        rep.extra = {
            "output_rows": out_rows, "expected_rows": want,
            "side_rows": side_rows, "key_space": key_space,
            "hot_keys": hot_keys, "hot_fraction": hot_fraction,
            "max_partition_rows": int(max_part),
            "skew_ratio": round(max_part / mean_part, 2),
            "num_mappers": num_mappers,
            "num_partitions": num_partitions,
            "probe_programs": rep.warm_programs,
            "forced_spills": budget.forced_spills,
            "forced_spill_bytes": budget.forced_bytes,
        }
    finally:
        for sid in (shuffle_id, shuffle_id + 1):
            manager.unregister_shuffle(sid)

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


def _gen_side(rng, rows: int, key_space: int, hot_keys: int,
              hot_fraction: float, payload_base: int):
    """Keys with a heavy head: `hot_fraction` of rows land on `hot_keys`
    keys; payload encodes (key, side marker) for verification."""
    n_hot = int(rows * hot_fraction)
    hot = rng.integers(0, hot_keys, size=n_hot)
    cold = rng.integers(hot_keys, key_space, size=rows - n_hot)
    keys = np.concatenate([hot, cold]).astype(np.int64)
    rng.shuffle(keys)
    vals = np.stack([keys.astype(np.int32),
                     np.full(rows, payload_base, np.int32)], axis=1)
    return keys, vals


def run_join(manager: ShuffleManager, *, num_mappers: int = 4,
             build_rows: int = 2000, probe_rows: int = 8000,
             num_partitions: int = 32, key_space: int = 1000,
             hot_keys: int = 5, hot_fraction: float = 0.5,
             shuffle_id: int = 9100, seed: int = 0) -> Dict[str, int]:
    """Repartition join: shuffle build side and probe side on the join
    key, join per partition, verify counts against the numpy oracle.
    Returns {'output_rows', 'max_partition_rows', 'skew_ratio'}."""
    rng = np.random.default_rng(seed)

    sides = {}
    for name, rows, base, sid in (("build", build_rows, 1, shuffle_id),
                                  ("probe", probe_rows, 2, shuffle_id + 1)):
        h = manager.register_shuffle(sid, num_mappers, num_partitions)
        all_k = []
        per_map = rows // num_mappers
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            k, v = _gen_side(rng, per_map, key_space, hot_keys,
                             hot_fraction, base)
            w.write(k, v)
            w.commit(num_partitions)
            all_k.append(k)
        sides[name] = (h, np.concatenate(all_k))

    try:
        build_res = manager.read(sides["build"][0], sink="host")
        probe_res = manager.read(sides["probe"][0], sink="host")

        # partition-local hash join + verification
        out_rows = 0
        max_part = 0
        for r in range(num_partitions):
            bk, bv = build_res.partition(r)
            pk, pv = probe_res.partition(r)
            assert (bv[:, 0] == bk.astype(np.int32)).all(), "row corruption"
            assert (pv[:, 0] == pk.astype(np.int32)).all(), "row corruption"
            # join: count matches per key (values carry the side marker)
            bu, bc = np.unique(bk, return_counts=True)
            pu, pc = np.unique(pk, return_counts=True)
            common, bi, pi = np.intersect1d(bu, pu, return_indices=True)
            part_out = int((bc[bi] * pc[pi]).sum())
            out_rows += part_out
            max_part = max(max_part, bk.shape[0] + pk.shape[0])

        # oracle on unpartitioned data
        bu, bc = np.unique(sides["build"][1], return_counts=True)
        pu, pc = np.unique(sides["probe"][1], return_counts=True)
        common, bi, pi = np.intersect1d(bu, pu, return_indices=True)
        want = int((bc[bi] * pc[pi]).sum())
        if out_rows != want:
            raise AssertionError(
                f"join output {out_rows} != oracle {want}")

        mean_part = (build_rows + probe_rows) / num_partitions
        return {"output_rows": out_rows,
                "max_partition_rows": int(max_part),
                "skew_ratio": round(max_part / mean_part, 2)}
    finally:
        manager.unregister_shuffle(shuffle_id)
        manager.unregister_shuffle(shuffle_id + 1)


def run_join_varchar(manager: ShuffleManager, *, num_mappers: int = 4,
                     build_rows: int = 1500, probe_rows: int = 6000,
                     num_partitions: int = 24, vocab_size: int = 300,
                     hot_keys: int = 4, hot_fraction: float = 0.5,
                     max_key_bytes: int = 20, shuffle_id: int = 9120,
                     seed: int = 0) -> Dict[str, int]:
    """Repartition join on STRING keys — the TPC-DS varchar-join shape.
    Keys are customer-id-like strings; routing and grouping use their
    64-bit FNV hash and the EXACT key bytes ride as a carried varlen
    payload next to a side marker, so the partition-local join matches on
    true strings (a hash collision would surface as a byte mismatch, not
    silent corruption). Returns {'output_rows', 'distinct_keys'}."""
    from sparkucx_tpu_torch.io.varlen import (hash_bytes64,
                                              pack_counted_varbytes,
                                              unpack_counted_rows)

    rng = np.random.default_rng(seed)
    vocab = ([f"AAAAAAAA{i:08x}" for i in range(hot_keys)]
             + [f"CUST{rng.integers(0, 1 << 48):012x}"
                for _ in range(vocab_size - hot_keys)])
    assert all(len(wd) <= max_key_bytes for wd in vocab)

    def gen_side(rows, marker):
        n_hot = int(rows * hot_fraction)
        idx = np.concatenate([
            rng.integers(0, hot_keys, size=n_hot),
            rng.integers(hot_keys, vocab_size, size=rows - n_hot)])
        rng.shuffle(idx)
        words = [vocab[i] for i in idx]
        # [marker | varbytes(key)] — the counted-varbytes layout with the
        # side marker riding the count lane
        vals, _ = pack_counted_varbytes(
            words, np.full(rows, marker, np.int32), max_key_bytes)
        return hash_bytes64(words), vals, words

    sides = {}
    for name, rows, marker, sid in (
            ("build", build_rows, 1, shuffle_id),
            ("probe", probe_rows, 2, shuffle_id + 1)):
        h = manager.register_shuffle(sid, num_mappers, num_partitions)
        all_words = []
        per_map = rows // num_mappers
        for m in range(num_mappers):
            keys, vals, words = gen_side(per_map, marker)
            w = manager.get_writer(h, m)
            w.write(keys, vals)
            w.commit(num_partitions)
            all_words.extend(words)
        sides[name] = (h, all_words)

    try:
        build_res = manager.read(sides["build"][0], sink="host")
        probe_res = manager.read(sides["probe"][0], sink="host")

        out_rows = 0
        for r in range(num_partitions):
            per = {}
            for res, marker in ((build_res, 1), (probe_res, 2)):
                ks, vs = res.partition(r)
                if not ks.shape[0]:
                    per[marker] = {}
                    continue
                markers, words = unpack_counted_rows(ks.shape[0], vs)
                assert (markers == marker).all(), "side marker corrupted"
                counts = {}
                for wd in words:
                    counts[wd] = counts.get(wd, 0) + 1
                per[marker] = counts
            for wd, bc in per[1].items():
                pc = per[2].get(wd, 0)
                out_rows += bc * pc

        truth_b, truth_p = {}, {}
        for wd in sides["build"][1]:
            truth_b[wd] = truth_b.get(wd, 0) + 1
        for wd in sides["probe"][1]:
            truth_p[wd] = truth_p.get(wd, 0) + 1
        want = sum(c * truth_p.get(wd, 0) for wd, c in truth_b.items())
        if out_rows != want:
            raise AssertionError(
                f"varchar join output {out_rows} != oracle {want}")
        return {"output_rows": out_rows,
                "distinct_keys": len(set(truth_b) | set(truth_p))}
    finally:
        manager.unregister_shuffle(shuffle_id)
        manager.unregister_shuffle(shuffle_id + 1)
