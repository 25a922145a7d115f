"""Shuffle hash join — the TPC-DS-style skew stressor.

TPC-DS's shuffle-heavy joins (q64, q95) are repartition joins: both sides
hash-partitioned on the join key through the shuffle, then joined
partition by partition. Skew (a few hot keys owning most rows) is what
breaks static provisioning: the hot partitions overflow their receive
capacity and the exchange regrows. :func:`run_join` joins int64 keys with
a Zipf-ish hot head; :func:`run_join_varchar` joins on string keys whose
exact bytes ride beside a side marker. Both verify the join's output row
count against a numpy oracle on the unshuffled data. The external-memory
join pipeline is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


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
