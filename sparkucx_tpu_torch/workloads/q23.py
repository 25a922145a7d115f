"""TPC-DS q23 shape — semi-join against an aggregated filter set.

q23 first aggregates a fact table to build a filter set ("frequent
items": items sold more than N times), then semi-joins another fact table
against it and aggregates the survivors. Two exchanges, one device
combine:

  exchange 1  — combine-sum sales counts by item (the "frequent items"
                CTE): one row per item survives the exchange, and the
                partitions hold disjoint item sets.
  exchange 2  — route the second fact table's raw rows by the same key
                through the same partitioner: every row lands in the
                partition that owns its item's aggregate, so the
                semi-join filter is partition-local (Spark runs q23's
                semi-join the same way).
  reduce      — per partition: frequent set = items over threshold;
                semi-join filter; grouped sum of surviving quantities.

Verified end to end against a host oracle over the unshuffled inputs;
set membership is ``np.isin`` where the JAX runner probes Python sets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


def run_q23(manager: ShuffleManager, *, num_mappers: int = 4,
            sales_rows: int = 4000, probe_rows: int = 6000,
            num_partitions: int = 16, item_space: int = 400,
            frequency_threshold: int = 12, shuffle_id: int = 9300,
            seed: int = 0) -> Dict[str, int]:
    """Run the q23 shape; returns {'frequent_items', 'surviving_rows',
    'surviving_qty'} after verifying every number against the host
    oracle. Item popularity has a hot eighth so the frequent set is a
    real subset (not empty, not everything)."""
    rng = np.random.default_rng(seed)

    def gen_items(rows):
        # heavy head: popular items clear the frequency threshold,
        # the long tail does not
        hot = rng.integers(0, item_space // 8, size=rows // 2)
        cold = rng.integers(item_space // 8, item_space,
                            size=rows - rows // 2)
        keys = np.concatenate([hot, cold]).astype(np.int64)
        rng.shuffle(keys)
        return keys

    # ---- exchange 1: combine-sum sales counts by item ------------------
    h1 = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    store_sales = []
    per_map = sales_rows // num_mappers
    for m in range(num_mappers):
        k = gen_items(per_map)
        w = manager.get_writer(h1, m)
        w.write(k, np.ones((per_map, 1), np.int32))   # count lane
        w.commit(num_partitions)
        store_sales.append(k)
    store_sales = np.concatenate(store_sales)
    agg = manager.read(h1, combine="sum", sink="host")

    # per-partition frequent sets (the CTE result, partition-local)
    frequent_by_part = {}
    for r in range(num_partitions):
        k, v = agg.partition(r)
        frequent_by_part[r] = k[v[:, 0] > frequency_threshold]
    manager.unregister_shuffle(shuffle_id)

    # ---- exchange 2: route probe rows by item, same partitioner --------
    h2 = manager.register_shuffle(shuffle_id + 1, num_mappers,
                                  num_partitions)
    probe_keys, probe_qty = [], []
    per_map = probe_rows // num_mappers
    for m in range(num_mappers):
        k = gen_items(per_map)
        q = rng.integers(1, 10, size=(per_map, 1)).astype(np.int32)
        w = manager.get_writer(h2, m)
        w.write(k, q)
        w.commit(num_partitions)
        probe_keys.append(k)
        probe_qty.append(q)
    probe_keys = np.concatenate(probe_keys)
    probe_qty = np.concatenate(probe_qty)[:, 0]
    probe = manager.read(h2, sink="host")

    # ---- reduce: partition-local semi-join + grouped aggregation -------
    surviving_rows = 0
    surviving_qty = 0
    for r in range(num_partitions):
        k, v = probe.partition(r)
        # co-partitioning invariant: a probe row's item aggregate lives
        # in THIS partition, so the filter set lookup is local
        mask = np.isin(k, frequent_by_part[r])
        surviving_rows += int(mask.sum())
        surviving_qty += int(v[mask, 0].sum())
    manager.unregister_shuffle(shuffle_id + 1)

    # ---- host oracle ----------------------------------------------------
    items, counts = np.unique(store_sales, return_counts=True)
    frequent = items[counts > frequency_threshold]
    oracle_mask = np.isin(probe_keys, frequent)
    if not np.array_equal(
            np.unique(np.concatenate(list(frequent_by_part.values()))),
            frequent):
        raise AssertionError("frequent-item sets disagree with oracle")
    if surviving_rows != int(oracle_mask.sum()):
        raise AssertionError(
            f"semi-join rows {surviving_rows} != "
            f"oracle {int(oracle_mask.sum())}")
    want_qty = int(probe_qty[oracle_mask].sum())
    if surviving_qty != want_qty:
        raise AssertionError(
            f"aggregated qty {surviving_qty} != oracle {want_qty}")
    if not (0 < len(frequent) < len(items)):
        raise AssertionError(
            "degenerate frequent set — tune threshold/item_space")
    return {"frequent_items": len(frequent),
            "surviving_rows": surviving_rows,
            "surviving_qty": surviving_qty}
