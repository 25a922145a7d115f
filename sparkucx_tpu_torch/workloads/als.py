"""ALS — alternating least squares over a sparse rating matrix, the
iterative all-to-all shuffle.

Each half-iteration re-shuffles the ratings so the factors being solved
for are co-located with their ratings: ratings grouped by user, then by
item. Every entity's factor is the ridge-regularised normal-equation
solve over its ratings; here all entities of a partition are solved in
one batch (their outer products summed per entity, then one stacked
``np.linalg.solve``), where the JAX runner solves one entity at a time.
Verified by decreasing RMSE.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


def _group_by_key(manager, shuffle_id, keys, payload, num_partitions,
                  num_mappers):
    """Shuffle (key, payload) rows; returns every partition's (keys,
    payload rows)."""
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        kchunks = np.array_split(keys, num_mappers)
        pchunks = np.array_split(payload, num_mappers)
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            if kchunks[m].size:
                w.write(np.ascontiguousarray(kchunks[m]),
                        np.ascontiguousarray(pchunks[m]))
            w.commit(num_partitions)
        res = manager.read(h, sink="host")
        return [res.partition(r) for r in range(num_partitions)]
    finally:
        manager.unregister_shuffle(shuffle_id)


def _solve_side(parts, factors_other, rank, reg):
    """Per grouped partition: the ridge normal equations ``(O^T O + reg
    I) f = O^T r`` of every entity at once, where O holds the factors of
    the entity's rated counterparts (payload lane 1) and r its ratings
    (lane 0). The rows are sorted by entity and each entity's outer
    products and right-hand sides are summed over its run
    (``np.add.reduceat``), then one stacked solve. Returns {entity:
    factor}."""
    out = {}
    for k, v in parts:
        if k.size == 0:
            continue
        order = np.argsort(k, kind="stable")
        ks, v = k[order], v[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        others = factors_other[v[:, 1].astype(np.int64)]
        outer = (others[:, :, None] * others[:, None, :]).reshape(
            -1, rank * rank)
        A = np.add.reduceat(outer, starts, axis=0).reshape(-1, rank, rank)
        A += reg * np.eye(rank)
        b = np.add.reduceat(others * v[:, 0:1], starts, axis=0)
        f = np.linalg.solve(A, b[:, :, None])[:, :, 0]
        out.update(zip(ks[starts].tolist(), f))
    return out


def run_als(manager: ShuffleManager, *, num_users: int = 64,
            num_items: int = 48, num_ratings: int = 800, rank: int = 8,
            iterations: int = 4, reg: float = 0.1,
            num_partitions: int = 16, num_mappers: int = 4,
            seed: int = 0) -> Dict[str, float]:
    """Returns {'rmse_initial', 'rmse_final', 'iterations'}; raises unless
    the final RMSE is below half the initial one."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, size=num_ratings).astype(np.int64)
    items = rng.integers(0, num_items, size=num_ratings).astype(np.int64)
    # planted low-rank structure so ALS has something to recover
    tu = rng.normal(size=(num_users, rank)) / np.sqrt(rank)
    ti = rng.normal(size=(num_items, rank)) / np.sqrt(rank)
    ratings = np.sum(tu[users] * ti[items], axis=1).astype(np.float32)

    U = rng.normal(size=(num_users, rank)).astype(np.float64) * 0.1
    V = rng.normal(size=(num_items, rank)).astype(np.float64) * 0.1

    def rmse():
        pred = np.sum(U[users] * V[items], axis=1)
        return float(np.sqrt(np.mean((pred - ratings) ** 2)))

    first = rmse()
    sid = 7000
    for _ in range(iterations):
        # solve U: group ratings by user (payload: rating, item)
        payload = np.stack(
            [ratings, items.astype(np.float32)], axis=1).astype(np.float32)
        parts = _group_by_key(manager, sid, users, payload,
                              num_partitions, num_mappers)
        sid += 1
        for ent, f in _solve_side(parts, V, rank, reg).items():
            U[ent] = f
        # solve V: group by item (payload: rating, user)
        payload = np.stack(
            [ratings, users.astype(np.float32)], axis=1).astype(np.float32)
        parts = _group_by_key(manager, sid, items, payload,
                              num_partitions, num_mappers)
        sid += 1
        for ent, f in _solve_side(parts, U, rank, reg).items():
            V[ent] = f
    last = rmse()
    if not (last < first * 0.5):
        raise AssertionError(f"ALS failed to converge: {first} -> {last}")
    return {"rmse_initial": first, "rmse_final": last,
            "iterations": iterations}
