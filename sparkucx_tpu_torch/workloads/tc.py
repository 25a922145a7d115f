"""Transitive closure — Spark's ``SparkTC`` example.

The closure of a random digraph by iterated join: paths(a, b) |><|
edges(b, c) -> (a, c), union, distinct, until the fixpoint. Every round
shuffles both relations on the join key through the manager, then
hash-joins per partition on the host. Verified against boolean matrix
powers.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
from sparkucx_tpu_torch.workloads.graphs import random_digraph


def _shuffle_pairs(manager: ShuffleManager, shuffle_id: int,
                   pairs: np.ndarray, key_col: int, num_partitions: int,
                   num_mappers: int):
    """Shuffle (a, b) int pairs keyed on one column; returns per-partition
    [n, 2] arrays."""
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        chunks = np.array_split(pairs, num_mappers)
        for m, chunk in enumerate(chunks):
            w = manager.get_writer(h, m)
            if chunk.size:
                w.write(np.ascontiguousarray(chunk[:, key_col]),
                        np.ascontiguousarray(chunk))
            w.commit(num_partitions)
        res = manager.read(h, sink="host")
        return [res.partition(r)[1] for r in range(num_partitions)]
    finally:
        manager.unregister_shuffle(shuffle_id)


def run_tc(manager: ShuffleManager, *, num_vertices: int = 40,
           num_edges: int = 120, num_partitions: int = 16,
           num_mappers: int = 4, seed: int = 0,
           max_iters: int = 16) -> Dict[str, int]:
    """Returns {'edges', 'closure', 'iterations'}; verified against a
    boolean matrix-power oracle."""
    rng = np.random.default_rng(seed)
    edges = random_digraph(rng, num_vertices, num_edges)

    closure: Set[Tuple[int, int]] = {tuple(e) for e in edges}
    sid = 8000
    iters = 0
    while iters < max_iters:
        iters += 1
        paths = np.asarray(sorted(closure), dtype=np.int64)
        # join paths(a,b) with edges(b,c) on b: shuffle paths by col 1,
        # edges by col 0, same partition count -> co-partitioned
        p_parts = _shuffle_pairs(manager, sid, paths, 1, num_partitions,
                                 num_mappers)
        sid += 1
        e_parts = _shuffle_pairs(manager, sid, edges, 0, num_partitions,
                                 num_mappers)
        sid += 1
        new_pairs: Set[Tuple[int, int]] = set()
        for pp, ee in zip(p_parts, e_parts):
            if pp is None or ee is None or not len(pp) or not len(ee):
                continue
            by_b: Dict[int, list] = {}
            for a, b in pp:
                by_b.setdefault(int(b), []).append(int(a))
            for b, c in ee:
                for a in by_b.get(int(b), ()):
                    if a != int(c):
                        new_pairs.add((a, int(c)))
        before = len(closure)
        closure |= new_pairs
        if len(closure) == before:
            break

    # oracle: boolean matrix powers
    adj = np.zeros((num_vertices, num_vertices), dtype=bool)
    adj[edges[:, 0], edges[:, 1]] = True
    reach = adj.copy()
    for _ in range(num_vertices):
        nxt = reach | (reach @ adj)
        if (nxt == reach).all():
            break
        reach = nxt
    np.fill_diagonal(reach, False)
    want = {(int(i), int(j)) for i, j in zip(*np.nonzero(reach))}
    if closure != want:
        raise AssertionError(
            f"transitive closure mismatch: {len(closure)} vs {len(want)}")
    return {"edges": len(edges), "closure": len(closure),
            "iterations": iters}
