"""PageRank — the canonical iterative shuffle workload.

Every iteration shuffles one contribution per edge, keyed by destination
vertex, and sums per key on the device through the combine read
(``read(handle, combine="sum")``): one row per edge enters the exchange,
one row per distinct destination leaves it. Every iteration registers a
same-shape shuffle, so the manager's capacity learning warms after the
first round.

Semantics mirror Spark's ``SparkPageRank`` example: ``rank = 0.15 + 0.85
* contribs``, dangling-vertex mass is dropped, and vertices with no
in-links settle at 0.15. The oracle is the same float64 power iteration
as the JAX runner's, with the product by the link matrix taken edge by
edge (``np.bincount`` over destinations) where the JAX runner builds the
dense ``[V, V]`` matrix.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
from sparkucx_tpu_torch.workloads.graphs import random_digraph


def power_iteration(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                    iterations: int) -> np.ndarray:
    """float64 ranks after ``iterations`` rounds of ``0.15 + 0.85 * A @
    r`` with ``A[dst, src] = 1 / outdeg[src]`` over distinct edges."""
    outdeg = np.bincount(src, minlength=num_vertices).astype(np.float64)
    want = np.full(num_vertices, 1.0, dtype=np.float64)
    for _ in range(iterations):
        want = 0.15 + 0.85 * np.bincount(
            dst, weights=want[src] / outdeg[src], minlength=num_vertices)
    return want


def run_pagerank(manager: ShuffleManager, *, num_vertices: int = 64,
                 num_edges: int = 400, num_partitions: int = 8,
                 num_mappers: int = 4, iterations: int = 10,
                 seed: int = 0, shuffle_id_base: int = 9100,
                 tol: float = 1e-3) -> Dict[str, float]:
    """Returns {'vertices', 'edges', 'iterations', 'max_err'}; raises if
    the device ranks drift from the float64 oracle beyond ``tol``."""
    rng = np.random.default_rng(seed)
    edges = random_digraph(rng, num_vertices, num_edges)
    src, dst = edges[:, 0], edges[:, 1]
    outdeg = np.bincount(src, minlength=num_vertices).astype(np.float64)

    ranks = np.full(num_vertices, 1.0, dtype=np.float64)
    sid = shuffle_id_base
    for _ in range(iterations):
        # one contribution row per edge: key = destination vertex,
        # value = rank[src] / outdeg[src] — summed per key on device
        contrib = (ranks[src] / outdeg[src]).astype(np.float32)
        h = manager.register_shuffle(sid, num_mappers, num_partitions)
        try:
            lo = 0
            for m, chunk in enumerate(np.array_split(dst, num_mappers)):
                w = manager.get_writer(h, m)
                if chunk.size:
                    w.write(chunk,
                            contrib[lo:lo + chunk.size].reshape(-1, 1))
                lo += chunk.size
                w.commit(num_partitions)
            sums = np.zeros(num_vertices, dtype=np.float64)
            res = manager.read(h, combine="sum", sink="host")
            for _, (ks, vs) in res.partitions():
                if len(ks):
                    sums[ks] = vs[:, 0]
        finally:
            manager.unregister_shuffle(sid)
        sid += 1
        ranks = 0.15 + 0.85 * sums

    want = power_iteration(src, dst, num_vertices, iterations)
    max_err = float(np.abs(ranks - want).max())
    if max_err > tol:
        raise AssertionError(
            f"pagerank drift vs oracle: max_err={max_err:.2e} > {tol}")
    return {"vertices": num_vertices, "edges": int(len(edges)),
            "iterations": iterations, "max_err": max_err}
