"""Shared graph-input generation for the graph workloads (tc, pagerank)."""

from __future__ import annotations

import numpy as np


def random_digraph(rng: np.random.Generator, num_vertices: int,
                   num_edges: int) -> np.ndarray:
    """[E, 2] int64 distinct edges, self-loops removed (E <= num_edges)."""
    edges = np.unique(
        rng.integers(0, num_vertices, size=(num_edges, 2)), axis=0)
    return edges[edges[:, 0] != edges[:, 1]].astype(np.int64)
