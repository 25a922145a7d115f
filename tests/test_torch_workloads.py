"""Port parity for the analytics workloads: every runner of the JAX
package (``sparkucx_tpu.workloads``) on its ``dense`` manager over 8
virtual CPU devices against the port's runner on ``connect(device="cpu")``
with 8 logical shards, with the same seed and arguments (the sizes of the
JAX package's own workload tests, ``torch_workload_cases``), two seeds
each.

Exact: every returned dict, except PageRank's ``max_err`` (each side
within ``tol`` and the two within 1e-5 of each other: float32
contributions summed in another order) and ALS's ``rmse_final`` (within
1e-9 relative: the port solves every entity of a partition in one batch).
Also held: the q23 degenerate-set guard, ``sampled_key_digest``,
``keystream``, ``PhaseWalls``' counters and ``WorkloadReport.finalize``
against the JAX package's, and the port's vectorised oracles (PageRank's
edge-wise power iteration, ALS's batched solve) against the JAX loops
within 1e-12."""

import numpy as np
import pytest

from sparkucx_tpu import workloads as jwl
from sparkucx_tpu.utils.metrics import Metrics as JaxMetrics
from sparkucx_tpu.workloads import als as jals
from sparkucx_tpu.workloads import terasort as jts
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch import workloads as twl
from sparkucx_tpu_torch.utils.metrics import Metrics
from sparkucx_tpu_torch.workloads import als as tals
from sparkucx_tpu_torch.workloads import terasort as tts
from sparkucx_tpu_torch.workloads.graphs import random_digraph
from sparkucx_tpu_torch.workloads.pagerank import power_iteration
from torch_workload_cases import WORKLOAD_CASES, check_same_result, runner


@pytest.fixture(scope="module")
def port_manager():
    svc = connect(device="cpu", num_shards=8, use_env=False)
    yield svc.manager
    svc.stop()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", WORKLOAD_CASES, ids=lambda c: c[0])
def test_runner_matches_jax(dense_manager, port_manager, case, seed):
    _, module, fn, kw = case
    want = runner("sparkucx_tpu", module, fn)(dense_manager, seed=seed, **kw)
    got = runner("sparkucx_tpu_torch", module, fn)(port_manager, seed=seed,
                                                   **kw)
    check_same_result(fn, got, want)


def test_q23_degenerate_guard_raises_in_both(dense_manager, port_manager):
    from sparkucx_tpu.workloads.q23 import run_q23 as jq23
    from sparkucx_tpu_torch.workloads.q23 import run_q23 as tq23
    for run, mgr in ((jq23, dense_manager), (tq23, port_manager)):
        with pytest.raises(AssertionError, match="degenerate frequent set"):
            run(mgr, shuffle_id=9310, frequency_threshold=10_000_000)


@pytest.mark.parametrize("stride", [1, 3, 16])
def test_sampled_key_digest_matches_jax(stride):
    rng = np.random.default_rng(stride)
    keys = rng.integers(-(1 << 62), 1 << 62, 5000, dtype=np.int64)
    keys[:7] = [0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                1 << 32, -(1 << 40)]
    got = twl.sampled_key_digest(keys, stride)
    assert got == jwl.sampled_key_digest(keys, stride)
    # order-free: a permutation digests the same
    assert twl.sampled_key_digest(rng.permutation(keys), stride) == got


@pytest.mark.parametrize("seed,start,n", [(0, 0, 1000), (7, 123456, 3),
                                          (2**31, 2**40, 257), (1, 5, 0)])
def test_keystream_matches_jax(seed, start, n):
    got = tts.keystream(seed, start, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jts.keystream(seed, start, n))


def test_phase_walls_and_report_match_jax():
    walls = []
    for cls, metrics in ((twl.PhaseWalls, Metrics()),
                         (jwl.PhaseWalls, JaxMetrics())):
        w = cls("join", metrics)
        w.add("exchange", 12.5)
        w.add("emit", 0.25)
        with pytest.raises(ValueError, match="unknown phase"):
            w.phase("shuffle")
        w.publish(1000)
        walls.append((w.ms, {k: v for k, v in metrics.snapshot().items()
                             if k.startswith("workload.")}))
    assert walls[0] == walls[1]
    assert walls[0][1]['workload.phase.ms{phase="exchange",workload="join"}'] \
        == 12.5
    reps = []
    for cls in (twl.WorkloadReport, jwl.WorkloadReport):
        r = cls("join", rows_in=800, bytes_in=6400, budget_bytes=1024,
                phases={"ingest": 4.0, "exchange": 2.0, "emit": 0.0})
        r.finalize(800)
        reps.append(r.to_dict())
    assert reps[0] == reps[1]
    assert twl.PHASES == jwl.PHASES


@pytest.mark.parametrize("seed", [0, 1])
def test_pagerank_oracle_matches_dense_loop(seed):
    V, iters = 48, 8
    edges = random_digraph(np.random.default_rng(seed), V, 300)
    src, dst = edges[:, 0], edges[:, 1]
    outdeg = np.bincount(src, minlength=V).astype(np.float64)
    # the JAX runner's oracle: the dense float64 link matrix
    A = np.zeros((V, V), dtype=np.float64)
    A[dst, src] = 1.0 / outdeg[src]
    want = np.full(V, 1.0, dtype=np.float64)
    for _ in range(iters):
        want = 0.15 + 0.85 * (A @ want)
    np.testing.assert_allclose(power_iteration(src, dst, V, iters), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_als_batched_solve_matches_jax_loop(seed):
    rng = np.random.default_rng(seed)
    rank, others_n = 8, 48
    factors = rng.normal(size=(others_n, rank))
    parts = []
    for n in (0, 1, 37, 120):
        k = rng.integers(0, 20, n).astype(np.int64)
        v = np.stack([rng.normal(size=n),
                      rng.integers(0, others_n, n)], axis=1).astype(np.float32)
        parts.append((k, v))
    got = tals._solve_side(parts, factors, rank, 0.1)
    want = jals._solve_side(parts, factors, rank, 0.1)
    assert got.keys() == want.keys() and len(got) > 0
    for ent in want:
        np.testing.assert_allclose(got[ent], want[ent], rtol=0, atol=1e-12)
