"""Port parity for the external-memory pipelines: the JAX package's
``terasort_pipeline``, ``groupby_pipeline`` and ``join_pipeline`` on its
``dense`` manager over 8 virtual CPU devices against the port's on
``connect(device="cpu")`` with 8 logical shards, at the sizes of the JAX
package's own pipeline tests, with the same seed and conf.

Exact: ``rows_in``, ``rows_out``, ``oracle`` and ``oracle_ok``, the
rounds, the digest rows checked and the oracle legs, the groupby
aggregates (``truth_distinct``, ``value_sum``; int32 lanes summed
exactly), the join's output and expected rows, the merged stream of
``merge_sorted_runs``, chunk for chunk, and the registry. Spill must be
positive on both sides; its byte count may differ, because the budget
valve reads pool bytes the two pools round differently (the JAX pool to
power-of-two classes)."""

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


@pytest.fixture(scope="module")
def port_svc():
    svc = connect({"spark.shuffle.tpu.a2a.impl": "dense"}, device="cpu",
                  num_shards=8, use_env=False)
    yield svc
    svc.stop()


def _conf(tmp_path, side, extra):
    """The JAX pipeline tests' conf (``test_workloads._wl_manager``)."""
    cm = {"spark.shuffle.tpu.a2a.impl": "dense",
          "spark.shuffle.tpu.spill.threshold": "8192",
          "spark.shuffle.tpu.a2a.waveRows": "1024",
          "spark.shuffle.tpu.a2a.waveDepth": "2",
          "spark.shuffle.tpu.spill.dir": str(tmp_path / side)}
    cm.update(extra or {})
    return cm


def _run_both(dense_manager, port_svc, tmp_path, module, fn, kw,
              extra=None):
    """(JAX report, port report) of one pipeline call, each on a fresh
    manager over its package's shared node."""
    import importlib

    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.shuffle.manager import TpuShuffleManager
    reps = []
    for pkg, mk in (
            ("sparkucx_tpu", lambda c: TpuShuffleManager(
                dense_manager.node, TpuShuffleConf(c, use_env=False))),
            ("sparkucx_tpu_torch", lambda c: ShuffleManager(
                port_svc.node, ShuffleConf(c, use_env=False)))):
        m = mk(_conf(tmp_path, pkg, extra))
        try:
            run = getattr(importlib.import_module(
                f"{pkg}.workloads.{module}"), fn)
            reps.append(run(m, **kw))
        finally:
            m.stop()
    assert port_svc.node.pool.stats()["in_use_bytes"] == 0
    return reps


def _same(want, got, extra_keys=()):
    for k in ("workload", "rows_in", "rows_out", "bytes_in",
              "budget_bytes", "oracle", "oracle_ok", "exchanges",
              "scale_ratio"):
        assert getattr(got, k) == getattr(want, k), k
    for k in extra_keys:
        assert got.extra[k] == want.extra[k], k
    assert want.spill_bytes > 0 and got.spill_bytes > 0
    assert got.spill_count > 0
    assert set(got.phases) == set(want.phases) == {
        "ingest", "spill", "exchange", "merge", "emit"}
    assert got.rows_per_s["total"] > 0
    assert got.programs == got.warm_programs == 0
    assert got.backend == "cpu"


def test_merge_sorted_runs_matches_jax():
    """Duplicates, empty runs, uneven lengths: the same chunks, equal
    to one big sort, with a bounded window."""
    from sparkucx_tpu.workloads.terasort import merge_sorted_runs as jmerge
    from sparkucx_tpu_torch.workloads.terasort import merge_sorted_runs
    rng = np.random.default_rng(3)
    runs = [np.sort(rng.integers(0, 500, size=n).astype(np.int64))
            for n in (0, 1, 700, 1300, 64, 2500)]
    got = list(merge_sorted_runs(runs, chunk_rows=128))
    want = list(jmerge(runs, chunk_rows=128))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.sort(np.concatenate(runs)))
    assert max(c.shape[0] for c in got) <= len(runs) * 128 + 500


def test_run_store_sealed_roundtrip(tmp_path):
    """Runs appended per round come back as mapped views split at the
    recorded run lengths; empty runs are dropped; close deletes."""
    from sparkucx_tpu_torch.workloads.terasort import RunStore
    store = RunStore(str(tmp_path), num_partitions=3, store_id=7)
    a = np.arange(10, dtype=np.int64) * 3
    b = np.arange(5, dtype=np.int64) * 7
    assert store.append_run(0, a) == 80
    store.append_run(0, b)
    store.append_run(2, b)
    assert store.append_run(1, np.zeros(0, np.int64)) == 0
    store.seal()
    runs0 = store.runs(0)
    assert len(runs0) == 2
    np.testing.assert_array_equal(runs0[0], a)
    np.testing.assert_array_equal(runs0[1], b)
    assert store.runs(1) == []
    assert store.rows(2) == 5
    store.close()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("oracle", ["exact", "digest"])
def test_terasort_pipeline_matches_jax(dense_manager, port_svc, tmp_path,
                                       oracle):
    """Several rounds through the sealed-run store, spill by threshold
    and valve, waved ordered reads and the k-way merge, held by the
    exact oracle (below the threshold) or by monotonicity, boundaries
    and the sampled digest (threshold forced to 0)."""
    if oracle == "exact":
        kw = dict(budget_bytes=64 << 10, total_rows=16384,
                  num_partitions=8, chunk_rows=2048, shuffle_id=9500)
        extra = {"spark.shuffle.tpu.a2a.waveRows": "256"}
    else:
        kw = dict(budget_bytes=64 << 10, total_rows=8192, num_partitions=8,
                  chunk_rows=2048, exact_threshold=0, shuffle_id=9501)
        extra = None
    want, got = _run_both(dense_manager, port_svc, tmp_path, "terasort",
                          "terasort_pipeline", kw, extra)
    _same(want, got, ("rounds", "round_rows", "digest_rows_checked",
                      "boundary_ok", "monotonic_ok", "digest_ok"))
    assert got.oracle == oracle and got.oracle_ok
    assert got.extra["rounds"] >= 2
    assert got.waves == want.waves
    if oracle == "exact":
        assert got.waves >= 2


def test_groupby_pipeline_host_arm_matches_jax(dense_manager, port_svc,
                                               tmp_path):
    """Spilled ingest, the combine exchange, each key's int32 sums
    exactly against the O(key_space) oracle."""
    kw = dict(budget_bytes=64 << 10, total_rows=6144, key_space=200,
              num_partitions=8, chunk_rows=1024, sink="host", warm_reads=0,
              shuffle_id=9510)
    want, got = _run_both(dense_manager, port_svc, tmp_path, "groupby",
                          "groupby_pipeline", kw)
    _same(want, got, ("distinct_keys", "truth_distinct", "value_sum",
                      "truth_sum"))
    assert got.oracle_ok and got.rows_out == 200


def test_groupby_pipeline_device_arm_zero_d2h(dense_manager, port_svc,
                                              tmp_path):
    """The waved combine read folds on the device and is consumed there:
    exact int sums, a warm second read, and the same ``d2h_bytes`` as
    the JAX package's. On the CPU the port's ``d2h_bytes`` is 0 by
    construction (nothing crosses from a device); that no payload byte
    crosses D2H is measured on the card, in
    ``test_groupby_pipeline_device_arm_on_card``."""
    kw = dict(budget_bytes=64 << 10, total_rows=4800, key_space=150,
              num_partitions=8, chunk_rows=1024, sink="device",
              warm_reads=1, shuffle_id=9512)
    want, got = _run_both(dense_manager, port_svc, tmp_path, "groupby",
                          "groupby_pipeline", kw,
                          {"spark.shuffle.tpu.a2a.waveRows": "512"})
    _same(want, got, ("distinct_keys", "truth_distinct", "value_sum",
                      "truth_sum", "d2h_bytes"))
    assert got.oracle_ok and got.extra["d2h_bytes"] == 0
    assert got.waves == want.waves >= 2 and got.exchanges == 2
    assert got.phases["merge"] > 0


def test_join_pipeline_matches_jax(dense_manager, port_svc, tmp_path):
    """Both skewed sides spilled, read, joined per partition: the output
    row count equals the exact oracle's, in both packages."""
    kw = dict(budget_bytes=64 << 10, total_rows=8192, key_space=400,
              num_partitions=8, chunk_rows=1024, shuffle_id=9520)
    want, got = _run_both(dense_manager, port_svc, tmp_path, "join",
                          "join_pipeline", kw)
    _same(want, got, ("output_rows", "expected_rows", "side_rows",
                      "max_partition_rows", "skew_ratio"))
    assert got.oracle_ok and got.rows_out == got.extra["expected_rows"] > 0


def test_groupby_device_runner_matches_jax(dense_manager, port_svc):
    """The single-shot device-combiner runner: the same distinct keys and
    staged rows, zero D2H, float32 value sums within 1e-4 relative of
    each other (per-shard sums in another order)."""
    from sparkucx_tpu.workloads.groupby import run_groupby_device as jrun
    from sparkucx_tpu_torch.workloads.groupby import run_groupby_device
    kw = dict(num_mappers=8, pairs_per_mapper=500, key_space=100,
              num_partitions=16, shuffle_id=9102)
    want = jrun(dense_manager, **kw)
    got = run_groupby_device(port_svc.manager, **kw)
    for k in ("distinct_keys", "rows_staged", "d2h_bytes"):
        assert got[k] == want[k], k
    assert got["d2h_bytes"] == 0
    assert abs(got["value_sum"] - want["value_sum"]) \
        <= 1e-4 * max(1.0, abs(want["value_sum"]))


def test_workload_registry_and_run_workload(tmp_path):
    """The registry names the same pipelines as the JAX package's; an
    unknown name raises with the registry listed; ``run_workload`` builds
    its own node on the asked device and returns the report."""
    from sparkucx_tpu.workloads import WORKLOADS as JWORKLOADS
    from sparkucx_tpu_torch.workloads import (WORKLOADS, run_workload,
                                              workload_conf_overrides)
    from sparkucx_tpu.workloads import \
        workload_conf_overrides as jconf_overrides
    assert set(WORKLOADS.keys()) == set(JWORKLOADS.keys()) \
        == {"terasort", "groupby", "join"}
    assert workload_conf_overrides(16 << 20, num_mappers=4) \
        == jconf_overrides(16 << 20, num_mappers=4)
    with pytest.raises(KeyError, match="registered"):
        run_workload("bogus", device="cpu")
    rep = run_workload(
        "terasort", budget_mb=0.0625, scale=0.1, device="cpu",
        conf_overrides={"spark.shuffle.tpu.a2a.impl": "dense",
                        "spark.shuffle.tpu.spill.dir": str(tmp_path)})
    assert rep.workload == "terasort" and rep.oracle_ok
    assert rep.spill_bytes > 0 and rep.rows_in == rep.rows_out
    assert set(rep.phases) == {"ingest", "spill", "exchange", "merge",
                               "emit"}
    assert not list(tmp_path.iterdir())
