"""Port parity for the failure plane (``sparkucx_tpu_torch/runtime/
failures.py`` and its sites in the writer and the manager): the
counterparts of ``tests/test_failures.py``.

Every case runs the same seeded inputs through the JAX package and the
port and holds the port to the reference's outcome: the same
``FaultInjector`` firings and ``stats()`` for the same seed and sequence
of hits, the same ``RetryPolicy`` delay schedule for the same jitter
source (exact: both draw from ``random.Random``), and through the
managers (the JAX package's ``manager_factory`` on 8 virtual CPU devices,
``a2a.impl=dense``; the port's ``connect(device="cpu")`` on 8 logical
shards, ``a2a.impl=dense``) the same raised types, replay counts, budget
spend, injector stats and partition key multisets (exact). The probe,
the epoch plane and the failfast stale-handle fence are held in
``tests/test_torch_watchdog.py``."""

import random
import time

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.runtime import failures as jf
from sparkucx_tpu.utils import metrics as jmetrics
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime import failures as tf
from sparkucx_tpu_torch.utils import metrics as tmetrics

BOTH = [pytest.param(jf, id="jax"), pytest.param(tf, id="port")]


@pytest.fixture()
def port_factory():
    """``make(overrides)`` -> a port manager on the CPU (dense, 8 shards),
    torn down after the test."""
    made = []

    def make(overrides=None):
        svc = connect({"spark.shuffle.tpu.a2a.impl": "dense",
                       **(overrides or {})}, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


@pytest.fixture()
def managers(manager_factory, port_factory):
    """``make(overrides)`` -> (the JAX manager, the port manager) under
    the same conf."""
    return lambda overrides=None: (manager_factory(overrides),
                                   port_factory(overrides))


def _write_all(mgr, h, seed: int, rows: int = 32):
    rng = np.random.default_rng(seed)
    keys = []
    for m in range(h.num_maps):
        k = rng.integers(0, 1 << 20, size=rows)
        w = mgr.get_writer(h, m)
        w.write(k)
        w.commit(h.num_partitions)
        keys.append(k)
    return np.sort(np.concatenate(keys))


def _keys(res) -> np.ndarray:
    return np.sort(np.concatenate([k for _, (k, _) in res.partitions()]))


def _hist_count(metrics, name: str) -> int:
    h = metrics.histogram(name)
    return 0 if h is None else int(h.count)


# -- FaultInjector ------------------------------------------------------------
@pytest.mark.parametrize("mod", BOTH)
def test_injector_inactive_is_noop(mod):
    fi = mod.FaultInjector()
    for _ in range(100):
        fi.check("anything")
    assert fi.stats() == {} and not fi.active


def test_injector_fail_count_matches():
    out = []
    for mod in (jf, tf):
        fi = mod.FaultInjector()
        fi.arm("publish", fail_count=2)
        seq = []
        for _ in range(3):
            try:
                fi.check("publish")
                seq.append(0)
            except mod.InjectedFault:
                seq.append(1)
        out.append((seq, fi.stats()))
    assert out[0] == out[1] == ([1, 1, 0], {"publish": (3, 2)})


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_injector_fail_rate_same_firings_for_a_seed(seed):
    """The same seed and the same sequence of hits over several sites
    (unarmed sites draw too while anything is armed) fire alike."""
    sites = ["x", "y", "x", "z"] * 20

    def pattern(mod):
        fi = mod.FaultInjector(seed=seed)
        fi.arm("x", fail_rate=0.5)
        fi.arm("y", fail_rate=0.25)
        out = []
        for s in sites:
            try:
                fi.check(s)
                out.append(0)
            except mod.InjectedFault:
                out.append(1)
        return out, fi.stats()

    pj, pt = pattern(jf), pattern(tf)
    assert pj == pt
    assert 0 < sum(pj[0]) < len(sites)


def test_injector_from_conf_matches():
    keys = {"spark.shuffle.tpu.fault.publish.failCount": "1",
            "spark.shuffle.tpu.fault.fetch.failRate": "0.0",
            "spark.shuffle.tpu.fault.wave.failRate": "0.3",
            "spark.shuffle.tpu.fault.seed": "7"}
    got = []
    for mod, conf in ((jf, TpuShuffleConf(keys, use_env=False)),
                      (tf, ShuffleConf(keys, use_env=False))):
        fi = mod.FaultInjector(conf)
        assert fi.active
        seq = []
        for site in ["publish", "publish", "fetch"] + ["wave"] * 30:
            try:
                fi.check(site)
                seq.append(0)
            except mod.InjectedFault:
                seq.append(1)
        got.append((seq, fi.stats()))
    assert got[0] == got[1]
    assert got[1][0][:3] == [1, 0, 0]      # rate 0 never fires


@pytest.mark.parametrize("mod,conf_cls", [(jf, TpuShuffleConf),
                                          (tf, ShuffleConf)])
def test_injector_env_cased_knobs(mod, conf_cls):
    """Env-derived keys arrive lowercased; the knob match still hits."""
    conf = conf_cls({"spark.shuffle.tpu.fault.publish.failcount": "1",
                     "spark.shuffle.tpu.fault.publish.delayms": "1"},
                    use_env=False)
    fi = mod.FaultInjector(conf)
    assert fi.active
    with pytest.raises(mod.InjectedFault):
        fi.check("publish")


@pytest.mark.parametrize("mod", BOTH)
def test_injector_disarm(mod):
    fi = mod.FaultInjector()
    fi.arm("s", fail_count=5)
    fi.disarm("s")
    fi.check("s")
    assert not fi.active


# -- RetryPolicy ----------------------------------------------------------------
@pytest.mark.parametrize("mod", BOTH)
def test_retry_rejects_bad_settings(mod):
    with pytest.raises(ValueError, match="max_attempts"):
        mod.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="max_backoff_ms"):
        mod.RetryPolicy(backoff_ms=100.0, max_backoff_ms=10.0)


@pytest.mark.parametrize("mod", BOTH)
def test_retry_succeeds_after_transient(mod):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise mod.TransientError("boom")
        return "ok"

    assert mod.RetryPolicy(max_attempts=3, backoff_ms=1).run(flaky) == "ok"
    assert len(calls) == 3


@pytest.mark.parametrize("mod", BOTH)
def test_retry_exhausts_and_does_not_catch_fatal(mod):
    def always():
        raise mod.TransientError("nope")

    def fatal():
        raise ValueError("fatal")

    with pytest.raises(mod.TransientError):
        mod.RetryPolicy(max_attempts=2, backoff_ms=1).run(always)
    with pytest.raises(ValueError):
        mod.RetryPolicy(max_attempts=3, backoff_ms=1).run(fatal)


def test_backoff_schedule_without_jitter_matches():
    def schedule(mod):
        p = mod.RetryPolicy(backoff_ms=10.0, backoff_factor=2.0,
                            jitter=False, max_backoff_ms=65.0)
        out, prev = [], None
        for _ in range(5):
            prev = p.next_delay_ms(prev)
            out.append(prev)
        return out

    assert schedule(jf) == schedule(tf) == [10.0, 20.0, 40.0, 65.0, 65.0]


@pytest.mark.parametrize("seed", [1, 7, 3])
def test_jittered_schedule_matches_for_one_entropy(seed):
    """Fed ``random.Random(seed)``, both policies draw the same
    decorrelated-jitter schedule, inside its bounds and under the cap."""
    def schedule(mod):
        p = mod.RetryPolicy(backoff_ms=10.0, backoff_factor=2.0,
                            max_backoff_ms=50.0, rng=random.Random(seed))
        out, prev = [], None
        for _ in range(20):
            prev = p.next_delay_ms(prev)
            out.append(prev)
        return out

    sj, st = schedule(jf), schedule(tf)
    assert sj == st
    assert 10.0 <= st[0] <= 20.0
    for a, b in zip(st, st[1:]):
        assert 10.0 <= b <= min(a * 3.0, 50.0)


def test_jitter_decorrelates_processes():
    def schedule(seed):
        p = tf.RetryPolicy(backoff_ms=10.0, rng=random.Random(seed))
        out, prev = [], None
        for _ in range(6):
            prev = p.next_delay_ms(prev)
            out.append(prev)
        return out

    assert schedule(1) != schedule(2)
    assert schedule(3) == schedule(3)


@pytest.mark.parametrize("mod", BOTH)
def test_total_deadline_stops_retries_early(mod):
    calls = []

    def always():
        calls.append(1)
        raise mod.TransientError("persistent")

    p = mod.RetryPolicy(max_attempts=50, backoff_ms=200.0, jitter=False,
                        total_deadline_ms=50.0)
    t0 = time.perf_counter()
    with pytest.raises(mod.TransientError, match="persistent"):
        p.run(always)
    assert len(calls) == 1
    assert (time.perf_counter() - t0) * 1e3 < 5_000.0


@pytest.mark.parametrize("mod", BOTH)
def test_total_deadline_none_keeps_attempt_bound(mod):
    calls = []

    def always():
        calls.append(1)
        raise mod.TransientError("x")

    with pytest.raises(mod.TransientError):
        mod.RetryPolicy(max_attempts=3, backoff_ms=1.0,
                        total_deadline_ms=None).run(always)
    assert len(calls) == 3


@pytest.mark.parametrize("keys", [
    {"spark.shuffle.tpu.failure.maxAttempts": "5"},
    {"spark.shuffle.tpu.failure.backoffMs": "20",
     "spark.shuffle.tpu.failure.maxBackoffMs": "5",
     "spark.shuffle.tpu.failure.collectiveTimeoutMs": "1500"},
    {}])
def test_retry_from_conf_matches(keys):
    pj = jf.RetryPolicy.from_conf(TpuShuffleConf(keys, use_env=False))
    pt = tf.RetryPolicy.from_conf(ShuffleConf(keys, use_env=False))
    fields = ("max_attempts", "backoff_ms", "backoff_factor", "jitter",
              "max_backoff_ms", "total_deadline_ms")
    assert [getattr(pt, f) for f in fields] == \
        [getattr(pj, f) for f in fields]


# -- through the managers -----------------------------------------------------
def test_manager_exchange_fault_site(managers):
    for mgr in managers({"spark.shuffle.tpu.fault.exchange.failCount": "1"}):
        h = mgr.register_shuffle(913, num_maps=1, num_partitions=4)
        want = _write_all(mgr, h, 0, rows=8)
        with pytest.raises(Exception) as e:
            mgr.read(h)
        assert type(e.value).__name__ == "InjectedFault"
        assert _keys(mgr.read(h)).tolist() == want.tolist()
        assert mgr.node.faults.stats()["exchange"] == (2, 1)
        mgr.unregister_shuffle(913)


def test_manager_fetch_fault_retried(managers):
    """A transient fetch fault is absorbed by the node's retry policy,
    and each failed attempt lands in its latency histogram."""
    out = []
    for mgr, hname in zip(managers({
            "spark.shuffle.tpu.fault.fetch.failCount": "2",
            "spark.shuffle.tpu.failure.backoffMs": "1"}),
            (jmetrics.H_RETRY_MS, tmetrics.H_RETRY_MS)):
        h = mgr.register_shuffle(910, num_maps=2, num_partitions=4)
        want = _write_all(mgr, h, 1)
        assert _keys(mgr.read(h)).tolist() == want.tolist()
        out.append((mgr.node.faults.stats()["fetch"],
                    mgr.report(910).replays,
                    _hist_count(mgr.node.metrics, hname)))
        mgr.unregister_shuffle(910)
    assert out[0] == out[1] == ((3, 2), 0, 2)


def test_manager_publish_fault_surfaces(managers):
    """A publish fault surfaces at commit; a fresh writer of the same map
    redoes it."""
    for mgr in managers({"spark.shuffle.tpu.fault.publish.failCount": "1"}):
        rng = np.random.default_rng(2)
        h = mgr.register_shuffle(911, num_maps=1, num_partitions=4)
        w = mgr.get_writer(h, 0)
        w.write(rng.integers(0, 1 << 20, size=16))
        with pytest.raises(Exception) as e:
            w.commit(h.num_partitions)
        assert type(e.value).__name__ == "InjectedFault"
        w2 = mgr.get_writer(h, 0)
        k = rng.integers(0, 1 << 20, size=16)
        w2.write(k)
        w2.commit(h.num_partitions)
        assert _keys(mgr.read(h)).tolist() == np.sort(k).tolist()
        mgr.unregister_shuffle(911)


def test_spill_fault_surfaces(managers, tmp_path):
    """The ``spill`` site fires before a writer's move to disk."""
    for i, mgr in enumerate(managers({
            "spark.shuffle.tpu.spill.threshold": "1k",
            "spark.shuffle.tpu.spill.dir": str(tmp_path),
            "spark.shuffle.tpu.fault.spill.failCount": "1"})):
        h = mgr.register_shuffle(920 + i, num_maps=1, num_partitions=4)
        w = mgr.get_writer(h, 0)
        with pytest.raises(Exception) as e:
            w.write(np.arange(512, dtype=np.int64))
        assert type(e.value).__name__ == "InjectedFault"
        assert mgr.node.faults.stats()["spill"] == (1, 1)
        mgr.unregister_shuffle(920 + i)


def test_replay_absorbs_exchange_fault(managers):
    """Under replay a transient exchange fault re-runs the exchange: the
    same keys, replays and injector stats, and the replay counter."""
    out = []
    for mgr, creplays in zip(managers({
            "spark.shuffle.tpu.failure.policy": "replay",
            "spark.shuffle.tpu.fault.exchange.failCount": "1"}),
            (jmetrics.C_REPLAYS, tmetrics.C_REPLAYS)):
        h = mgr.register_shuffle(914, num_maps=2, num_partitions=4)
        want = _write_all(mgr, h, 3)
        got = _keys(mgr.read(h))
        rep = mgr.report(914)
        assert got.tolist() == want.tolist()
        assert rep.replay_ms > 0.0
        out.append((got.tolist(), rep.replays, mgr.node.metrics.get(creplays),
                    mgr.node.faults.stats()["exchange"],
                    mgr._replay_counts.get(914)))
        mgr.unregister_shuffle(914)
    assert out[0] == out[1]
    assert out[1][1:] == (1, 1.0, (2, 1), 1)


def test_replay_budget_exhaustion_falls_back_to_failfast(managers):
    out = []
    for mgr in managers({"spark.shuffle.tpu.failure.policy": "replay",
                         "spark.shuffle.tpu.failure.replayBudget": "1",
                         "spark.shuffle.tpu.fault.exchange.failCount": "5"}):
        h = mgr.register_shuffle(915, num_maps=1, num_partitions=4)
        _write_all(mgr, h, 4)
        with pytest.raises(Exception) as e:
            mgr.read(h)
        first = (type(e.value).__name__, mgr.node.faults.stats()["exchange"])
        mgr.node.faults.arm("exchange", fail_count=1)
        with pytest.raises(Exception) as e2:
            mgr.read(h)
        out.append((first, type(e2.value).__name__,
                    mgr._replay_counts.get(915)))
        mgr.unregister_shuffle(915)
    assert out[0] == out[1] == (("InjectedFault", (2, 2)), "InjectedFault", 1)


def test_peer_lost_replay_spends_single_unit(managers):
    """One PeerLostError on one process: a remesh, the handle re-pinned
    through the ledger, ONE budget unit end to end."""
    out = []
    for mgr, err in zip(managers({
            "spark.shuffle.tpu.failure.policy": "replay",
            "spark.shuffle.tpu.failure.replayBudget": "1"}),
            (jf.PeerLostError, tf.PeerLostError)):
        h = mgr.register_shuffle(917, num_maps=2, num_partitions=4)
        want = _write_all(mgr, h, 5)
        orig = mgr._submit_local
        state = {"fired": False}

        def lose_peer_once(*a, _orig=orig, _err=err, **kw):
            if not state["fired"]:
                state["fired"] = True
                raise _err("synthetic peer loss")
            return _orig(*a, **kw)

        mgr._submit_local = lose_peer_once
        got = _keys(mgr.read(h))
        assert got.tolist() == want.tolist()
        out.append((mgr.report(917).replays, mgr._replay_counts.get(917),
                    h.epoch == mgr.node.epochs.current))
        mgr._submit_local = orig
        mgr.unregister_shuffle(917)
    assert out[0] == out[1] == (1, 1, True)


def test_failfast_stale_read_leaves_metrics_window_closed(managers):
    """A failfast stale read never started: no read.count and no sample
    in the read's wait histogram."""
    for mgr, hname in zip(managers(), (jmetrics.H_FETCH_WAIT,
                                       tmetrics.H_FETCH_WAIT)):
        h = mgr.register_shuffle(918, num_maps=1, num_partitions=4)
        _write_all(mgr, h, 6)
        mgr.node.epochs.bump("simulated device loss")
        m = mgr.node.metrics
        before = (m.get("shuffle.read.count"), _hist_count(m, hname))
        with pytest.raises(Exception) as e:
            mgr.read(h)
        assert type(e.value).__name__ == "StaleEpochError"
        assert (m.get("shuffle.read.count"), _hist_count(m, hname)) == before
        mgr.unregister_shuffle(918)


def test_read_wait_histogram_counts_every_read(managers):
    for mgr, hname in zip(managers(), (jmetrics.H_FETCH_WAIT,
                                       tmetrics.H_FETCH_WAIT)):
        h = mgr.register_shuffle(919, num_maps=1, num_partitions=4)
        _write_all(mgr, h, 7)
        mgr.read(h)
        mgr.read(h)
        # the JAX package puts a compiling read in its first-wait
        # histogram; the port compiles nothing
        total = _hist_count(mgr.node.metrics, hname) + _hist_count(
            mgr.node.metrics, "shuffle.read.first_wait_ms")
        assert total == 2
        mgr.unregister_shuffle(919)


def test_failfast_policy_reports_zero_replays(managers):
    for mgr in managers({"spark.shuffle.tpu.fault.exchange.failCount": "1"}):
        h = mgr.register_shuffle(916, num_maps=1, num_partitions=4)
        want = _write_all(mgr, h, 8)
        with pytest.raises(Exception) as e:
            mgr.read(h)
        assert type(e.value).__name__ == "InjectedFault"
        assert _keys(mgr.read(h)).tolist() == want.tolist()
        assert mgr.report(916).replays == 0
        mgr.unregister_shuffle(916)


@pytest.mark.parametrize("site", ["wave", "exchange"])
def test_replay_under_waves_restarts_whole_exchange(managers, site):
    """A fault before a wave (or before the waved dispatch) settles the
    waves in flight and the replay re-runs the WHOLE waved exchange."""
    out = []
    for mgr in managers({"spark.shuffle.tpu.failure.policy": "replay",
                         "spark.shuffle.tpu.a2a.waveRows": "16",
                         "spark.shuffle.tpu.a2a.waveDepth": "2",
                         f"spark.shuffle.tpu.fault.{site}.failCount": "1"}):
        h = mgr.register_shuffle(917, num_maps=2, num_partitions=4)
        want = _write_all(mgr, h, 9, rows=64)
        got = _keys(mgr.read(h))
        rep = mgr.report(917)
        assert got.tolist() == want.tolist()
        out.append((rep.replays, rep.waves, mgr.node.faults.stats()[site]))
        mgr.unregister_shuffle(917)
    assert out[0] == out[1]
    assert out[1][0] == 1 and out[1][1] >= 2


def test_failed_attempt_gives_back_the_pack_buffer(port_factory):
    """The exchange fault comes after the pack: the pinned pack buffer
    and the admission reservation go back, so the replay neither waits
    for its own bytes nor shares a buffer."""
    mgr = port_factory({"spark.shuffle.tpu.failure.policy": "replay",
                        "spark.shuffle.tpu.a2a.maxBytesInFlight": "1k",
                        "spark.shuffle.tpu.fault.exchange.failCount": "1"})
    h = mgr.register_shuffle(930, num_maps=2, num_partitions=4)
    want = _write_all(mgr, h, 10)
    staged = mgr.node.pool.stats()["in_use_bytes"]
    res = mgr.read(h, timeout=5.0)
    assert _keys(res).tolist() == want.tolist()
    assert mgr.report(930).replays == 1
    assert mgr.node.pool.stats()["in_use_bytes"] == staged
    assert mgr._inflight_bytes == 0 and not mgr._admit_queue
    mgr.unregister_shuffle(930)
    assert mgr.node.pool.stats()["in_use_bytes"] == 0


def test_nothing_armed_checks_do_no_work(port_factory):
    """With nothing armed no site counts a hit: a fault-free read runs
    exactly as before."""
    mgr = port_factory()
    h = mgr.register_shuffle(931, num_maps=2, num_partitions=4)
    _write_all(mgr, h, 11)
    mgr.read(h)
    assert mgr.node.faults.stats() == {} and not mgr.node.faults.active
    mgr.unregister_shuffle(931)


def test_failure_conf_keys_match_the_reference():
    keys = {"spark.shuffle.tpu.failure.policy": "replay",
            "spark.shuffle.tpu.failure.replayBudget": "5",
            "spark.shuffle.tpu.failure.collectiveTimeoutMs": "900"}
    c, j = ShuffleConf(keys, use_env=False), TpuShuffleConf(keys,
                                                            use_env=False)
    for name in ("failure_policy", "replay_budget",
                 "replay_agree_timeout_ms"):
        assert getattr(c, name) == getattr(j, name), name
    d, jd = ShuffleConf({}, use_env=False), TpuShuffleConf({},
                                                           use_env=False)
    assert (d.failure_policy, d.replay_budget, d.replay_agree_timeout_ms) \
        == (jd.failure_policy, jd.replay_budget, jd.replay_agree_timeout_ms)
    for key, value, prop, text in (
            ("failure.policy", "retry", "failure_policy",
             "failure.policy='retry': want failfast|replay"),
            ("failure.replayBudget", "-1", "replay_budget",
             "replayBudget=-1: want >= 0"),
            ("failure.replayAgreeTimeoutMs", "-2", "replay_agree_timeout_ms",
             "replayAgreeTimeoutMs=-2.0: want >= 0")):
        bad = {f"spark.shuffle.tpu.{key}": value}
        with pytest.raises(ValueError, match=text):
            ShuffleConf(bad, use_env=False)
        with pytest.raises(ValueError, match=text):
            getattr(TpuShuffleConf(bad, use_env=False), prop)
