"""Port parity for the multi-tenant service plane
(``sparkucx_tpu_torch/shuffle/tenancy.py``, the turnstile of
``shuffle/agreement.py`` and the tenancy sites of the manager and the
service): the counterparts of ``tests/test_tenancy.py`` (all but
``test_v2_async_futures``, the doctor and the Prometheus exposition),
the report fields of the ported planes, and randomized scripts.

A queue case runs the same enqueue / grant / discard script on both
packages' ``FairShareQueue`` (or ``FifoAdmitQueue``) and compares the
grant sequences ticket for ticket; ``agreed_submission_order`` is
compared on random batches. A manager case runs one call sequence on
the JAX package's ``manager_factory`` (8 virtual CPU devices,
``a2a.impl=dense``) and on the port's ``connect(device="cpu")`` (8
logical shards) and compares what it observed: specs, raised texts,
reservations, labeled counters, reports, delivered keys (exact). An
executor case runs each package's ``AsyncShuffleExecutor`` through the
same script; where the script sleeps, it sleeps a fraction of a
second. Threaded reads on the JAX side run under the reference's pinned
``a2a.maxBytesInFlight=1`` (its XLA:CPU wedges on concurrently
dispatched collective programs)."""

import threading
import time

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.shuffle import agreement as jagreement
from sparkucx_tpu.shuffle import tenancy as jtenancy
from sparkucx_tpu.utils import metrics as jmetrics
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.shuffle import agreement as tagreement
from sparkucx_tpu_torch.shuffle import tenancy as ttenancy
from sparkucx_tpu_torch.utils import metrics as tmetrics

PFX = "spark.shuffle.tpu."
SIDES = ["jax", "port"]


class Pkg:
    """One package's modules and constructors."""

    def __init__(self, side):
        self.side = side
        jax = side == "jax"
        self.tenancy = jtenancy if jax else ttenancy
        self.agreement = jagreement if jax else tagreement
        self.metrics = jmetrics if jax else tmetrics

    def conf(self, extra=None):
        m = {PFX + "a2a.impl": "dense", **(extra or {})}
        if self.side == "jax":
            return TpuShuffleConf(m, use_env=False)
        return ShuffleConf(m, use_env=False)

    def registry(self, extra=None):
        return self.tenancy.TenantRegistry(self.conf(extra))

    def hist(self, metrics, name):
        """(count, max) of a histogram; (0, None) before any."""
        h = metrics.histogram(name)
        return (0, None) if h is None else (h.count, h.max)


@pytest.fixture()
def port_factory():
    made = []

    def make(overrides=None):
        while made:
            made.pop().stop()
        svc = connect({PFX + "a2a.impl": "dense", **(overrides or {})},
                      device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


@pytest.fixture()
def managers(manager_factory, port_factory):
    """``managers(overrides)`` -> [(Pkg, JAX manager), (Pkg, port
    manager)]; use the JAX one first (a second factory call stops it)."""
    return lambda overrides=None: [(Pkg("jax"), manager_factory(overrides)),
                                   (Pkg("port"), port_factory(overrides))]


def _raised(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


# -- the registry --------------------------------------------------------------
def test_priority_validation():
    for arg in ("HIGH ", "batch", " Normal"):
        assert ttenancy.validate_priority(arg) == \
            jtenancy.validate_priority(arg)
    got = [_raised(lambda t=t: t.validate_priority("urgent"))
           for t in (jtenancy, ttenancy)]
    assert got[0] == got[1] and "tenant.priority" in got[0][1]
    assert ttenancy.PRIORITY_WEIGHTS == jtenancy.PRIORITY_WEIGHTS
    assert (ttenancy.DRR_QUANTUM, ttenancy.DEFAULT_TENANT) == \
        (jtenancy.DRR_QUANTUM, jtenancy.DEFAULT_TENANT)


def _spec_tuple(spec):
    return (spec.tenant_id, spec.priority, spec.weight,
            spec.max_bytes_in_flight, spec.max_inflight_reads,
            spec.replay_budget, spec.integrity_verify, spec.wave_depth)


def test_registry_defaults_and_overrides():
    conf = {PFX + "tenant.id": "svc-a", PFX + "tenant.priority": "batch",
            PFX + "tenant.whale.priority": "high",
            PFX + "tenant.whale.maxBytesInFlight": "64m",
            PFX + "tenant.whale.maxInflightReads": "3",
            PFX + "tenant.whale.replayBudget": "0",
            PFX + "tenant.whale.integrity.verify": "off",
            PFX + "tenant.whale.waveDepth": "1"}
    got = []
    for side in SIDES:
        reg = Pkg(side).registry(conf)
        got.append((reg.default_id, reg.default_priority, reg.fair_share,
                    _spec_tuple(reg.spec("anon")), _spec_tuple(reg.spec("whale")),
                    _spec_tuple(reg.spec(None)), reg.resolve(None),
                    reg.resolve(" x ")))
    assert got[0] == got[1]
    assert got[1][4] == ("whale", "high", 4, 64 << 20, 3, 0, "off", 1)
    assert got[1][3] == ("anon", "batch", 1, 0, 0, None, None, None)


@pytest.mark.parametrize("key,value", [
    ("tenant.w.priority", "urgent"), ("tenant.w.replayBudget", "-1"),
    ("tenant.w.integrity.verify", "paranoid"), ("tenant.w.waveDepth", "99"),
    ("tenant.w.waveDepth", "0"), ("tenant.w.maxInflightReads", "-2")])
def test_registry_rejects_bad_values(key, value):
    got = [_raised(lambda s=side: Pkg(s).registry(
        {PFX + key: value}).spec("w")) for side in SIDES]
    assert got[0] == got[1] and got[1][0] == "ValueError"
    assert key.split(".", 2)[2] in got[1][1]


def test_conf_tenant_keys_defaults_and_errors():
    """The port's typed tenant keys: the reference's defaults, and its
    error texts for a bad default priority and a zero worker count."""
    conf = ShuffleConf(use_env=False)
    assert (conf.tenant_id, conf.tenant_priority, conf.tenant_fair_share,
            conf.tenant_async_workers, conf.tenant_async_agreed_order) == \
        ("default", "normal", True, 4, True)
    want = _raised(lambda: jtenancy.TenantRegistry(TpuShuffleConf(
        {PFX + "tenant.priority": "urgent"}, use_env=False)))
    got = _raised(lambda: ShuffleConf({PFX + "tenant.priority": "urgent"},
                                      use_env=False))
    assert got[0] == want[0] == "ValueError" and want[1] in got[1]
    want = _raised(lambda: jtenancy.AsyncShuffleExecutor(
        Pkg("jax").conf({PFX + "tenant.asyncWorkers": "0"}),
        Pkg("jax").registry(), jmetrics.Metrics(), distributed=False))
    got = _raised(lambda: ShuffleConf({PFX + "tenant.asyncWorkers": "0"},
                                      use_env=False))
    assert want[1] in got[1]


def test_register_shuffle_validates_tenant_conf(managers):
    got = []
    for p, mgr in managers({PFX + "tenant.bad.priority": "urgent"}):
        err = _raised(lambda: mgr.register_shuffle(1, 1, 8, tenant="bad"))
        h = mgr.register_shuffle(2, 1, 8, tenant="ok")
        got.append((err, h.tenant, mgr.register_shuffle(3, 1, 8).tenant,
                    mgr.live_shuffles() if p.side == "port" else None))
    assert got[0][:3] == got[1][:3]
    assert got[1][:3] == (got[0][0], "ok", "default")
    assert "priority" in got[1][0][1]
    # the failed registration left nothing behind
    assert got[1][3] == [2, 3]


# -- the fair-share queue ------------------------------------------------------
def _fits_all(tenant, nb):
    return True


def _queues(priorities, quantum=1 << 20):
    conf = {PFX + f"tenant.{t}.priority": p for t, p in priorities.items()}
    return [Pkg(s).tenancy.FairShareQueue(Pkg(s).registry(conf),
                                          quantum=quantum) for s in SIDES]


def test_drr_minnows_overtake_whale_flood():
    """The whale's flood queued first does not park the minnows: every
    minnow is granted before the last whale ticket, both stay FIFO, and
    both packages grant in the same order."""
    orders = []
    big, small = 8 << 20, 256 << 10
    for q in _queues({"whale": "batch", "minnow": "high"}):
        for t in range(4):
            q.enqueue(t, "whale", big)
        for t in range(10, 16):
            q.enqueue(t, "minnow", small)
        order = []
        while q:
            tk = q.grantable(_fits_all)
            assert tk is not None
            order.append(tk)
            q.pop(tk, big if tk < 10 else small)
        orders.append(order)
    assert orders[0] == orders[1]
    order = orders[1]
    minnow_pos = [order.index(t) for t in range(10, 16)]
    assert max(minnow_pos) < order.index(3)
    assert minnow_pos == sorted(minnow_pos)
    assert [order.index(t) for t in range(4)] == sorted(
        order.index(t) for t in range(4))
    assert sorted(order) == list(range(4)) + list(range(10, 16))


def test_drr_weights_bias_byte_share():
    """Both tenants backlogged: the granted shares track the weights
    (high 4 : batch 1), not poll frequency; the grant sequences match."""
    seqs = []
    nb = 1 << 20
    for q in _queues({"a": "high", "b": "batch"}):
        tid = [0]

        def refill(tenant, base, q=q, tid=tid):
            q.enqueue(base + tid[0], tenant, nb)
            tid[0] += 1

        for _ in range(4):
            refill("a", 0)
            refill("b", 100000)
        seq = []
        for _ in range(100):
            for _ in range(3):
                q.grantable(_fits_all)
            tk = q.grantable(_fits_all)
            tenant = "a" if tk < 100000 else "b"
            seq.append(tk)
            q.pop(tk, nb)
            refill(tenant, 0 if tenant == "a" else 100000)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    share_a = sum(1 for tk in seqs[1] if tk < 100000)
    assert 65 <= share_a <= 92


def test_drr_quota_blocked_head_bypasses():
    got = []
    for q in _queues({"a": "normal", "b": "normal"}):
        q.enqueue(1, "a", 1 << 20)
        q.enqueue(2, "b", 1 << 20)
        blocked = {"a"}

        def fits(tenant, nb, blocked=blocked):
            return tenant not in blocked

        def quota_blocked(tenant, nb, blocked=blocked):
            return tenant in blocked

        seq = [q.grantable(fits), q.grantable(fits, lambda t, nb: False),
               q.grantable(fits, quota_blocked)]
        q.pop(2, 1 << 20)
        blocked.clear()
        seq.append(q.grantable(fits, quota_blocked))
        q.pop(1, 1 << 20)
        seq.append(bool(q))
        got.append(seq)
    assert got[0] == got[1] == [None, None, 2, 1, False]


def test_drr_discard_unblocks():
    got = []
    for q in _queues({"a": "normal"}):
        q.enqueue(1, "a", 1 << 20)
        q.enqueue(2, "a", 1 << 20)
        seq = [q.grantable(_fits_all)]
        q.discard(1)
        seq.append(q.grantable(_fits_all))
        q.discard(2)
        q.discard(99)
        seq += [q.grantable(_fits_all), bool(q), len(q), q.depth()]
        got.append(seq)
    assert got[0] == got[1] == [1, 2, None, False, 0, 0]


def test_fifo_queue_strict_order():
    got = []
    for side in SIDES:
        q = Pkg(side).tenancy.FifoAdmitQueue()
        q.enqueue(1, "whale", 8 << 20)
        q.enqueue(2, "minnow", 1 << 10)
        q.enqueue(3, "whale", 1 << 10)
        seq = [q.grantable(_fits_all), 1 in q, len(q)]
        q.pop(1, 8 << 20)
        seq += [q.grantable(_fits_all), q.grantable(lambda t, nb: False)]
        q.discard(2)
        seq += [q.grantable(_fits_all), q.depth()]
        got.append(seq)
    assert got[0] == got[1] == [1, True, 3, 2, None, 3, 1]


def _drr_script(q, seed):
    """A random script of enqueues, discards and capacity-limited grants
    on one queue; returns everything it observed."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "d"]
    sizes, queued, seen = {}, [], []
    ticket = 0
    for _ in range(400):
        op = rng.random()
        if op < 0.45 or not queued:
            t = tenants[int(rng.integers(0, 4))]
            nb = int(rng.choice([4 << 10, 300 << 10, 1 << 20, 3 << 20,
                                 9 << 20]))
            q.enqueue(ticket, t, nb)
            sizes[ticket] = nb
            queued.append(ticket)
            ticket += 1
        elif op < 0.52:
            tk = queued[int(rng.integers(0, len(queued)))]
            q.discard(tk)
            queued.remove(tk)
            seen.append(("discard", tk))
        else:
            blocked = {t for t in tenants if rng.random() < 0.25}
            quota = {t for t in blocked if rng.random() < 0.5}
            tk = q.grantable(lambda t, nb: t not in blocked,
                             lambda t, nb: t in quota)
            seen.append(("grant", tk))
            if tk is not None:
                q.pop(tk, sizes[tk])
                queued.remove(tk)
        seen.append(("depth", q.depth(), len(q), bool(q)))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_drr_random_scripts_match_reference(seed):
    """Random enqueue / discard / grant scripts under random global and
    quota blocks: the port's queue grants the reference's tickets in the
    reference's order, step for step."""
    prio = {"a": "high", "b": "normal", "c": "batch", "d": "normal"}
    quantum = [1 << 20, 256 << 10][seed % 2]
    qs = _queues(prio, quantum=quantum)
    got = [_drr_script(q, seed) for q in qs]
    assert got[0] == got[1]
    assert any(s[0] == "grant" and s[1] is not None for s in got[1])


@pytest.mark.parametrize("seed", range(4))
def test_fifo_random_scripts_match_reference(seed):
    qs = [Pkg(s).tenancy.FifoAdmitQueue() for s in SIDES]
    got = [_drr_script(q, 100 + seed) for q in qs]
    assert got[0] == got[1]


# -- agreed submission order ---------------------------------------------------
def test_agreed_submission_order_deterministic_drr():
    weights = {"hi": 4, "lo": 1}
    pending = [(1, "lo"), (2, "hi"), (3, "hi"), (4, "hi"), (5, "hi"),
               (6, "hi"), (7, "lo")]
    a = ttenancy.agreed_submission_order(pending, lambda t: weights[t])
    b = ttenancy.agreed_submission_order(list(pending), lambda t: weights[t])
    assert a == b == jtenancy.agreed_submission_order(
        pending, lambda t: weights[t])
    assert sorted(a) == [1, 2, 3, 4, 5, 6, 7]
    assert a[:5] == [1, 2, 3, 4, 5]
    assert a.index(2) < a.index(3) < a.index(4)


@pytest.mark.parametrize("seed", range(8))
def test_agreed_submission_order_random_batches(seed):
    rng = np.random.default_rng(seed)
    tenants = ["t%d" % i for i in range(int(rng.integers(1, 6)))]
    weights = {t: int(rng.choice([1, 2, 4])) for t in tenants}
    n = int(rng.integers(0, 40))
    pending = [(int(s), tenants[int(rng.integers(0, len(tenants)))])
               for s in rng.permutation(1000)[:n]]
    got = ttenancy.agreed_submission_order(pending, weights.get)
    assert got == jtenancy.agreed_submission_order(pending, weights.get)
    assert sorted(got) == sorted(s for s, _ in pending)
    for t in tenants:      # FIFO within a tenant
        mine = [s for s, tt in pending if tt == t]
        assert [s for s in got if s in set(mine)] == mine


# -- per-tenant admission accounting -------------------------------------------
def test_tenant_quota_and_inflight_accounting(managers):
    got = []
    for p, mgr in managers({PFX + "a2a.maxBytesInFlight": "64m",
                            PFX + "tenant.capped.maxBytesInFlight": "1m"}):
        lab = p.metrics.labeled
        with mgr._inflight_cv:
            seq = [mgr._tenant_fits_locked("capped", 2 << 20)]
            mgr._grant_inflight_locked("capped", 2 << 20)
            seq += [mgr._tenant_fits_locked("capped", 1 << 10),
                    mgr._tenant_fits_locked("other", 1 << 20),
                    mgr._tenant_quota_blocked_locked("capped", 1 << 10),
                    mgr._tenant_quota_blocked_locked("other", 1 << 10),
                    mgr._tenant_fits_locked("other", 63 << 20)]
        m = mgr.node.metrics
        seq += [m.get(lab("shuffle.admit.bytes", tenant="capped")),
                m.get_gauge(lab("shuffle.inflight.bytes", tenant="capped"))]
        mgr._release_inflight(2 << 20, tenant="capped")
        with mgr._inflight_cv:
            seq.append(mgr._tenant_fits_locked("capped", 1 << 10))
        seq += [m.get_gauge(lab("shuffle.inflight.bytes", tenant="capped")),
                mgr._inflight_bytes, dict(mgr._inflight_by_tenant)]
        got.append(seq)
    assert got[0] == got[1] == [True, False, True, True, False, False,
                                float(2 << 20), float(2 << 20), True, 0.0,
                                0, {}]


def test_pack_share_splits_by_weight(managers):
    got = []
    for p, mgr in managers({PFX + "a2a.packThreads": "10",
                            PFX + "tenant.hi.priority": "high",
                            PFX + "tenant.lo.priority": "batch"}):
        seq = []
        for packing in ({"hi": 1}, {"hi": 1, "lo": 1},
                        {"hi": 2, "lo": 1, "x": 1}, {"lo": 0, "hi": 1}):
            with mgr._lock:
                mgr._packing = dict(packing)
            seq.append([mgr._pack_share(t) for t in ("hi", "lo", "x")])
        with mgr._lock:
            mgr._packing = {}
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][0] == [10, 10, 10] and got[1][1][:2] == [8, 2]


def test_pack_under_contention_delivers_and_clears(port_factory):
    """A pack that runs while another tenant packs keeps its share of
    fills in flight and still delivers every row; the packing counts
    clear afterwards."""
    mgr = port_factory({PFX + "a2a.packThreads": "4",
                        PFX + "tenant.lo.priority": "batch"})
    rng = np.random.default_rng(3)
    slots = [[(rng.integers(0, 1 << 40, 20000).astype(np.int64),
               rng.random((20000, 2)).astype(np.float32))]
             for _ in range(8)]
    windows = []
    real = mgr._pack_share

    def spy(t):
        windows.append(real(t))
        return windows[-1]

    mgr._pack_share = spy
    with mgr._lock:
        mgr._packing = {"hi": 1}          # another tenant mid-pack
    rows, buf = mgr._pack_shards(slots, 20000, 4, True, tenant="lo")
    with mgr._lock:
        assert mgr._packing == {"hi": 1}
        mgr._packing = {}
    assert windows == [1]                 # 4 workers * 1/3 -> 1
    got = rows.numpy()
    for p in range(8):
        k, v = slots[p][0]
        assert np.array_equal(got[p, :, :2].copy().view(np.int64)[:, 0], k)
        assert np.array_equal(got[p, :, 2:].copy().view(np.float32), v)
    mgr.node.pool.put(buf)


# -- end-to-end labeled telemetry ----------------------------------------------
def _write_small(mgr, sid, tenant, rows=256, maps=2, R=8, seed=0):
    rng = np.random.default_rng(seed)
    h = mgr.register_shuffle(sid, maps, R, tenant=tenant)
    for m in range(maps):
        w = mgr.get_writer(h, m)
        w.write(rng.integers(0, 1 << 20, rows).astype(np.int64),
                rng.random((rows, 2)).astype(np.float32))
        w.commit(R)
    return h


def _sorted_keys(res, R=8):
    return np.sort(np.concatenate([res.partition(r)[0] for r in range(R)]))


def test_read_labels_metrics_and_report(managers):
    got = []
    for p, mgr in managers({PFX + "a2a.maxBytesInFlight": "1"}):
        lab = p.metrics.labeled
        h = _write_small(mgr, 7, "alice")
        keys = _sorted_keys(mgr.read(h))
        m = mgr.node.metrics
        rep = mgr.report(7)
        got.append((keys.tolist(),
                    m.get(lab("shuffle.read.count", tenant="alice")),
                    m.get(lab("shuffle.payload.bytes", tenant="alice")),
                    m.get(lab("shuffle.wire.bytes", tenant="alice")),
                    m.get(lab("shuffle.admit.bytes", tenant="alice")) > 0,
                    p.hist(m, lab("shuffle.admit.wait_ms",
                                  tenant="alice"))[0],
                    rep.tenant, rep.completed, rep.to_dict()["tenant"],
                    m.get_gauge(lab("shuffle.inflight.bytes",
                                    tenant="alice"))))
        if p.side == "port":
            # the reference files a compiling read under read.first_ms;
            # the port compiles nothing, so every read is a wait
            assert p.hist(m, lab("shuffle.read.wait_ms",
                                 tenant="alice"))[0] == 1
    assert got[0] == got[1]
    assert got[1][1] == 1.0 and got[1][2] > 0 and got[1][3] > 0
    assert got[1][5] == 1 and got[1][6] == "alice"


def test_default_read_reports_default_tenant(managers):
    got = []
    for p, mgr in managers():
        h = _write_small(mgr, 8, None)
        mgr.read(h)
        rep = mgr.report(8)
        got.append((rep.tenant, rep.async_workers, h.tenant))
    # the port's managers come from connect(), whose async plane stamps
    # its width; the reference's factory makes a bare manager
    assert got[0] == ("default", 0, "default")
    assert got[1] == ("default", 4, "default")


def test_report_ring_tenant_aware_eviction(managers, manager_factory,
                                           port_factory):
    got = []
    for p, mgr in managers({PFX + "metrics.reportCapacity": "8"}):
        end = (lambda: mgr.node.flight.end_trace("")) \
            if p.side == "jax" else (lambda: None)
        quiet = [mgr.register_shuffle(100 + i, 1, 8, tenant="quiet")
                 for i in range(3)]
        for h in quiet:
            mgr._new_report(h, distributed=False)
            end()
        for i in range(62):
            ch = mgr.register_shuffle(200 + i, 1, 8, tenant="chatty")
            mgr._new_report(ch, distributed=False)
            end()
        got.append((mgr._report_capacity,
                    [(r.shuffle_id, r.tenant) for r in mgr.reports()]))
    assert got[0] == got[1]
    tenants = [t for _, t in got[1][1]]
    assert got[1][0] == 8 and tenants.count("quiet") == 3
    # one tenant: the oldest goes first
    lru = []
    for side, make in (("jax", manager_factory), ("port", port_factory)):
        mgr2 = make({PFX + "metrics.reportCapacity": "4"})
        for i in range(6):
            h = mgr2.register_shuffle(300 + i, 1, 8)
            mgr2._new_report(h, distributed=False)
            if side == "jax":
                mgr2.node.flight.end_trace("")
        lru.append([r.shuffle_id for r in mgr2.reports()])
    assert lru[0] == lru[1] == [302, 303, 304, 305]


# -- per-tenant policy overrides -----------------------------------------------
def test_replay_budget_override(managers):
    got = []
    for p, mgr in managers({PFX + "failure.policy": "replay",
                            PFX + "failure.replayBudget": "2",
                            PFX + "tenant.frugal.replayBudget": "0"}):
        h_default = mgr.register_shuffle(1, 1, 8)
        h_frugal = mgr.register_shuffle(2, 1, 8, tenant="frugal")
        got.append((mgr._spend_replay(h_default.shuffle_id),
                    mgr._spend_replay(h_frugal.shuffle_id),
                    mgr._replay_budget_for(h_frugal.shuffle_id),
                    mgr._replay_budget_for(h_default.shuffle_id),
                    mgr._tenant_of(2), mgr._tenant_of(1),
                    mgr._tenant_of(99)))
    assert got[0] == got[1]
    assert got[1][:2] == (True, False)
    assert got[1][2] == (0, PFX + "tenant.frugal.replayBudget")


def test_replay_budget_override_on_a_read(managers):
    """Under an armed exchange fault, a tenant with replayBudget=0 fails
    without a replay; the default tenant's read replays once and the
    labeled replay counter names it."""
    got = []
    for p, mgr in managers({PFX + "failure.policy": "replay",
                            PFX + "tenant.d.replayBudget": "0"}):
        lab = p.metrics.labeled
        hd = _write_small(mgr, 21, "d", seed=4)
        hn = _write_small(mgr, 22, None, seed=5)
        mgr.node.faults.arm("exchange", fail_count=1)
        err = _raised(lambda: mgr.read(hd))
        mgr.node.faults.arm("exchange", fail_count=1)
        keys = _sorted_keys(mgr.read(hn)).tolist()
        m = mgr.node.metrics
        got.append((err[0], mgr.report(21).replays, mgr.report(22).replays,
                    keys, m.get(lab("shuffle.replay.count", tenant="default")),
                    m.get(lab("shuffle.replay.count", tenant="d")),
                    m.get(lab("shuffle.replay.ms", tenant="default")) > 0))
    assert got[0] == got[1]
    assert got[1][:3] == ("InjectedFault", 0, 1) and got[1][4:] == (
        1.0, 0.0, True)


def test_integrity_override_per_tenant(managers):
    got = []
    for p, mgr in managers({PFX + "integrity.verify": "staged",
                            PFX + "tenant.fast.integrity.verify": "off",
                            PFX + "tenant.careful.integrity.verify": "full"}):
        seq = [mgr._integrity_for("fast"), mgr._integrity_for("anyone"),
               mgr._integrity_for("careful")]
        m = mgr.node.metrics
        mgr.read(_write_small(mgr, 11, "fast", seed=1))
        seq += [m.get(p.metrics.C_INTEGRITY_VERIFIED), mgr.report(11).integrity]
        mgr.read(_write_small(mgr, 12, "careful", seed=2))
        rep = mgr.report(12)
        seq += [rep.integrity, rep.integrity_bytes]
        mgr.read(_write_small(mgr, 13, None, seed=3))
        rep = mgr.report(13)
        seq += [rep.integrity, rep.integrity_bytes,
                m.get(p.metrics.C_INTEGRITY_VERIFIED)]
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][:5] == ["off", "staged", "full", 0.0, ""]
    assert got[1][5] == "full" and got[1][7] == "staged"


def test_wave_depth_override_resolves(managers):
    """``tenant.<id>.waveDepth`` wins over ``a2a.waveDepth``: a waved
    device-sink read reserves ``depth`` pack blocks, so the shallow
    tenant's reservation is smaller, and equal to the reference's."""
    got = []
    keys = np.random.default_rng(6).integers(0, 1 << 40, 3000)
    for p, mgr in managers({PFX + "a2a.maxBytesInFlight": "1g",
                            PFX + "a2a.waveRows": "64",
                            PFX + "a2a.waveDepth": "3",
                            PFX + "tenant.shallow.waveDepth": "1"}):
        seq = [mgr._tenants.spec("shallow").wave_depth,
               mgr._tenants.spec("other").wave_depth]
        for sid, tenant in ((31, "shallow"), (32, "other")):
            h = mgr.register_shuffle(sid, 4, 8, tenant=tenant)
            for mid, part in enumerate(np.array_split(keys, 4)):
                w = mgr.get_writer(h, mid)
                w.write(part)
                w.commit(8)
            res = mgr.read(h, sink="device")
            seq += [mgr._inflight_bytes, mgr.report(sid).waves]
            res.consume(lambda c, rows, nv: None)
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][:2] == [1, None] and got[1][3] > 1
    assert 0 < got[1][2] < got[1][4]


def test_quota_blocked_hog_is_bypassed(managers):
    """A hog with a quota of one read: its second and third reads defer
    on its own quota, and a normal tenant's read queued behind them is
    granted past them while the hog's first read still holds; every read
    completes, with the reference's cross-grant counts."""
    got = []
    for p, mgr in managers({PFX + "a2a.maxBytesInFlight": "1g",
                            PFX + "tenant.hog.maxBytesInFlight": "1k"}):
        lab = p.metrics.labeled
        hs = [_write_small(mgr, 40 + i, "hog", seed=10 + i) for i in range(3)]
        hn = _write_small(mgr, 50, "normal", seed=20)
        pend = [mgr.submit(h) for h in hs]
        pn = mgr.submit(hn)
        # the deferred ones (the first one's done() is the JAX side's
        # asynchronous dispatch, a race)
        seq = [[x.done() for x in pend[1:]], pn.done()]
        keys = _sorted_keys(pn.result()).tolist()
        seq.append(dict(mgr._inflight_by_tenant).get("hog", 0) > 0)
        for x in pend:
            x.result()
        m = mgr.node.metrics
        seq += [keys, mgr._inflight_bytes, len(mgr._admit_queue),
                p.hist(m, lab("shuffle.admit.cross_grants", tenant="normal")),
                p.hist(m, lab("shuffle.admit.cross_grants", tenant="hog"))]
        got.append(seq)
    assert got[0][:2] == got[1][:2] and got[0][2:] == got[1][2:]
    assert got[1][2] and got[1][4:6] == [0, 0]


def test_cross_grants_observed(managers):
    got = []
    for p, mgr in managers({PFX + "a2a.maxBytesInFlight": "1",
                            PFX + "tenant.fairShare": "false"}):
        whale = [_write_small(mgr, 60 + i, "whale", rows=512, seed=i)
                 for i in range(3)]
        minnow = _write_small(mgr, 70, "minnow", rows=64, seed=9)
        pending = [mgr.submit(h) for h in whale]
        p_minnow = mgr.submit(minnow)
        for x in pending:
            x.result()
        p_minnow.result()
        m = mgr.node.metrics
        lab = p.metrics.labeled
        got.append((p.hist(m, lab("shuffle.admit.cross_grants",
                                  tenant="minnow")),
                    p.hist(m, lab("shuffle.admit.cross_grants",
                                  tenant="whale"))))
    assert got[0] == got[1]
    assert got[1][0] == (1, 2.0)        # the two whale reads queued ahead


@pytest.mark.parametrize("fair", [True, False])
def test_fair_share_minnow_crosses_at_most_one_whale_grant(fair):
    """A whale's three deferred reads queued ahead of four minnow reads
    (one read in flight at a time): under DRR no minnow waits through
    more than one whale grant (a whale read needs many quanta, a minnow
    one), under FIFO every minnow waits through all three."""
    svc = connect({PFX + "a2a.impl": "dense",
                   PFX + "a2a.maxBytesInFlight": "1",
                   PFX + "tenant.fairShare": str(fair).lower(),
                   PFX + "tenant.whale.priority": "batch",
                   PFX + "tenant.minnow.priority": "high"},
                  device="cpu", use_env=False)
    mgr = svc.manager
    try:
        whale = [_write_small(mgr, 80 + i, "whale", rows=40000, seed=i)
                 for i in range(4)]
        minnows = [_write_small(mgr, 90 + i, "minnow", rows=64, seed=9 + i)
                   for i in range(4)]
        pending = [mgr.submit(h) for h in whale]     # w0 in flight
        assert len(mgr._admit_queue) == 3
        out, errs = {}, []

        def minnow(h):
            try:
                out[h.shuffle_id] = _sorted_keys(mgr.read(h))
            except Exception as e:  # pragma: no cover
                errs.append(repr(e))

        threads = [threading.Thread(target=minnow, args=(h,))
                   for h in minnows]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while len(mgr._admit_queue) < 7 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(mgr._admit_queue) == 7      # every minnow deferred
        for x in pending:
            x.result()
        for t in threads:
            t.join(timeout=60)
        assert not errs and len(out) == 4
        h = mgr.node.metrics.histogram(tmetrics.labeled(
            tmetrics.H_ADMIT_CROSS, tenant="minnow"))
        assert h.count == 4
        if fair:
            assert h.max <= 1.0
        else:
            assert h.min == h.max == 3.0
        assert mgr._inflight_bytes == 0 and not mgr._admit_queue
    finally:
        svc.stop()


# -- async futures -------------------------------------------------------------
def _service(side, extra=None):
    m = {PFX + "a2a.impl": "dense", PFX + "io.format": "raw",
         PFX + "a2a.maxBytesInFlight": "1", **(extra or {})}
    if side == "jax":
        from sparkucx_tpu.service import connect as jconnect
        return jconnect(m, use_env=False)
    return connect(m, device="cpu", use_env=False)


@pytest.mark.parametrize("side", SIDES)
def test_v1_async_futures_match_sync(side, mesh8):
    svc = _service(side)
    try:
        rng = np.random.default_rng(3)
        h = svc.register_shuffle(1, 2, 8, tenant="alice")
        keys = rng.integers(0, 1 << 30, 800).astype(np.int64)
        for m in range(2):
            svc.write(h, m, keys[m * 400:(m + 1) * 400])
        want = _sorted_keys(svc.read(h))
        fut = svc.read_async(h)
        got = _sorted_keys(fut.result(timeout=60))
        np.testing.assert_array_equal(got, np.sort(keys))
        np.testing.assert_array_equal(got, want)
        assert fut.done() and fut.tenant == "alice" and fut.shuffle_id == 1
        assert fut.wall_ms > 0 and fut.queued_ms >= 0
        assert fut.exception() is None
        got2 = _sorted_keys(svc.submit_async(h).result(timeout=60))
        np.testing.assert_array_equal(got2, want)
        rep = svc.manager.report(1)
        assert (rep.tenant, rep.async_workers) == ("alice", 4)
        seen = []
        f3 = svc.read_async(h)
        f3.add_done_callback(lambda f: seen.append(f.tenant))
        f3.result(timeout=60)
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == ["alice"]
    finally:
        svc.stop()


def test_async_read_failure_reaches_the_future():
    """A failed async read fails its future with the read's own error:
    nothing falls back to a synchronous read or swallows it."""
    svc = connect({PFX + "a2a.impl": "dense"}, device="cpu", use_env=False)
    try:
        h = svc.register_shuffle(5, 2, 8)
        svc.write(h, 0, np.arange(10))         # map 1 never commits
        fut = svc.read_async(h, timeout=0.05)
        with pytest.raises(TimeoutError, match="1/2 map outputs"):
            fut.result(timeout=30)
        assert isinstance(fut.exception(), TimeoutError)
        assert svc._async.inflight("default") == 0
    finally:
        svc.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_inflight_cap_throttles(side):
    p = Pkg(side)
    reg = p.registry({PFX + "tenant.t.maxInflightReads": "1"})
    metrics = p.metrics.Metrics()
    ex = p.tenancy.AsyncShuffleExecutor(p.conf(), reg, metrics,
                                        distributed=False)
    try:
        gate = threading.Event()
        f1 = ex.submit(gate.wait, "t", 1)
        t0 = time.monotonic()
        box = {}

        def second():
            box["f2"] = ex.submit(lambda: "done", "t", 2, timeout=30)

        th = threading.Thread(target=second)
        th.start()
        time.sleep(0.2)
        assert "f2" not in box
        gate.set()
        th.join(timeout=30)
        assert box["f2"].result(30) == "done"
        assert time.monotonic() - t0 >= 0.2
        assert f1.result(30) is True
        assert metrics.get(p.metrics.labeled(
            "shuffle.submit.throttled.count", tenant="t")) == 1.0
        g2 = threading.Event()
        ex.submit(g2.wait, "t", 3)
        with pytest.raises(TimeoutError, match="maxInflightReads"):
            ex.submit(lambda: None, "t", 4, timeout=0.2)
        g2.set()
    finally:
        ex.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_stop_wakes_capped_submitter(side):
    p = Pkg(side)
    reg = p.registry({PFX + "tenant.t.maxInflightReads": "1"})
    ex = p.tenancy.AsyncShuffleExecutor(p.conf(), reg, p.metrics.Metrics(),
                                        distributed=False)
    gate = threading.Event()
    ex.submit(gate.wait, "t", 1)
    box = {}

    def blocked():
        try:
            ex.submit(lambda: None, "t", 2)
        except RuntimeError as e:
            box["err"] = str(e)

    th = threading.Thread(target=blocked)
    th.start()
    time.sleep(0.2)
    ex.stop(wait=False)
    th.join(timeout=10)
    alive = th.is_alive()
    gate.set()
    assert not alive, "capped submitter hung across stop()"
    assert "stopped" in box.get("err", "")


@pytest.mark.parametrize("side", SIDES)
def test_async_distributed_keeps_k_workers_with_agreed_order(side):
    p = Pkg(side)
    reg = p.registry()
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "8"}), reg,
        p.metrics.Metrics(), distributed=True)
    ex_local = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "8"}), reg,
        p.metrics.Metrics(), distributed=False)
    assert (ex.workers, ex._dispatching) == (8, True)
    assert (ex_local.workers, ex_local._dispatching) == (8, False)
    ex.stop()
    ex_local.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_distributed_opt_out_clamps_single_worker(side):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "8",
                PFX + "tenant.asyncAgreedOrder": "false"}),
        p.registry(), p.metrics.Metrics(), distributed=True)
    assert ex.workers == 1 and not ex._dispatching
    order = []

    def job(i, delay):
        time.sleep(delay)
        order.append(i)

    futs = [ex.submit(lambda i=i, d=d: job(i, d), None, i)
            for i, d in enumerate([0.1, 0.0, 0.0])]
    for f in futs:
        f.result(30)
    assert order == [0, 1, 2]
    ex.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        ex.submit(lambda: None, None, 9)


@pytest.mark.parametrize("side", SIDES)
def test_async_agreed_order_dispatch_single_process(side):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "4"}), p.registry(),
        p.metrics.Metrics(), distributed=True)
    assert ex._dispatching
    futs = [ex.submit(lambda i=i: i * 10, None, i) for i in range(5)]
    assert [f.result(30) for f in futs] == [0, 10, 20, 30, 40]
    ex.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_turnstile_orders_execution_not_just_submission(side):
    p = Pkg(side)
    metrics = p.metrics.Metrics()
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "4"}),
        p.registry({PFX + "tenant.hi.priority": "high"}), metrics,
        distributed=True)
    try:
        ex._dispatcher = threading.current_thread()
        spans = []

        def body(tag):
            t0 = time.monotonic()
            time.sleep(0.02)
            spans.append((tag, t0, time.monotonic()))
            return tag

        subs = [("lo0", "lo"), ("hi0", "hi"), ("hi1", "hi"),
                ("lo1", "lo"), ("hi2", "hi")]
        futs = [ex.submit(lambda t=t: body(t), tid, i)
                for i, (t, tid) in enumerate(subs)]
        ex._dispatch_batch(len(subs))
        assert [f.result(30) for f in futs] == [t for t, _ in subs]
        ordered = sorted(spans, key=lambda s: s[1])
        assert [s[0] for s in ordered] == ["lo0", "lo1", "hi0", "hi1", "hi2"]
        for (_, _, end), (_, start, _) in zip(ordered, ordered[1:]):
            assert end <= start
    finally:
        ex._dispatcher = None
        ex.stop()
    if side == "port":
        # the node's metrics carry the rounds and the turnstile's waits
        m = tmetrics
        assert metrics.get(m.labeled(m.C_AGREE_ROUNDS,
                                     topic="async.order")) == 1.0
        assert metrics.histogram(m.H_TURNSTILE_WAIT).count == 6


def _boom_agree(p, topic_to_fail, exc):
    real = p.agreement.agree

    def boom(topic, *a, **k):
        if topic == topic_to_fail:
            raise exc()
        return real(topic, *a, **k)
    return real, boom


@pytest.mark.parametrize("side", SIDES)
def test_async_dispatch_failure_after_pop_frees_popped_batch(side,
                                                             monkeypatch):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "4"}),
        p.registry({PFX + "tenant.t.maxInflightReads": "2"}),
        p.metrics.Metrics(), distributed=True)
    real, boom = _boom_agree(p, "async.order",
                             lambda: RuntimeError("order channel down"))
    try:
        ex._dispatcher = threading.current_thread()
        f1 = ex.submit(lambda: 1, "t", 1)
        f2 = ex.submit(lambda: 2, "t", 2)
        monkeypatch.setattr(p.agreement, "agree", boom)
        with pytest.raises(RuntimeError, match="order channel down"):
            ex._dispatch_batch(2)
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="order channel down"):
                f.result(10)
        assert ex.inflight("t") == 0
        monkeypatch.setattr(p.agreement, "agree", real)
        f3 = ex.submit(lambda: 3, "t", 3)
        ex._dispatch_batch(1)
        assert f3.result(10) == 3
    finally:
        ex._dispatcher = None
        ex.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_dispatcher_survives_batch_fault_live_loop(side, monkeypatch):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "4"}), p.registry(),
        p.metrics.Metrics(), distributed=True)
    real, boom = _boom_agree(p, "async.order",
                             lambda: RuntimeError("order channel down"))
    try:
        monkeypatch.setattr(p.agreement, "agree", boom)
        f1 = ex.submit(lambda: 1, "default", 1)
        with pytest.raises(RuntimeError, match="order channel down"):
            f1.result(10)
        assert ex.inflight("default") == 0
        monkeypatch.setattr(p.agreement, "agree", real)
        f2 = ex.submit(lambda: 2, "default", 2)
        assert f2.result(10) == 2
        assert ex.inflight("default") == 0
    finally:
        ex.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_dispatch_divergence_fails_batch_typed(side, monkeypatch):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "2"}), p.registry(),
        p.metrics.Metrics(), distributed=True)
    err = p.agreement.AgreementDivergenceError
    real, dissent = _boom_agree(p, "async.order", lambda: err(
        "async.order", "value", [1], [[0], [9]],
        conf_key=PFX + "tenant.asyncAgreedOrder"))
    try:
        ex._dispatcher = threading.current_thread()
        f1 = ex.submit(lambda: 1, None, 1)
        monkeypatch.setattr(p.agreement, "agree", dissent)
        ex._dispatch_batch(1)               # returns, does not raise
        with pytest.raises(err, match="asyncAgreedOrder"):
            f1.result(10)
        assert ex.inflight("default") == 0
        monkeypatch.setattr(p.agreement, "agree", real)
        f2 = ex.submit(lambda: 2, None, 2)
        ex._dispatch_batch(1)
        assert f2.result(10) == 2
    finally:
        ex._dispatcher = None
        ex.stop()


@pytest.mark.parametrize("side", SIDES)
def test_async_stop_unblocks_turnstiled_read(side):
    p = Pkg(side)
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "2"}), p.registry(),
        p.metrics.Metrics(), distributed=True)
    gate = threading.Event()
    ex._dispatcher = threading.current_thread()
    f1 = ex.submit(gate.wait, None, 1)
    f2 = ex.submit(lambda: "late", None, 2)
    ex._dispatch_batch(2)
    time.sleep(0.1)
    ex._dispatcher = None
    ex.stop(wait=False)
    with pytest.raises(RuntimeError, match="closed"):
        f2.result(10)
    gate.set()
    assert f1.result(10) is True


def test_async_queued_reads_fail_at_stop():
    """Reads still on the dispatcher's queue when the executor stops fail
    typed and free their tenant slots."""
    p = Pkg("port")
    ex = p.tenancy.AsyncShuffleExecutor(
        p.conf({PFX + "tenant.asyncWorkers": "2"}), p.registry(),
        p.metrics.Metrics(), distributed=True)
    ex._dispatcher = threading.current_thread()   # nothing dispatches
    futs = [ex.submit(lambda: 1, "q", i) for i in range(3)]
    ex._dispatcher = None
    ex.stop()
    for f in futs:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(10)
    assert ex.inflight("q") == 0


# -- the facade under concurrent reads -----------------------------------------
def test_facade_race_stats_reports():
    """``stats()``, ``reports()`` and ``exchange_reports()`` racing reads
    from four threads: no exception, sane snapshots, every read correct,
    and both tenants' labeled read counters."""
    svc = connect({PFX + "a2a.impl": "dense",
                   PFX + "tenant.m.priority": "high"}, device="cpu",
                  use_env=False)
    errs = []
    try:
        rng = np.random.default_rng(5)
        handles, keys = [], {}
        for i in range(4):
            h = svc.register_shuffle(50 + i, 2, 8,
                                     tenant="m" if i % 2 else "w")
            ks = rng.integers(0, 1 << 20, 512).astype(np.int64)
            for m in range(2):
                svc.write(h, m, ks[m * 256:(m + 1) * 256])
            handles.append(h)
            keys[50 + i] = np.sort(ks)
        stop = threading.Event()

        def reader(h):
            try:
                for _ in range(3):
                    got = _sorted_keys(svc.read(h))
                    assert np.array_equal(got, keys[h.shuffle_id])
            except Exception as e:  # pragma: no cover
                errs.append(("read", repr(e)))

        def scraper():
            try:
                while not stop.is_set():
                    assert isinstance(svc.stats(), dict)
                    for h in handles:
                        svc.report(h.shuffle_id)
                    for d in svc.manager.exchange_reports():
                        assert d["tenant"] in ("m", "w")
                    svc.manager.reports()
                    svc.node.metrics.gauges()
                    svc.node.metrics.histograms()
            except Exception as e:  # pragma: no cover
                errs.append(("scrape", repr(e)))

        threads = [threading.Thread(target=reader, args=(h,))
                   for h in handles]
        scrapers = [threading.Thread(target=scraper) for _ in range(2)]
        for t in threads + scrapers:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        for t in scrapers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads + scrapers)
        assert not errs, errs
        counters = svc.stats()["counters"]
        lab = tmetrics.labeled
        assert counters[lab("shuffle.read.count", tenant="m")] == 6.0
        assert counters[lab("shuffle.read.count", tenant="w")] == 6.0
    finally:
        svc.stop()


# -- the report's fields of the ported planes ----------------------------------
_FIELDS_CASES = {
    "plain": ({}, 6, np.int32),
    "int8": ({PFX + "a2a.wire": "int8"}, 8, np.float32),
    "lossless_waved": ({PFX + "a2a.wire": "lossless",
                        PFX + "a2a.waveRows": "96"}, 4, np.int32),
}


@pytest.mark.parametrize("case", sorted(_FIELDS_CASES))
def test_report_fields_match_reference(case, managers):
    """The report fields of the planes the port already has, on the same
    read in both packages: the byte and row fields equal; ``bw_gbps`` and
    ``effective_bw_gbps`` each package's own formula over its own
    ``group_ms`` (timings differ), with the same int8 row-width gain;
    ``lossless_ratio`` the reference's rounding of each side's bytes."""
    conf, vw, dtype = _FIELDS_CASES[case]
    rng = np.random.default_rng(12)
    maps = [(rng.integers(0, 1 << 40, 700).astype(np.int64),
             (rng.standard_normal((700, vw)) * 100).astype(dtype))
            for _ in range(6)]
    reps = []
    for p, mgr in managers(conf):
        h = mgr.register_shuffle(33, 6, 16)
        for m, (k, v) in enumerate(maps):
            w = mgr.get_writer(h, m)
            w.write(k, v)
            w.commit(16)
        res = mgr.read(h)
        keys = _sorted_keys(res, 16)
        rep = mgr.report(33)
        reps.append((keys, rep.to_dict(), rep._wire_gain))
    (jk, jd, jg), (tk, td, tg) = reps
    np.testing.assert_array_equal(jk, tk)
    for f in ("rows_global", "rows_local", "bytes_local", "payload_bytes",
              "peer_rows", "peer_bytes", "wire_bytes", "wire", "tenant",
              "waves", "completed"):
        assert td[f] == jd[f], f
    assert tg == jg
    assert td["rows_local"] == td["rows_global"] == 4200
    assert td["bytes_local"] == td["payload_bytes"]
    for d, g in ((jd, jg), (td, tg)):
        gbps = d["payload_bytes"] / (d["group_ms"] * 1e6)
        assert d["group_ms"] > 0
        assert d["bw_gbps"] == round(gbps, 6)
        assert d["effective_bw_gbps"] == round(gbps * g, 6)
        want = round(d["lossless_bytes"] / d["payload_bytes"], 6) \
            if d["lossless_bytes"] else 0.0
        assert d["lossless_ratio"] == want
    if case == "int8":
        assert tg > 1.0
    if case == "lossless_waved":
        assert td["waves"] > 1 and td["lossless_ratio"] > 0


def test_report_public_fields_cover_the_ported_planes():
    """Every public field of the reference's report exists on the port's
    but the four of the XLA step cache, which the port has no use for."""
    import dataclasses

    from sparkucx_tpu.shuffle.manager import ExchangeReport as JRep
    from sparkucx_tpu_torch.shuffle.manager import ExchangeReport as TRep
    ref = {f.name for f in dataclasses.fields(JRep)
           if not f.name.startswith("_")}
    port = {f.name for f in dataclasses.fields(TRep)
            if not f.name.startswith("_")}
    step_cache = {"device_cost", "stepcache_hits", "stepcache_programs",
                  "plan_family"}
    assert ref - port == step_cache
    assert port - ref == {"device"}
    assert {"trace_id", "agreement", "phases", "dark_ms", "dark_intervals",
            "anatomy_wall_ms"} <= port
    assert {"tenant", "async_workers", "rows_local", "bytes_local",
            "peer_bytes", "bw_gbps", "effective_bw_gbps",
            "lossless_ratio"} <= port


def test_tier_bytes_carry_the_tenant(manager_factory, port_factory):
    """``shuffle.tier.bytes{tier, tenant}`` names the read's tenant on a
    two-tier read, with the reference's figures."""
    from sparkucx_tpu.utils.metrics import C_TIER_BYTES
    conf = {PFX + "mesh.numSlices": "2"}
    got = []
    for side, make in (("jax", manager_factory), ("port", port_factory)):
        mgr = make(conf)
        h = _write_small(mgr, 44, "tiered", seed=7)
        mgr.read(h)
        m = mgr.node.metrics
        lab = (jmetrics if side == "jax" else tmetrics).labeled
        got.append([m.get(lab(C_TIER_BYTES, tier=t, tenant="tiered"))
                    for t in ("ici", "dcn")])
        assert mgr.report(44).tiers
    assert got[0] == got[1] and min(got[1]) > 0


def test_tenant_survives_remesh_and_restart(manager_factory, port_factory,
                                            tmp_path):
    """A remesh under replay re-pins the stale handle as its tenant (the
    tenant's budget spent and named), and a restart on the durable
    ledger adopts the shuffle under the tenant ``register_shuffle``
    names; the same in both packages."""
    got = []
    for side, make in (("jax", manager_factory), ("port", port_factory)):
        conf = {PFX + "failure.policy": "replay",
                PFX + "tenant.t.replayBudget": "1",
                PFX + "failure.ledgerDir": str(tmp_path / side)}
        mgr = make(conf)
        h = _write_small(mgr, 61, "t", seed=3)
        want = _sorted_keys(mgr.read(h)).tolist()
        mgr.node.epochs.bump("remesh")
        keys = _sorted_keys(mgr.read(h)).tolist()
        rep = mgr.report(61)
        seq = [keys == want, rep.tenant, rep.replays, mgr._tenant_of(61)]
        mgr.node.epochs.bump("remesh again")
        err = _raised(lambda: mgr.read(h))
        seq += [err[0], "tenant.t.replayBudget" in err[1]]
        mgr2 = make(conf)                   # a restart on the ledger
        h2 = mgr2.register_shuffle(61, 2, 8, tenant="t")
        keys = _sorted_keys(mgr2.read(h2)).tolist()
        seq += [h2.tenant, mgr2._tenant_of(61), mgr2.report(61).tenant,
                keys == want]
        got.append(seq)
    assert got[0] == got[1] == [True, "t", 1, "t", "StaleEpochError", True,
                                "t", "t", "t", True]
