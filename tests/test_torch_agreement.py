"""Port parity for the agreement primitive (``shuffle/agreement.py``):
``tests/test_distributed_parity.py``'s primitive cases against the
port's ``agree`` and ``CollectiveTurnstile`` (with
``tests/test_decisions.py``'s turnstile case, run on both packages) — one
process, where every
allgather is the identity, and divergence shapes replayed through a
stubbed 3-process gather on the agreement channel — plus a real
divergence among three processes on the CPU (``cluster.run_cluster``).
Every comparison is exact."""

import threading
import time

import numpy as np
import pytest

from sparkucx_tpu_torch.cluster import run_cluster
from sparkucx_tpu_torch.shuffle import distributed as dist
from sparkucx_tpu_torch.shuffle.agreement import (AgreementDivergenceError,
                                                  CollectiveTurnstile, agree,
                                                  current_round, reset_epoch)
from sparkucx_tpu_torch.utils.metrics import (C_AGREE_DIVERGENCE,
                                              C_AGREE_ROUNDS,
                                              H_AGREE_ROUND, Metrics,
                                              labeled)


def test_agree_identity_and_sequencing_single_process():
    """One process: agree() is the identity on the payload, the (epoch,
    seq) stream advances per round and resets at an epoch bump."""
    reset_epoch(7)
    assert current_round() == (7, 0)
    out = agree("parity.unit", [3, 1, 4, 1, 5])
    assert out.tolist() == [3, 1, 4, 1, 5] and out.dtype == np.int64
    assert current_round() == (7, 1)
    agree("parity.unit", [2])
    assert current_round() == (7, 2)
    reset_epoch(8)
    assert current_round() == (8, 0)


def test_agree_reductions_single_process():
    reset_epoch(0)
    assert agree("parity.red", [5, 2], reduce="max").tolist() == [5, 2]
    assert agree("parity.red", [5, 2], reduce="min").tolist() == [5, 2]
    assert agree("parity.red", [5, 2], reduce="sum").tolist() == [5, 2]
    assert agree("parity.red", [0, 3], reduce="any").tolist() == [0, 1]
    assert agree("parity.red", [0, 3], reduce="all").tolist() == [0, 1]
    got = agree("parity.red", [4, 6], reduce=lambda rows: rows[0] * 2)
    assert got.tolist() == [8, 12]
    with pytest.raises(ValueError, match="agreement reduction"):
        agree("parity.red", [1], reduce="median")


class _FakeGather:
    """Replays a 3-process allgather on the agreement channel: the header
    round echoes identically unless ``mutate_header``; the payload round
    stacks [mine, mine, mutate(mine)] so process 2 dissents."""

    def __init__(self, mutate=None, mutate_header=None):
        self.mutate = mutate
        self.mutate_header = mutate_header

    def __call__(self, payload, what="", timeout_ms=None):
        mine = np.asarray(payload)
        rows = [mine, mine, mine.copy()]
        if what.startswith("agreement header"):
            if self.mutate_header is not None:
                rows[2] = self.mutate_header(mine.copy())
        elif self.mutate is not None:
            rows[2] = self.mutate(mine.copy())
        return np.stack(rows)


def test_agree_value_divergence_names_dissenter(monkeypatch):
    reset_epoch(0)
    metrics = Metrics()

    def bump(row):
        row[0] += 9
        return row

    monkeypatch.setattr(dist, "allgather_blob", _FakeGather(mutate=bump))
    with pytest.raises(AgreementDivergenceError) as ei:
        agree("a2a.waveRows", [12, 40],
              conf_key="spark.shuffle.tpu.a2a.waveRows", metrics=metrics)
    e = ei.value
    assert e.topic == "a2a.waveRows" and e.kind == "value"
    assert e.dissenters == [2]
    assert e.proposals[2] == [21, 40] and e.proposals[0] == [12, 40]
    assert "spark.shuffle.tpu.a2a.waveRows" in str(e)
    assert "process(es) [2]" in str(e)
    # the round counts, the divergence too, each with its topic twin
    for name in (C_AGREE_ROUNDS, C_AGREE_DIVERGENCE):
        assert metrics.get(name) == 1.0
        assert metrics.get(labeled(name, topic="a2a.waveRows")) == 1.0
    assert metrics.histogram(H_AGREE_ROUND).count == 1


def test_agree_sequencing_divergence_from_header(monkeypatch):
    """A process entering another round (a stale seq) raises typed from
    the fixed-shape header round."""
    reset_epoch(3)

    def stale_seq(row):
        row[1] += 1        # header = [epoch, seq, topic, len, reduce]
        return row

    monkeypatch.setattr(dist, "allgather_blob",
                        _FakeGather(mutate_header=stale_seq))
    with pytest.raises(AgreementDivergenceError) as ei:
        agree("hier.dcn.regrow", [256],
              conf_key="spark.shuffle.tpu.a2a.capacityFactor")
    e = ei.value
    assert e.kind == "sequencing" and e.dissenters == [2]
    assert "different agreement rounds" in str(e)
    assert "capacityFactor" in str(e)


def test_agree_divergence_reduction_rounds_never_diverge(monkeypatch):
    reset_epoch(0)

    def flip(row):
        row[0] = 1 - row[0]
        return row

    monkeypatch.setattr(dist, "allgather_blob", _FakeGather(mutate=flip))
    assert agree("hier.ici.overflow", [0], reduce="any").tolist() == [1]
    assert agree("hier.ici.overflow", [0], reduce="all").tolist() == [0]


def test_agree_threads_tear_no_frames():
    """Concurrent agree() calls never reuse a sequence number."""
    reset_epoch(0)
    n, per = 4, 25
    done = []

    def worker():
        for _ in range(per):
            agree("parity.thread", [1], reduce="sum")
        done.append(1)

    ts = [threading.Thread(target=worker) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(done) == n
    assert current_round() == (0, n * per)


def test_agree_rounds_atomic_across_threads(monkeypatch):
    """The round mutex holds across BOTH allgathers: concurrent rounds
    never interleave one round's header with another's payload."""
    reset_epoch(0)
    calls = []

    def gather(payload, what="", timeout_ms=None):
        calls.append(what)
        time.sleep(0.001)       # widen the interleave window
        return np.asarray(payload)[None]

    monkeypatch.setattr(dist, "allgather_blob", gather)
    per = 10

    def worker():
        for _ in range(per):
            agree("parity.atomic", [1], reduce="sum")

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(calls) == 4 * per * 2
    for header, payload in zip(calls[::2], calls[1::2]):
        assert header.startswith("agreement header")
        assert payload.startswith("agreement 'parity.atomic'")
        assert header.rsplit("#", 1)[1] == payload.rsplit("#", 1)[1]


def test_three_processes_raise_naming_process_2():
    """A real world of three: process 2 proposes another value, and every
    process raises AgreementDivergenceError naming it, after a round all
    three agreed."""
    run = run_cluster("torch_cluster_jobs:divergence", 3, 6, device="cpu",
                      timeout_s=120)
    assert len(run.results) == 3
    for res in run.results:
        assert res["agreed"] == [3, 4]
        assert (res["kind"], res["topic"]) == ("value", "test.divergent")
        assert res["dissenters"] == [2]
        assert res["proposals"] == [[7, 1], [7, 1], [7, 99]]
        assert "process(es) [2]" in res["message"]
        assert "spark.shuffle.tpu.test" in res["message"]


# -- the collective turnstile --------------------------------------------------
def _turnstiles():
    from sparkucx_tpu.shuffle import agreement as jagreement
    from sparkucx_tpu.utils import metrics as jmetrics
    from sparkucx_tpu_torch.utils import metrics as tmetrics
    return [(jagreement.CollectiveTurnstile, jmetrics),
            (CollectiveTurnstile, tmetrics)]


def test_collective_turnstile_orders_and_skips_abandoned():
    """Acquisition follows issue order in both packages; a ticket
    released out of turn is skipped, not waited for; ``close()`` fails a
    waiter typed."""
    got = []
    for cls, mod in _turnstiles():
        gate = cls(metrics=mod.Metrics())
        t0, t1, t2, t3 = (gate.issue() for _ in range(4))
        ran = []

        def hold(ticket, tag, gate=gate, ran=ran):
            gate.acquire(ticket)
            ran.append(tag)
            gate.release(ticket)

        gate.release(t1)
        th = threading.Thread(target=hold, args=(t2, "c"))
        th.start()
        time.sleep(0.05)
        before = list(ran)
        hold(t0, "a")
        th.join(timeout=10)
        gate.release(t0)                 # idempotent
        gate.close()
        with pytest.raises(RuntimeError, match="closed"):
            gate.acquire(t3)
        got.append((before, ran, (t0, t1, t2, t3)))
    assert got[0] == got[1] == ([], ["a", "c"], (0, 1, 2, 3))


def test_turnstile_k_workers_ordered_abandoned_counted():
    """Eight workers started in reverse acquire in ticket order; the
    abandoned ticket is counted and skipped; the depth gauge returns to
    0 and every wait is observed — the same in both packages."""
    got = []
    for cls, mod in _turnstiles():
        m = mod.Metrics()
        gate = cls(metrics=m)
        tickets = [gate.issue() for _ in range(8)]
        depth0 = m.gauges()[mod.G_TURNSTILE_DEPTH]
        ran, lock = [], threading.Lock()

        def work(t, gate=gate, ran=ran, lock=lock):
            gate.acquire(t)
            with lock:
                ran.append(t)
            gate.release(t)

        gate.release(tickets[3])
        live = [t for t in tickets if t != tickets[3]]
        threads = [threading.Thread(target=work, args=(t,))
                   for t in reversed(live)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        count = m.histogram(mod.H_TURNSTILE_WAIT).count
        got.append((depth0, ran == live, m.gauges()[mod.G_TURNSTILE_DEPTH],
                    m.get(mod.C_TURNSTILE_ABANDONED), count))
        gate.close()
    assert got[0] == got[1] == (8.0, True, 0.0, 1.0, 7)


def test_turnstile_without_metrics_and_released_ticket():
    gate = CollectiveTurnstile()
    t = gate.issue()
    gate.release(t)
    with pytest.raises(RuntimeError, match="already released"):
        gate.acquire(t)
