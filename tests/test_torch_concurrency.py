"""Thread-safety of the port's host control plane: the counterparts of
``tests/test_concurrency.py`` on ``connect(device="cpu")`` (8 logical
shards, ``a2a.impl=dense``).

Many threads share one manager, its staging pool, its registry and its
admission queue: concurrent map tasks must neither corrupt staged rows
nor lose commits, the admission queue must neither starve nor leak a
ticket, and a buffer goes back to the pool exactly once. Every read is
held against its written keys (exact). The reference's ``slow`` remesh
storm is not ported: ``tests/test_torch_remesh.py`` holds the graveyard
under a remesh (``test_graveyard_held_while_read_in_flight``,
``test_remesh_during_pack_defers_release``)."""

import gc
import threading
import time

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime.failures import InjectedFault
from sparkucx_tpu_torch.runtime.node import HostStagingPool
from sparkucx_tpu_torch.shuffle.writer import hash32_np

PFX = "spark.shuffle.tpu."


def _mk(conf_map=None):
    svc = connect({PFX + "a2a.impl": "dense", **(conf_map or {})},
                  device="cpu", use_env=False)
    return svc.manager, svc


def _write_one(mgr, sid, keys, R=8, maps=1):
    h = mgr.register_shuffle(sid, maps, R)
    per = keys.shape[0] // maps
    for m in range(maps):
        w = mgr.get_writer(h, m)
        w.write(keys[m * per:(m + 1) * per])
        w.commit(R)
    return h


def _check(res, keys, R=8):
    got = np.sort(np.concatenate([res.partition(r)[0] for r in range(R)]))
    np.testing.assert_array_equal(got, np.sort(keys))


def _poison_pool_puts(pool):
    """Overwrite every buffer put back with 0xAB: a read still walking
    released memory then delivers poisoned keys its oracle catches."""
    real_put = pool.put

    def poisoned_put(buf):
        buf.fill_(0xAB)
        real_put(buf)

    pool.put = poisoned_put


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_concurrent_map_tasks_one_manager():
    mgr, svc = _mk()
    try:
        M, R, rows_per_map = 16, 32, 500
        h = mgr.register_shuffle(80, M, R)
        errs = []

        def map_task(m):
            try:
                rng = np.random.default_rng(m)
                w = mgr.get_writer(h, m)
                keys = rng.integers(0, 10_000, size=rows_per_map) \
                    .astype(np.int64)
                vals = np.repeat(keys[:, None], 3, axis=1).astype(np.int32)
                for i in range(0, rows_per_map, 100):
                    w.write(keys[i:i + 100], vals[i:i + 100])
                w.commit(R)
            except Exception as e:  # pragma: no cover
                errs.append((m, e))

        threads = [threading.Thread(target=map_task, args=(m,))
                   for m in range(M)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        total = 0
        for r, (k, v) in mgr.read(h).partitions():
            assert (v == k[:, None]).all(), f"row corruption in {r}"
            assert (hash32_np(k) % R == r).all(), f"misroute in {r}"
            total += k.shape[0]
        assert total == M * rows_per_map
    finally:
        svc.stop()


def test_concurrent_pool_get_put():
    pool = HostStagingPool(False, ShuffleConf(use_env=False))
    errs = []

    def worker(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(200):
                buf = pool.get(int(rng.integers(64, 8192)))
                buf[:8] = seed % 256
                assert (buf[:8] == seed % 256).all()
                pool.put(buf)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    st = pool.stats()
    assert st["in_use"] == 0 and st["in_use_bytes"] == 0, st
    assert st["requests"] == 8 * 200
    pool.close()


def test_threaded_submit_storm_over_small_cap():
    """8 threads x 3 rounds of submit + result under a cap of about one
    exchange, random delays between them: every exchange completes
    correctly and the reservations return to zero."""
    mgr, svc = _mk({PFX + "a2a.maxBytesInFlight": "200k"})
    try:
        errs = []
        reg_lock = threading.Lock()

        def worker(t):
            try:
                trng = np.random.default_rng(t)
                for i in range(3):
                    sid = 1000 + t * 10 + i
                    keys = trng.integers(0, 1 << 40, 1000).astype(np.int64)
                    with reg_lock:
                        h = _write_one(mgr, sid, keys)
                    p = mgr.submit(h)
                    time.sleep(float(trng.uniform(0, 0.05)))
                    _check(p.result(), keys)
                    mgr.unregister_shuffle(sid)
            except Exception as e:  # pragma: no cover
                errs.append((t, repr(e)))

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "storm deadlocked"
        assert not errs, errs
        assert mgr._inflight_bytes == 0 and not mgr._admit_queue
        assert mgr._inflight_by_tenant == {}
    finally:
        svc.stop()


def test_fifo_head_blocks_later_ticket(rng):
    """Capacity freed while two submits are queued goes to the head: the
    later ticket's result() stays blocked until the head dispatches."""
    mgr, svc = _mk({PFX + "a2a.maxBytesInFlight": "200k"})
    try:
        ka, kb, kc = (rng.integers(0, 1 << 40, 2000).astype(np.int64)
                      for _ in range(3))
        pa = mgr.submit(_write_one(mgr, 1, ka))
        pb = mgr.submit(_write_one(mgr, 2, kb))
        pc = mgr.submit(_write_one(mgr, 3, kc))
        assert not pb.done() and not pc.done()
        c_done, c_out = threading.Event(), {}

        def resolve_c():
            c_out["res"] = pc.result()
            c_done.set()

        tc = threading.Thread(target=resolve_c)
        tc.start()
        _check(pa.result(), ka)
        assert not c_done.wait(0.5), \
            "later ticket was admitted ahead of the head"
        _check(pb.result(), kb)
        tc.join(timeout=60)
        assert c_done.is_set()
        _check(c_out["res"], kc)
        assert mgr._inflight_bytes == 0 and not mgr._admit_queue
    finally:
        svc.stop()


def test_abandoned_queued_handle_unblocks_queue(rng):
    """Dropping a queued pending handle takes its ticket out of the queue,
    so the next ticket runs."""
    mgr, svc = _mk({PFX + "a2a.maxBytesInFlight": "200k"})
    try:
        ka = rng.integers(0, 1 << 40, 2000).astype(np.int64)
        kc = rng.integers(0, 1 << 40, 2000).astype(np.int64)
        pa = mgr.submit(_write_one(mgr, 11, ka))
        pb = mgr.submit(_write_one(
            mgr, 12, rng.integers(0, 1 << 40, 2000).astype(np.int64)))
        pc = mgr.submit(_write_one(mgr, 13, kc))
        assert not pb.done() and not pc.done()
        del pb
        gc.collect()
        assert len(mgr._admit_queue) == 1
        _check(pa.result(), ka)
        _check(pc.result(), kc)
        assert mgr._inflight_bytes == 0 and not mgr._admit_queue
    finally:
        svc.stop()


def test_abandoned_inflight_handles_release_buffers_under_load(rng):
    """Half the pending handles are dropped mid-flight: every pinned pack
    buffer still goes back to the pool once the survivors resolve."""
    mgr, svc = _mk()
    try:
        keep = []
        for i in range(6):
            keys = rng.integers(0, 1 << 40, 1500).astype(np.int64)
            p = mgr.submit(_write_one(mgr, 20 + i, keys))
            if i % 2 == 0:
                keep.append((keys, p))
        del p
        gc.collect()
        for keys, p in keep:
            _check(p.result(), keys)
        keep.clear()
        gc.collect()
        for i in range(6):
            mgr.unregister_shuffle(20 + i)
        st = mgr.node.pool.stats()
        assert st["in_use"] == 0, st
    finally:
        svc.stop()


def test_unregister_racing_active_reads():
    """unregister_shuffle racing reads of the same shuffle: a completed
    read is bit-correct (the graveyard held its buffers), a failed one
    raises cleanly."""
    mgr, svc = _mk()
    _poison_pool_puts(mgr.node.pool)
    try:
        errs, oks = [], []
        for i in range(10):
            sid = 3000 + i
            keys = np.random.default_rng(i).integers(
                0, 1 << 40, 1500).astype(np.int64)
            h = _write_one(mgr, sid, keys)

            def racer(sid=sid, i=i):
                time.sleep(float(np.random.default_rng(1000 + i)
                                 .uniform(0, 0.02)))
                try:
                    mgr.unregister_shuffle(sid)
                except Exception:
                    pass

            t = threading.Thread(target=racer)
            t.start()
            try:
                _check(mgr.read(h), keys)
                oks.append(sid)
            except AssertionError as e:
                errs.append((sid, repr(e)))
            except Exception:
                pass
            t.join(timeout=10)
            try:
                mgr.unregister_shuffle(sid)
            except Exception:
                pass
        assert not errs, f"use-after-free reached a completed read: {errs}"
        assert oks, "every read lost the race: no coverage"
    finally:
        svc.stop()


def test_exchange_failure_releases_exactly_once(rng):
    """A submit that dies at the exchange fault site returns the pinned
    pack buffer exactly once and leaves admission clean; the next read
    of the shuffle succeeds."""
    mgr, svc = _mk({PFX + "fault.exchange.failCount": "1",
                    PFX + "a2a.maxBytesInFlight": "10m"})
    try:
        pool = mgr.node.pool
        puts = []
        real_put = pool.put

        def spy(buf):
            puts.append(id(buf))
            real_put(buf)

        pool.put = spy
        keys = rng.integers(0, 1 << 40, 1000).astype(np.int64)
        h = _write_one(mgr, 40, keys)
        with pytest.raises(InjectedFault):
            mgr.submit(h)
        assert mgr._inflight_bytes == 0
        assert len(puts) == 1, f"expected exactly 1 put, saw {len(puts)}"
        _check(mgr.read(h), keys)
        mgr.unregister_shuffle(40)
        assert pool.stats()["in_use"] == 0, pool.stats()
    finally:
        svc.stop()


def test_stop_with_read_in_flight_releases_graveyard(rng):
    """stop() with a read still inside its window over the writers'
    memory ends, and releases every parked writer batch."""
    mgr, svc = _mk()
    keys = rng.integers(0, 1 << 40, 500).astype(np.int64)
    _write_one(mgr, 50, keys)
    mgr._read_started()                   # a stuck read
    t0 = time.monotonic()
    mgr.stop()
    assert time.monotonic() - t0 < 30
    assert mgr._graveyard == []
    assert mgr.node.pool.stats()["in_use"] == 0, mgr.node.pool.stats()
    svc.node.close()


def test_graveyard_generation_exactness(rng):
    """Batches park by generation: a read started after the drop does
    not hold the batch once every read from before the drop finished."""
    mgr, svc = _mk()
    try:
        released = []
        h = _write_one(mgr, 60, rng.integers(0, 1 << 40, 500)
                       .astype(np.int64))
        for w in mgr._writers[60].values():
            real = w.release

            def spy(real=real):
                released.append(1)
                return real()

            w.release = spy
        g1 = mgr._read_started()
        mgr.unregister_shuffle(60)
        assert not released, "batch freed while a pre-drop read is live"
        g2 = mgr._read_started()
        mgr._read_finished(g1)
        assert released, "batch still parked with no pre-drop read left"
        mgr._read_finished(g2)
        assert h.shuffle_id not in mgr.live_shuffles()
    finally:
        svc.stop()
