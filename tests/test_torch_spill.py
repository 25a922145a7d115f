"""Port parity for the memory planes: writer spill, the staging pool's
byte accounting and ``a2a.maxBytesInFlight`` admission. The JAX
``TpuShuffleManager`` on 8 virtual CPU devices (``manager_factory``)
against the port through ``connect(..., device="cpu")`` with 8 logical
shards, on the same seeded map outputs, under the same conf.

Exact: every partition's (key, value) multiset of a spilled read, the
``shuffle.spill.bytes`` / ``shuffle.spill.count`` deltas (the JAX
package counts them in its global registry, the port in the node's), the
spill files' seal and truncation contract, the pool's in-use / peak
bytes over one ``get``/``put`` sequence (sizes on the JAX pool's
power-of-two classes, so both count the same bytes), and the admission
reservation of the same read (``_exchange_footprint``: pinned stage plus
device send and receive buffers)."""

import glob
import os

import numpy as np
import pytest

from sparkucx_tpu.utils.metrics import GLOBAL_METRICS
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.runtime.failures import TruncatedBlockError
from sparkucx_tpu_torch.runtime.node import HostStagingPool
from sparkucx_tpu_torch.utils.metrics import C_SPILL_BYTES, C_SPILL_COUNT

N_SHARDS = 8


def _port(conf):
    c = {"spark.shuffle.tpu.a2a.impl": "dense"}
    c.update(conf)
    return connect(c, device="cpu", num_shards=N_SHARDS, use_env=False)


def _spill_conf(tmp_path, side, threshold="4k"):
    return {"spark.shuffle.tpu.spill.threshold": threshold,
            "spark.shuffle.tpu.spill.dir": str(tmp_path / side)}


def _recs(k, v):
    if v is None:
        return sorted(k.tolist())
    return sorted(zip(k.tolist(), map(bytes, np.ascontiguousarray(v))))


def _spill_delta(metrics, before):
    return (metrics.get(C_SPILL_BYTES) - before[0],
            metrics.get(C_SPILL_COUNT) - before[1])


@pytest.mark.parametrize("with_values", [True, False],
                         ids=["values", "keys_only"])
def test_spill_roundtrip_matches_jax(manager_factory, tmp_path, with_values):
    """Several batches per writer past a 4 kB threshold: both packages
    spill, the read serves each partition the same multiset, the spill
    counters move alike, and unregister deletes the files."""
    R, M, N = 8, 4, 500
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(M * 4):
        k = rng.integers(0, 1 << 31, size=N).astype(np.int64)
        batches.append((k, k.astype(np.float64).reshape(-1, 1) * 0.5
                        if with_values else None))
    jm = manager_factory(_spill_conf(tmp_path, "jax"))
    with _port(_spill_conf(tmp_path, "port")) as svc:
        out = {}
        for tag, mgr, mets in (("jax", jm, GLOBAL_METRICS),
                               ("port", svc.manager, svc.node.metrics)):
            before = (mets.get(C_SPILL_BYTES), mets.get(C_SPILL_COUNT))
            h = mgr.register_shuffle(1, M, R)
            for mid in range(M):
                w = mgr.get_writer(h, mid)
                for k, v in batches[mid * 4:(mid + 1) * 4]:
                    w.write(k, v)
                assert w._spill is not None, "the threshold must spill"
                w.commit(R)
            assert glob.glob(str(tmp_path / tag / "shuffle_1_map_*.keys"))
            res = mgr.read(h)
            out[tag] = ([_recs(*res.partition(r)) for r in range(R)],
                        _spill_delta(mets, before))
            mgr.unregister_shuffle(1)
            assert not glob.glob(str(tmp_path / tag / "shuffle_1_map_*"))
        assert out["port"][0] == out["jax"][0]
        assert out["port"][1] == out["jax"][1]
        assert out["port"][1][0] == M * 4 * N * (16 if with_values else 8)
        assert svc.node.pool.stats()["in_use_bytes"] == 0


def test_spill_pool_bounded_after_flush(manager_factory, tmp_path):
    """A writer far past the threshold holds at most one threshold of
    staging: every flush returns the buffers, so in_use_bytes is back at
    its floor (0) after the last one, in both packages."""
    R, N = 4, 2000
    keys = np.random.default_rng(3).integers(0, 1 << 31,
                                             size=N).astype(np.int64)
    jm = manager_factory(_spill_conf(tmp_path, "jax", "2k"))
    with _port(_spill_conf(tmp_path, "port", "2k")) as svc:
        for mgr in (jm, svc.manager):
            mgr.node.pool.reset_peak_bytes()
            h = mgr.register_shuffle(2, 1, R)
            w = mgr.get_writer(h, 0)
            for i in range(0, N, 250):
                w.write(keys[i:i + 250])
            st = mgr.node.pool.stats()
            assert st["in_use_bytes"] == 0
            # two 2,000-byte batches at most before each flush (the JAX
            # pool rounds each up to its 2 kB class)
            assert st["peak_bytes"] <= 2 * 2048
            w.commit(R)
            res = mgr.read(h)
            assert sum(res.partition(r)[0].size for r in range(R)) == N
            mgr.unregister_shuffle(2)


def test_no_spill_below_threshold(manager_factory, tmp_path):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 100, size=50).astype(np.int64)
    jm = manager_factory(_spill_conf(tmp_path, "jax", "1g"))
    with _port(_spill_conf(tmp_path, "port", "1g")) as svc:
        for mgr in (jm, svc.manager):
            h = mgr.register_shuffle(3, 1, 4)
            w = mgr.get_writer(h, 0)
            w.write(keys)
            assert w._spill is None
            w.commit(4)
            assert sum(mgr.read(h).partition(r)[0].size
                       for r in range(4)) == 50
            mgr.unregister_shuffle(3)
        assert not os.path.exists(tmp_path / "port")


def test_spill_mixed_schema_rejected(manager_factory, tmp_path):
    jm = manager_factory(_spill_conf(tmp_path, "jax"))
    with _port(_spill_conf(tmp_path, "port")) as svc:
        for mgr in (jm, svc.manager):
            h = mgr.register_shuffle(4, 1, 4)
            w = mgr.get_writer(h, 0)
            w.write(np.arange(8, dtype=np.int64),
                    np.ones((8, 2), dtype=np.float32))
            with pytest.raises(ValueError, match="mixed value schema"):
                w.write(np.arange(8, dtype=np.int64),
                        np.ones((8, 3), dtype=np.float32))
            with pytest.raises(ValueError, match="with and without"):
                w.write(np.arange(8, dtype=np.int64))
            mgr.unregister_shuffle(4)


def test_spill_truncation_raises_typed_naming_file(tmp_path):
    """A sealed file shorter than its sidecar declares raises the typed
    error, naming the file, before anything is mapped."""
    with _port(_spill_conf(tmp_path, "port", "1k")) as svc:
        m = svc.manager
        h = m.register_shuffle(30, 1, 4)
        w = m.get_writer(h, 0)
        keys = np.random.default_rng(1).integers(0, 1 << 31,
                                                 size=800).astype(np.int64)
        w.write(keys, keys.astype(np.float64).reshape(-1, 1))
        w.commit(4)
        vals_path = w._spill.vals_path
        w._spill.drop_views()
        w._spill_views = None
        with open(vals_path, "r+b") as f:
            f.truncate(os.path.getsize(vals_path) - 512)
        with pytest.raises(TruncatedBlockError,
                           match="shuffle_30_map_0.vals"):
            w.materialize()
        m.unregister_shuffle(30)


def test_spill_seal_is_torn_write_proof(tmp_path):
    """Before the seal only ``*.tmp`` files exist; commit renames them
    under the final names with the sidecar; sealed files refuse appends;
    unregister deletes everything."""
    with _port(_spill_conf(tmp_path, "port", "1k")) as svc:
        m = svc.manager
        h = m.register_shuffle(31, 1, 4)
        w = m.get_writer(h, 0)
        keys = np.random.default_rng(2).integers(0, 1 << 31,
                                                 size=800).astype(np.int64)
        w.write(keys)
        stem = str(tmp_path / "port" / "shuffle_31_map_0")
        assert os.path.exists(stem + ".keys.tmp")
        assert not os.path.exists(stem + ".keys")
        w.commit(4)
        assert os.path.exists(stem + ".keys")
        assert not os.path.exists(stem + ".keys.tmp")
        assert os.path.exists(stem + ".index")
        with pytest.raises(RuntimeError, match="sealed"):
            w._spill.append(keys, None)
        m.unregister_shuffle(31)
        assert not glob.glob(stem + "*")


def test_spill_valve_and_rows_count_spilled(tmp_path):
    """``spill()`` moves what is staged and returns its bytes (0 when
    nothing is staged); ``num_rows`` counts the spilled rows too."""
    with _port(_spill_conf(tmp_path, "port", "1g")) as svc:
        m = svc.manager
        h = m.register_shuffle(32, 1, 4)
        w = m.get_writer(h, 0)
        w.write(np.arange(100, dtype=np.int64),
                np.ones((100, 3), dtype=np.int32))
        assert svc.node.pool.stats()["in_use_bytes"] >= 100 * 20
        assert w.spill() == 100 * 20
        assert w.spill() == 0
        assert svc.node.pool.stats()["in_use_bytes"] == 0
        w.write(np.arange(10, dtype=np.int64),
                np.ones((10, 3), dtype=np.int32))
        assert w.num_rows == 110
        w.commit(4)
        k, v = w.materialize()
        assert isinstance(k, np.memmap) or isinstance(k.base, np.memmap)
        assert k.shape == (110,) and v.shape == (110, 3)
        with pytest.raises(RuntimeError, match="committed"):
            w.spill()
        assert svc.node.metrics.get(C_SPILL_COUNT) == 2
        m.unregister_shuffle(32)


def test_pool_accounting_matches_jax_pool():
    """One get/put sequence on both pools: the same in-use and peak bytes
    after every step, ``reset_peak_bytes`` returns the prior peak, and a
    second put of one buffer raises without moving the count."""
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.runtime.memory import HostMemoryPool
    jp = HostMemoryPool(TpuShuffleConf(
        {"spark.shuffle.tpu.memory.minBufferSize": "1k",
         "spark.shuffle.tpu.memory.minAllocationSize": "64k"},
        use_env=False))
    tp = HostStagingPool(pinned=False)
    held = {}

    def both(op, name, size=None):
        if op == "get":
            held[name] = (jp.get(size), tp.get(size))
        else:
            jb, tb = held[name]
            jp.put(jb)
            tp.put(tb)
        js, ts = jp.stats(), tp.stats()
        assert (ts["in_use_bytes"], ts["peak_bytes"]) == \
            (js["in_use_bytes"], js["peak_bytes"]), (op, name)

    try:
        both("get", "a", 4096)
        both("get", "b", 1024)
        both("get", "c", 2048)
        both("put", "a")
        assert tp.reset_peak_bytes() == jp.reset_peak_bytes() == 7168
        assert tp.stats()["peak_bytes"] == jp.stats()["peak_bytes"] == 3072
        both("get", "d", 4096)            # reuses a's block on both
        both("put", "b")
        jb, tb = held["b"]
        with pytest.raises(ValueError):
            jp.put(jb)
        with pytest.raises(ValueError):
            tp.put(tb)
        assert tp.stats()["in_use_bytes"] == jp.stats()["in_use_bytes"] \
            == 6144
        both("put", "c")
        both("put", "d")
        assert tp.stats()["in_use_bytes"] == 0
        assert tp.reset_peak_bytes() == jp.reset_peak_bytes() == 7168
    finally:
        jp.close()
        tp.close()


def test_pool_free_list_bounded():
    """Past ``max_free_bytes`` a ``put`` drops the longest-free buffers;
    the in-use and peak bytes move as without the bound, and a later
    ``get`` reuses what was kept. (The 1000 B request gets the pool's
    1 KiB floor, ``memory.minBufferSize``'s default.)"""
    pool = HostStagingPool(pinned=False)
    pool.max_free_bytes = 6000
    bufs = [pool.get(n) for n in (4000, 1000, 2000, 1500)]
    assert pool.stats()["peak_bytes"] == 8524
    for b in bufs:
        pool.put(b)
        st = pool.stats()
        assert st["free_bytes"] <= 6000
        assert st["free_bytes"] == sum(x.numel() for x in pool._free)
    # the 4000 B buffer, freed first, went when the third put passed 6000
    assert sorted(x.numel() for x in pool._free) == [1024, 1500, 2000]
    assert pool.stats()["in_use_bytes"] == 0
    assert pool.stats()["peak_bytes"] == 8524
    again = pool.get(1800)                  # the 2000 B buffer, reused
    assert again.numel() == 2000 and pool.stats()["free_bytes"] == 2524
    pool.put(again)
    pool.close()
    assert pool.stats()["free_bytes"] == 0


# -- admission (a2a.maxBytesInFlight) ----------------------------------------

def _stage(mgr, sid, keys, maps=2, R=8):
    h = mgr.register_shuffle(sid, maps, R)
    for mid, part in enumerate(np.array_split(keys, maps)):
        w = mgr.get_writer(h, mid)
        w.write(part)
        w.commit(R)
    return h


def _all_keys(res, R=8):
    return np.sort(np.concatenate([res.partition(r)[0] for r in range(R)]))


def test_max_bytes_in_flight_queues_and_completes():
    """Three pipelined submits under a cap of about one exchange: later
    submits are deferred (``done()`` False, nothing dispatched) and
    complete, in order, once earlier results release."""
    rng = np.random.default_rng(0)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "200k"}) as svc:
        m = svc.manager
        pendings, expected = [], {}
        for sid in range(3):
            keys = rng.integers(0, 1 << 40, size=2000).astype(np.int64)
            expected[sid] = np.sort(keys)
            pendings.append(m.submit(_stage(m, sid, keys)))
        assert any(not p.done() for p in pendings[1:])
        assert m._inflight_bytes > 0
        for sid, p in enumerate(pendings):
            np.testing.assert_array_equal(_all_keys(p.result()),
                                          expected[sid])
        assert m._inflight_bytes == 0
        waits = [m.report(sid).admit_wait_ms for sid in range(3)]
        assert waits[0] == 0.0 and max(waits[1:]) > 0.0


def test_max_bytes_in_flight_single_big_exchange_admitted():
    """An exchange larger than the cap runs when nothing else is in
    flight: the cap is backpressure, not a rejection."""
    keys = np.random.default_rng(1).integers(0, 1 << 40,
                                             size=5000).astype(np.int64)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1k"}) as svc:
        m = svc.manager
        res = m.read(_stage(m, 7, keys, maps=1, R=4))
        np.testing.assert_array_equal(_all_keys(res, 4), np.sort(keys))
        assert m._inflight_bytes == 0


def test_max_bytes_in_flight_fifo_no_starvation():
    """A later submit does not take capacity freed for an earlier
    deferred one: resolving in submit order completes without a
    timeout."""
    rng = np.random.default_rng(2)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "200k"}) as svc:
        m = svc.manager

        def make(sid):
            keys = rng.integers(0, 1 << 40, size=2000).astype(np.int64)
            return keys, m.submit(_stage(m, sid, keys, maps=1))

        ka, pa = make(0)
        kb, pb = make(1)
        assert not pb.done()
        ra = pa.result()
        kc, pc = make(2)
        assert not pc.done()
        for keys, res in ((ka, ra), (kb, pb.result()), (kc, pc.result())):
            np.testing.assert_array_equal(_all_keys(res), np.sort(keys))
        assert m._inflight_bytes == 0 and not m._admit_queue


def test_deferred_submit_times_out_with_reason():
    """A deferred exchange whose capacity never frees raises
    ``TimeoutError`` naming the cap."""
    rng = np.random.default_rng(4)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1k"}) as svc:
        m = svc.manager
        held = m.read(_stage(m, 0, rng.integers(0, 1 << 40, 500)),
                      sink="device")
        p = m.submit(_stage(m, 1, rng.integers(0, 1 << 40, 500)),
                     timeout=0.2)
        assert not p.done()
        with pytest.raises(TimeoutError, match="a2a.maxBytesInFlight"):
            p.result()
        assert not m._admit_queue
        held.close()
        assert m._inflight_bytes == 0


@pytest.mark.parametrize("sink,waved", [("host", False), ("device", False),
                                        ("host", True), ("device", True)])
def test_reservation_matches_jax_footprint(manager_factory, sink, waved):
    """The same read reserves the same bytes in both packages: pinned
    stage + device buffers for a single-shot read; ``depth`` pack blocks
    plus ``depth`` (host sink) or every (device sink) wave's device
    buffers for a waved read. A device-sink reservation holds until the
    result is consumed."""
    conf = {"spark.shuffle.tpu.a2a.maxBytesInFlight": "1g"}
    if waved:
        conf["spark.shuffle.tpu.a2a.waveRows"] = "64"
    keys = np.random.default_rng(6).integers(0, 1 << 40,
                                             size=3000).astype(np.int64)
    jm = manager_factory(conf)
    with _port(conf) as svc:
        held = {}
        for tag, mgr in (("jax", jm), ("port", svc.manager)):
            h = _stage(mgr, 11, keys, maps=4)
            if sink == "host" and not waved:
                pend = mgr.submit(h)
                held[tag] = mgr._inflight_bytes
                pend.result()
            else:
                res = mgr.read(h, sink=sink)
                held[tag] = mgr._inflight_bytes
                if sink == "device":
                    res.consume(lambda c, rows, nv: None)
            assert mgr._inflight_bytes == 0
            if waved:
                assert mgr.report(11).waves > 1
            mgr.unregister_shuffle(11)
        if sink == "host" and waved:
            assert held == {"jax": 0, "port": 0}     # released at drain
        else:
            assert held["port"] == held["jax"] > 0


def test_admission_hbm_residency_released_on_consume_and_close():
    keys = np.random.default_rng(8).integers(0, 1 << 40, 3000)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1g"}) as svc:
        m = svc.manager
        h = _stage(m, 12, keys)
        res = m.read(h, sink="device")
        assert m._inflight_bytes > 0
        res.consume(lambda c, rows, nv: None)
        assert m._inflight_bytes == 0
        res2 = m.read(h, sink="device")
        assert m._inflight_bytes > 0
        res2.close()
        assert m._inflight_bytes == 0


def test_host_view_drain_releases_admission():
    """The live ``host_view()`` drain takes over the device-sink release:
    once every shard is on the host the reservation frees, and a later
    close does not release twice."""
    keys = np.random.default_rng(9).integers(0, 1 << 40, 3000)
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1g"}) as svc:
        m = svc.manager
        res = m.read(_stage(m, 13, keys), sink="device")
        assert m._inflight_bytes > 0
        for _r, _kv in res.host_view().partitions():
            pass
        assert m._inflight_bytes == 0
        res.close()
        assert m._inflight_bytes == 0
