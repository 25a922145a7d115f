"""Port parity for the manager, service and pool surface: the
partition-range reader, the report ring and the staging queries, the
``memory.*`` pool keys, the pack executor's size and
``io.fetchGranularity`` — counterparts of
``tests/test_manager.py::test_read_partitions_range``,
``tests/test_device_sink.py`` (a device-sink conf still serves
``read_partitions`` on the host), ``tests/test_memory.py::
test_preallocate_and_stats`` and ``::test_non_pow2_min_buffer_size``.

The JAX side runs on its ``manager_factory`` (8 virtual CPU devices,
``a2a.impl=dense``) and its pure-Python pool; the port on
``connect(device="cpu")`` (8 logical shards, ``dense``). Each case
feeds both the same seeded keys and compares exactly: partition ids and
per-partition key multisets, report fields, exported staged arrays, pool
sizes and counts, and conf values and error texts."""

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime.node import HostStagingPool
from sparkucx_tpu_torch.shuffle import reader as treader


@pytest.fixture()
def port_factory():
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
    return lambda overrides=None: (manager_factory(overrides),
                                   port_factory(overrides))


def _stage(mgr, sid: int, maps: int = 2, parts: int = 8, rows: int = 300,
           seed: int = 1, commit=None):
    rng = np.random.default_rng(seed)
    h = mgr.register_shuffle(sid, maps, parts)
    for m in range(maps):
        k = rng.integers(0, 100, size=rows).astype(np.int64)
        w = mgr.get_writer(h, m)
        w.write(k, np.stack([k, k], axis=1).astype(np.int32))
        if commit is None or m in commit:
            w.commit(parts)
    return h


def test_read_partitions_range(managers):
    """Only ``[start, end)`` comes back, each partition equal to the full
    read's; a range past the partitions raises IndexError up front."""
    got = []
    for mgr in managers():
        h = _stage(mgr, 77)
        part = dict(mgr.read_partitions(h, 2, 5))
        full = mgr.read(h)
        assert sorted(part) == [2, 3, 4]
        for r in part:
            np.testing.assert_array_equal(np.sort(part[r][0]),
                                          np.sort(full.partition(r)[0]))
        with pytest.raises(IndexError):
            mgr.read_partitions(h, 5, 9)
        assert list(mgr.read_partitions(h, 3, 3)) == []
        got.append({r: np.sort(k).tolist() for r, (k, _) in part.items()})
        mgr.unregister_shuffle(77)
    assert got[0] == got[1]


def test_read_partitions_pins_the_host_sink(managers):
    for mgr in managers({"spark.shuffle.tpu.read.sink": "device"}):
        h = _stage(mgr, 78, seed=2)
        dev = mgr.read(h)
        assert type(dev).__name__ == "DeviceShuffleReaderResult"
        dev.close()
        out = list(mgr.read_partitions(h, 0, 4))
        assert [r for r, _ in out] == [0, 1, 2, 3]
        assert all(isinstance(k, np.ndarray) for _, (k, _) in out)
        assert mgr.report(78).sink == "host"
        mgr.unregister_shuffle(78)


def test_reports_ring_and_exchange_reports(managers):
    """``metrics.reportCapacity`` bounds the ring, oldest out first;
    ``exchange_reports()`` is its dict view."""
    got = []
    for mgr in managers({"spark.shuffle.tpu.metrics.reportCapacity": "2"}):
        for sid in (81, 82, 83):
            mgr.read(_stage(mgr, sid, seed=sid))
        reps = mgr.reports()
        dicts = mgr.exchange_reports()
        got.append(([r.shuffle_id for r in reps],
                    [(d["shuffle_id"], d["completed"], d["num_maps"],
                      d["payload_bytes"], d["wire_bytes"], d["replays"])
                     for d in dicts]))
        assert mgr.report(81) is None
        for sid in (81, 82, 83):
            mgr.unregister_shuffle(sid)
    assert got[0] == got[1]
    assert got[1][0] == [82, 83]


def test_live_writers_shuffles_and_export(managers):
    """``has_live_writer`` is true only for an uncommitted writer,
    ``live_shuffles`` lists the registered ids, ``export_shuffle`` copies
    every writer's staged arrays with its commit flag."""
    got = []
    for mgr in managers():
        h = _stage(mgr, 85, maps=3, rows=40, seed=5, commit={0, 2})
        _stage(mgr, 84, maps=1, rows=10, seed=6)
        live = [mgr.has_live_writer(85, m) for m in range(3)] + \
            [mgr.has_live_writer(84, 0), mgr.has_live_writer(99, 0)]
        ex = mgr.export_shuffle(85)
        with pytest.raises(KeyError):
            mgr.export_shuffle(99)
        got.append((live, mgr.live_shuffles(),
                    {m: (k.tolist(), v.tolist(), c)
                     for m, (k, v, c) in sorted(ex.items())}))
        mgr.unregister_shuffle(85)
        mgr.unregister_shuffle(84)
        assert mgr.live_shuffles() == []
        assert h.shuffle_id == 85
    assert got[0] == got[1]
    assert got[1][0] == [False, True, False, False, False]
    assert got[1][1] == [84, 85]


def test_export_copies_spilled_views(managers, tmp_path):
    """A spilled writer's export owns its bytes: it survives the
    shuffle's unregister (which deletes the files)."""
    got = []
    for i, mgr in enumerate(managers({
            "spark.shuffle.tpu.spill.threshold": "1k",
            "spark.shuffle.tpu.spill.dir": str(tmp_path / str(0))})):
        h = mgr.register_shuffle(86, 1, 4)
        w = mgr.get_writer(h, 0)
        w.write(np.arange(600, dtype=np.int64))
        w.commit(4)
        ex = mgr.export_shuffle(86)
        mgr.unregister_shuffle(86)
        got.append(ex[0][0].tolist())
    assert got[0] == got[1] == list(range(600))


def test_pool_preallocate_and_stats():
    """``test_memory.py::test_preallocate_and_stats`` on both pools, and
    the port's counts in full."""
    from sparkucx_tpu.runtime.memory import HostMemoryPool
    conf = {"spark.shuffle.tpu.memory.minBufferSize": "1k",
            "spark.shuffle.tpu.memory.minAllocationSize": "64k"}
    jp = HostMemoryPool(TpuShuffleConf(conf, use_env=False))
    tp = HostStagingPool(pinned=False,
                         conf=ShuffleConf(conf, use_env=False))
    try:
        for pool in (jp, tp):
            pool.preallocate(1024, 8)
            assert pool.stats()["preallocated"] >= 8
            a = pool.get(1024)
            assert pool.stats()["in_use"] == 1
            pool.put(a)
        st = tp.stats()
        assert (st["requests"], st["allocated"], st["preallocated"],
                st["in_use"], st["free"], st["free_bytes"]) == \
            (1, 8, 8, 0, 8, 8 * 1024)
        js = jp.stats()
        assert (js["in_use_bytes"], js["peak_bytes"]) == \
            (st["in_use_bytes"], st["peak_bytes"]) == (0, 1024)
    finally:
        jp.close()
        tp.close()


def test_pool_preallocates_small_buffers_from_slabs():
    """Below ``minAllocationSize`` preallocated buffers are carved from
    shared slabs of that size; above it each is its own allocation."""
    tp = HostStagingPool(pinned=False, conf=ShuffleConf(
        {"spark.shuffle.tpu.memory.minAllocationSize": "4k"},
        use_env=False))
    tp.preallocate(1024, 6)
    tp.preallocate(8192, 2)
    bases = {b.untyped_storage().data_ptr() for b in tp._free[:6]}
    assert len(bases) == 2                   # 4 + 2 buffers of 1 KiB
    assert [b.numel() for b in tp._free] == [1024] * 6 + [8192] * 2
    assert tp.stats()["preallocated"] == 8
    tp.close()


def test_pool_non_pow2_min_buffer_size():
    """A non-power-of-two floor rounds up as the reference's does."""
    from sparkucx_tpu.runtime.memory import HostMemoryPool
    conf = {"spark.shuffle.tpu.memory.minBufferSize": "1536"}
    jp = HostMemoryPool(TpuShuffleConf(conf, use_env=False))
    tp = HostStagingPool(pinned=False,
                         conf=ShuffleConf(conf, use_env=False))
    try:
        assert jp.min_block == tp.min_block == 2048
        jb, tb = jp.get(1600), tp.get(1600)
        assert jb.capacity == tb.numel() == 2048
        tb[:] = 1
        jp.put(jb)
        tp.put(tb)
    finally:
        jp.close()
        tp.close()


def test_node_preallocates_from_conf_and_unpinned_conf():
    conf = {"spark.shuffle.tpu.memory.preAllocateBuffers": "4k:3,1m:1",
            "spark.shuffle.tpu.memory.pinned": "false"}
    with connect(conf, device="cpu", use_env=False) as svc:
        st = svc.node.pool.stats()
        assert (st["preallocated"], st["free"],
                st["free_bytes"]) == (4, 4, 3 * 4096 + (1 << 20))
        assert not svc.node.pool.pinned
        svc.node.pool.put(svc.node.pool.get(1 << 20))
        assert svc.node.pool.stats()["allocated"] == 4


@pytest.mark.parametrize("keys", [
    {},
    {"spark.shuffle.tpu.memory.minBufferSize": "3000",
     "spark.shuffle.tpu.memory.minAllocationSize": "1m",
     "spark.shuffle.tpu.memory.preAllocateBuffers": "4k:2, 1m:3".replace(
         " ", ""),
     "spark.shuffle.tpu.memory.pinned": "off",
     "spark.shuffle.tpu.a2a.packThreads": "3",
     "spark.shuffle.tpu.coresPerProcess": "5",
     "spark.shuffle.tpu.io.fetchGranularity": "partition"}])
def test_surface_conf_keys_match_the_reference(keys):
    c, j = ShuffleConf(keys, use_env=False), TpuShuffleConf(keys,
                                                            use_env=False)
    for name in ("min_buffer_size", "min_allocation_size",
                 "pre_allocate_buffers", "pinned_memory", "pack_threads",
                 "cores_per_process", "fetch_granularity"):
        assert getattr(c, name) == getattr(j, name), name
    assert c.report_capacity == max(1, j.get_int("metrics.reportCapacity",
                                                 64))


@pytest.mark.parametrize("key,value,text", [
    ("memory.preAllocateBuffers", "4k", "entry '4k' is not 'size:count'"),
    ("a2a.packThreads", "-1", "packThreads=-1: want >= 0"),
    ("io.fetchGranularity", "block",
     "fetchGranularity='block': want shard|partition")])
def test_surface_conf_errors_match_the_reference(key, value, text):
    keys = {f"spark.shuffle.tpu.{key}": value}
    with pytest.raises(ValueError, match=text):
        ShuffleConf(keys, use_env=False)
    prop = {"memory.preAllocateBuffers": "pre_allocate_buffers",
            "a2a.packThreads": "pack_threads",
            "io.fetchGranularity": "fetch_granularity"}[key]
    with pytest.raises(ValueError, match=text):
        getattr(TpuShuffleConf(keys, use_env=False), prop)


@pytest.mark.parametrize("threads,cores,want", [("3", "5", 3), ("0", "5", 5),
                                                ("0", "1", 1)])
def test_pack_executor_is_sized_from_conf(port_factory, threads, cores,
                                          want):
    mgr = port_factory({"spark.shuffle.tpu.a2a.packThreads": threads,
                        "spark.shuffle.tpu.coresPerProcess": cores})
    assert mgr._executor()._max_workers == want


def test_report_capacity_from_conf(port_factory):
    mgr = port_factory({"spark.shuffle.tpu.metrics.reportCapacity": "0"})
    assert mgr._report_capacity == 1
    assert port_factory()._report_capacity == 64


@pytest.mark.parametrize("mode", [{}, {"combine": "sum"}, {"ordered": True}])
def test_partition_fetch_granularity(managers, mode):
    """``io.fetchGranularity=partition``: every partition equals the
    shard-granular read's (and the JAX package's under the same conf);
    the port's device rows are dropped only once every partition was
    fetched."""
    conf = {"spark.shuffle.tpu.io.fetchGranularity": "partition"}
    got = []
    for mgr in managers(conf):
        h = _stage(mgr, 87, maps=3, rows=200, seed=7)
        res = mgr.read(h, **mode)
        port = isinstance(res, treader.LazyShuffleReaderResult)
        assert res.fetch_granularity == "partition"
        if port:
            res.partition(0)
            assert res._rows_dev is not None and len(res._part_cache) == 1
        parts = {r: (k.tolist(), v.tolist()) for r, (k, v) in
                 res.partitions()}
        if port:
            assert res._rows_dev is None and not res._shards
        order = {r: sorted(zip(k, map(tuple, v)))
                 for r, (k, v) in parts.items()}
        got.append(order if not mode else parts)
        mgr.unregister_shuffle(87)
    assert got[0] == got[1]


def test_partition_granularity_matches_shard_granularity(port_factory):
    shard = port_factory()
    part = port_factory({"spark.shuffle.tpu.io.fetchGranularity":
                         "partition"})
    views = []
    for mgr in (shard, part):
        res = mgr.read(_stage(mgr, 88, maps=4, rows=500, seed=8))
        views.append({r: (k.tolist(), v.tolist())
                      for r, (k, v) in res.partitions()})
        mgr.unregister_shuffle(88)
    assert views[0] == views[1]
