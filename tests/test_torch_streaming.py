"""Port parity for the streaming read plane: ``partitions_ready()`` on
every result class and the lazy result's per-shard pulls — counterparts
of ``tests/test_manager.py::test_partitions_ready_arrival_order`` (and
the full scan before it), ``tests/test_waves.py:128-131``,
``tests/test_device_sink.py:547-548`` and the shared result of
``tests/test_tenancy.py:798``.

The JAX side runs on its ``manager_factory`` (8 virtual CPU devices,
``a2a.impl=dense``), the port on ``connect(device="cpu")`` (8 logical
shards) from the same seeded numpy inputs; each case compares partition
ids, their order where the contract fixes one, and every partition's
(key, value) multiset.

On the CPU a shard's "copy" is a view that lands at once, so a slow
shard is made through the seams each package's iterator waits through:
the reference's ``_shard_dev`` (a device array whose completion wait
blocks) and the port's ``_shard_transfer`` (a copy whose ``query()`` is
False and whose ``synchronize()`` blocks).

One divergence is kept on purpose (C.9): the port's device-sink partial
view of a distributed read walks only its own shards, where the
reference's raises ``KeyError("shard s not addressable here")`` at the
first shard another process owns."""

import sys
import threading
import time

import numpy as np
import pytest

import torch_cluster_jobs as jobs
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.cluster import run_cluster
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.parallel.mesh import local_shard_ids
from sparkucx_tpu_torch.shuffle import reader as treader

SHARDS = 8
IMPLS = ["dense", "pallas"]


@pytest.fixture()
def port_factory():
    made = []

    def make(overrides=None, impl="dense"):
        svc = connect({"spark.shuffle.tpu.a2a.impl": impl,
                       **(overrides or {})}, device="cpu",
                      num_shards=SHARDS, use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


def _stage(mgr, sid: int, maps: int = 4, parts: int = 16, rows: int = 200,
           seed: int = 0):
    """``maps`` maps of int64 keys with an int32 value lane derived from
    them, so a row's value names its key."""
    rng = np.random.default_rng(seed)
    h = mgr.register_shuffle(sid, maps, parts)
    for m in range(maps):
        k = rng.integers(0, 1 << 31, size=rows).astype(np.int64)
        w = mgr.get_writer(h, m)
        w.write(k, (k % 1000).astype(np.int32).reshape(-1, 1))
        w.commit(parts)
    return h


def _rows(k, v) -> list:
    return sorted(zip(np.asarray(k).tolist(),
                      map(tuple, np.asarray(v).reshape(len(k), -1)
                          .tolist())))


def _walk(it) -> tuple:
    """(order, {r: sorted rows}) of an iterator of (r, (keys, values))."""
    order, got = [], {}
    for r, (k, v) in it:
        order.append(r)
        got[r] = _rows(k, v)
    return order, got


class _SlowCopy:
    """A shard copy that has not landed until ``release`` is set."""

    def __init__(self, release: threading.Event, timed_out: list):
        self._release = release
        self._timed_out = timed_out

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        # runs in the iterator's waiter thread, where a raise is swallowed:
        # record a timeout for the main thread instead
        if not self._release.wait(timeout=30):
            self._timed_out.append(True)


class _SlowDev:
    """The reference test's slow device array (tests/test_manager.py)."""

    def __init__(self, real, release, timed_out):
        self._real, self.shape = real, real.shape
        self._release, self._timed_out = release, timed_out

    def is_ready(self):
        return False

    def block_until_ready(self):
        if not self._release.wait(timeout=30):
            self._timed_out.append(True)
        return self

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._real)


def _arrival(res, slow: threading.Event) -> tuple:
    """Walk ``partitions_ready`` releasing the slow shard once shard 1's
    first partition came out."""
    order, got = [], {}
    for r, (k, v) in res.partitions_ready(poll_s=0.001):
        if int(res._part_to_shard[r]) == 1:
            slow.set()
        order.append(r)
        got[r] = _rows(k, v)
    return order, got


@pytest.mark.parametrize("impl", IMPLS)
def test_partitions_ready_arrival_order(manager_factory, port_factory, impl):
    """Shard 0 made slow: its partitions come last on both sides, every
    partition arrives exactly once, and each partition's rows equal the
    reference's."""
    R = 16
    seen = []
    for side in ("jax", "port"):
        mgr = manager_factory() if side == "jax" \
            else port_factory(impl=impl)
        res = mgr.read(_stage(mgr, 975, parts=R))
        slow, timed_out = threading.Event(), []
        if side == "jax":
            real = res._shard_dev
            res._shard_dev = lambda s: _SlowDev(real(s), slow, timed_out) \
                if s == 0 else real(s)
        else:
            assert isinstance(res, treader.LazyShuffleReaderResult)
            real = res._shard_transfer
            res._shard_transfer = lambda s: (real(s), _SlowCopy(
                slow, timed_out))[1] if s == 0 else real(s)
        order, got = _arrival(res, slow)
        assert not timed_out, f"{side}: the consumer never reached shard 1"
        assert sorted(order) == list(range(R)), "every partition once"
        slow_rs = np.nonzero(np.asarray(res._part_to_shard) == 0)[0]
        assert order[-len(slow_rs):] == slow_rs.tolist(), order
        seen.append(got)
        mgr.unregister_shuffle(975)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("impl", IMPLS)
def test_shard_pulls_drop_device_rows_with_the_last(manager_factory,
                                                    port_factory, impl):
    """``partition(0)`` pulls shard 0 alone; the device rows drop, and the
    device-free hook fires once, when the last shard lands — as the
    reference drops its buffers after a full scan. A repeat read is
    host slicing."""
    R = 16
    seen = []
    for side in ("jax", "port"):
        mgr = manager_factory() if side == "jax" \
            else port_factory(impl=impl)
        res = mgr.read(_stage(mgr, 961, parts=R, seed=3))
        freed = []
        res._on_device_free = lambda: freed.append(1)
        res.partition(0)
        assert res._rows_dev is not None and list(res._shards) == [0]
        first = [_rows(*res.partition(r)) for r in range(R)]
        assert res._rows_dev is None and freed == [1]
        assert [_rows(*res.partition(r)) for r in range(R)] == first
        order, _ = _walk(res.partitions_ready())
        assert order == list(range(R))
        assert freed == [1]
        seen.append(first)
        mgr.unregister_shuffle(961)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("impl", IMPLS)
def test_device_rows_unreferenced_when_the_free_hook_fires(port_factory,
                                                           impl):
    """Each copy made as on the card (a block of its own, and the device
    rows it reads kept in the copy): when the device-free hook fires
    under ``partitions_ready()``, whose copies the iterator still holds,
    nothing references the rows any more."""
    import gc
    import weakref
    mgr = port_factory(impl=impl)
    res = mgr.read(_stage(mgr, 963, seed=5))
    rows = weakref.ref(res._rows_dev)
    real = res._shard_transfer

    def as_on_card(shard):
        j = res._ordinal(shard)
        with res._lock:
            fresh = j not in res._copies and j not in res._shards
            dev = res._rows_dev
        copy = real(shard)
        if fresh:
            copy.host, copy.src = np.array(copy.host), dev[j]
        return copy

    alive = []

    def freed():
        gc.collect()
        alive.append(rows() is not None)

    res._shard_transfer, res._on_device_free = as_on_card, freed
    order, _ = _walk(res.partitions_ready())
    assert sorted(order) == list(range(16)) and alive == [False]
    mgr.unregister_shuffle(963)


def _count_copies(monkeypatch) -> list:
    """Every shard copy the port makes from now on appends to the list."""
    issued = []
    real = treader._ShardCopy.__init__

    def count(self, *a, **kw):
        issued.append(1)
        real(self, *a, **kw)

    monkeypatch.setattr(treader._ShardCopy, "__init__", count)
    return issued


def test_materialize_pulls_every_shard_once(port_factory, monkeypatch):
    """The drain-all (a waved read's drain, a distributed host view's
    settle) after a partial touch: one copy per shard, the touched one
    not again."""
    mgr = port_factory()
    res = mgr.read(_stage(mgr, 962))
    res.partition(0)
    issued = _count_copies(monkeypatch)
    res._materialize()
    res._materialize()
    assert len(issued) == SHARDS - 1
    assert sorted(res._shards) == list(range(SHARDS))
    assert res._rows_dev is None and not res._copies
    mgr.unregister_shuffle(962)


def test_waved_result_is_index_order(manager_factory, port_factory):
    """A waved host read is on the host when it returns: both packages
    yield index order, with the same rows."""
    conf = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.a2a.waveRows": "64"}
    seen = []
    for mgr in (manager_factory(conf), port_factory(conf)):
        res = mgr.read(_stage(mgr, 963, maps=4, parts=16, rows=400, seed=4))
        assert res.waves >= 2
        order, got = _walk(res.partitions_ready())
        assert order == sorted(set(order)) == list(range(16))
        seen.append(got)
        mgr.unregister_shuffle(963)
    assert seen[0] == seen[1]


def test_device_sink_fails_closed(manager_factory, port_factory):
    """A device-sink result raises the same ``RuntimeError`` as its
    ``partition()``, naming ``consume``."""
    conf = {"spark.shuffle.tpu.read.sink": "device"}
    for mgr in (manager_factory(conf), port_factory(conf)):
        res = mgr.read(_stage(mgr, 964, seed=5))
        with pytest.raises(RuntimeError, match="consume"):
            list(res.partitions_ready())
        res.close()
        mgr.unregister_shuffle(964)


def test_partition_granularity_is_index_order(manager_factory,
                                              port_factory):
    """``io.fetchGranularity=partition`` pulls per partition on demand:
    index order on both sides, and the port pulls no shard."""
    conf = {"spark.shuffle.tpu.io.fetchGranularity": "partition"}
    seen = []
    for mgr in (manager_factory(conf), port_factory(conf)):
        res = mgr.read(_stage(mgr, 965, seed=6))
        assert res.fetch_granularity == "partition"
        order, got = _walk(res.partitions_ready())
        assert order == list(range(16))
        if isinstance(res, treader.LazyShuffleReaderResult):
            assert not res._shards and res._rows_dev is None
        seen.append(got)
        mgr.unregister_shuffle(965)
    assert seen[0] == seen[1]


def test_shared_v2_result_under_concurrent_readers(mesh8, tmp_path,
                                                   monkeypatch):
    """One compat v2 shared result read by threads at once: two in
    ``partitions_ready()``, two walking ``partition(r)`` in reverse, for
    several reads, each shard's copy taking 2 ms to land; every shard is
    pulled once per read and every thread sees the reference's rows."""
    from sparkucx_tpu.compat.v2 import ShuffleDependency as JDep
    from sparkucx_tpu.compat.v2 import ShuffleServiceV2 as JV2
    from sparkucx_tpu_torch.compat.v2 import ShuffleDependency as TDep
    from sparkucx_tpu_torch.compat.v2 import ShuffleServiceV2 as TV2
    import sparkucx_tpu
    import sparkucx_tpu_torch
    R, M = 16, 4
    base = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.compat.version": "v2",
            "spark.shuffle.tpu.io.format": "raw"}

    def stage(svc, Dep, sid, seed):
        h = svc.register(Dep(sid, M, R))
        rng = np.random.default_rng(seed)
        for m in range(M):
            w = svc.writer(h, m)
            k = rng.integers(0, 1 << 31, size=300).astype(np.int64)
            w.write(k, (k % 1000).astype(np.int32).reshape(-1, 1))
            w.commit()
        return h

    with sparkucx_tpu.connect({**base, "spark.shuffle.tpu.spill.dir":
                               str(tmp_path / "jax")},
                              use_env=False) as svc:
        assert isinstance(svc, JV2)
        want = [{r: _rows(*kv) for r, kv in svc.reader(
            stage(svc, JDep, 70 + i, i)).batch().items()} for i in range(3)]

    issued = _count_copies(monkeypatch)
    # a card copy's wait, so that readers meet on one shard's copy
    monkeypatch.setattr(treader._ShardCopy, "synchronize",
                        lambda self: time.sleep(0.002))
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with sparkucx_tpu_torch.connect({**base,
                                         "spark.shuffle.tpu.spill.dir":
                                         str(tmp_path / "port")},
                                        device="cpu",
                                        num_shards=SHARDS,
                                        use_env=False) as svc:
            assert isinstance(svc, TV2)
            for i in range(3):
                h = stage(svc, TDep, 70 + i, i)
                res = svc.reader(h)._result()
                assert svc.reader(h, 3, 4)._result() is res   # shared
                issued.clear()
                outs, errs = [None] * 4, []

                def ready(slot):
                    try:
                        outs[slot] = _walk(res.partitions_ready())[1]
                    except Exception as e:       # reported below
                        errs.append(repr(e))

                def walk(slot):
                    try:
                        outs[slot] = {r: _rows(*res.partition(r))
                                      for r in reversed(range(R))}
                    except Exception as e:       # reported below
                        errs.append(repr(e))

                threads = [threading.Thread(target=f, args=(n,))
                           for n, f in enumerate((ready, walk, ready, walk))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
                assert not errs, errs
                assert len(issued) == SHARDS, "a shard was pulled twice"
                assert res._rows_dev is None and not res._copies
                for got in outs:
                    assert got == want[i]
                svc.unregister(70 + i)
    finally:
        sys.setswitchinterval(old_switch)


# -- the distributed partial views (divergence C.9) --------------------------
@pytest.fixture(scope="module")
def stream_world():
    run = run_cluster("torch_cluster_jobs:streaming_suite", 2, SHARDS,
                      device="cpu", timeout_s=240)
    assert run.returncodes == [0, 0]
    return run.results


def test_partial_views_yield_their_own_partitions(stream_world,
                                                  manager_factory):
    """Each process's host-sink and device-sink partial views yield every
    partition on its own shards exactly once (the device sink's pulled
    shard by shard as the iterator goes, no D2H before it), and the two
    processes together hold the reference's single-process read."""
    mgr = manager_factory()
    h = jobs.write(mgr, 1, jobs.float_maps(), range(jobs.MAPS))
    want = {r: _rows(*kv) for r, kv in mgr.read(h).partitions()}
    mgr.unregister_shuffle(1)
    p2s = blocked_partition_map(jobs.R, SHARDS)
    merged = {}
    for res in stream_world:
        mine = set(local_shard_ids(SHARDS, 2, res["rank"]))
        local = [r for r in range(jobs.R) if p2s[r] in mine]
        assert res["host_order"] == local
        assert sorted(res["device_order"]) == local
        assert res["device_d2h_before"] == 0
        assert res["device_shards_pulled"] == len(mine)
        for key in ("host", "device"):
            for r, (k, v) in res[key].items():
                kk = np.frombuffer(bytes.fromhex(k), np.int64)
                vv = np.frombuffer(bytes.fromhex(v), np.float32)
                merged.setdefault(key, {})[int(r)] = _rows(kk, vv.reshape(
                    len(kk), jobs.VW))
    assert merged["host"] == merged["device"] == want


def test_reference_device_partial_view_raises_on_a_foreign_shard(
        manager_factory):
    """C.9, the reference's side: its lazy view walks every shard, so a
    process whose addressable shards are 4-7 (``_shard_dev`` None for the
    others, as ``addressable_shards`` gives it there) raises at shard 0.
    The port's partial view yields its own shards' partitions instead
    (the test above)."""
    mgr = manager_factory()
    h = jobs.write(mgr, 1, jobs.float_maps(), range(jobs.MAPS))
    res = mgr.read(h)
    real = res._shard_dev
    res._shard_dev = lambda s: real(s) if s >= 4 else None
    with pytest.raises(KeyError, match="shard 0 not addressable here"):
        list(res.partitions_ready())
    mgr.unregister_shuffle(1)
