"""Port parity for the device sink (``read.sink`` / ``read(sink=)``): the
JAX ``TpuShuffleManager`` on 8 virtual CPU devices against the port
through ``connect(..., device="cpu")`` with 8 logical shards, on the same
seeded map outputs.

Exact: the sink resolution table (including the counted fallback when
the conf pins the host), the single-consumer contract of the device
result, the per-wave totals ``consume`` hands over, and the partitions a
device read serves through ``host_view()``: multisets for plain reads,
key sequences for ordered and combine reads (which waved reads fold on
the device, ``reader.device_merge_fold``), int32 sums."""

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.ops.partition import ReservoirSampler
from sparkucx_tpu_torch.shuffle.reader import (DeviceShuffleReaderResult,
                                               LazyShuffleReaderResult)
from sparkucx_tpu_torch.utils.metrics import C_SINK_FALLBACK, labeled

N_SHARDS = 8
M = 12


def _maps(seed, key_space=1 << 40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(M):
        n = int(rng.integers(300, 600))
        k = rng.integers(-key_space, key_space, n).astype(np.int64) * 7919
        v = rng.integers(-(1 << 31), 1 << 31, (n, 3)).astype(np.int32)
        out.append((k, v))
    return out


def _stage(mgr, sid, maps, R, partitioner="hash", bounds=None):
    h = mgr.register_shuffle(sid, len(maps), R, partitioner, bounds=bounds)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        w.write(k, v)
        w.commit(R)
    return h


def _port(conf):
    c = {"spark.shuffle.tpu.a2a.impl": "dense"}
    c.update(conf)
    return connect(c, device="cpu", num_shards=N_SHARDS, use_env=False)


def _recs(k, v):
    return sorted(zip(k.tolist(), map(bytes, v)))


@pytest.mark.parametrize("conf_sink", ["auto", "host", "device"])
def test_sink_resolution_matches_reference(manager_factory, conf_sink):
    conf = {"spark.shuffle.tpu.read.sink": conf_sink}
    jm = manager_factory(conf)
    with _port(conf) as svc:
        tm = svc.manager
        for ask in (None, "auto", "host", "device"):
            for combine, ordered in ((None, False), (None, True),
                                     ("sum", False)):
                assert tm._resolve_sink(ask, combine, ordered) == \
                    jm._resolve_sink(ask, combine, ordered), (ask, ordered)
        for mode in ("plain", "ordered", "combine"):
            key = labeled(C_SINK_FALLBACK, mode=mode,
                          reason="conf_pins_host")
            assert svc.node.metrics.get(key) == jm.node.metrics.get(key)
        assert svc.node.metrics.get(C_SINK_FALLBACK) == \
            jm.node.metrics.get(C_SINK_FALLBACK) == \
            (3.0 if conf_sink == "host" else 0.0)
        with pytest.raises(ValueError):
            tm._resolve_sink("hbm")
        with pytest.raises(ValueError):
            jm._resolve_sink("hbm")


@pytest.mark.parametrize("mode", ["plain", "ordered", "combine"])
def test_single_shot_device_read_serves_host_partitions(manager_factory,
                                                        mode):
    """One wave: the device result holds the exchange step's own output;
    ``host_view()`` serves what the host read serves, and no payload left
    the device before it."""
    R = 10
    maps = _maps(30 + len(mode), key_space=50 if mode == "combine"
                 else 1 << 40)
    kw = {"combine": "sum"} if mode == "combine" else (
        {"ordered": True} if mode == "ordered" else {})
    jm = manager_factory({})
    h = _stage(jm, 930, maps, R)
    want = [jm.read(h, sink="host", **kw).partition(r) for r in range(R)]
    with _port({}) as svc:
        th = _stage(svc.manager, 930, maps, R)
        res = svc.read(th, sink="device", **kw)
        rep = svc.report(930)
        assert isinstance(res, DeviceShuffleReaderResult)
        assert res.waves == 1 and rep.sink == "device"
        assert rep.d2h_bytes == 0 and rep.merge_ms == 0.0
        assert tuple(res.device_rows().shape[:1]) == (N_SHARDS,)
        assert int(res.device_totals().sum()) == sum(
            want[r][0].size for r in range(R))
        hv = res.host_view()
        assert isinstance(hv, LazyShuffleReaderResult)
        got = [hv.partition(r) for r in range(R)]
    for r in range(R):
        if mode == "plain":
            assert _recs(*got[r]) == _recs(*want[r]), f"partition {r}"
        else:
            np.testing.assert_array_equal(got[r][0], want[r][0])
            assert _recs(*got[r]) == _recs(*want[r]), f"partition {r}"


def test_consume_runs_in_wave_order_once(manager_factory):
    """A waved plain device read hands every wave over in order, with
    totals equal to the report's per-wave rows (as in the reference);
    the result is then spent, and partition() fails closed throughout."""
    conf = {"spark.shuffle.tpu.a2a.waveRows": "150"}
    maps = _maps(40)
    jm = manager_factory(conf)
    jres = jm.read(_stage(jm, 931, maps, 8), sink="device")
    jrep = jm.report(931)
    with _port(conf) as svc:
        res = svc.read(_stage(svc.manager, 931, maps, 8), sink="device")
        rep = svc.report(931)
        assert res.waves == rep.waves == jres.waves >= 3
        with pytest.raises(RuntimeError, match="consume"):
            res.partition(0)
        with pytest.raises(RuntimeError, match="consume"):
            res.partitions()
        seen, outs = [], []

        def fold(carry, rows, totals):
            assert res.wave_views()[len(seen)]._rows_dev is None
            seen.append(int(totals.sum()))
            outs.append(rows)
            return (carry or 0) + 1

        assert res.consume(fold) == res.waves
        assert seen == [int(x) for x in rep.wave_payload_rows] == \
            [int(x) for x in jrep.wave_payload_rows]
        assert rep.d2h_bytes == 0
        for call in (lambda: res.consume(fold), res.host_view,
                     res.device_rows, res.device_totals):
            with pytest.raises(RuntimeError, match="consumed"):
                call()
        # the consumer's rows read back through the waves' run indexes
        hv = res.host_view(wave_rows=outs)
        got = [hv.partition(r) for r in range(8)]
    keys = np.concatenate([k for k, _ in maps])
    assert sum(k.size for k, _ in got) == keys.size
    assert sorted(np.concatenate([k for k, _ in got]).tolist()) == \
        sorted(keys.tolist())


def test_close_drops_the_device_result():
    with _port({}) as svc:
        res = svc.read(_stage(svc.manager, 932, _maps(41), 4),
                       sink="device")
        res.close()
        with pytest.raises(RuntimeError, match="consumed"):
            res.consume(lambda c, rows, nv: None)


@pytest.mark.parametrize("merge", ["pallas", "jnp"])
@pytest.mark.parametrize("mode", ["ordered", "combine"])
def test_waved_device_fold_matches_reference(manager_factory, mode, merge):
    """A waved ordered or combine device read folds its waves on the
    device into one merged view: the same key sequences as the
    reference's ``device_merge_fold``, int32 sums exact, and no payload
    D2H until ``host_view()``."""
    R = 12
    maps = _maps(50 + len(mode) + len(merge),
                 key_space=120 if mode == "combine" else 1 << 40)
    bounds = None
    part = "hash"
    if mode == "ordered":
        s = ReservoirSampler(capacity=512, seed=4)
        for k, _ in maps:
            s.add(k)
        bounds, part = s.bounds(R), "range"
    conf = {"spark.shuffle.tpu.a2a.waveRows": "200",
            "spark.shuffle.tpu.read.mergeImpl": merge}
    kw = {"combine": "sum"} if mode == "combine" else {"ordered": True}
    jm = manager_factory(conf)
    jres = jm.read(_stage(jm, 933, maps, R, part, bounds), sink="device",
                   **kw)
    jrep = jm.report(933)
    want = [jres.host_view().partition(r) for r in range(R)]
    with _port(conf) as svc:
        res = svc.read(_stage(svc.manager, 933, maps, R, part, bounds),
                       sink="device", **kw)
        rep = svc.report(933)
        assert isinstance(res, DeviceShuffleReaderResult) and res.waves == 1
        assert rep.waves == jrep.waves >= 3 and rep.sink == "device"
        assert rep.merge_ms > 0 and rep.d2h_bytes == 0
        assert rep.kernel == jrep.kernel == merge
        hv = res.host_view()
        got = [hv.partition(r) for r in range(R)]
    for r in range(R):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        if mode == "combine":
            np.testing.assert_array_equal(got[r][1], want[r][1])
            assert (np.diff(got[r][0]) > 0).all()
        else:
            assert _recs(*got[r]) == _recs(*want[r]), f"partition {r}"
    if mode == "ordered":
        allk = np.concatenate([got[r][0] for r in range(R)])
        assert allk.size == sum(k.size for k, _ in maps)
        assert (np.diff(allk) >= 0).all()
