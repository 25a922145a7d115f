"""Port parity for wave-pipelined host reads (``a2a.waveRows``): the JAX
``TpuShuffleManager`` on 8 virtual CPU devices against the port through
``connect(..., device="cpu")`` with 8 logical shards, both on
``a2a.impl=dense``, on the same seeded map outputs.

Exact: the wave split (``waves``, ``wave_payload_rows``, the wave plan's
capacities and wire bytes), plain partitions as (key, value) multisets,
ordered partitions' key sequences and multisets, int32 combine rows, and
which wave an overflow re-ran; plus the wave plan helpers and the conf
keys against the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.ops.partition import ReservoirSampler
from sparkucx_tpu_torch.shuffle import plan as tplan
from sparkucx_tpu_torch.shuffle.reader import WavedShuffleReaderResult
from sparkucx_tpu_torch.utils.metrics import H_WAVE_GAP

N_SHARDS = 8
M = 16


def _maps(seed, mode):
    rng = np.random.default_rng(seed)
    out = []
    for m in range(M):
        n = 0 if m == 3 else int(rng.integers(400, 700))
        space = 200 if mode == "combine" else 1 << 40
        k = rng.integers(-space, space, n).astype(np.int64) * 1_000_003
        v = rng.integers(-(1 << 31), 1 << 31, (n, 3)).astype(np.int32)
        out.append((k, v))
    return out


def _run(mgr, sid, maps, R, partitioner, bounds, **read_kw):
    h = mgr.register_shuffle(sid, len(maps), R, partitioner, bounds=bounds)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        if k.size:
            w.write(k, v)
        w.commit(R)
    res = mgr.read(h, **read_kw)
    parts = [res.partition(r) for r in range(R)]
    rep = mgr.report(sid)
    mgr.unregister_shuffle(sid)
    return parts, rep, res


def _recs(k, v):
    return sorted(zip(k.tolist(), map(bytes, v)))


@pytest.mark.parametrize("mode", ["plain", "ordered", "combine"])
def test_waved_host_read_matches_reference(manager_factory, mode):
    R = 12
    maps = _maps(["plain", "ordered", "combine"].index(mode), mode)
    bounds = None
    if mode == "ordered":
        s = ReservoirSampler(capacity=512, seed=2)
        for k, _ in maps:
            s.add(k)
        bounds = s.bounds(R)
    part = "range" if mode == "ordered" else "hash"
    conf = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.a2a.waveRows": "400",
            "spark.shuffle.tpu.read.mergeImpl": "pallas"}
    kw = {"combine": "sum"} if mode == "combine" else (
        {"ordered": True} if mode == "ordered" else {})
    want, jrep, _ = _run(manager_factory(conf), 920, maps, R, part, bounds,
                         **kw)
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        got, trep, res = _run(svc.manager, 920, maps, R, part, bounds,
                              **kw)
        gaps = svc.node.metrics.histogram(H_WAVE_GAP)
    assert isinstance(res, WavedShuffleReaderResult)
    assert trep.waves == jrep.waves >= 3
    assert res.waves == trep.waves == len(trep.wave_timeline)
    assert trep.wave_payload_rows == [int(x) for x in jrep.wave_payload_rows]
    assert trep.wave_rows == jrep.wave_rows == 400
    assert trep.plan_bucket == jrep.plan_bucket
    assert (trep.payload_bytes, trep.wire_bytes, trep.retries) == \
        (jrep.payload_bytes, jrep.wire_bytes, jrep.retries)
    assert trep.sink == jrep.sink == "host" and trep.completed
    assert [t["rows"] for t in trep.wave_timeline] == \
        [t["rows"] for t in jrep.wave_timeline]
    assert not trep.wave_timeline[0]["hidden"]
    assert trep.wave_pack_hidden_ms <= trep.pack_ms
    assert gaps.count == trep.waves - 1
    for r in range(R):
        (gk, gv), (wk, wv) = got[r], want[r]
        if mode == "plain":
            assert _recs(gk, gv) == _recs(wk, wv), f"partition {r}"
        elif mode == "ordered":
            np.testing.assert_array_equal(gk, wk)
            assert (np.diff(gk) >= 0).all()
            assert _recs(gk, gv) == _recs(wk, wv), f"partition {r}"
        else:
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)
    if mode == "ordered":
        allk = np.concatenate([got[r][0] for r in range(R)])
        assert (np.diff(allk) >= 0).all()


def test_wave_overflow_regrows_only_that_wave(manager_factory):
    """Skew confined to wave 1: both packages regrow and re-run that wave
    alone, later same-shape reads start at the grown wave capacity, and
    every partition holds the same rows."""
    conf = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.a2a.waveRows": "512"}

    def job(mgr, sid):
        h = mgr.register_shuffle(sid, 8, 8, partitioner="direct")
        for m in range(8):
            w = mgr.get_writer(h, m)
            balanced = np.arange(512, dtype=np.int64) % 8   # wave 0
            hot = np.zeros(512, np.int64)                   # wave 1 -> p0
            w.write(np.concatenate([balanced, hot]))
            w.commit(8)
        res = mgr.read(h)
        sizes = [res.partition(r)[0].shape[0] for r in range(8)]
        rep = mgr.report(sid)
        mgr.unregister_shuffle(sid)
        return sizes, rep

    jm = manager_factory(conf)
    jsizes, jrep = job(jm, 921)
    jsizes2, jrep2 = job(jm, 922)
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        tsizes, trep = job(svc.manager, 921)
        tsizes2, trep2 = job(svc.manager, 922)
    per_wave = [t["retries"] for t in trep.wave_timeline]
    assert per_wave == [t["retries"] for t in jrep.wave_timeline]
    assert trep.waves == 2 and per_wave[0] == 0 and per_wave[1] >= 1
    assert trep.retries == sum(per_wave)
    assert tsizes == jsizes and tsizes[0] == 8 * 512 + 8 * 64
    assert trep.wire_bytes == jrep.wire_bytes
    assert trep2.retries == jrep2.retries == 0 and tsizes2 == jsizes2


def test_waves_stay_off_below_two_waves_and_under_the_kernel(
        manager_factory):
    """One wave's worth of rows is a single-shot read; so is any read
    under the segment-move kernel (a2a.impl=pallas), as in the
    reference."""
    maps = _maps(5, "plain")
    for impl, wave_rows in (("dense", "100000"), ("pallas", "300")):
        conf = {"spark.shuffle.tpu.a2a.impl": impl,
                "spark.shuffle.tpu.a2a.waveRows": wave_rows}
        _, jrep, _ = _run(manager_factory(conf), 923, maps, 6, "hash",
                          None)
        with connect(conf, device="cpu", num_shards=N_SHARDS,
                     use_env=False) as svc:
            _, trep, res = _run(svc.manager, 923, maps, 6, "hash", None)
        assert trep.waves == jrep.waves == 0
        assert trep.wave_timeline == [] and not isinstance(
            res, WavedShuffleReaderResult)


def test_wave_plan_helpers_match_reference():
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.shuffle import plan as jplan
    for rows in ([100, 10, 0], [128], [129], [0, 0, 0, 0], [5000, 70, 4096]):
        for wr in (0, 64, 4096):
            a = np.asarray(rows)
            assert tplan.wave_count(a, wr) == jplan.wave_count(a, wr)
            n = tplan.wave_count(a, wr)
            if wr:
                np.testing.assert_array_equal(
                    tplan.wave_payload_rows(a, wr, n),
                    jplan.wave_payload_rows(a, wr, n))
    for kv in ({}, {"spark.shuffle.tpu.a2a.capacityFactor": "1.5"},
               {"spark.shuffle.tpu.a2a.capBuckets": "false"}):
        tconf = ShuffleConf(kv, use_env=False)
        jconf = TpuShuffleConf(kv, use_env=False)
        for total in (10_000, 200_000):
            tp = tplan.make_plan(np.full(8, total), 8, 16, tconf, torch.device("cpu"))
            jp = jplan.make_plan(np.full(8, total), 8, 16, jconf)
            tw = tplan.wave_step_plan(
                dataclasses.replace(tp, wave_rows=4096, num_waves=3), tconf)
            jw = jplan.wave_step_plan(
                dataclasses.replace(jp, wave_rows=4096, num_waves=3), jconf)
            assert (tw.cap_in, tw.cap_out, tw.wave_rows, tw.num_waves) == \
                (jw.cap_in, jw.cap_out, jw.wave_rows, jw.num_waves)
    with pytest.raises(ValueError):
        tplan.wave_step_plan(tplan.make_plan(np.full(8, 10), 8, 4,
                                             ShuffleConf(use_env=False),
                                             torch.device("cpu")))


@pytest.mark.parametrize("key,value", [("a2a.waveRows", "-1"),
                                       ("a2a.waveDepth", "0"),
                                       ("a2a.waveDepth", "9"),
                                       ("read.sink", "hbm")])
def test_wave_and_sink_conf_rejected_like_reference(key, value):
    from sparkucx_tpu.config import TpuShuffleConf
    kv = {"spark.shuffle.tpu." + key: value}
    with pytest.raises(ValueError):
        TpuShuffleConf(kv, use_env=False)
    with pytest.raises(ValueError):
        ShuffleConf(kv, use_env=False)
    c = ShuffleConf({"spark.shuffle.tpu.a2a.waveRows": "4096"},
                    use_env=False)
    assert (c.wave_rows, c.wave_depth, c.read_sink) == (4096, 2, "auto")
