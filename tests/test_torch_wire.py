"""Port parity for the wire tiers (``a2a.wire``) end to end: the JAX
``TpuShuffleManager`` on 8 virtual CPU devices against the port through
``connect(..., device="cpu")`` with 8 logical shards, on the same seeded
float32 map outputs.

Exact: the conf seam and its error text, the tier resolution table, the
int8 byte accounting (``wire_bytes``, ``wire_row_bytes``,
``scale_bytes``, ``pad_ratio``, ``wire_dequant_error``), keys, per-
partition counts, overflow retries, lossless partitions (bit-identical to
a raw read) and the lossless codec's bytes. Within bounds: int8 values
(one quantization step of the row, ``amax/127``), int8 combine sums (one
step of each shard's map-side partial, plus float32 summation slack).
The two packages draw different rounding noise (``torch.Generator``
against ``jax.random``), so int8 values are held to the bound, not to
each other."""

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.shuffle import plan as tplan
from sparkucx_tpu_torch.shuffle import reader as treader
from sparkucx_tpu_torch.shuffle import wire as twire
from sparkucx_tpu_torch.shuffle.reader import LosslessBlock
from sparkucx_tpu_torch.shuffle.writer import hash32_np

N_SHARDS = 8
W_KEY = "spark.shuffle.tpu.a2a.wire"


def _maps(seed, M, vw, key_space, unique=False):
    rng = np.random.default_rng(seed)
    out = []
    used = rng.permutation(1 << 20)[:M * 600] if unique else None
    off = 0
    for m in range(M):
        n = 0 if m == 2 else int(rng.integers(150, 500))
        if unique:
            k = (used[off:off + n].astype(np.int64) - (1 << 19)) * 1_000_003
            off += n
        else:
            k = rng.integers(-key_space, key_space, n).astype(np.int64) \
                * 1_000_003
        v = (rng.standard_normal((n, vw)) * np.exp(rng.normal(0, 2, (n, 1)))
             ).astype(np.float32)
        out.append((k, v))
    return out


def _write(mgr, sid, maps, R, partitioner="hash"):
    h = mgr.register_shuffle(sid, len(maps), R, partitioner)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        if k.size:
            w.write(k, v)
        w.commit(R)
    return h


def _read(mgr, sid, maps, R, **kw):
    h = _write(mgr, sid, maps, R)
    res = mgr.read(h, **kw)
    return [res.partition(r) for r in range(R)], mgr.report(sid)


def _pid(keys, R):
    return (hash32_np(keys) % np.uint32(R)).astype(np.int64)


def _truth(maps):
    return {int(k): v[i] for k, v in maps for i, k in enumerate(k)}


def _check_rows_within_step(parts, truth, R):
    """Every delivered row is some written row of its key, within one
    quantization step of it, lane by lane (keys are unique here)."""
    n = 0
    for r in range(R):
        ks, vs = parts[r]
        assert (_pid(ks, R) == r).all()
        for i, k in enumerate(ks):
            v = truth[int(k)].astype(np.float64)
            step = np.abs(v).max() / 127.0
            assert (np.abs(vs[i] - v) <= step * (1 + 1e-6)).all(), (r, k)
            n += 1
    return n


def _combine_bound(maps, R):
    """Per key: (float64 sum, tolerance) — one quantization step of every
    shard's map-side partial row (shard = map % 8), plus float32
    summation slack."""
    part = {}
    for m, (k, v) in enumerate(maps):
        for i, kk in enumerate(k):
            key = (m % N_SHARDS, int(kk))
            part[key] = part.get(key, 0) + v[i].astype(np.float64)
    total, tol = {}, {}
    for (s, kk), p in part.items():
        total[kk] = total.get(kk, 0) + p
        tol[kk] = tol.get(kk, 0) + np.abs(p).max() / 127.0 * (1 + 1e-5) \
            + 2.0 ** -20 * np.abs(p)
    return total, tol


# -- conf and resolution -----------------------------------------------------
def test_conf_wire_values_and_errors():
    from sparkucx_tpu.config import TpuShuffleConf
    assert ShuffleConf(use_env=False).a2a_wire == "raw"
    for w in ("raw", "int8", "lossless"):
        assert ShuffleConf({W_KEY: w}, use_env=False).a2a_wire == w
        assert TpuShuffleConf({W_KEY: w}, use_env=False).a2a_wire == w
    with pytest.raises(ValueError, match=r"spark\.shuffle\.tpu\.a2a\.wire"):
        ShuffleConf({W_KEY: "zstd"}, use_env=False)
    with pytest.raises(ValueError, match=r"spark\.shuffle\.tpu\.a2a\.wire"):
        TpuShuffleConf({W_KEY: "zstd"}, use_env=False).a2a_wire
    key = "spark.shuffle.tpu.a2a.wireErrorSampleRows"
    assert ShuffleConf(use_env=False).wire_error_sample_rows == \
        TpuShuffleConf(use_env=False).wire_error_sample_rows == 256
    with pytest.raises(ValueError, match="wireErrorSampleRows"):
        ShuffleConf({key: "-1"}, use_env=False)


@pytest.mark.parametrize("shards,has_vals,dtype", [
    (8, True, np.float32), (1, True, np.float32), (8, False, None),
    (8, True, np.int32), (8, True, np.float16)])
@pytest.mark.parametrize("wire", ["raw", "int8", "lossless"])
def test_resolve_wire_table_matches_reference(manager_factory, shards,
                                              has_vals, dtype, wire):
    from sparkucx_tpu.shuffle.plan import ShufflePlan as JaxPlan
    jm = manager_factory({W_KEY: wire})
    val_tail = (6,) if has_vals else None
    want = jm._resolve_wire(JaxPlan(shards, 16, 64, 64, "dense"), has_vals,
                            val_tail, dtype)
    with connect({W_KEY: wire}, device="cpu", num_shards=shards,
                 use_env=False) as svc:
        got = svc.manager._resolve_wire(
            tplan.ShufflePlan(shards, 16, 64, 64, "dense"), has_vals,
            val_tail, dtype)
    assert got == want


def test_wave_step_plan_preserves_wire():
    p = tplan.ShufflePlan(8, 16, 4096, 4096, "dense", wire="int8",
                          wire_words=6, wave_rows=500, num_waves=3)
    w = tplan.wave_step_plan(p, ShuffleConf(use_env=False))
    assert (w.wire, w.wire_words, w.wave_rows) == ("int8", 6, 0)


@pytest.mark.parametrize("impl", ["dense", "pallas", "gather"])
@pytest.mark.parametrize("wire,ww", [("raw", 0), ("int8", 6), ("int8", 7),
                                     ("lossless", 0), ("int8", 128)])
def test_layout_matches_reference(impl, wire, ww):
    from sparkucx_tpu.shuffle.plan import ShufflePlan as JaxPlan
    from sparkucx_tpu.shuffle.plan import ragged_layout as jlayout
    width = 2 + (ww or 6)
    rows = np.array([500, 0, 713, 1, 64, 999, 12, 300])
    kw = dict(wire=wire, wire_words=ww)
    want = jlayout(JaxPlan(8, 24, 1024, 1536, impl, **kw), rows, width,
                   backend="cpu")
    got = tplan.ragged_layout(tplan.ShufflePlan(8, 24, 1024, 1536, impl,
                                                **kw), rows, width)
    for f in ("wire_rows", "payload_bytes", "wire_bytes", "pad_ratio",
              "wire", "wire_row_bytes", "scale_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    if wire == "int8":
        assert tplan.wire_row_words(
            tplan.ShufflePlan(8, 24, 1024, 1536, impl, **kw), width) == \
            got.wire_row_bytes // 4 < width


# -- int8 reads against the reference ----------------------------------------
@pytest.mark.parametrize("mode,impl", [("plain", "dense"),
                                       ("plain", "pallas"),
                                       ("ordered", "dense"),
                                       ("ordered", "pallas"),
                                       ("combine", "dense"),
                                       ("combine", "pallas")])
def test_int8_read_matches_reference(manager_factory, mode, impl):
    R = 12
    maps = _maps(["plain", "ordered", "combine"].index(mode) * 2
                 + (impl == "pallas"), 10, 6, 40, unique=mode != "combine")
    conf = {"spark.shuffle.tpu.a2a.impl": impl, W_KEY: "int8",
            "spark.shuffle.tpu.read.mergeImpl": "pallas"}
    kw = {"combine": "sum"} if mode == "combine" else (
        {"ordered": True} if mode == "ordered" else {})
    want, jrep = _read(manager_factory(conf), 930, maps, R, **kw)
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        got, trep = _read(svc.manager, 930, maps, R, **kw)
    assert trep.wire == jrep.wire == "int8"
    assert (trep.payload_bytes, trep.wire_bytes, trep.pad_ratio) == \
        (jrep.payload_bytes, jrep.wire_bytes, jrep.pad_ratio)
    assert trep.wire_dequant_error == jrep.wire_dequant_error > 0
    assert trep.kernel == jrep.kernel and trep.retries == jrep.retries
    for r in range(R):
        gk, wk = got[r][0], want[r][0]
        if mode == "plain":
            np.testing.assert_array_equal(np.sort(gk), np.sort(wk))
        else:
            np.testing.assert_array_equal(gk, wk)      # sorted, same keys
    if mode != "combine":
        truth = _truth(maps)
        n = _check_rows_within_step(got, truth, R)
        assert n == _check_rows_within_step(want, truth, R) == \
            sum(k.size for k, _ in maps)
        return
    total, tol = _combine_bound(maps, R)
    for r in range(R):
        for parts in (got, want):
            ks, vs = parts[r]
            for i, k in enumerate(ks):
                assert (np.abs(vs[i] - total[int(k)])
                        <= tol[int(k)]).all(), (r, k)


def test_int8_overflow_regrow_draws_fresh_noise(manager_factory,
                                                monkeypatch):
    """Half the keys hash to one partition under capacityFactor 1: both
    packages overflow and regrow the same number of times; each attempt
    draws its rounding noise from new seeds (base + attempt), and the
    delivered values stay within one step."""
    R = 8
    rng = np.random.default_rng(12)
    pool = rng.choice(1 << 40, 40_000, replace=False).astype(np.int64)
    hot = pool[_pid(pool, R) == 0]
    cold = pool[_pid(pool, R) != 0]
    maps = []
    for m in range(8):
        k = np.concatenate([hot[m * 150:(m + 1) * 150],
                            cold[m * 150:(m + 1) * 150]])
        maps.append((k, rng.standard_normal((300, 5)).astype(np.float32)))
    conf = {"spark.shuffle.tpu.a2a.impl": "dense", W_KEY: "int8",
            "spark.shuffle.tpu.a2a.capacityFactor": "1.0"}
    seeds_seen = []
    orig = treader.wire_uniforms

    def spy(shape, seeds, device):
        seeds_seen.append(list(seeds))
        return orig(shape, seeds, device)

    want, jrep = _read(manager_factory(conf), 940, maps, R)
    monkeypatch.setattr(treader, "wire_uniforms", spy)
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        got, trep = _read(svc.manager, 940, maps, R)
    assert trep.retries == jrep.retries >= 1
    assert trep.wire == jrep.wire == "int8"
    assert len(seeds_seen) == trep.retries + 1
    for attempt, seeds in enumerate(seeds_seen):
        assert seeds == [((trep._seq + attempt) * N_SHARDS + p) & 0x7FFFFFFF
                         for p in range(N_SHARDS)]
    assert len({tuple(x) for x in seeds_seen}) == len(seeds_seen)
    for r in range(R):
        np.testing.assert_array_equal(np.sort(got[r][0]), np.sort(want[r][0]))
    assert _check_rows_within_step(got, _truth(maps), R) == 8 * 300


def test_waved_int8_combine_device_sink_matches_reference(manager_factory):
    R = 10
    maps = _maps(21, 12, 8, 30)
    conf = {"spark.shuffle.tpu.a2a.impl": "dense", W_KEY: "int8",
            "spark.shuffle.tpu.a2a.waveRows": "200",
            "spark.shuffle.tpu.read.mergeImpl": "pallas"}
    jm = manager_factory(conf)
    hj = _write(jm, 950, maps, R)
    jres = jm.read(hj, combine="sum", sink="device")
    jrep = jm.report(950)
    want = [jres.host_view().partition(r) for r in range(R)]
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        ht = _write(svc.manager, 950, maps, R)
        tres = svc.read(ht, combine="sum", sink="device")
        trep = svc.report(950)
        assert trep.sink == "device" and trep.merge_ms > 0
        got = [tres.host_view().partition(r) for r in range(R)]
    assert trep.wire == jrep.wire == "int8"
    assert trep.waves == jrep.waves >= 3
    assert trep.wave_payload_rows == [int(x) for x in jrep.wave_payload_rows]
    assert (trep.wire_bytes, trep.pad_ratio, trep.wire_dequant_error) == \
        (jrep.wire_bytes, jrep.pad_ratio, jrep.wire_dequant_error)
    total, tol = _combine_bound(maps, R)
    for r in range(R):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        ks, vs = got[r]
        for i, k in enumerate(ks):
            assert (np.abs(vs[i] - total[int(k)]) <= tol[int(k)]).all()


# -- lossless ----------------------------------------------------------------
def test_lossless_codec_bytes_match_reference():
    from sparkucx_tpu.shuffle import wire as jwire
    rng = np.random.default_rng(5)
    for arr in (rng.integers(-9, 9, (300, 7)).astype(np.int32),
                rng.standard_normal((64, 5)).astype(np.float32)[:, ::2],
                np.zeros((0, 4), np.int32), np.arange(11, dtype=np.int16)):
        got, want = twire.encode_block(arr), jwire.encode_block(arr)
        assert (got.payload, got.shape, got.dtype, got.raw_bytes) == \
            (want.payload, want.shape, want.dtype, want.raw_bytes)
        back = twire.decode_block(got)
        assert back.dtype == arr.dtype and np.array_equal(back, arr)
    v = rng.standard_normal((500, 16)).astype(np.float32)
    v[7, 3] = 4e4                                       # one outlier row
    assert twire.estimate_dequant_error(v) == \
        jwire.estimate_dequant_error(v)
    assert twire.estimate_dequant_error(v, sample_rows=32) == \
        jwire.estimate_dequant_error(v, sample_rows=32)
    assert twire.estimate_dequant_error(np.zeros((3, 3))) == 0.0


@pytest.mark.parametrize("mode", ["plain", "combine"])
def test_waved_lossless_blocks_decompress_on_touch(manager_factory, mode):
    """Waved lossless host reads hold compressed blocks after the drain,
    report their bytes, and serve partitions bit-identical to the raw
    read (and to the reference's lossless read)."""
    R = 16
    maps = _maps(31, 8, 8, 50 if mode == "combine" else 1 << 40)
    kw = {"combine": "sum"} if mode == "combine" else {}
    base = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.a2a.waveRows": "96"}
    jm = manager_factory({**base, W_KEY: "lossless"})
    want, jrep = _read(jm, 960, maps, R, **kw)
    with connect(base, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        raw, rrep = _read(svc.manager, 960, maps, R, **kw)
    with connect({**base, W_KEY: "lossless"}, device="cpu",
                 num_shards=N_SHARDS, use_env=False) as svc:
        h = _write(svc.manager, 961, maps, R)
        res = svc.read(h, **kw)
        rep = svc.report(961)
        blocks = [b for w in res.wave_results() for b in w._shards.values()
                  if isinstance(b, LosslessBlock)]
        got = [res.partition(r) for r in range(R)]
    assert rep.wire == jrep.wire == "lossless" and rrep.wire == "raw"
    assert rep.waves == jrep.waves >= 3
    assert rep.lossless_bytes > 0 and jrep.lossless_bytes > 0
    # compressed until touched: the report counts every block encoded
    assert blocks and rep.lossless_bytes >= sum(b.nbytes for b in blocks)
    assert (rep.wire_bytes, rep.payload_bytes) == (rrep.wire_bytes,
                                                   rrep.payload_bytes)
    for r in range(R):
        for a, b in ((got[r], raw[r]), (got[r], want[r])):
            if mode == "plain":
                oa, ob = np.argsort(a[0], kind="stable"), \
                    np.argsort(b[0], kind="stable")
                assert np.array_equal(a[0][oa], b[0][ob])
                assert np.array_equal(a[1][oa].view(np.int32),
                                      b[1][ob].view(np.int32))
            else:
                assert np.array_equal(a[0], b[0])
        np.testing.assert_array_equal(got[r][1].view(np.int32),
                                      raw[r][1].view(np.int32))


def test_lossless_single_shot_and_device_sink_compress_nothing(caplog):
    maps = _maps(41, 4, 3, 1 << 30)
    with connect({W_KEY: "lossless"}, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        parts, rep = _read(svc.manager, 970, maps, 8)
        assert rep.wire == "lossless" and rep.lossless_bytes == 0
        h = _write(svc.manager, 971, maps, 8)
        dres = svc.read(h, sink="device")
        assert svc.report(971).lossless_bytes == 0
        dres.close()
    assert sum(k.size for k, _ in parts) == sum(k.size for k, _ in maps)


def test_int8_raw_fallbacks_report_raw():
    """int8 asked, raw run: one shard, keys only, integer values."""
    rng = np.random.default_rng(2)
    k = rng.integers(0, 1 << 30, 200).astype(np.int64)
    cases = [(1, rng.standard_normal((200, 3)).astype(np.float32)),
             (8, None), (8, rng.integers(0, 9, (200, 3)).astype(np.int32))]
    for shards, v in cases:
        with connect({W_KEY: "int8"}, device="cpu", num_shards=shards,
                     use_env=False) as svc:
            h = svc.register_shuffle(980, 1, 4)
            svc.write(h, 0, k, v)
            res = svc.read(h)
            rep = svc.report(980)
            assert rep.wire == "raw" and rep.wire_dequant_error == 0.0
            got = np.sort(np.concatenate([res.partition(r)[0]
                                          for r in range(4)]))
            np.testing.assert_array_equal(got, np.sort(k))
            if v is not None:
                vals = np.concatenate([res.partition(r)[1]
                                       for r in range(4)])
                assert vals.dtype == v.dtype


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("merge", ["pallas", "jnp"])
def test_int8_combine_routes_through_the_fused_reduce(monkeypatch, impl,
                                                      merge):
    """The JAX package's ``fused`` condition: an int8 combine under the
    segment-reduce kernel hands the wire rows to the fused dequant
    reduce, once per exchange; under ``jnp`` it dequantizes first."""
    calls = []
    orig = treader.segment_reduce_wire_rows

    def spy(rows, *args, **kw):
        calls.append(tuple(rows.shape))
        return orig(rows, *args, **kw)

    monkeypatch.setattr(treader, "segment_reduce_wire_rows", spy)
    maps = _maps(51, 8, 9, 40)
    conf = {"spark.shuffle.tpu.a2a.impl": impl, W_KEY: "int8",
            "spark.shuffle.tpu.read.mergeImpl": merge}
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        parts, rep = _read(svc.manager, 990, maps, 8, combine="sum")
    assert rep.wire == "int8" and rep.kernel == merge
    if merge == "jnp":
        assert calls == []
    else:
        # 2 exact key lanes + ceil(9 / 4) packed words + the scale lane
        assert len(calls) == 1 + rep.retries and calls[0][2] == 2 + 3 + 1
    total, tol = _combine_bound(maps, 8)
    for r in range(8):
        for i, k in enumerate(parts[r][0]):
            assert (np.abs(parts[r][1][i] - total[int(k)])
                    <= tol[int(k)]).all()
