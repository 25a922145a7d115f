"""Port parity for the combine and ordered reads, end to end: the JAX
``TpuShuffleManager`` on 8 virtual CPU devices against the port through
``connect(..., device="cpu")`` with 8 logical shards, on the same seeded
map outputs, with the hash and range partitioners and the dense and
pallas exchanges.

Exact: per-partition row counts and keys (unique and sorted for combine,
the sorted key sequence for ordered), int32 and int16 ring sums, carried
lanes, ordered (key, value) multisets, the resolved kernel tier, the
report's byte accounting and the overflow-retry count. Float32 sums:
within ``rtol=1e-5`` and ``atol = 2**-22 * sum(|v|)`` over the rows the
partition's shard received, because the reference sums float32 prefix
differences, which lose low bits on long prefixes, where the port sums in
float64 or per run."""

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.ops.partition import (ReservoirSampler,
                                              blocked_partition_map)
from sparkucx_tpu_torch.shuffle.writer import hash32_np
from sparkucx_tpu_torch.utils.metrics import C_KERNEL_FALLBACK, labeled

N_SHARDS = 8


def _maps(seed, M, vals, key_space, sum_words=0):
    """[(keys, values)] per map; map 1 writes nothing. The carried lanes
    (f32carry's lane 1, an int32 schema's lanes past ``sum_words``) are a
    constant of the key, as a carried payload is."""
    rng = np.random.default_rng(seed)
    out = []
    for m in range(M):
        n = 0 if m == 1 else int(rng.integers(100, 500))
        k = rng.integers(-key_space, key_space, n).astype(np.int64) \
            * 1_000_003
        if vals == "int32":
            v = rng.integers(-(1 << 31), 1 << 31, (n, 3)).astype(np.int32)
            if sum_words:
                v[:, sum_words:] = (k % 977)[:, None]
        elif vals == "int16":
            v = rng.integers(-(1 << 15), 1 << 15, (n, 4)).astype(np.int16)
        else:
            v = rng.standard_normal((n, 2)).astype(np.float32)
            if vals == "f32carry":
                v[:, 1] = (k % 977).astype(np.float32)
        out.append((k, v))
    return out


def _bounds(maps, R):
    s = ReservoirSampler(capacity=256, seed=3)
    for k, _ in maps:
        s.add(k)
    return s.bounds(R)


def _run(mgr, sid, maps, R, partitioner, bounds, **read_kw):
    h = mgr.register_shuffle(sid, len(maps), R, partitioner, bounds=bounds)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        if k.size:
            w.write(k, v)
        w.commit(R)
    res = mgr.read(h, **read_kw)
    return [res.partition(r) for r in range(R)], mgr.report(sid)


def _part_of(keys, R, partitioner, bounds):
    if partitioner == "range":
        return np.searchsorted(bounds, keys, side="right")
    return (hash32_np(keys) % np.uint32(R)).astype(np.int64)


CASES = [
    # (mode, partitioner, a2a.impl, values, read.mergeImpl, sum_words, R)
    ("combine", "hash", "dense", "int32", "pallas", 0, 16),
    ("combine", "hash", "pallas", "int32", "pallas", 0, 24),
    ("combine", "range", "dense", "float32", "auto", 0, 12),
    ("combine", "range", "pallas", "f32carry", "pallas", 1, 20),
    ("combine", "hash", "gather", "int16", "pallas", 0, 10),
    ("combine", "hash", "dense", "int32", "jnp", 2, 9),
    ("ordered", "hash", "dense", "int32", "auto", 0, 16),
    ("ordered", "range", "dense", "float32", "auto", 0, 24),
    ("ordered", "range", "pallas", "int32", "pallas", 0, 12),
    ("ordered", "hash", "pallas", "int16", "auto", 0, 8),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_read_mode_matches_reference(manager_factory, case):
    mode, partitioner, impl, vals, merge, sum_words, R = case
    if impl == "pallas":
        from sparkucx_tpu.ops.pallas.ragged_a2a import interpret_supported
        if not interpret_supported():
            pytest.skip("pltpu.InterpretParams unavailable on this jax")
    seed = CASES.index(case)
    maps = _maps(seed, 5, vals, 60 if mode == "combine" else 1 << 40,
                 sum_words)
    bounds = _bounds(maps, R) if partitioner == "range" else None
    conf = {"spark.shuffle.tpu.a2a.impl": impl,
            "spark.shuffle.tpu.read.mergeImpl": merge}
    kw = ({"combine": "sum", "combine_sum_words": sum_words}
          if mode == "combine" else {"ordered": True})
    want, jrep = _run(manager_factory(conf), 910, maps, R, partitioner,
                      bounds, **kw)
    svc = connect(conf, device="cpu", num_shards=N_SHARDS, use_env=False)
    try:
        got, trep = _run(svc.manager, 910, maps, R, partitioner, bounds,
                         **kw)
        fallbacks = svc.node.metrics.get(
            labeled(C_KERNEL_FALLBACK, reason="subword_dtype"))
    finally:
        svc.stop()

    keys = np.concatenate([k for k, _ in maps])
    values = np.concatenate([v for _, v in maps])
    pid = _part_of(keys, R, partitioner, bounds)
    p2s = blocked_partition_map(R, N_SHARDS)
    for r in range(R):
        (gk, gv), (wk, wv) = got[r], want[r]
        sel = pid == r
        if mode == "combine":
            np.testing.assert_array_equal(gk, np.unique(keys[sel]))
        else:
            np.testing.assert_array_equal(gk, np.sort(keys[sel]))
        np.testing.assert_array_equal(gk, wk)
        if mode == "ordered":
            def recs(k, v):
                return sorted(zip(k.tolist(), map(bytes, v)))
            assert recs(gk, gv) == recs(wk, wv), f"partition {r}"
        elif vals in ("float32", "f32carry"):
            shard_rows = np.isin(pid, np.flatnonzero(p2s == p2s[r]))
            atol = 2.0 ** -22 * float(np.abs(values[shard_rows]).sum())
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=atol)
            if vals == "f32carry":
                np.testing.assert_array_equal(gv[:, 1], wv[:, 1])
        else:
            np.testing.assert_array_equal(gv, wv)
    assert trep.kernel == jrep.kernel
    assert trep.impl == jrep.impl
    assert (trep.payload_bytes, trep.wire_bytes, trep.retries) == \
        (jrep.payload_bytes, jrep.wire_bytes, jrep.retries)
    gated = mode == "combine" and vals == "int16" and merge == "pallas"
    assert fallbacks == (1.0 if gated else 0.0)
    if gated:
        assert trep.kernel == "jnp"


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("mode", ["combine", "ordered"])
def test_read_mode_overflow_regrow_matches_reference(manager_factory,
                                                     impl, mode):
    """One shard's rows overflow the first receive capacity: both
    packages discard the overflowed step, regrow the same number of times
    and serve the same rows. An ordered read gets a hot key; a combine
    read, whose map-side combine folds a hot key away, gets a hot range
    partition of many distinct keys."""
    if impl == "pallas":
        from sparkucx_tpu.ops.pallas.ragged_a2a import interpret_supported
        if not interpret_supported():
            pytest.skip("pltpu.InterpretParams unavailable on this jax")
    rng = np.random.default_rng(5)
    R = 8
    maps = []
    for m in range(4):
        if mode == "combine":
            k = np.concatenate([rng.integers(0, 1000, 600),
                                rng.integers(1000, 1 << 20, 200)])
        else:
            k = np.concatenate([np.full(600, 4242),
                                rng.integers(0, 1 << 20, 200)])
        v = rng.integers(-1000, 1000, (k.size, 2)).astype(np.int32)
        maps.append((k.astype(np.int64), v))
    if mode == "combine":
        part, bounds = "range", 1000 + 150_000 * np.arange(R - 1)
    else:
        part, bounds = "hash", None
    conf = {"spark.shuffle.tpu.a2a.impl": impl,
            "spark.shuffle.tpu.a2a.capacityFactor": "0.5",
            "spark.shuffle.tpu.read.mergeImpl": "pallas"}
    kw = {"combine": "sum"} if mode == "combine" else {"ordered": True}
    want, jrep = _run(manager_factory(conf), 911, maps, R, part, bounds,
                      **kw)
    svc = connect(conf, device="cpu", num_shards=N_SHARDS, use_env=False)
    try:
        got, trep = _run(svc.manager, 911, maps, R, part, bounds, **kw)
    finally:
        svc.stop()
    assert jrep.retries >= 1 and trep.retries == jrep.retries
    for r in range(R):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        if mode == "combine":
            np.testing.assert_array_equal(got[r][1], want[r][1])


def test_register_rejects_bad_range_bounds():
    """Bounds are checked when the shuffle is registered, before any map
    publishes a size row; a failed registration leaves no entry behind."""
    with connect(device="cpu", num_shards=N_SHARDS, use_env=False) as svc:
        with pytest.raises(ValueError):
            svc.register_shuffle(1, 2, 4, "range", bounds=[3, 1, 2])
        with pytest.raises(ValueError):
            svc.register_shuffle(1, 2, 4, "range", bounds=[1, 2])
        with pytest.raises(ValueError):
            svc.register_shuffle(1, 2, 4, "range")
        with pytest.raises(ValueError):
            svc.register_shuffle(1, 2, 4, "hash", bounds=[1, 2, 3])
        h = svc.register_shuffle(1, 2, 4, "range", bounds=[-5, 0, 5])
        assert h.bounds == (-5, 0, 5)
        svc.write(h, 0, np.array([-9, -5, 0, 4, 5, 9]))
        svc.write(h, 1, np.array([1 << 62]))
        keys = [svc.read(h, ordered=True).partition(r)[0].tolist()
                for r in range(4)]
        assert keys == [[-9], [-5], [0, 4], [5, 9, 1 << 62]]
        with pytest.raises(ValueError):        # keys-only: nothing to sum
            svc.read(h, combine="sum")
        with pytest.raises(ValueError):
            svc.read(h, combine="max")
