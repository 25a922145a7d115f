"""``a2a.sortStrips`` in the port: the key of the JAX package's
strip-sorted one-shard plain path (``tests/test_strip_sort.py``),
validated as the reference validates it and read by nothing. Strips
serve the reference's depth-bound sort network on the TPU; on the card
every read is one flat ``torch.sort``, so a one-shard read returns the
same partitions under every value, held here against the JAX package's
strip read.

The reference's cases of the strip layout itself (the grouping contract,
the run index, the step's strip path, the activation predicate, the
``partition`` fetch granularity, spill and the device sink under
strips) and its two XLA cases (the AOT lowering proof and the warmup
precompile) have no counterpart."""

import jax
import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import STRIPS_RANGE, ShuffleConf
from sparkucx_tpu_torch.shuffle.writer import hash32_np
from tests.conftest import FUZZ_SEEDS

PFX = "spark.shuffle.tpu."


@pytest.mark.parametrize("raw", ["auto", "1", "8", "4096", "0", "4097",
                                 "-3"])
def test_sort_strips_conf_matches_reference(raw):
    """Each value is accepted or refused as the reference's conf does,
    and an accepted one reads back the same."""
    m = {PFX + "a2a.sortStrips": raw}
    try:
        want = TpuShuffleConf(m, use_env=False).sort_strips
    except ValueError:
        with pytest.raises(ValueError, match="sortStrips"):
            ShuffleConf(m, use_env=False).sort_strips
        return
    assert ShuffleConf(m, use_env=False).sort_strips == want
    assert STRIPS_RANGE == (1, 4096)
    assert ShuffleConf({}, use_env=False).sort_strips == "auto"
    keys = {r["key"] for r in ShuffleConf.describe_keys()}
    assert PFX + "a2a.sortStrips" in keys


def _port(strips):
    return connect({PFX + "a2a.impl": "dense",
                    PFX + "a2a.sortStrips": str(strips)},
                   device="cpu", num_shards=1, use_env=False)


def _jax_manager(manager_factory, strips):
    m = manager_factory({PFX + "a2a.sortStrips": str(strips)})
    m.node.remesh(devices=list(jax.devices())[:1], reason="strips")
    return m


def _partitions(res, R):
    return {r: np.sort(np.asarray(res.partition(r)[0])) for r in range(R)}


def test_manager_e2e_strips(manager_factory, rng):
    """register -> write -> commit -> read on one shard under
    ``sortStrips`` 8 and 1: the same flat layout (no strip alignment),
    and partitions equal to the reference's strip read."""
    R, Mw = 16, 4
    data = [(rng.integers(0, 1 << 31, size=300).astype(np.int64),
             rng.normal(size=(300, 2)).astype(np.float32))
            for _ in range(Mw)]
    got = {}
    for strips in (8, 1):
        with _port(strips) as svc:
            h = svc.register_shuffle(7, Mw, R)
            for m, (k, v) in enumerate(data):
                svc.write(h, m, k, v)
            res = svc.read(h)
            for r, (k, v) in res.partitions():
                assert ((hash32_np(np.asarray(k)) % np.uint32(R))
                        .astype(np.int64) == r).all()
                assert v is not None and v.shape == (k.size, 2)
            got[strips] = _partitions(res, R)
            assert res._align_chunk == 0
    jm = _jax_manager(manager_factory, 8)
    h = jm.register_shuffle(7, Mw, R)
    for m, (k, v) in enumerate(data):
        w = jm.get_writer(h, m)
        w.write(k, v)
        w.commit(R)
    want = _partitions(jm.read(h), R)
    for r in range(R):
        np.testing.assert_array_equal(got[8][r], want[r])
        np.testing.assert_array_equal(got[1][r], want[r])


@pytest.mark.parametrize("seed", range(min(FUZZ_SEEDS, 64)))
def test_random_strips_roundtrip(seed):
    """Random shapes, ``sortStrips`` values and value schemas on one
    shard against the host oracle: routing, the global multiset and the
    value binding."""
    rng = np.random.default_rng(10_000 + seed)
    strips = int(rng.choice([2, 3, 5, 8, 16, 64]))
    M = int(rng.integers(1, 6))
    R = int(rng.integers(1, 24))
    with_vals = bool(rng.integers(0, 2))
    with _port(strips) as svc:
        h = svc.register_shuffle(20_000 + seed, M, R)
        kv, total = {}, 0
        for mid in range(M):
            n = int(rng.integers(0, 900))
            keys = rng.integers(-(1 << 62), 1 << 62,
                                size=n).astype(np.int64)
            if with_vals:
                vals = rng.integers(-1000, 1000,
                                    size=(n, 2)).astype(np.int32)
                svc.write(h, mid, keys, vals)
                for k, v in zip(keys, vals):
                    kv.setdefault(int(k), []).append(tuple(v))
            else:
                svc.write(h, mid, keys)
                for k in keys:
                    kv.setdefault(int(k), []).append(None)
            total += n
        res = svc.read(h)
        got, seen = {}, 0
        for r, (k, v) in res.partitions():
            exp_r = (hash32_np(np.asarray(k)) % np.uint32(R)).astype(int)
            assert (exp_r == r).all(), f"misrouted rows in partition {r}"
            for i, ki in enumerate(k):
                got.setdefault(int(ki), []).append(
                    tuple(v[i]) if with_vals else None)
            seen += k.size
    assert seen == total
    assert set(got) == set(kv)
    for ki in kv:
        assert sorted(got[ki], key=repr) == sorted(kv[ki], key=repr)
