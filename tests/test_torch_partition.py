"""Port parity: map-side routing (sparkucx_tpu_torch.ops.partition) against
the JAX package's ops/partition.py on identical numpy inputs.

Hashes, counts and chunk alignment are exact; intra-destination row order
may differ (the JAX sorts are unstable), so rows compare as multisets per
destination or per device segment."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import partition as jref
from sparkucx_tpu.shuffle.reader import _device_bounds as jax_bounds
from sparkucx_tpu_torch.ops import partition as tport
from sparkucx_tpu_torch.shuffle.reader import _device_bounds
from sparkucx_tpu_torch.shuffle.writer import hash32_np

EDGE_KEYS = np.array([0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                      1, -2, 0x7FFF, 0x8000, 0xFFFF, 0x10000, -0x10000],
                     dtype=np.int32)


def _keys(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rnd = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                       size=n, dtype=np.int64).astype(np.int32)
    return np.concatenate([EDGE_KEYS, rnd])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash32_bit_exact(seed):
    k = _keys(seed)
    want = np.asarray(jref.hash32(jnp.asarray(k))).astype(np.int64)
    got = tport.hash32(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)
    # the writer's host twin agrees too
    np.testing.assert_array_equal(hash32_np(k).astype(np.int64), want)


def test_hash32_uses_low_word_of_int64_keys():
    rng = np.random.default_rng(7)
    k64 = rng.integers(-(1 << 62), 1 << 62, size=2048, dtype=np.int64)
    lo = k64.view(np.int32).reshape(-1, 2)[:, 0].copy()
    want = np.asarray(jref.hash32(jnp.asarray(lo))).astype(np.int64)
    np.testing.assert_array_equal(
        tport.hash32(torch.from_numpy(k64)).numpy(), want)


@pytest.mark.parametrize("R", [1, 7, 8, 200, 1 << 20])
def test_hash_partition_exact(R):
    k = _keys(R)
    want = np.asarray(jref.hash_partition(jnp.asarray(k), R))
    got = tport.hash_partition(torch.from_numpy(k), R)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_from_sorted_exact():
    rng = np.random.default_rng(3)
    s = np.sort(rng.integers(0, 12, size=500).astype(np.int32))
    want = np.asarray(jref.counts_from_sorted(jnp.asarray(s), 10))
    got = tport.counts_from_sorted(torch.from_numpy(s)[None], 10)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,P", [(16, 8), (200, 8), (5, 8), (3, 1)])
def test_blocked_map_and_bounds(R, P):
    np.testing.assert_array_equal(tport.blocked_partition_map(R, P),
                                  np.asarray(jref.blocked_partition_map(R, P)))
    np.testing.assert_array_equal(_device_bounds(R, P), jax_bounds(R, P))


def _rows(seed, cap, W):
    rng = np.random.default_rng(seed)
    return rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        size=(cap, W), dtype=np.int64).astype(np.int32)


def _multiset(a: np.ndarray):
    return sorted(map(tuple, a.tolist()))


@pytest.mark.parametrize("method", ["argsort", "multisort", "counting"])
@pytest.mark.parametrize("nvalid", [0, 333, 512])
def test_destination_sort_groups(method, nvalid):
    cap, W, D = 512, 4, 9
    rows = _rows(11, cap, W)
    dest = np.random.default_rng(12).integers(0, D, cap).astype(np.int32)
    js, jc = jref.destination_sort(jnp.asarray(rows), jnp.asarray(dest),
                                   jnp.int32(nvalid), D, method=method)
    js, jc = np.asarray(js), np.asarray(jc)
    ts, tc = tport.destination_sort(
        torch.from_numpy(rows)[None], torch.from_numpy(dest)[None],
        torch.tensor([nvalid], dtype=torch.int32), D, method=method)
    ts, tc = ts[0].numpy(), tc[0].numpy()
    np.testing.assert_array_equal(tc, jc)
    off = 0
    for d in range(D):
        n = int(jc[d])
        assert _multiset(ts[off:off + n]) == _multiset(js[off:off + n]), d
        off += n
    if method in ("argsort", "counting"):   # stable: exact order
        np.testing.assert_array_equal(ts[:nvalid], js[:nvalid])


@pytest.mark.parametrize("case", [
    # (R, P, W, cap, nvalid, key skew)
    (16, 8, 10, 700, 650, "uniform"),
    (200, 8, 25, 1024, 1000, "uniform"),
    (5, 8, 10, 300, 300, "uniform"),      # R < P: empty device ranges
    (16, 8, 1, 400, 123, "onehot"),
    (40, 8, 3, 512, 512, "zipf"),
    (9, 1, 10, 256, 200, "uniform"),
])
def test_partition_major_sort_aligned(case):
    R, P, W, cap, nvalid, skew = case
    rng = np.random.default_rng(R * 31 + W)
    rows = _rows(R + W, cap, W)
    rows[:, 0] = np.arange(cap) + 1          # row id (dummies are zero)
    if skew == "onehot":
        part = np.full(cap, R // 2, np.int32)
    elif skew == "zipf":
        part = np.minimum(rng.zipf(1.3, cap) - 1, R - 1).astype(np.int32)
    else:
        part = rng.integers(0, R, cap).astype(np.int32)
    from sparkucx_tpu.ops.pallas.ragged_a2a import chunk_rows_for
    chunk = chunk_rows_for(W)
    bounds = jax_bounds(R, P)
    js, jr, jd = jref.partition_major_sort_aligned(
        jnp.asarray(rows), jnp.asarray(part), jnp.int32(nvalid), R, bounds,
        chunk)
    js, jr, jd = np.asarray(js), np.asarray(jr), np.asarray(jd)
    ts, tr, td = tport.partition_major_sort_aligned(
        torch.from_numpy(rows)[None], torch.from_numpy(part)[None],
        torch.tensor([nvalid], dtype=torch.int32), R, bounds, chunk)
    ts, tr, td = ts[0].numpy(), tr[0].numpy(), td[0].numpy()
    assert ts.shape == js.shape == (cap + P * chunk, W)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(td, jd)
    off = 0
    for d in range(P):
        n = int(td[d])
        aligned = -(-n // chunk) * chunk
        assert off % chunk == 0, f"device {d} segment starts unaligned"
        seg_t, seg_j = ts[off:off + n], js[off:off + n]
        assert _multiset(seg_t) == _multiset(seg_j), f"device {d}"
        # real rows are partition-sorted and inside d's partition range
        seg_part = part[seg_t[:, 0] - 1]
        assert (np.diff(seg_part) >= 0).all(), f"device {d} order"
        assert ((seg_part >= bounds[d]) & (seg_part < bounds[d + 1])).all()
        # armed dummy rows fill the segment's tail with zeros
        assert not ts[off + n:off + aligned].any(), f"device {d} pad"
        off += aligned
    assert off <= ts.shape[0]


I64 = np.iinfo(np.int64)
RANGE_EDGE_KEYS = np.array([I64.min, I64.min + 1, -(1 << 32) - 1, -(1 << 32),
                            -(1 << 31), -1, 0, 1, (1 << 31) - 1, 1 << 31,
                            (1 << 32) - 1, 1 << 32, I64.max - 1, I64.max],
                           dtype=np.int64)


@pytest.mark.parametrize("bounds_kind", ["extremes", "random", "dups",
                                         "empty"])
def test_range_partition_words_matches_reference(bounds_kind):
    """#(b <= key) over signed int64, exact: the port's binary search over
    the rebuilt key against np.searchsorted and against the reference's
    broadcast word compare, at the int64 extremes and across the 32-bit
    word seams."""
    rng = np.random.default_rng(len(bounds_kind))
    keys = np.concatenate([RANGE_EDGE_KEYS, rng.integers(
        I64.min, I64.max, 3000, dtype=np.int64)])
    if bounds_kind == "extremes":
        bounds = RANGE_EDGE_KEYS.copy()
    elif bounds_kind == "random":
        bounds = np.sort(rng.integers(I64.min, I64.max, 40, dtype=np.int64))
    elif bounds_kind == "dups":          # repeated split points: empty ranges
        bounds = np.sort(np.repeat(keys[rng.integers(0, keys.size, 6)], 3))
    else:
        bounds = np.zeros(0, np.int64)
    words = keys.view(np.int32).reshape(-1, 2)
    got = tport.range_partition_words(torch.from_numpy(words[:, 0].copy()),
                                      torch.from_numpy(words[:, 1].copy()),
                                      bounds).numpy()
    want = np.searchsorted(bounds, keys, side="right")
    np.testing.assert_array_equal(got, want)
    jw = np.asarray(jref.range_partition_words(
        jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1]), bounds))
    np.testing.assert_array_equal(got, jw)
    # the numpy and tensor forms of range_partition agree with both
    np.testing.assert_array_equal(tport.range_partition(keys, bounds), want)
    np.testing.assert_array_equal(
        tport.range_partition(torch.from_numpy(keys), bounds).numpy(), want)
    np.testing.assert_array_equal(
        tport.range_partition(keys, bounds),
        jref.range_partition(keys, bounds))


@pytest.mark.parametrize("chunks", [(10,), (3000,), (100, 4000, 7, 0, 900)])
def test_reservoir_sampler_matches_reference(chunks):
    """The same seed and the same chunking give the same reservoir and the
    same split points in both packages."""
    rng = np.random.default_rng(sum(chunks))
    t, j = tport.ReservoirSampler(256, seed=7), jref.ReservoirSampler(256, 7)
    for n in chunks:
        k = rng.integers(I64.min, I64.max, n, dtype=np.int64)
        t.add(k)
        j.add(k)
    assert t.seen == j.seen
    np.testing.assert_array_equal(t.sample(), j.sample())
    np.testing.assert_array_equal(t.bounds(9), j.bounds(9))
    np.testing.assert_array_equal(tport.sample_bounds(t.sample(), 5),
                                  jref.sample_bounds(j.sample(), 5))


def test_reservoir_sampler_rejects_bad_input():
    with pytest.raises(ValueError):
        tport.ReservoirSampler(0)
    s = tport.ReservoirSampler(4)
    with pytest.raises(ValueError):
        s.bounds(3)                      # nothing seen yet
    with pytest.raises(ValueError):
        s.add(np.zeros((2, 2), np.int64))
    assert s.sample().size == 0
