"""Port parity for ``ops/aggregate``: ``keysort_rows``, ``combine_rows``
and ``check_combinable`` against ``sparkucx_tpu.ops.aggregate`` on the
same seeded numpy inputs.

Exact: partition order, key order, per-partition counts, n_out, key and
carried lanes, integer sums (int32 and int16 ring sums), float16 sums on
exactly representable inputs. Float32 sums: within ``rtol=1e-5`` and
``atol = 2**-22 * sum(|v|)`` of the shard, because the reference takes
them as differences of float32 prefix sums, which lose low bits on long
prefixes, and the port's float64 differences do not. Rows of equal
(partition, key) may come out in another order (both sorts are
unstable), so keysort rows are compared as multisets per group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops import aggregate as jagg
from sparkucx_tpu_torch.ops import aggregate as tagg

B = 3        # shards per port call; the reference runs one at a time


def _keys(rng, n, kind):
    if kind == "dup":                      # many repeats, both signs
        return rng.integers(-40, 40, n).astype(np.int64) * (1 << 31) \
            + rng.integers(0, 3, n)
    if kind == "extreme":
        pool = np.array([np.iinfo(np.int64).min, -1, 0, 1, 1 << 32,
                         (1 << 32) - 1, np.iinfo(np.int64).max], np.int64)
        return pool[rng.integers(0, pool.size, n)]
    return rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                        dtype=np.int64)


def _rows(rng, cap, width, kind):
    rows = rng.integers(-(1 << 31), 1 << 31, (cap, width)).astype(np.int32)
    rows[:, :2] = _keys(rng, cap, kind).view(np.int32).reshape(cap, 2)
    return rows


def _canon(part, rows, n):
    """(part, row) of the first n rows in one lexicographic order."""
    blk = np.concatenate([part[:n, None], rows[:n]], axis=1)
    return blk[np.lexsort(blk.T[::-1])]


@pytest.mark.parametrize("kind", ["dup", "extreme", "unique"])
@pytest.mark.parametrize("R", [1, 7])
def test_keysort_rows_matches_reference(kind, R):
    rng = np.random.default_rng(R * 10 + len(kind))
    cap, W = 700, 5
    rows = np.stack([_rows(rng, cap, W, kind) for _ in range(B)])
    part = rng.integers(0, R, (B, cap)).astype(np.int32)
    nvalid = np.array([cap, 333, 0], np.int32)
    sp, sr, pc = tagg.keysort_rows(torch.from_numpy(rows),
                                   torch.from_numpy(part),
                                   torch.from_numpy(nvalid), R)
    for b in range(B):
        jsp, jsr, jpc = map(np.asarray, jagg.keysort_rows(
            jnp.asarray(rows[b]), jnp.asarray(part[b]),
            jnp.int32(nvalid[b]), R))
        n = int(nvalid[b])
        np.testing.assert_array_equal(sp[b].numpy(), jsp)
        np.testing.assert_array_equal(pc[b].numpy(), jpc)
        got = sr[b].numpy()
        key = lambda r: r[:n, :2].copy().view(np.int64).ravel()
        np.testing.assert_array_equal(key(got), key(jsr))
        np.testing.assert_array_equal(_canon(jsp, got, n),
                                      _canon(jsp, jsr, n))


def _values(rng, cap, dtype, n_elems):
    if dtype == "int32":                   # wraps mod 2**32 in the sums
        return rng.integers(-(1 << 31), 1 << 31, (cap, n_elems)) \
            .astype(np.int32)
    if dtype == "int16":
        return rng.integers(-(1 << 15), 1 << 15, (cap, n_elems)) \
            .astype(np.int16)
    if dtype == "float16":                 # quarters: every sum is exact
        return (rng.integers(-32, 32, (cap, n_elems)) / 4).astype(np.float16)
    return rng.standard_normal((cap, n_elems)).astype(np.float32)


CASES = [
    # (dtype, value elements, sum_words, compaction)
    ("int32", 3, 0, "stable"),
    ("int32", 3, 2, "unstable"),
    ("float32", 4, 0, "unstable"),
    ("float32", 4, 1, "stable"),
    ("int16", 4, 0, "stable"),
    ("int16", 6, 2, "unstable"),
    ("float16", 4, 1, "stable"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_combine_rows_matches_reference(case):
    dtype, n_elems, sum_words, compaction = case
    rng = np.random.default_rng(CASES.index(case))
    cap, R = 900, 6
    vdt = np.dtype(dtype)
    vw = n_elems * vdt.itemsize // 4
    W = 2 + vw + 1                          # one slack word past the value
    rows = np.zeros((B, cap, W), np.int32)
    part = np.zeros((B, cap), np.int32)
    for b in range(B):
        keys = rng.integers(0, 150, cap).astype(np.int64) - 75
        rows[b, :, :2] = keys.view(np.int32).reshape(cap, 2)
        vals = _values(rng, cap, dtype, n_elems)
        rows[b, :, 2:2 + vw] = vals.view(np.int32).reshape(cap, vw)
        if sum_words:                      # carried words: constant per key
            rows[b, :, 2 + sum_words:2 + vw] = (keys * 7 + 3)[:, None]
        rows[b, :, -1] = rng.integers(0, 1 << 30, cap)
        part[b] = (keys % R).astype(np.int32)
    nvalid = np.array([cap, 517, 1], np.int32)
    ro, pc, n = tagg.combine_rows(
        torch.from_numpy(rows), torch.from_numpy(part),
        torch.from_numpy(nvalid), R, vw, vdt, sum_words=sum_words,
        compaction=compaction)
    for b in range(B):
        jro, jpc, jn = map(np.asarray, jagg.combine_rows(
            jnp.asarray(rows[b]), jnp.asarray(part[b]),
            jnp.int32(nvalid[b]), R, vw, vdt, sum_words=sum_words,
            compaction=compaction))
        assert int(n[b]) == int(jn[0])
        np.testing.assert_array_equal(pc[b].numpy(), jpc)
        got = ro[b].numpy()
        m = int(jn[0])
        np.testing.assert_array_equal(got[m:], 0)
        sw = sum_words or vw
        exact = np.r_[0, 1, 2 + sw:W]      # keys, carried lanes, slack
        np.testing.assert_array_equal(got[:, exact], jro[:, exact])
        gs = got[:m, 2:2 + sw].copy().view(vdt)
        js = jro[:m, 2:2 + sw].copy().view(vdt)
        if dtype == "float32":
            v = rows[b, :nvalid[b], 2:2 + sw].copy().view(np.float32)
            atol = 2.0 ** -22 * float(np.abs(v).sum())
            np.testing.assert_allclose(gs, js, rtol=1e-5, atol=atol)
        else:
            np.testing.assert_array_equal(gs, js)


def test_compactions_are_bit_identical():
    rng = np.random.default_rng(9)
    cap, R = 500, 4
    rows = np.stack([_rows(rng, cap, 4, "dup") for _ in range(2)])
    part = rng.integers(0, R, (2, cap)).astype(np.int32)
    nv = torch.tensor([cap, 250])
    a = tagg.combine_rows(torch.from_numpy(rows), torch.from_numpy(part), nv,
                          R, 2, np.float32, compaction="stable")
    b = tagg.combine_rows(torch.from_numpy(rows), torch.from_numpy(part), nv,
                          R, 2, np.float32, compaction="unstable")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tagg.combine_rows(torch.from_numpy(rows), torch.from_numpy(part), nv,
                          R, 2, np.int32, compaction="bogus")
    with pytest.raises(ValueError):
        tagg.combine_rows(torch.from_numpy(rows), torch.from_numpy(part), nv,
                          R, 2, np.int32, sum_words=3)


@pytest.mark.parametrize("schema", [
    ((3,), np.int32, "sum"), ((2,), np.float32, "sum"),
    ((4,), np.int16, "sum"), ((4,), np.int8, "sum"),
    ((3,), np.int16, "sum"), ((2,), np.float64, "sum"),
    ((2,), np.int32, "max"), ((1,), None, "sum"),
    ((2,), np.bool_, "sum")], ids=str)
def test_check_combinable_matches_reference(schema):
    tail, dt, op = schema

    def outcome(fn):
        try:
            fn(tail, dt, op)
            return "ok"
        except ValueError:
            return "raises"
    assert outcome(tagg.check_combinable) == outcome(jagg.check_combinable)
