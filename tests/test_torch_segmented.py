"""Port parity for ``ops/segmented``: the segment reduce's plain version
(what the wrapper runs for a CPU tensor) against the reference's Pallas
kernel in interpret mode and against its jnp path, on the same seeded
sorted inputs; and ``resolve_kernel_impl`` against the reference's table
of outcomes.

Exact: n_out, pcounts, key lanes, carried lanes, int32 ring sums, the
zero/sentinel tail. Float32 sums: within ``rtol=1e-5`` and ``atol =
2**-22 * sum(|v|)``, because the three formulations add in different
orders (the reference kernel by per-tile matmul partials, its jnp path
by float32 prefix-sum differences, the port in float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import segmented as jseg
from sparkucx_tpu_torch.ops import segmented as tseg

R = 5


def _sorted_case(rng, cap, width, pattern, dtype, sum_words):
    """rows [cap, W] int32 sorted by (part, key), part [cap] (sentinel R
    rows zeroed at the tail); carried lanes are constant per key."""
    if pattern == "empty":
        return np.zeros((cap, width), np.int32), np.full(cap, R, np.int32)
    n_real = cap - (cap // 5 if pattern == "tail" else 0)
    if pattern == "long":                  # runs of 150..400 rows
        keys = np.repeat(rng.integers(-50, 50, 8), rng.integers(150, 400, 8))
    elif pattern == "single":
        keys = np.full(n_real, 123456789012)
    else:                                  # runs of 1..8 rows
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, n_real),
                         rng.integers(1, 9, n_real))
    keys = keys[:n_real].astype(np.int64)
    keys = np.concatenate([keys, np.zeros(n_real - keys.size, np.int64)])
    part = (keys % R).astype(np.int32)     # a key lives in one partition
    order = np.lexsort((keys, part))
    keys, part = keys[order], part[order]
    rows = np.zeros((cap, width), np.int32)
    rows[:n_real, :2] = keys.view(np.int32).reshape(n_real, 2)
    vw = width - 2
    if dtype == "float32":
        v = rng.standard_normal((n_real, vw)).astype(np.float32)
    else:
        v = rng.integers(-(1 << 31), 1 << 31, (n_real, vw)).astype(np.int32)
    rows[:n_real, 2:] = v.view(np.int32)
    sw = sum_words or vw
    rows[:n_real, 2 + sw:] = (keys * 31 + part)[:, None].astype(np.int32)
    full_part = np.full(cap, R, np.int32)
    full_part[:n_real] = part
    return rows, full_part


def _check_sums(got, want, rows, sw, dtype):
    g = got[:, 2:2 + sw].copy()
    w = want[:, 2:2 + sw].copy()
    if dtype == "float32":
        v = rows[:, 2:2 + sw].copy().view(np.float32)
        np.testing.assert_allclose(g.view(np.float32), w.view(np.float32),
                                   rtol=1e-5,
                                   atol=2.0 ** -22 * float(np.abs(v).sum()))
    else:
        np.testing.assert_array_equal(g, w)


CASES = [
    # (cap, width, pattern, dtype, sum_words)
    (640, 3, "short", "int32", 0),
    (700, 6, "tail", "int32", 0),
    (700, 6, "tail", "float32", 2),
    (1500, 6, "long", "int32", 3),
    (1500, 25, "long", "float32", 0),
    (300, 25, "short", "int32", 10),
    (900, 6, "single", "float32", 0),
    (256, 6, "empty", "int32", 0),
    (200, 3, "tail", "float32", 0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_segment_reduce_matches_reference_kernel(case):
    cap, width, pattern, dtype, sum_words = case
    rng = np.random.default_rng(CASES.index(case))
    rows, part = _sorted_case(rng, cap, width, pattern, dtype, sum_words)
    vw = width - 2
    ro, pc, n = tseg.segment_reduce_rows(
        torch.from_numpy(rows)[None], torch.from_numpy(part)[None], R, vw,
        np.dtype(dtype), sum_words=sum_words, impl="pallas")
    got = ro[0].numpy()
    jro, jpc, jn = map(np.asarray, jseg.segment_reduce_rows(
        jnp.asarray(rows), jnp.asarray(part), R, vw, np.dtype(dtype),
        sum_words=sum_words, impl="pallas", interpret=True))
    m = int(jn[0])
    assert int(n[0]) == m
    if pattern == "long":
        assert m <= 8                      # runs far longer than a tile
    np.testing.assert_array_equal(pc[0].numpy(), jpc)
    sw = sum_words or vw
    exact = np.r_[0, 1, 2 + sw:width]
    np.testing.assert_array_equal(got[:, exact], jro[:, exact])
    np.testing.assert_array_equal(got[m:], 0)
    _check_sums(got, jro, rows, sw, dtype)

    # the reference's jnp path agrees on n_out, pcounts, keys and sums
    jjro, jjpc, jjn = map(np.asarray, jseg.segment_reduce_rows(
        jnp.asarray(rows), jnp.asarray(part), R, vw, np.dtype(dtype),
        sum_words=sum_words, impl="jnp"))
    assert int(jjn[0]) == m
    np.testing.assert_array_equal(jjpc, jpc)
    np.testing.assert_array_equal(got[:m, exact], jjro[:m, exact])
    _check_sums(got[:m], jjro[:m], rows, sw, dtype)

    # and so does the port's own jnp path
    tro, tpc, tn = tseg.segment_reduce_rows(
        torch.from_numpy(rows)[None], torch.from_numpy(part)[None], R, vw,
        np.dtype(dtype), sum_words=sum_words, impl="jnp")
    assert int(tn[0]) == m
    assert torch.equal(tpc, pc)
    np.testing.assert_array_equal(tro[0].numpy()[:m, exact], got[:m, exact])


def test_segment_reduce_batched_shards_are_independent():
    """Five shards in one call, each against the reference on its own.
    Shards 1 and 2 hold one run each of the same (partition, key): the
    run that ends shard 1 and the one that starts shard 2 never merge."""
    rng = np.random.default_rng(41)
    cap, width = 600, 6
    pats = ("short", "single", "single", "empty", "tail")
    shards = [_sorted_case(rng, cap, width, p, "int32", 0) for p in pats]
    rows = np.stack([s[0] for s in shards])
    part = np.stack([s[1] for s in shards])
    ro, pc, n = tseg.segment_reduce_rows(
        torch.from_numpy(rows), torch.from_numpy(part), R, 4, np.int32,
        impl="pallas")
    assert n[1:4].tolist() == [1, 1, 0]
    for b in range(len(pats)):
        jro, jpc, jn = map(np.asarray, jseg.segment_reduce_rows(
            jnp.asarray(rows[b]), jnp.asarray(part[b]), R, 4, np.int32,
            impl="pallas", interpret=True))
        assert int(n[b]) == int(jn[0])
        np.testing.assert_array_equal(pc[b].numpy(), jpc)
        np.testing.assert_array_equal(ro[b].numpy(), jro)


def test_segment_reduce_plain_edges():
    """No rows at all, a sum-free reduce (every value word carried), and
    the argument checks the kernel wrapper shares."""
    z = torch.zeros((2, 0, 4), dtype=torch.int32)
    ro, po, n = tseg.segment_reduce_plain(
        z, torch.zeros((2, 0), dtype=torch.int32), R, 2, False)
    assert ro.shape == (2, 0, 4) and n.tolist() == [0, 0]
    rows = torch.tensor([[[1, 0, 5, 6], [1, 0, 7, 6], [2, 0, 9, 9]]],
                        dtype=torch.int32)
    part = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    ro, po, n = tseg.segment_reduce_plain(rows, part, R, 0, False)
    assert n.tolist() == [2]
    assert ro[0].tolist() == [[1, 0, 5, 6], [2, 0, 9, 9], [0, 0, 0, 0]]
    assert po[0].tolist() == [0, 0, R]
    with pytest.raises(ValueError):
        tseg.segment_reduce_plain(rows, part, R, 3, False)
    with pytest.raises(ValueError):
        tseg.segment_reduce_plain(rows.long(), part, R, 1, False)
    with pytest.raises(ValueError):
        tseg.segment_reduce_kernel(rows, part, R, 1, False)   # CPU tensor
    with pytest.raises(ValueError):
        tseg.segment_reduce_rows(rows, part, R, 1, np.int16, impl="pallas")


def test_drop_sentinel_group_matches_reference():
    part = np.array([[0, 1, R, R], [0, 0, 1, 2], [R, R, R, R]], np.int32)
    n = np.array([3, 3, 1], np.int32)
    got = tseg._drop_sentinel_group(torch.from_numpy(n),
                                    torch.from_numpy(part), R)
    want = [int(jseg._drop_sentinel_group(jnp.asarray(n[i]),
                                          jnp.asarray(part[i]), R))
            for i in range(3)]
    assert got.tolist() == want


DTYPES = [None, np.float32, np.int32, np.uint32, np.int16, np.float16,
          np.int8]


@pytest.mark.parametrize("requested", ["auto", "jnp", "pallas"])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_resolve_kernel_impl_matches_reference_table(requested, dt):
    """The TPU backend's outcome is the card's, the CPU backend's is the
    CPU's (both have a runnable pallas: the kernel, or interpret mode and
    the plain version)."""
    for jax_backend, dev in (("tpu", torch.device("cuda", 0)),
                             ("cpu", torch.device("cpu"))):
        want = jseg.resolve_kernel_impl(requested, jax_backend,
                                        combine_dtype=dt)
        got = tseg.resolve_kernel_impl(requested, dev, combine_dtype=dt)
        assert got == want, (jax_backend, got, want)


def test_resolve_kernel_impl_rejects_unknown():
    with pytest.raises(ValueError):
        tseg.resolve_kernel_impl("triton", torch.device("cpu"))
    assert tseg.pallas_reduce_supported(np.float32)
    assert not tseg.pallas_reduce_supported(np.float16)
