"""Port parity for the merge half of ``ops/segmented``: ``merge_rows``
and ``merge_reduce_rows`` of the port (``pallas``, which is the merge
kernel's plain version on a CPU tensor, and ``jnp``) against the
reference's merge-path kernel in interpret mode, shard by shard, on the
same seeded sorted inputs (``torch_merge_cases``).

Exact: valid rows, their partition ids and pcounts (the ``jnp`` impl
sorts unstably, so rows of equal (partition, key) are compared as a
multiset there), the sentinel partition on every row past the valid
total, int32 ring sums and carried lanes. Float32 sums: within the
sequential-summation bound ``n * 2**-24 * sum|v|`` of each n-row run,
because the reference adds per-tile matmul partials in float32 and the
port adds in float64 and rounds once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import segmented as jseg
from sparkucx_tpu_torch.ops import segmented as tseg
from torch_merge_cases import (MERGE_PATTERNS, MERGE_WIDTHS, R,
                               combined_case, merge_case)


P = 2
_CASES = {}


def _case(pattern, width):
    """The seeded inputs and the reference's per-shard merge, made once
    per (pattern, width) and shared by both impls' cases."""
    key = (pattern, width)
    if key not in _CASES:
        rng = np.random.default_rng(MERGE_PATTERNS.index(pattern) * 10
                                    + width)
        a_rows, a_part, b_rows, b_part, out_cap = merge_case(rng, P, width,
                                                             pattern)
        ref = []
        for p in range(P):
            rows, part, _ = jseg.merge_rows(
                jnp.asarray(a_rows[p]), jnp.asarray(a_part[p]),
                jnp.asarray(b_rows[p]), jnp.asarray(b_part[p]), R,
                impl="pallas", interpret=True)
            ref.append((np.asarray(rows), np.asarray(part)))
        _CASES[key] = (a_rows, a_part, b_rows, b_part, out_cap, ref)
    return _CASES[key]


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("width", MERGE_WIDTHS)
@pytest.mark.parametrize("pattern", MERGE_PATTERNS)
def test_merge_rows_matches_reference(pattern, width, impl):
    a_rows, a_part, b_rows, b_part, out_cap, ref = _case(pattern, width)
    rows, part, pcounts = tseg.merge_rows(
        torch.from_numpy(a_rows), torch.from_numpy(a_part),
        torch.from_numpy(b_rows), torch.from_numpy(b_part), R, impl=impl,
        out_cap=out_cap)
    n_out = a_rows.shape[1] + b_rows.shape[1] if out_cap is None \
        else out_cap
    assert tuple(rows.shape) == (P, n_out, width)
    rows, part, pcounts = rows.numpy(), part.numpy(), pcounts.numpy()
    for p in range(P):
        want_rows, want_part = ref[p]
        want_rows, want_part = want_rows[:n_out], want_part[:n_out]
        want_counts = np.bincount(want_part[want_part < R], minlength=R)
        np.testing.assert_array_equal(pcounts[p], want_counts)
        n = int(want_counts.sum())
        np.testing.assert_array_equal(part[p], want_part)
        assert (part[p, n:] == R).all()
        assert not rows[p, n:].any()
        if impl == "pallas":
            np.testing.assert_array_equal(rows[p], want_rows)
        else:
            np.testing.assert_array_equal(rows[p, :n, :2],
                                          want_rows[:n, :2])
            assert sorted(map(tuple, rows[p, :n].tolist())) == \
                sorted(map(tuple, want_rows[:n].tolist()))


def test_merge_ties_take_the_first_side():
    """Equal (partition, key) rows: every row of A precedes every equal
    row of B, and each side keeps its order (the merge is stable)."""
    a = torch.zeros((1, 3, 3), dtype=torch.int32)
    b = torch.zeros((1, 3, 3), dtype=torch.int32)
    a[0, :, 0] = torch.tensor([5, 5, 9])
    b[0, :, 0] = torch.tensor([5, 5, 5])
    a[0, :, 2] = torch.tensor([1, 2, 3])
    b[0, :, 2] = torch.tensor([4, 5, 6])
    part = torch.tensor([[1, 1, 1]], dtype=torch.int32)
    rows, _, pcounts = tseg.merge_rows(a, part, b, part, R, impl="pallas")
    assert rows[0, :, 2].tolist() == [1, 2, 4, 5, 6, 3]
    assert pcounts[0, 1] == 6


def test_merge_rejects_bad_shapes():
    a = torch.zeros((2, 4, 3), dtype=torch.int32)
    pa = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):                  # out_cap > ca + cb
        tseg.merge_rows(a, pa, a, pa, R, impl="pallas", out_cap=9)
    with pytest.raises(ValueError):                  # widths differ
        tseg.merge_rows(a, pa, a[..., :2].contiguous(), pa, R)
    with pytest.raises(ValueError):                  # shard counts differ
        tseg.merge_rows(a, pa, a[:1], pa[:1], R)
    with pytest.raises(ValueError):                  # unknown impl
        tseg.merge_rows(a, pa, a, pa, R, impl="xla")
    with pytest.raises(ValueError):                  # the kernel: CUDA only
        tseg.merge_kernel(a, pa, a, pa)


def _run_tolerance(rows, part, sw):
    """[cap, sw] per output run: n * 2**-24 * sum|v| over the run's rows
    of the concatenated input, keyed by (partition, key)."""
    key = rows[:, :2].copy().view(np.int64)[:, 0]
    live = part < R
    v = np.abs(rows[live, 2:2 + sw].copy().view(np.float32)
               .astype(np.float64))
    groups = {}
    for kk, pp, vv in zip(key[live], part[live], v):
        n, s = groups.get((pp, kk), (0, 0.0))
        groups[(pp, kk)] = (n + 1, s + vv)
    return groups


_REDUCE_CASES = {}


def _reduce_case(dtype, sum_words, width):
    """Two combined sides and the reference's per-shard merge + reduce,
    made once per (dtype, sum_words) and shared by both impls' cases."""
    key = (dtype, sum_words)
    if key not in _REDUCE_CASES:
        rng = np.random.default_rng(7 + sum_words)
        sides = combined_case(rng, P, width, dtype, sum_words)
        a_rows, a_part, b_rows, b_part = sides
        ref = []
        for p in range(P):
            ro, pc, n = jseg.merge_reduce_rows(
                jnp.asarray(a_rows[p]), jnp.asarray(a_part[p]),
                jnp.asarray(b_rows[p]), jnp.asarray(b_part[p]), R,
                width - 2, np.dtype(dtype), sum_words=sum_words,
                impl="pallas", interpret=True)
            ref.append((np.asarray(ro), np.asarray(pc),
                        int(np.asarray(n)[0])))
        _REDUCE_CASES[key] = sides + (ref,)
    return _REDUCE_CASES[key]


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("dtype,sum_words", [("int32", 0), ("int32", 2),
                                             ("float32", 0),
                                             ("float32", 1)])
def test_merge_reduce_rows_matches_reference(dtype, sum_words, impl):
    width = 6
    a_rows, a_part, b_rows, b_part, ref = _reduce_case(dtype, sum_words,
                                                       width)
    vdt = np.dtype(dtype)
    # the fold's out_cap: the most valid rows a shard's two sides hold
    acc_cap = int(((a_part < R).sum(1) + (b_part < R).sum(1)).max())
    assert acc_cap < a_rows.shape[1] + b_rows.shape[1]
    rows, pcounts, n_out = tseg.merge_reduce_rows(
        torch.from_numpy(a_rows), torch.from_numpy(a_part),
        torch.from_numpy(b_rows), torch.from_numpy(b_part), R, width - 2,
        vdt, sum_words=sum_words, impl=impl, out_cap=acc_cap)
    rows, pcounts, n_out = rows.numpy(), pcounts.numpy(), n_out.numpy()
    sw = sum_words or width - 2
    for p in range(P):
        ro, pc, n = ref[p]
        assert n_out[p] == n and n <= acc_cap
        np.testing.assert_array_equal(pcounts[p], pc)
        exact = [0, 1] + list(range(2 + sw, width))
        np.testing.assert_array_equal(rows[p, :n][:, exact], ro[:n][:, exact])
        assert not rows[p, n:].any() and not ro[n:].any()
        if dtype == "int32":
            np.testing.assert_array_equal(rows[p, :n], ro[:n])
            continue
        cat = np.concatenate([a_rows[p], b_rows[p]])
        pcat = np.concatenate([a_part[p], b_part[p]])
        groups = _run_tolerance(cat, pcat, sw)
        got = rows[p, :n, 2:2 + sw].copy().view(np.float32)
        want = ro[:n, 2:2 + sw].copy().view(np.float32)
        keys = rows[p, :n, :2].copy().view(np.int64)[:, 0]
        part_of = np.repeat(np.arange(R), pc)
        for j in range(n):
            cnt, s = groups[(part_of[j], keys[j])]
            assert (np.abs(got[j].astype(np.float64) - want[j])
                    <= cnt * 2.0 ** -24 * s).all(), f"row {j}"
