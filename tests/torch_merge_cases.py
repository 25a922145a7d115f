"""Seeded inputs for the merge tests of the PyTorch port (no JAX import:
the card tests use them too).

:func:`merge_case` builds the two sides of a merge for ``P`` shards, each
side ``[P, cap, W]`` int32 rows sorted by (partition, signed int64 key)
with ``[P, cap]`` partition ids, the sentinel ``R`` and zero rows past the
side's valid count, as the receive buffers hold them. :func:`combined_case`
builds two COMBINED sides (one row per (partition, key) on each side, some
keys on both) for a merge + reduce."""

import numpy as np

R = 7

MERGE_PATTERNS = ("interleaved", "a_before_b", "ties", "a_empty", "b_empty",
                  "all_sentinel", "sign_bits", "ragged", "out_cap")

# keys whose lo word has its high bit set or clear and whose hi word is
# negative or not: signed int64 order must hold across all of them
SIGN_KEYS = np.array([0, 1, -1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1 << 32,
                      -(1 << 32), (1 << 32) + 0x80000000, -(1 << 31),
                      -(1 << 31) - 1, 1 << 62, -(1 << 62), -(1 << 63),
                      (1 << 63) - 1], dtype=np.int64)

# (ca, na, cb, nb): capacities and valid rows of shard 0; later shards
# hold a few rows fewer
_SIZES = {"interleaved": (300, 280, 200, 150), "a_before_b": (300, 300, 300,
          299), "ties": (260, 250, 260, 240), "a_empty": (64, 0, 300, 290),
          "b_empty": (300, 300, 0, 0), "all_sentinel": (100, 0, 150, 0),
          "sign_bits": (200, 190, 180, 170), "ragged": (257, 257, 511, 300),
          "out_cap": (300, 280, 200, 150)}


def _side(rng, cap: int, n: int, width: int, keys, parts):
    order = np.lexsort((keys, parts))
    rows = np.zeros((cap, width), np.int32)
    part = np.full(cap, R, np.int32)
    if n:
        rows[:n, :2] = keys[order].view(np.int32).reshape(n, 2)
        rows[:n, 2:] = rng.integers(-(1 << 31), 1 << 31, (n, width - 2))
        part[:n] = parts[order]
    return rows, part


def _keys_parts(rng, pattern: str, n: int, side: str):
    if pattern == "a_before_b":
        lo, hi = (0, 4) if side == "a" else (4, R)
        return (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
                rng.integers(lo, hi, n))
    if pattern == "ties":                 # few keys: equal rows both sides
        keys = rng.integers(-20, 20, n).astype(np.int64) * (1 << 33)
        return keys, (keys >> 33) % R
    if pattern == "sign_bits":
        return rng.choice(SIGN_KEYS, n), rng.integers(0, 3, n)
    return (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            rng.integers(0, R, n))


def merge_case(rng, P: int, width: int, pattern: str):
    """(a_rows, a_part, b_rows, b_part, out_cap) as numpy arrays;
    ``out_cap`` is None except for the ``out_cap`` pattern, where it cuts
    into the valid rows."""
    ca, na, cb, nb = _SIZES[pattern]
    sides = {"a": ([], []), "b": ([], [])}
    for p in range(P):
        for side, cap, n in (("a", ca, na), ("b", cb, nb)):
            n = max(0, n - 3 * p) if n else 0
            keys, parts = _keys_parts(rng, pattern, n, side)
            rows, part = _side(rng, cap, n, width, keys, parts)
            sides[side][0].append(rows)
            sides[side][1].append(part)
    out_cap = (ca + cb) // 2 + 3 if pattern == "out_cap" else None
    return (np.stack(sides["a"][0]), np.stack(sides["a"][1]),
            np.stack(sides["b"][0]), np.stack(sides["b"][1]), out_cap)


def combined_case(rng, P: int, width: int, dtype: str, sum_words: int):
    """Two combined sides ([P, cap, W] rows, [P, cap] part each): unique
    (partition, key) rows per side, a key's partition is key % R, about
    half of B's keys also on A; carried lanes (past ``sum_words``) are a
    constant of the key."""
    out = []
    for cap, n in ((160, 150), (120, 100)):
        rows_p, part_p = [], []
        for p in range(P):
            keys = rng.choice(300, n - p, replace=False).astype(np.int64) \
                * 1_000_003 - 150 * 1_000_003
            parts = keys % R
            rows, part = _side(rng, cap, n - p, width, keys, parts)
            m = n - p
            vw = width - 2
            if dtype == "float32":
                rows[:m, 2:] = rng.standard_normal((m, vw)).astype(
                    np.float32).view(np.int32)
            if 0 < sum_words < vw:
                k = rows[:m, :2].copy().view(np.int64)[:, 0]
                rows[:m, 2 + sum_words:] = (k % 977)[:, None].astype(
                    np.int32)
            rows_p.append(rows)
            part_p.append(part)
        out += [np.stack(rows_p), np.stack(part_p)]
    return tuple(out)
