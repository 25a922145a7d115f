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
                  "all_sentinel", "sign_bits", "ragged", "out_cap",
                  "long_runs", "misaligned", "offset", "out_cap_mid")

# widths of the merge cases: 2 (keys only) to 130 (2 key words + 128
# float32 lanes, the int8 combine fold's full-width rows)
MERGE_WIDTHS = (2, 3, 6, 25, 130)

# "offset": every side tensor is a contiguous view at these storage offsets
# (words) into a larger buffer, so no base is 16-byte aligned
OFFSET_WORDS = (1, 2, 3, 1)

# "long_runs": the merged order alternates between A-only and B-only runs
# of these lengths (A first), longer than a tile of every width's merge
# kernel at the first, shorter at the others, so tile boundaries fall
# inside runs and at their ends
LONG_RUNS = (1500, 1100, 3, 2100, 700, 1, 1300)

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
          "out_cap": (300, 280, 200, 150),
          "long_runs": (sum(LONG_RUNS[0::2]) + 5, sum(LONG_RUNS[0::2]),
                        sum(LONG_RUNS[1::2]) + 2, sum(LONG_RUNS[1::2])),
          "misaligned": (257, 250, 131, 124), "offset": (301, 290, 203, 190),
          "out_cap_mid": (1300, 1250, 900, 850)}

# "out_cap_mid": the cut falls inside a tile at every width's tile rows
# (1024, 512, 98 and 1 for widths up to 12, 25, 130 and above 800)
OUT_CAP_MID = 1524


def _side(rng, cap: int, n: int, width: int, keys, parts):
    order = np.lexsort((keys, parts))
    rows = np.zeros((cap, width), np.int32)
    part = np.full(cap, R, np.int32)
    if n:
        rows[:n, :2] = keys[order].view(np.int32).reshape(n, 2)
        rows[:n, 2:] = rng.integers(-(1 << 31), 1 << 31, (n, width - 2))
        part[:n] = parts[order]
    return rows, part


def _long_runs(rng, na: int, nb: int):
    """Keys and partitions of both sides of ``long_runs``: one sorted
    sequence cut into runs of ``LONG_RUNS`` taken by A and B in turn (a
    shard's shorter sides cut the last runs short); partitions split the
    sequence at a few points, inside runs."""
    total = sum(LONG_RUNS)
    keys = np.sort(rng.integers(-(1 << 40), 1 << 40, total).astype(
        np.int64))
    parts = np.arange(total) * R // total
    side = np.repeat(np.arange(len(LONG_RUNS)) % 2, LONG_RUNS)
    out = []
    for s, n in ((0, na), (1, nb)):
        idx = np.flatnonzero(side == s)[:n]
        out.append((keys[idx], parts[idx]))
    return out


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
        n_a, n_b = (max(0, n - 3 * p) if n else 0 for n in (na, nb))
        runs = _long_runs(rng, n_a, n_b) if pattern == "long_runs" \
            else None
        for s, (side, cap, n) in enumerate((("a", ca, n_a),
                                            ("b", cb, n_b))):
            keys, parts = runs[s] if runs else _keys_parts(rng, pattern, n,
                                                            side)
            rows, part = _side(rng, cap, n, width, keys, parts)
            sides[side][0].append(rows)
            sides[side][1].append(part)
    out_cap = {"out_cap": (ca + cb) // 2 + 3,
               "out_cap_mid": OUT_CAP_MID}.get(pattern)
    arrays = [np.stack(sides["a"][0]), np.stack(sides["a"][1]),
              np.stack(sides["b"][0]), np.stack(sides["b"][1])]
    if pattern == "offset":
        arrays = [with_storage_offset(x, off)
                  for x, off in zip(arrays, OFFSET_WORDS)]
    return (*arrays, out_cap)


def with_storage_offset(x: np.ndarray, off: int) -> np.ndarray:
    """A C-contiguous copy of ``x`` that starts ``off`` elements into a
    larger buffer."""
    buf = np.empty(x.size + off, x.dtype)
    view = buf[off:].reshape(x.shape)
    view[...] = x
    return view


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
