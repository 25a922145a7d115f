"""Seeded int8 wire rows for the fused dequant segment-reduce tests of
the PyTorch port (no JAX import: the card tests use them too).

:func:`wire_case` builds ``P`` shards of wire rows ``[P, cap, 2 +
int8_wire_words(ww)]`` int32 — exact key lanes, random int8 values packed
four to a word (odd ``ww`` leave pad bytes), a float32 scale per row —
sorted by (partition, key) with the sentinel ``R`` on the rows past each
shard's valid count, and the float32 values they decode to.
:func:`sum_tolerance` is the bound the float32 sums are held to.
:func:`quant_values` builds the float rows the quantize tests feed both
versions of the quantize kernel."""

import numpy as np

R = 5

# per-shard run patterns: runs of 1..8 rows, runs of 150..400 rows
# (across the 256-row blocks of the CUDA kernel and the 128-row tiles of
# the TPU kernel), a sentinel tail, one key over the shard, no rows; and
# "huge" (not cycled): a 5,000-row run, then short runs
PATTERNS = ("short", "long", "tail", "single", "empty")


def _keys(rng, pattern: str, n: int) -> np.ndarray:
    if pattern == "long":                  # runs of 150..400 rows
        keys = np.repeat(rng.integers(-50, 50, 8), rng.integers(150, 400, 8))
    elif pattern == "huge":                # one 5,000-row run, then others
        keys = np.concatenate([np.full(5000, 77), np.repeat(
            rng.integers(100, 1 << 40, n), rng.integers(1, 9, n))])
    elif pattern == "single":
        keys = np.full(n, -123456789012)
    else:                                  # runs of 1..8 rows
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, n),
                         rng.integers(1, 9, n))
    keys = keys[:n].astype(np.int64)
    return np.concatenate([keys, np.zeros(n - keys.size, np.int64)])


def _wire_shard(rng, cap: int, ww: int, pattern: str, sum_words: int,
                per_row_scale: bool):
    """(wire rows [cap, 2 + int8_wire_words(ww)], part [cap], values
    [cap, ww] float32 = int8 * scale) for one shard."""
    qw = -(-ww // 4)
    rows = np.zeros((cap, 2 + qw + 1), np.int32)
    part = np.full(cap, R, np.int32)
    vals = np.zeros((cap, ww), np.float32)
    if pattern == "empty":
        return rows, part, vals
    n = cap - (cap // 5 if pattern == "tail" else 0)
    keys = _keys(rng, pattern, n)
    p = (keys % R).astype(np.int32)        # a key lives in one partition
    order = np.lexsort((keys, p))
    keys, p = keys[order], p[order]
    q = rng.integers(-127, 128, (n, ww)).astype(np.int8)
    sw = sum_words or ww
    q[:, sw:] = ((keys * 7 + 3)[:, None] % 255 - 127).astype(np.int8)
    key_scale = np.exp(rng.normal(0, 3, 1 << 10)).astype(np.float32)
    scale = (np.exp(rng.normal(0, 3, n)).astype(np.float32) if per_row_scale
             else key_scale[(keys % 1021).astype(np.int64) % (1 << 10)])
    qb = np.zeros((n, 4 * qw), np.int8)
    qb[:, :ww] = q
    rows[:n, :2] = keys.view(np.int32).reshape(n, 2)
    rows[:n, 2:2 + qw] = qb.view(np.int32)
    rows[:n, 2 + qw] = scale.view(np.int32)
    part[:n] = p
    vals[:n] = q.astype(np.float32) * scale[:, None]
    return rows, part, vals


def wire_case(seed, P, cap, ww, sum_words, per_row_scale=True,
              patterns=None):
    """(rows, part, values) of ``P`` shards, shard p taking run pattern
    ``patterns[p % len]`` (default: cycling through PATTERNS)."""
    rng = np.random.default_rng(seed)
    pats = patterns or [PATTERNS[(seed + p) % len(PATTERNS)]
                        for p in range(P)]
    shards = [_wire_shard(rng, cap, ww, pats[p % len(pats)], sum_words,
                          per_row_scale) for p in range(P)]
    return (np.stack([s[0] for s in shards]), np.stack([s[1] for s in shards]),
            np.stack([s[2] for s in shards]))


def runs(rows, part):
    """Run id of every valid row of each shard."""
    key = rows[..., :2].copy().view(np.int64)[..., 0]
    out = []
    for p in range(part.shape[0]):
        valid = part[p] < R
        start = valid.copy()
        start[1:] &= (key[p, 1:] != key[p, :-1]) | (part[p, 1:]
                                                    != part[p, :-1])
        out.append((np.cumsum(start) - 1, valid))
    return out


def sum_tolerance(rows, part, vals, sw, prefix: bool = False):
    """[P, cap, sw] per output row j (run j): n * 2**-24 * sum|v| over the
    run's n rows; with ``prefix``, the bound of a float32 prefix-sum
    difference instead (the JAX jnp path): 2 * k * 2**-24 * sum|v| over
    the k rows up to the run's end."""
    cap = part.shape[1]
    tol = np.zeros((part.shape[0], cap, sw))
    for p, (run, valid) in enumerate(runs(rows, part)):
        r = run[valid]
        if not r.size:
            continue
        n = np.bincount(r, minlength=cap)[:cap]
        av = np.abs(vals[p, valid, :sw].astype(np.float64))
        if prefix:
            ends = np.flatnonzero(np.r_[r[1:] != r[:-1], True])
            cum = np.cumsum(av, axis=0)
            tol[p, :ends.size] = 2.0 * (ends[:, None] + 1) * 2.0 ** -24 \
                * cum[ends] + 1e-45
            continue
        for c in range(sw):
            tol[p, :, c] = n * 2.0 ** -24 * np.bincount(
                r, weights=av[:, c], minlength=cap)[:cap] + 1e-45
    return tol


QUANT_KINDS = ("normal", "zero_rows", "magnitudes", "saturate")


def quant_values(rng, n: int, w: int, kind: str) -> np.ndarray:
    """[n, w] float32: standard normal; with all-zero and -0.0 rows; rows
    at their own scale from 1e-30 to 1e30 (and mixed within some rows);
    or lanes near the float32 maximum, whose x / scale lands on 127."""
    x = rng.standard_normal((n, w)).astype(np.float32)
    if kind == "magnitudes":
        row_scale = 10.0 ** rng.uniform(-30, 30, (n, 1))
        x = (x * row_scale).astype(np.float32)
        x[::5] *= (10.0 ** rng.uniform(-4, 4, (1, w))).astype(np.float32)
    if kind in ("zero_rows", "magnitudes"):
        x[::7] = 0.0
        x[3::11, 0] = -0.0
    if kind == "saturate":
        x[:, 0] = np.float32(3.4e38) * np.sign(x[:, 0] + 1e-9)
        x[:, -1] = np.nextafter(x[:, 0], np.float32(0))
    return x
