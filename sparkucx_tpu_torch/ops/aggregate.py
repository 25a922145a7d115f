"""Combine-by-key on tensors — the aggregation half of the combine read,
the port of the JAX package's ``ops/aggregate.py``.

* map-side combine: rows are summed per (partition, key) before the
  exchange, so the segment move carries one row per distinct key per
  shard;
* reduce-side combine: received rows are merged per key after the
  exchange (here, or by the segment-reduce kernel in
  :mod:`sparkucx_tpu_torch.ops.segmented`).

Every function is batched over a leading shard dimension, like
:mod:`sparkucx_tpu_torch.ops.partition`: rows ``[B, cap, W]`` int32,
partition ids ``[B, cap]``, valid counts ``[B]``.

Key order: rows carry int64 keys as two int32 words [lo, hi];
lexicographic (hi signed, lo unsigned) order equals signed int64 order,
so the sorts run on the rebuilt int64 key.

Numerics: integer lanes are int32 ring sums (mod 2^32, and mod 2^16 /
2^8 for int16 / int8 values packed several to a word). Float lanes are
summed as prefix-sum differences in float64 and rounded once to the
value dtype. The JAX package takes the same differences in float32, so
its long prefixes lose low bits this formulation keeps: float results
agree within that loss, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import COMPACTIONS
from sparkucx_tpu_torch.ops.partition import (_gather_rows,
                                              counts_from_sorted,
                                              words_to_key)

COMBINERS = ("sum",)
KEY_WORDS = 2

# the lane dtype a value dtype is summed in: ring sums are sign-blind, so
# every integer type sums as the signed type of its width
_LANE_DTYPES = {("f", 2): torch.float16, ("f", 4): torch.float32,
                ("i", 1): torch.int8, ("i", 2): torch.int16,
                ("i", 4): torch.int32}


def check_combinable(val_tail, val_dtype, op: str) -> None:
    """Raise unless the declared value schema supports device combining."""
    if op not in COMBINERS:
        raise ValueError(f"unknown combiner {op!r}; want one of {COMBINERS}")
    if val_dtype is None:
        raise ValueError("combine needs valued rows (keys-only shuffle)")
    vdt = np.dtype(val_dtype)
    numeric = np.issubdtype(vdt, np.integer) or np.issubdtype(vdt, np.floating)
    if not numeric or vdt.itemsize > 4:
        raise ValueError(
            f"combine supports numeric value dtypes up to 4 bytes "
            f"(int8/16/32, float16/32), got {vdt}")
    nbytes = int(np.prod(val_tail, dtype=np.int64)) * vdt.itemsize
    if nbytes % 4:
        raise ValueError(
            f"combine needs the value row to fill whole transport words; "
            f"{val_tail} x {vdt} = {nbytes} B (pad the trailing dim)")


def is_float_dtype(val_dtype) -> bool:
    return np.issubdtype(np.dtype(val_dtype), np.floating)


def _lane_dtype(vdt: np.dtype) -> torch.dtype:
    kind = "f" if np.issubdtype(vdt, np.floating) else "i"
    got = _LANE_DTYPES.get((kind, vdt.itemsize))
    if got is None:
        raise ValueError(f"no lane type for value dtype {vdt}")
    return got


def _valid_mask(num_valid, B: int, cap: int,
                device: torch.device) -> torch.Tensor:
    idx = torch.arange(cap, device=device)
    if isinstance(num_valid, int):       # no host-to-device copy
        return (idx < num_valid).expand(B, cap)
    nv = torch.as_tensor(num_valid, device=device).reshape(-1, 1)
    return (idx[None, :] < nv).expand(B, cap)


def keysort_rows(rows: torch.Tensor, part: torch.Tensor, num_valid,
                 num_parts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort rows by (partition, signed int64 key), padding last.

    rows ``[B, cap, W]``, part ``[B, cap]``, num_valid ``[B]`` (or a
    scalar). Rows at or past ``num_valid`` take the sentinel partition
    ``num_parts``. Returns (spart ``[B, cap]``, srows ``[B, cap, W]``,
    pcounts ``[B, num_parts]``). Equal (partition, key) rows land in an
    unspecified relative order, as in the JAX package: one unstable sort
    by key, then a stable sort by partition, then one row gather."""
    B, cap, _ = rows.shape
    valid = _valid_mask(num_valid, B, cap, rows.device)
    pkey = torch.where(valid, part.to(torch.int32),
                       torch.full_like(part, num_parts, dtype=torch.int32))
    key = torch.where(valid, words_to_key(rows[..., 0], rows[..., 1]),
                      torch.zeros((), dtype=torch.int64, device=rows.device))
    _, by_key = torch.sort(key, dim=-1)
    spart, by_part = torch.sort(torch.gather(pkey, 1, by_key), dim=-1,
                                stable=True)
    order = torch.gather(by_key, 1, by_part)
    return spart, _gather_rows(rows, order), \
        counts_from_sorted(spart, num_parts)


def words_to_vals(words: torch.Tensor, val_dtype) -> torch.Tensor:
    """Reinterpret ``[..., vw]`` int32 transport words as value lanes
    (several lanes per word for a sub-word dtype)."""
    return words.contiguous().view(_lane_dtype(np.dtype(val_dtype)))


def vals_to_words(vals: torch.Tensor, val_dtype) -> torch.Tensor:
    """Round or wrap float64 / int64 sums to the value dtype and view
    them as int32 transport words — the inverse of :func:`words_to_vals`."""
    vdt = np.dtype(val_dtype)
    lane = _lane_dtype(vdt)
    if not lane.is_floating_point:
        half = 1 << (8 * vdt.itemsize - 1)
        vals = torch.remainder(vals + half, 2 * half) - half
    return vals.to(lane).contiguous().view(torch.int32)


def _sum_dtype(val_dtype) -> torch.dtype:
    return torch.float64 if is_float_dtype(val_dtype) else torch.int64


def combine_rows(rows: torch.Tensor, part: torch.Tensor, num_valid,
                 num_parts: int, val_words_n: int, val_dtype,
                 op: str = "sum", sum_words: int = 0,
                 compaction: str = "stable"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group rows by (partition, int64 key) and sum the values per group.

    rows       ``[B, cap, W]`` int32 (cols 0, 1 = key lo, hi; the next
               ``val_words_n`` cols are the bit-packed value)
    part       ``[B, cap]`` int32 partition per row
    num_valid  ``[B]`` real rows per shard (or a scalar)
    sum_words  leading value words that are SUMMED; the other
               ``val_words_n - sum_words`` are CARRIED from one row of
               the group (per-key constant payload). 0 sums them all.
    compaction the end-row compaction, bit-identical results either way:
               ``stable`` — a stable sort on the end-row flag keeps the
               (partition, key) order of the grouping sort;
               ``unstable`` — each end row is written straight to its
               slot (its rank among the end rows), no sort.

    Returns (rows_out ``[B, cap, W]``, pcounts ``[B, num_parts]``, n_out
    ``[B]``): the first n_out rows of each shard are one row per distinct
    (partition, key), in (partition, key) order; rows past n_out are
    zero. n_out counts every group of the rows below ``num_valid``,
    sentinel-partition groups included (pcounts never counts those)."""
    if op not in COMBINERS:
        raise ValueError(f"unknown combiner {op!r}; want one of {COMBINERS}")
    if compaction not in COMPACTIONS:
        raise ValueError(f"unknown compaction {compaction!r}; want one of "
                         f"{COMPACTIONS}")
    if sum_words > val_words_n:
        raise ValueError(
            f"sum_words={sum_words} > value width {val_words_n} words")
    if sum_words <= 0:
        sum_words = val_words_n
    B, cap, W = rows.shape
    dev = rows.device
    valid = _valid_mask(num_valid, B, cap, dev)

    spart, srows, _ = keysort_rows(rows, part, num_valid, num_parts)
    key = words_to_key(srows[..., 0], srows[..., 1])
    same = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    same[:, 1:] = (key[:, 1:] == key[:, :-1]) & (spart[:, 1:] == spart[:, :-1])
    is_start = valid & ~same
    n_out = is_start.sum(dim=1, dtype=torch.int32)
    nxt_start = torch.ones((B, cap), dtype=torch.bool, device=dev)
    nxt_start[:, :-1] = is_start[:, 1:]
    nv = num_valid if isinstance(num_valid, int) else \
        torch.as_tensor(num_valid, device=dev).reshape(-1, 1)
    idx = torch.arange(cap, device=dev)
    is_end = valid & (nxt_start | (idx[None, :] == nv - 1))

    # inclusive prefix sums of the summed lanes; an end row's prefix minus
    # the previous end row's is its group's sum. The scan runs over the
    # innermost dim: over the row dim of [B, cap, lanes] CUDA scans with
    # one thread per lane, which took 351 ms of a 10 M-row combine read
    # on an H100.
    vals = words_to_vals(srows[..., KEY_WORDS:KEY_WORDS + sum_words],
                         val_dtype).to(_sum_dtype(val_dtype))
    vals = torch.where(valid.unsqueeze(-1), vals, torch.zeros_like(vals))
    incl = torch.cumsum(vals.transpose(1, 2).contiguous(),
                        dim=2).transpose(1, 2)

    if compaction == "stable":
        _, order = torch.sort(torch.where(is_end, 0, 1).to(torch.int8),
                              dim=1, stable=True)
    else:
        # end row -> its rank; every other row -> a dump column
        slot = torch.where(is_end, torch.cumsum(is_end, dim=1) - 1, cap)
        order = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
        order.scatter_(1, slot, idx.expand(B, cap).contiguous())
        order = order[:, :cap]
    live = idx[None, :] < n_out.reshape(-1, 1)
    ends = _gather_rows(srows, order)
    ends_incl = torch.gather(incl, 1,
                             order.unsqueeze(-1).expand(-1, -1,
                                                        incl.shape[-1]))
    prev = torch.zeros_like(ends_incl)
    prev[:, 1:] = ends_incl[:, :-1]
    sums = torch.where(live.unsqueeze(-1), ends_incl - prev,
                       torch.zeros_like(prev))

    rows_out = torch.zeros_like(rows)
    rows_out[..., :KEY_WORDS] = ends[..., :KEY_WORDS]
    rows_out[..., KEY_WORDS:KEY_WORDS + sum_words] = \
        vals_to_words(sums, val_dtype)
    carry_hi = KEY_WORDS + val_words_n
    rows_out[..., KEY_WORDS + sum_words:carry_hi] = \
        ends[..., KEY_WORDS + sum_words:carry_hi]
    rows_out.masked_fill_(~live.unsqueeze(-1), 0)
    out_part = torch.where(live, torch.gather(spart, 1, order),
                           torch.full_like(spart, num_parts))
    return rows_out, counts_from_sorted(out_part, num_parts), n_out
