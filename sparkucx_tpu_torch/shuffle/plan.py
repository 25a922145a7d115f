"""Shuffle plans — the capacity policy of one exchange.

* ``cap_in``  — per-shard send-buffer rows (max staged rows, rounded up)
* ``cap_out`` — per-shard receive rows = balanced share x capacityFactor
* retry — the exchange reports overflow on any shard; the reader doubles
  ``cap_out`` and re-runs, at most ``max_retries`` times.
* waves — a waved read (``a2a.waveRows``) dispatches every wave with ONE
  plan, :func:`wave_step_plan`, whose capacities follow from the wave
  size alone; the outer plan records the split (``wave_rows``,
  ``num_waves``).

The JAX package's ``merge_family`` keys its compiled-step cache; eager
PyTorch compiles nothing per shape, so it has no counterpart here.

Capacities are multiples of 8 rows and, with ``a2a.capBuckets`` on (the
default), rounded up onto a geometric ladder, exactly as in the JAX
package, so both packages plan the same capacities for the same data.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sparkucx_tpu_torch.backend import resolve_a2a_impl
from sparkucx_tpu_torch.config import (CAP_BUCKET_GROWTH_RANGE,
                                       PARTITIONERS, ShuffleConf)
from sparkucx_tpu_torch.ops.ragged_a2a import chunk_rows_for
from sparkucx_tpu_torch.shuffle.alltoall import int8_wire_words

# hard ceiling on a bucketed capacity (int32 plan arithmetic)
CAP_BUCKET_CEILING = (1 << 31) - 8


def _round_up(x: int, mult: int = 8) -> int:
    return max(mult, ((int(x) + mult - 1) // mult) * mult)


@dataclass(frozen=True)
class ShufflePlan:
    """Shapes and policy of one exchange. ``impl`` is RESOLVED (never
    'auto'): pallas (the CUDA segment move, or its plain version on a CPU
    device), dense, gather or local."""

    num_shards: int
    num_partitions: int
    cap_in: int
    cap_out: int
    impl: str
    partitioner: str = "hash"
    max_retries: int = 4
    sort_impl: str = "auto"
    # combine-by-key (ops/aggregate.py): None or "sum", applied map-side
    # before the segment move and reduce-side after it
    combine: Optional[str] = None
    combine_words: int = 0     # value width in int32 words (combine only)
    combine_dtype: str = ""    # np.dtype.str of the value (combine only)
    # value words the combiner SUMS; the rest are CARRIED per key. 0 sums
    # the whole value row.
    combine_sum_words: int = 0
    combine_compaction: str = "stable"
    # partitions come back key-sorted (signed int64 order); implied by
    # combine, whose output is key-sorted already
    ordered: bool = False
    # sorted int64 split points of partitioner="range"
    bounds: Optional[Tuple[int, ...]] = None
    # the combine read's reduce-side impl, RESOLVED (never 'auto'):
    # 'pallas' = the CUDA segment-reduce kernel (its plain version on a
    # CPU device), 'jnp' = the torch-op formulation
    kernel_impl: str = "jnp"
    # read sink, RESOLVED by the manager (never 'auto'): 'host' drains the
    # result to numpy views, 'device' keeps it in device tensors
    # (reader.DeviceShuffleReaderResult)
    sink: str = "host"
    # a waved read's OUTER plan carries the split: rows per shard per
    # wave and the wave count. The plan each wave dispatches
    # (wave_step_plan) keeps both at their defaults.
    wave_rows: int = 0
    num_waves: int = 1
    # wire tier (a2a.wire), RESOLVED by the manager: 'int8' quantizes the
    # trailing ``wire_words`` float32 value lanes around the exchange
    # (keys stay exact), 'lossless' compresses drained host blocks of a
    # waved read, 'raw' moves the rows as they are
    wire: str = "raw"
    # float32 value lanes the int8 wire narrows; 0 on the other tiers
    wire_words: int = 0

    def grown(self) -> "ShufflePlan":
        """Next plan after an overflow: double the receive capacity."""
        return dataclasses.replace(self, cap_out=self.cap_out * 2)


def bucket_cap(cap: int, growth: float) -> int:
    """Round ``cap`` UP to the next rung of ``rung(k) = round_up8(8 *
    growth**k)`` (the smallest rung >= cap, so a rung maps to itself)."""
    lo, hi = CAP_BUCKET_GROWTH_RANGE
    if not lo <= growth <= hi:
        raise ValueError(f"cap bucket growth {growth} out of {lo}..{hi}")
    cap = _round_up(int(cap))
    if cap <= 8:
        return 8
    if cap >= CAP_BUCKET_CEILING:
        return CAP_BUCKET_CEILING

    def rung(k: int) -> int:
        return _round_up(int(math.ceil(8.0 * growth ** k)))

    k = max(0, math.ceil(math.log(cap / 8.0) / math.log(growth) - 1e-9))
    while k > 0 and rung(k - 1) >= cap:
        k -= 1
    r = rung(k)
    while r < cap:
        k += 1
        r = rung(k)
    return min(r, CAP_BUCKET_CEILING)


def bucket_cap_conf(cap: int, conf: ShuffleConf) -> int:
    """``a2a.capBuckets`` off returns ``cap`` unchanged."""
    if not conf.cap_buckets:
        return int(cap)
    return bucket_cap(cap, conf.cap_bucket_growth)


def check_bounds(bounds, num_partitions: int) -> Tuple[int, ...]:
    """``num_partitions - 1`` sorted int64 split points, as a tuple."""
    b = np.asarray(bounds, dtype=np.int64)
    if b.shape != (num_partitions - 1,) or (np.diff(b) < 0).any():
        raise ValueError(
            f"range bounds must be {num_partitions - 1} sorted int64 split "
            f"points, got shape {b.shape}")
    return tuple(int(x) for x in b)


def make_plan(shard_rows: np.ndarray, num_shards: int, num_partitions: int,
              conf: ShuffleConf, device, partitioner: str = "hash",
              bounds=None, sink: str = "host",
              hierarchical: bool = False,
              distributed: bool = False) -> ShufflePlan:
    """Capacities from per-shard staged row counts; the impl resolved for
    ``device``, the read's sink, whether ``conf`` waves it, whether the
    read runs the hierarchical exchange and whether it spans processes
    (backend.resolve_a2a_impl).
    ``bounds`` are the range partitioner's split points as
    :func:`check_bounds` returned them at registration."""
    if partitioner not in PARTITIONERS:
        raise ValueError(f"unknown partitioner {partitioner!r}; want one "
                         f"of {PARTITIONERS}")
    total = int(np.sum(shard_rows))
    cap_in = bucket_cap_conf(
        _round_up(int(np.max(shard_rows, initial=0))), conf)
    balanced = total / max(num_shards, 1)
    cap_out = bucket_cap_conf(
        _round_up(int(np.ceil(balanced * conf.capacity_factor))), conf)
    return ShufflePlan(
        num_shards=num_shards, num_partitions=num_partitions,
        cap_in=cap_in, cap_out=cap_out,
        impl=resolve_a2a_impl(conf.a2a_impl, device, num_shards,
                              waved=conf.wave_rows > 0, sink=sink,
                              hierarchical=hierarchical,
                              distributed=distributed),
        partitioner=partitioner, sort_impl=conf.sort_impl, bounds=bounds,
        combine_compaction=conf.combine_compaction)


def plan_takes_seed(plan: ShufflePlan) -> bool:
    """Whether this plan's step draws rounding noise: the int8 wire tier
    is active. Every dispatch site asks this one predicate."""
    return plan.wire == "int8" and plan.wire_words > 0


def wire_row_words(plan: ShufflePlan, width: int) -> int:
    """int32 lanes one row costs on the wire: ``width`` on the raw and
    lossless tiers; on int8 the exact head lanes, the packed int8 value
    lanes and the scale lane (``alltoall.int8_wire_words``). The
    accounting, the segment move's chunk and the step's transport width
    all read this."""
    if not plan_takes_seed(plan):
        return int(width)
    return int(width) - plan.wire_words + int8_wire_words(plan.wire_words)


@dataclass(frozen=True)
class RaggedLayout:
    """Real-bytes accounting of one exchange: ``payload_*`` the real
    staged rows/bytes, ``wire_*`` what the transport moves for them,
    ``pad_ratio`` = wire/payload (0.0 for an empty exchange)."""

    impl: str
    num_shards: int
    width: int
    payload_rows: int
    wire_rows: int
    payload_bytes: int
    wire_bytes: int
    pad_ratio: float
    # the wire tier; ``wire_row_bytes`` is one row's cost on it (narrower
    # than width*4 on int8, so an int8 pad_ratio can sit below 1.0) and
    # ``scale_bytes`` the int8 scale lanes inside ``wire_bytes``
    wire: str = "raw"
    wire_row_bytes: int = 0
    scale_bytes: int = 0


def ragged_layout(plan: ShufflePlan, shard_rows,
                  width: int) -> RaggedLayout:
    """The JAX package's ``ragged_layout`` formulas for the impls this
    port runs: local moves the payload, dense ships P*P segments padded to
    cap_out, gather replicates every cap_in send buffer to all P shards,
    and the chunk-aligned segment move ships at most the payload plus
    (chunk - 1) pad rows per (sender, peer) pair, each row at its wire
    cost (:func:`wire_row_words`)."""
    payload = int(np.sum(np.asarray(shard_rows, dtype=np.int64)))
    P = plan.num_shards
    row_w = wire_row_words(plan, width)
    if plan.impl == "local":
        wire = payload
    elif plan.impl == "dense":
        wire = P * P * plan.cap_out
    elif plan.impl == "gather":
        wire = P * P * plan.cap_in
    elif plan.impl == "pallas":
        wire = payload + P * P * (chunk_rows_for(row_w) - 1)
    else:
        raise ValueError(f"unresolved impl {plan.impl!r}")
    payload_bytes = payload * width * 4
    wire_bytes = wire * row_w * 4
    pad = round(wire_bytes / payload_bytes, 6) if payload_bytes else 0.0
    scale = wire * 4 if plan_takes_seed(plan) else 0
    return RaggedLayout(impl=plan.impl, num_shards=P, width=width,
                        payload_rows=payload, wire_rows=wire,
                        payload_bytes=payload_bytes, wire_bytes=wire_bytes,
                        pad_ratio=pad, wire=plan.wire,
                        wire_row_bytes=row_w * 4, scale_bytes=scale)


def wave_payload_rows(shard_rows: np.ndarray, wave_rows: int,
                      num_waves: int) -> np.ndarray:
    """[W] real rows each wave moves over all shards: wave i takes rows
    ``[i*wave_rows, (i+1)*wave_rows)`` of every shard's staged sequence."""
    rows = np.asarray(shard_rows, dtype=np.int64)
    out = np.zeros(num_waves, dtype=np.int64)
    for i in range(num_waves):
        out[i] = int(np.clip(rows - i * int(wave_rows), 0,
                             int(wave_rows)).sum())
    return out


def wave_count(shard_rows: np.ndarray, wave_rows: int) -> int:
    """Waves a staged row distribution splits into at ``wave_rows`` rows
    per shard per wave: ceil(max staged rows / wave_rows), at least 1.
    Every shard runs the same count (a lighter shard's trailing waves are
    empty)."""
    if wave_rows <= 0:
        return 1
    mx = int(np.max(shard_rows, initial=0))
    return max(1, -(-mx // int(wave_rows)))


def wave_step_plan(plan: ShufflePlan,
                   conf: Optional[ShuffleConf] = None) -> ShufflePlan:
    """The plan ONE wave of a waved read dispatches: ``cap_in`` is the
    (bucketed) wave size, ``cap_out`` the wave size times
    capacityFactor, both independent of the read's total rows and wave
    count; the wave fields go back to their defaults and every other
    field (the wire tier included) is kept."""
    conf = conf or ShuffleConf(use_env=False)
    if plan.wave_rows <= 0:
        raise ValueError("wave_step_plan needs a plan with wave_rows > 0")
    cap_in = bucket_cap_conf(_round_up(plan.wave_rows), conf)
    cap_out = bucket_cap_conf(
        _round_up(int(np.ceil(plan.wave_rows * conf.capacity_factor))),
        conf)
    return dataclasses.replace(plan, cap_in=cap_in, cap_out=cap_out,
                               wave_rows=0, num_waves=1)
