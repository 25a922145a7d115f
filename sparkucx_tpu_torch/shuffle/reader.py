"""Reduce-side reader — the exchange step and its host views.

One step over all P logical shards at once (the JAX package runs the same
step per device under ``shard_map``; here the shard is a leading tensor
dimension):

    stage:   [P, cap_in, W] int32 rows, one H2D copy from pinned memory
    device:  route -> ONE partition-major sort -> segment exchange
    fetch:   per-reduce-partition runs, located by prefix sums over the
             [P, R] per-sender count matrix (no receive-side sort: the
             blocked partition->shard map is monotone, so partition order
             IS shard order and every delivered segment arrives grouped)

Read modes: the plain read serves the delivered segments as they are.
``combine`` sums rows per (partition, key) before the exchange
(map-side) and after it (reduce-side: the segment-reduce kernel or the
torch-op ``combine_rows``); ``ordered`` key-sorts every partition after
the exchange. Both serve one run per partition, so their seg matrix is
each shard's own ``[1, R]`` count row (``[P, 1, R]`` in all).

Row format: ``[key_lo, key_hi, value_words...]`` int32, built on the host
by bit views (:func:`pack_rows`). Routing reads ``key_lo``, which is what
the 32-bit hash consumes, so host-published size rows and device routing
agree.

Overflow: the step flags a capacity overflow on any shard; the pending
handle doubles ``cap_out`` and re-runs (bounded by ``plan.max_retries``).

Wire tiers (``plan.wire``): on ``int8`` the step quantizes the float32
value lanes of the send buffer (``alltoall.wire_pack_rows``, rounding
noise from per-shard seeds, :func:`wire_shard_seeds`), moves the narrower
wire rows and dequantizes on receive — or, for a multi-shard combine read
under the segment-reduce kernel, keysorts the wire rows and hands them to
the fused dequant reduce (``ops/segmented.segment_reduce_wire_rows``).
``lossless`` leaves the step alone: a waved host read compresses its
drained blocks (:meth:`LazyShuffleReaderResult.compress_host_blocks`).

Sinks: a host read serves :class:`LazyShuffleReaderResult` (numpy views,
each shard pulled on its first touch, or all of them in arrival order by
``partitions_ready()``); a device read (``plan.sink == "device"``) serves
:class:`DeviceShuffleReaderResult`, whose partitions stay in device
tensors until a consumer takes them (``consume``) or asks for the host
view; every shard's delivered rows are a prefix of its buffer (under the
segment move, :func:`compact_received` makes them so). A waved read
(manager.PendingWaveShuffle) composes its per-wave results:
:class:`WavedShuffleReaderResult` on the host, where ordered and combine
partitions merge across waves in numpy (:func:`merge_sorted_rows`,
:func:`combine_packed_rows`), or, on the device sink, one merged device
view from :func:`device_merge_fold`, a fold of merge-path merges (and
segment reduces) over the wave buffers.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import PARTITIONERS, ShuffleConf
from sparkucx_tpu_torch.io.dlpack import stage_to_device
from sparkucx_tpu_torch.ops.aggregate import combine_rows, keysort_rows
from sparkucx_tpu_torch.ops.partition import (_gather_rows,
                                              blocked_partition_map,
                                              destination_sort,
                                              hash_partition,
                                              partition_major_sort_aligned,
                                              range_partition_words,
                                              to_device)
from sparkucx_tpu_torch.ops.ragged_a2a import (align_rows, chunk_rows_for,
                                               ragged_a2a)
from sparkucx_tpu_torch.ops.segmented import (merge_reduce_rows, merge_rows,
                                              resolve_kernel_impl,
                                              segment_reduce_rows,
                                              segment_reduce_wire_rows)
from sparkucx_tpu_torch.shuffle.alltoall import (ShuffleResult,
                                                 ragged_shuffle,
                                                 wire_pack_rows,
                                                 wire_uniforms,
                                                 wire_unpack_rows)
from sparkucx_tpu_torch.shuffle.plan import (ShufflePlan, bucket_cap_conf,
                                             plan_takes_seed, wire_row_words)
from sparkucx_tpu_torch.shuffle.wire import (LosslessBlock, decode_block,
                                             encode_block)
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
from sparkucx_tpu_torch.utils.metrics import C_D2H

log = get_logger("shuffle.reader")

KEY_WORDS = 2  # int64 key as two int32 columns [lo, hi]


def _device_bounds(num_partitions: int, num_shards: int) -> np.ndarray:
    """Static [P+1] partition-range boundaries of the blocked map: shard d
    owns partitions [bounds[d], bounds[d+1])."""
    p2d = blocked_partition_map(num_partitions, num_shards)
    return np.searchsorted(p2d, np.arange(num_shards + 1)).astype(np.int32)


def _make_part_fn(plan: ShufflePlan, R: int):
    """The partitioner over ``[P, cap, W]`` rows: 'direct' keys are
    partition ids, 'hash' hashes ``key_lo``, 'range' searches the int64
    key in ``plan.bounds``."""
    if plan.partitioner not in PARTITIONERS:
        raise ValueError(f"unknown partitioner {plan.partitioner!r}")

    def part_fn(rows: torch.Tensor) -> torch.Tensor:
        if plan.partitioner == "direct":
            return torch.clamp(rows[..., 0], 0, R - 1)
        if plan.partitioner == "range":
            return range_partition_words(rows[..., 0], rows[..., 1],
                                         plan.bounds)
        return hash_partition(rows[..., 0], R)
    return part_fn


def _combine(plan: ShufflePlan, rows: torch.Tensor, part: torch.Tensor,
             num_valid):
    """``combine_rows`` with the plan's value schema."""
    return combine_rows(rows, part, num_valid, plan.num_partitions,
                        plan.combine_words, np.dtype(plan.combine_dtype),
                        plan.combine, sum_words=plan.combine_sum_words,
                        compaction=plan.combine_compaction)


def wire_shard_seeds(plan: ShufflePlan, base_seed: int,
                     shard_ids: Optional[Sequence[int]] = None
                     ) -> Optional[List[int]]:
    """The per-shard noise seeds of one int8 exchange, ``(base * P +
    shard) & 0x7FFFFFFF`` for each of ``shard_ids`` — the GLOBAL ids of
    the caller's shards (default: all P), so a shard's noise never
    depends on which process holds it (the JAX package's
    ``seeded_nvalid`` arithmetic, which carries the seeds in the staged
    count lane; here they travel as a host list beside the counts). None
    when the plan draws no noise."""
    if not plan_takes_seed(plan):
        return None
    P = plan.num_shards
    ids = range(P) if shard_ids is None else shard_ids
    return [int((int(base_seed) * P + int(p)) & 0x7FFFFFFF) for p in ids]


def _wire_pack(plan: ShufflePlan, send: torch.Tensor,
               seeds: Optional[Sequence[int]]) -> torch.Tensor:
    """The int8 send buffer: the value lanes of ``send`` ``[P, cap, W]``
    quantized with fresh uniforms drawn from ``seeds`` (freed once
    packed)."""
    if seeds is None:
        raise ValueError("an int8 wire step needs per-shard noise seeds")
    P, cap, _ = send.shape
    u = wire_uniforms((P, cap, plan.wire_words), seeds, send.device)
    return wire_pack_rows(send, plan.wire_words, u)


def _wire_ragged_shuffle(plan: ShufflePlan, send: torch.Tensor,
                         sizes: torch.Tensor, seeds, unpack: bool = True):
    """One dense-contract exchange on the plan's wire tier: int8 packs the
    value lanes before ``ragged_shuffle`` and, with ``unpack``,
    dequantizes after it (without, the caller gets the wire rows — the
    fused reduce's input); every other tier is ``ragged_shuffle``
    itself."""
    if not plan_takes_seed(plan):
        return ragged_shuffle(send, sizes, out_capacity=plan.cap_out,
                              impl=plan.impl)
    width = send.shape[2]
    r = ragged_shuffle(_wire_pack(plan, send, seeds), sizes,
                       out_capacity=plan.cap_out, impl=plan.impl)
    if not unpack:
        return r
    return ShuffleResult(wire_unpack_rows(r.data, width, plan.wire_words),
                         r.recv_sizes, r.total, r.overflow)


def _fused_wire_reduce(plan: ShufflePlan, width: int) -> bool:
    """int8 combine under the segment-reduce kernel with the wire covering
    the whole value row: the received rows stay in the wire format and
    the fused dequant reduce consumes them (the JAX package's ``fused``
    condition; the dense step also needs more than one shard)."""
    return bool(plan.combine and plan_takes_seed(plan)
                and plan.kernel_impl == "pallas"
                and width == KEY_WORDS + plan.wire_words)


def _reduce_side_combine(plan: ShufflePlan, rows: torch.Tensor,
                         part: torch.Tensor, num_valid, width: int):
    """Merge the received rows per (partition, key): one keysort, then
    the segment-reduce kernel (``kernel_impl == 'pallas'``; the fused
    dequant reduce when ``rows`` are int8 wire rows narrower than the
    logical ``width``), or the torch-op ``combine_rows``. Returns
    (rows_out, pcounts ``[P, R]``)."""
    R = plan.num_partitions
    if rows.shape[2] != width:
        spart, swire, _ = keysort_rows(rows, part, num_valid, R)
        rows_out, pcounts, _ = segment_reduce_wire_rows(
            swire, spart, R, width, plan.wire_words,
            sum_words=plan.combine_sum_words, impl="pallas")
    elif plan.kernel_impl == "pallas":
        spart, srows, _ = keysort_rows(rows, part, num_valid, R)
        rows_out, pcounts, _ = segment_reduce_rows(
            srows, spart, R, plan.combine_words,
            np.dtype(plan.combine_dtype), plan.combine,
            sum_words=plan.combine_sum_words,
            compaction=plan.combine_compaction, impl="pallas")
    else:
        rows_out, pcounts, _ = _combine(plan, rows, part, num_valid)
    return rows_out, pcounts


def _dev_counts(rcounts: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """[P, P] rows each shard sends each shard: partition-count sums over
    every receiver's static partition range."""
    P = rcounts.shape[0]
    cum = torch.zeros((P, rcounts.shape[1] + 1), dtype=torch.int32,
                      device=rcounts.device)
    cum[:, 1:] = torch.cumsum(rcounts, dim=1, dtype=torch.int32)
    hi = to_device(bounds[1:], cum.device)
    lo = to_device(bounds[:-1], cum.device)
    return cum[:, hi] - cum[:, lo]


def step_body(plan: ShufflePlan):
    """The exchange step: ``step(payload [P, cap_in, W], nvalid [P],
    seeds=None)`` -> (rows ``[P, cap, W]``, seg, total ``[P]`` delivered
    rows, overflow 0-d bool). seg is ``[P, R]`` per-sender partition
    counts on a plain read and each shard's own ``[P, 1, R]`` counts on a
    combine or ordered read. ``seeds`` are the per-shard noise seeds of
    an int8 plan (:func:`wire_shard_seeds`); the rows come back full
    width on every tier.

    PARTITION-MAJOR: the send side sorts by global reduce-partition id;
    the blocked map is monotone, so this groups rows by destination shard
    AND leaves every delivered segment partition-sorted."""
    if plan.impl == "pallas":
        return _pallas_step_body(plan)
    R = plan.num_partitions
    Pn = plan.num_shards
    bounds = _device_bounds(R, Pn)
    part_fn = _make_part_fn(plan, R)

    def step(payload: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        part = part_fn(payload)
        width = payload.shape[2]
        if plan.combine:
            # map-side combine: one row per distinct (partition, key)
            # enters the exchange; its (partition, key) order keeps the
            # send buffer grouped by destination
            send, rcounts, _ = _combine(plan, payload, part, nvalid)
        elif plan.ordered and Pn == 1:
            # one sender: delivered rows keep send order, so the key sort
            # runs on the (smaller) send buffer
            _, send, rcounts = keysort_rows(payload, part, nvalid, R)
        else:
            send, rcounts = destination_sort(payload, part, nvalid, R,
                                             method=plan.sort_impl)
        fused = Pn > 1 and _fused_wire_reduce(plan, width)
        r = _wire_ragged_shuffle(plan, send, _dev_counts(rcounts, bounds),
                                 seeds, unpack=not fused)
        if plan.combine or plan.ordered:
            if Pn == 1:
                # one sender: the send side already holds one key-sorted
                # run per partition
                return r.data, rcounts.reshape(1, 1, R), r.total, \
                    r.overflow
            out_part = part_fn(r.data)
            if plan.combine:
                rows_out, pcounts = _reduce_side_combine(
                    plan, r.data, out_part, r.total, width)
                total = pcounts.sum(dim=1, dtype=torch.int32)
            else:
                _, rows_out, pcounts = keysort_rows(r.data, out_part,
                                                    r.total, R)
                total = r.total
            return rows_out, pcounts.reshape(Pn, 1, R), total, r.overflow
        # every receiver needs every sender's partition counts to locate
        # its runs: the [P, R] matrix is the stacked per-shard rows
        return r.data, rcounts, r.total, r.overflow

    return step


def _pallas_step_body(plan: ShufflePlan):
    """The step over the hand-kernel segment move (ops/ragged_a2a.py):
    partition-major with DEVICE segments padded to chunk multiples, so
    delivered segments are still partition-sorted and readers locate runs
    by prefix sums with chunk-aligned segment starts
    (``_RunIndex(align_chunk=...)``). Whether the kernel or its plain
    version runs follows from the payload's device alone.

    Combine/ordered: the receive buffer is densified on the device —
    :func:`densified_receive` gives its pad rows the sentinel partition
    R, then one keysort (and, for combine, the reduce) leaves one
    key-sorted run per partition, served with ``align_chunk=0``."""
    R = plan.num_partitions
    Pn = plan.num_shards

    def step(payload: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        width = payload.shape[2]
        if not (plan.combine or plan.ordered):
            srows, rcounts, dev_counts, cap_eff = aligned_send(
                plan, payload, nvalid)
            if plan_takes_seed(plan):
                srows = _wire_pack(plan, srows, seeds)
            out, recv_real, recv_off, total_al = ragged_a2a(
                srows, dev_counts, out_capacity=cap_eff)
            if plan.sink == "device":
                # a device consumer reads rows[p, :total[p]]; host views
                # keep the chunk-aligned layout
                out = compact_received(out, recv_real, recv_off)
            if plan_takes_seed(plan):
                out = wire_unpack_rows(out, width, plan.wire_words)
            total = recv_real.sum(dim=1, dtype=torch.int32)
            return out, rcounts, total, (total_al < 0).any()
        out, pkey, ovf = densified_receive(
            plan, payload, nvalid, seeds,
            unpack=not _fused_wire_reduce(plan, width))
        cap_eff = out.shape[1]
        if plan.combine:
            rows_out, pcounts = _reduce_side_combine(plan, out, pkey,
                                                     cap_eff, width)
        else:
            _, rows_out, pcounts = keysort_rows(out, pkey, cap_eff, R)
        # the total from pcounts: sentinel groups never count
        total = pcounts.sum(dim=1, dtype=torch.int32)
        return rows_out, pcounts.reshape(Pn, 1, R), total, ovf

    return step


def compact_received(out: torch.Tensor, recv_real: torch.Tensor,
                     recv_off: torch.Tensor) -> torch.Tensor:
    """The segment move's receive buffer ``[P, cap, W]`` with each shard's
    real rows made a prefix, sender after sender: one row gather driven by
    the device counts (``recv_real[p, s]`` real rows of sender s at the
    aligned offset ``recv_off[p, s]``), no host synchronisation. Rows past
    a shard's total keep what the buffer held there."""
    Pn, cap, _ = out.shape
    idx = torch.arange(cap, dtype=torch.int32, device=out.device)
    idx = idx.expand(Pn, cap).contiguous()
    ends = torch.cumsum(recv_real, dim=1, dtype=torch.int32)
    seg = torch.clamp(torch.searchsorted(ends, idx, right=True), max=Pn - 1)
    src = idx - torch.gather(ends - recv_real, 1, seg) \
        + torch.gather(recv_off, 1, seg)
    return _gather_rows(out, torch.where(idx < ends[:, -1:], src, idx))


def densified_receive(plan: ShufflePlan, payload: torch.Tensor,
                      nvalid: torch.Tensor, seeds=None, unpack: bool = True):
    """The segment move of a combine or ordered read, up to the receive
    side's grouping: map-side combine (combine reads), the aligned sort,
    on the int8 wire the pack, the move (and, with ``unpack``, the
    dequantize), then every row outside a segment's real prefix gets the
    sentinel partition R. Returns (received rows ``[P, cap_eff, W]`` —
    wire rows when an int8 plan is not unpacked —, their partitions
    ``[P, cap_eff]`` with R on pad rows, overflow 0-d bool)."""
    R = plan.num_partitions
    Pn = plan.num_shards
    part_fn = _make_part_fn(plan, R)
    width = payload.shape[2]
    if plan.combine:
        # map-side combine first: one row per distinct (partition, key)
        # enters the move; the aligned sort re-lays the combined rows out
        comb, _, n_c = _combine(plan, payload, part_fn(payload), nvalid)
        srows, _, dev_counts, cap_eff = aligned_send(plan, comb, n_c)
    else:
        srows, _, dev_counts, cap_eff = aligned_send(plan, payload, nvalid)
    if plan_takes_seed(plan):
        # the pack follows the chunk-aligned sort: pad and dummy rows
        # quantize to zero values with scale 1.0
        srows = _wire_pack(plan, srows, seeds)
    out, recv_real, recv_off, total_al = ragged_a2a(
        srows, dev_counts, out_capacity=cap_eff)
    if plan_takes_seed(plan) and unpack:
        out = wire_unpack_rows(out, width, plan.wire_words)
    # row k belongs to the last segment whose aligned start is <= k (an
    # empty segment shares its start with the next), and is real iff it
    # lies inside that segment's real prefix
    idx = torch.arange(cap_eff, dtype=torch.int32, device=out.device)
    idx = idx.expand(Pn, cap_eff).contiguous()
    seg_i = torch.clamp(
        torch.searchsorted(recv_off.contiguous(), idx, right=True) - 1,
        0, Pn - 1)
    valid = (idx - torch.gather(recv_off, 1, seg_i)) \
        < torch.gather(recv_real, 1, seg_i)
    # (the partitioner reads only the key lanes, exact in wire rows too)
    pkey = torch.where(valid, part_fn(out),
                       torch.full_like(idx, R))
    return out, pkey, (total_al < 0).any()


def aligned_send(plan: ShufflePlan, payload: torch.Tensor,
                 nvalid: torch.Tensor):
    """The segment move's inputs for one step: (send rows ``[P, cap, W]``
    with chunk-aligned device segments, rcounts ``[P, R]``, dev_counts
    ``[P, P]``, receive capacity ``cap_eff``). ``cap_eff =
    align_rows(cap_out, chunk) + P*chunk`` — the chunk headroom every
    (sender, receiver) segment's pad can take."""
    R = plan.num_partitions
    Pn = plan.num_shards
    width = payload.shape[2]
    chunk = chunk_rows_for(wire_row_words(plan, width))
    srows, rcounts, dev_counts = partition_major_sort_aligned(
        payload, _make_part_fn(plan, R)(payload), nvalid, R,
        _device_bounds(R, Pn), chunk)
    # the kernel takes chunk-multiple capacities; the trailing pad rows
    # are never read
    pad = (-srows.shape[1]) % chunk
    if pad:
        srows = torch.cat([srows, srows.new_zeros(Pn, pad, width)], dim=1)
    cap_eff = int(align_rows(plan.cap_out, chunk)) + Pn * chunk
    return srows.contiguous(), rcounts, dev_counts, cap_eff


def pack_rows(keys: np.ndarray, values: Optional[np.ndarray],
              width: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host fuse: int64 keys + fixed-width values into an int32 row matrix
    by bit views (never value casts). ``out`` — optional [n, width] int32
    destination written in place (slack columns zeroed)."""
    n = keys.shape[0]
    if out is None:
        out = np.zeros((n, width), dtype=np.int32)
    elif out.shape != (n, width) or out.dtype != np.int32:
        raise ValueError(f"out must be [{n}, {width}] int32")
    out[:, :KEY_WORDS] = np.ascontiguousarray(
        keys.astype(np.int64, copy=False)).view(np.int32).reshape(n, 2)
    filled = KEY_WORDS
    if values is not None and n:
        vb = np.ascontiguousarray(values).view(np.uint8).reshape(n, -1)
        pad = (-vb.shape[1]) % 4
        if pad:
            vb = np.concatenate([vb, np.zeros((n, pad), np.uint8)], axis=1)
        vw = vb.shape[1] // 4
        out[:, KEY_WORDS:KEY_WORDS + vw] = vb.view(np.int32).reshape(n, vw)
        filled += vw
    if filled < width:
        out[:, filled:] = 0
    return out


def value_words(val_shape: Tuple[int, ...], val_dtype) -> int:
    nbytes = int(np.prod(val_shape, dtype=np.int64)) \
        * np.dtype(val_dtype).itemsize
    return (nbytes + 3) // 4


def unpack_rows(rows: np.ndarray, val_shape: Optional[Tuple[int, ...]],
                val_dtype) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Inverse of :func:`pack_rows` for a [n, width] int32 block."""
    n = rows.shape[0]
    if n == 0:
        keys = np.zeros(0, dtype=np.int64)
        values = (np.zeros((0,) + tuple(val_shape), dtype=val_dtype)
                  if val_shape is not None else None)
        return keys, values
    keys = np.ascontiguousarray(rows[:, :KEY_WORDS]).view(np.int64) \
        .reshape(n)
    if val_shape is None:
        return keys, None
    vw = value_words(val_shape, val_dtype)
    nbytes = int(np.prod(val_shape, dtype=np.int64)) \
        * np.dtype(val_dtype).itemsize
    vb = np.ascontiguousarray(
        rows[:, KEY_WORDS:KEY_WORDS + vw]).view(np.uint8).reshape(n, -1)
    values = vb[:, :nbytes].copy().view(val_dtype) \
        .reshape((n,) + tuple(val_shape))
    return keys, values


class _RunIndex:
    """Run arithmetic for one shard's partition-major receive buffer.

    The buffer is one segment per sender, each sorted by partition id.
    Given the per-sender count matrix M [NS, R] and the shard's partition
    range [r_lo, r_hi), partition r is NS contiguous runs at
        run_start[s] = seg_start[s] + within[s, r - r_lo]
    With ``align_chunk`` (the segment-move kernel's layout) segment starts
    are chunk-aligned."""

    def __init__(self, M: np.ndarray, r_lo: int, r_hi: int,
                 align_chunk: int = 0):
        C = np.asarray(M[:, r_lo:r_hi], dtype=np.int64)
        self.lens = C                                     # [NS, k]
        self.within = np.zeros_like(C)
        np.cumsum(C[:, :-1], axis=1, out=self.within[:, 1:])
        seg_sizes = C.sum(axis=1)
        if align_chunk:
            seg_sizes = -(-seg_sizes // align_chunk) * align_chunk
        self.seg_start = np.zeros_like(seg_sizes)
        np.cumsum(seg_sizes[:-1], out=self.seg_start[1:])
        # rows of the buffer the runs occupy (the D2H extent)
        self.extent = int(seg_sizes.sum())
        self.r_lo = r_lo

    def runs(self, r: int):
        k = r - self.r_lo
        starts = self.seg_start + self.within[:, k]
        lens = self.lens[:, k]
        return [(int(s), int(n)) for s, n in zip(starts, lens) if n]


def max_recv_rows(seg: np.ndarray, part_to_shard: np.ndarray,
                  num_shards: int) -> int:
    """Max over shards of delivered rows, from the shared ``[NS, R]`` seg
    matrix or the per-shard ``[P, 1, R]`` one."""
    best = 0
    for s in range(num_shards):
        r_lo = int(np.searchsorted(part_to_shard, s, "left"))
        r_hi = int(np.searchsorted(part_to_shard, s, "right"))
        m = seg if seg.ndim == 2 else seg[s]
        best = max(best, int(m[:, r_lo:r_hi].sum()))
    return best


class ShuffleReaderResult:
    """Host view of one completed exchange: ``partition(r)`` returns the
    (keys, values) of reduce partition r, densely packed.

    ``shard_ids`` makes it a PARTIAL view (a distributed read,
    ``shuffle/distributed.py``): it holds only those global shards, in
    that order (``rows`` and a per-shard seg matrix are indexed by the
    ordinal), and ``partition(r)`` raises ``KeyError`` for a partition
    another process owns."""

    def __init__(self, num_partitions: int, part_to_shard: np.ndarray,
                 rows: np.ndarray, seg_counts: np.ndarray,
                 val_shape: Optional[Tuple[int, ...]], val_dtype,
                 align_chunk: int = 0,
                 shard_ids: Optional[Sequence[int]] = None):
        self.num_partitions = num_partitions
        self._part_to_shard = part_to_shard
        # global shard id -> ordinal in rows; None: every shard, in order
        self._shard_ord = None if shard_ids is None else \
            {int(g): i for i, g in enumerate(shard_ids)}
        self._rows = rows                      # [P, cap, W] (or per-shard)
        self._seg = seg_counts                 # [P, R] or [P, 1, R]
        self._val_shape = val_shape
        self._val_dtype = val_dtype
        self._align_chunk = align_chunk
        self._runidx: Dict[int, _RunIndex] = {}
        self._block_cache: Dict[int, np.ndarray] = {}
        # receive capacity the exchange ran with (after any retries) and
        # the max per-shard rows it actually delivered — the manager's
        # capacity hint learns from these
        self.cap_out_used: Optional[int] = None
        self.recv_rows_needed: Optional[int] = None

    @property
    def shard_ids(self) -> Optional[List[int]]:
        """The global shards a partial view holds, in ordinal order (None
        for a view of every shard)."""
        return None if self._shard_ord is None else list(self._shard_ord)

    def is_local(self, r: int) -> bool:
        return self._shard_ord is None \
            or int(self._part_to_shard[r]) in self._shard_ord

    def _ordinal(self, shard: int) -> int:
        if self._shard_ord is None:
            return shard
        if shard not in self._shard_ord:
            raise KeyError(
                f"shard {shard} is not on this process (local shards: "
                f"{sorted(self._shard_ord)})")
        return self._shard_ord[shard]

    def _seg_matrix(self, shard: int) -> np.ndarray:
        """The count matrix shard's runs are indexed by: the shared
        ``[P, R]`` per-sender matrix, or its own ``[1, R]`` row of a
        ``[P, 1, R]`` per-shard matrix."""
        return self._seg if self._seg.ndim == 2 \
            else self._seg[self._ordinal(shard)]

    def _runs(self, shard: int) -> _RunIndex:
        ri = self._runidx.get(shard)
        if ri is None:
            r_lo = int(np.searchsorted(self._part_to_shard, shard, "left"))
            r_hi = int(np.searchsorted(self._part_to_shard, shard, "right"))
            ri = _RunIndex(self._seg_matrix(shard), r_lo, r_hi,
                           self._align_chunk)
            self._runidx[shard] = ri
        return ri

    def _shard_rows(self, shard: int) -> np.ndarray:
        return self._rows[self._ordinal(shard)]

    def _partition_block(self, r: int, shard: int) -> np.ndarray:
        rows = self._shard_rows(shard)
        runs = self._runs(shard).runs(r)
        if not runs:
            return rows[:0]
        if len(runs) == 1:
            s, n = runs[0]
            return rows[s:s + n]
        got = self._block_cache.get(r)
        if got is None:
            got = np.concatenate([rows[s:s + n] for s, n in runs])
            self._block_cache[r] = got
        return got

    def partition(self, r: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(keys, values) of reduce partition r, in a ``shuffle.fetch``
        span (partition id and bytes; a lazy result's first fetch of a
        shard carries its D2H wait)."""
        if not 0 <= r < self.num_partitions:
            raise IndexError(f"partition {r} out of [0, "
                             f"{self.num_partitions})")
        shard = int(self._part_to_shard[r])
        if not self.is_local(r):
            raise KeyError(
                f"partition {r} lives on shard {shard}, not on this "
                f"process (local shards: {sorted(self._shard_ord)})")
        with GLOBAL_TRACER.span("shuffle.fetch", partition=r) as sp:
            block = self._partition_block(r, shard)
            sp.set(bytes=int(block.nbytes))
            return unpack_rows(block, self._val_shape, self._val_dtype)

    def partitions(self):
        """(r, (keys, values)) for every partition this view holds."""
        for r in range(self.num_partitions):
            if self.is_local(r):
                yield r, self.partition(r)

    def partitions_ready(self, poll_s: float = 0.002):
        """Every partition this view holds, once each, in the order its
        rows reach the host (the reference's deliver-blocks-as-they-arrive
        iterator). Everything here is on the host already: index order.
        ``poll_s`` is the JAX package's signature; nothing here polls."""
        yield from self.partitions()

    def release_partition(self, r: int) -> None:
        """Drop partition r's cached dense block."""
        self._block_cache.pop(r, None)


class _ShardCopy:
    """One shard's pull to the host: the block it lands in (a numpy view
    on the CPU, a page-locked tensor on the card) and, on the card, the
    event recorded after the copy on the shard's own stream, with the
    device rows the copy reads (kept alive until it lands).
    :meth:`LazyShuffleReaderResult.partitions_ready` waits through
    ``query()`` and ``synchronize()``."""

    __slots__ = ("host", "event", "src")

    def __init__(self, host, event=None, src=None):
        self.host = host
        self.event = event
        self.src = src

    def query(self) -> bool:
        return self.event is None or self.event.query()

    def synchronize(self) -> None:
        if self.event is not None:
            self.event.synchronize()


_LANDED = _ShardCopy(None)


def _landed(copy) -> bool:
    """A look at ``copy`` that never blocks; an error counts as landed,
    so the shard's own ``partition()`` raises it."""
    try:
        return bool(copy.query())
    except Exception:
        return True


def _post_when_landed(copy, shard: int, ready: "queue.Queue") -> None:
    """A waiter thread's body: park in the copy's own wait, then post."""
    try:
        copy.synchronize()
    except Exception:
        pass                # raised again by the shard's own partition()
    ready.put(shard)


class LazyShuffleReaderResult(ShuffleReaderResult):
    """Result view over device tensors, pulled to the host shard by
    shard. The first ``partition()`` call pulls the seg matrix; each
    ``partition(r)`` then pulls only the shard that holds r, and only its
    occupied prefix (the runs' extent, not the whole receive capacity),
    into a page-locked block of that shard's own. The device tensors
    drop once every shard this view holds is on the host; later calls
    are host slicing. On a CPU device the "copy" is a view.

    On a CUDA device each shard's copy runs on a stream of its own
    (:meth:`_shard_stream`) that waits only for ``_ready_event``
    (recorded after the step that made the tensors), or, without one,
    for the work queued so far on the current stream, and records an
    event after itself: ``partition(r)`` waits for its shard's copy
    alone, not for the other shards' nor, as the compute stream would,
    for the exchanges queued after this result's (a waved read's later
    waves).

    One result may be read from several threads at once (compat v2
    shares one per shuffle). ``_lock`` (re-entrant: the seg pull nests
    in a shard's) guards the shard tables, so no shard is pulled twice
    and the device rows are never read after they were dropped; no
    thread waits on a copy while it holds the lock.

    ``fetch_granularity`` (``io.fetchGranularity``; the manager sets it
    on a single-shot host result): ``"shard"`` (default) as above;
    ``"partition"``: ``partition(r)`` copies only partition r's runs of
    its shard to the host (one pinned buffer of those rows), caches the
    block, and the device tensors are dropped once every partition this
    view holds was fetched."""

    def __init__(self, num_partitions: int, part_to_shard: np.ndarray,
                 rows_dev: torch.Tensor, seg_dev: torch.Tensor,
                 val_shape, val_dtype, align_chunk: int = 0, metrics=None,
                 shard_ids: Optional[Sequence[int]] = None):
        super().__init__(num_partitions, part_to_shard, None, None,
                         val_shape, val_dtype, align_chunk, shard_ids)
        self._rows_dev = rows_dev
        self._seg_dev = seg_dev
        # per-shard delivered rows [P], on the device: the device sink's
        # valid-row bound (set by the pending handle)
        self._totals_dev: Optional[torch.Tensor] = None
        self._metrics = metrics
        # ordinal -> host block (or LosslessBlock), once landed
        self._shards: Dict[int, object] = {}
        # ordinal -> _ShardCopy, issued and not landed yet
        self._copies: Dict[int, _ShardCopy] = {}
        self._num_held = int(rows_dev.shape[0])
        self.d2h_bytes = 0
        # the manager's hook onto the owning read's report (d2h bytes)
        self._d2h_cb = None
        self._ready_event: Optional["torch.cuda.Event"] = None
        # fired once when the device rows drop (every shard, or every
        # partition, on the host): a device result's host_view() hands
        # its admission release to it
        self._on_device_free = None
        self._lock = threading.RLock()
        self.fetch_granularity = "shard"
        self._part_cache: Dict[int, np.ndarray] = {}

    def _side_stream(self, dev: torch.device) -> "torch.cuda.Stream":
        """A stream from PyTorch's pool that starts once the tensors are
        ready."""
        stream = torch.cuda.Stream(dev)
        if self._ready_event is not None:
            stream.wait_event(self._ready_event)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
        return stream

    def _to_host(self, copy_into) -> None:
        """Run ``copy_into()`` (non-blocking D2H copies) on a side stream
        and wait for it alone."""
        dev = self._rows_dev.device if self._rows_dev is not None \
            else self._seg_dev.device
        stream = self._side_stream(dev)
        with torch.cuda.stream(stream):
            copy_into()
        stream.synchronize()

    def _seg_matrix(self, shard: int) -> np.ndarray:
        with self._lock:
            if self._seg is None:
                seg = self._seg_dev
                if seg.device.type == "cpu":
                    self._seg = seg.numpy()
                else:
                    host = torch.empty(seg.shape, dtype=seg.dtype,
                                       pin_memory=True)
                    self._to_host(lambda: host.copy_(seg, non_blocking=True))
                    self._seg = host.numpy()
                self._seg_dev = None
        return super()._seg_matrix(shard)

    def _held(self) -> List[int]:
        """The global shards this view holds, in ordinal order."""
        return list(range(self._num_held)) if self._shard_ord is None \
            else list(self._shard_ord)

    def _shard_stream(self, shard: int,
                      dev: torch.device) -> "torch.cuda.Stream":
        """The stream global shard ``shard``'s copy runs on: one of its
        own (a test or the smoke delays one shard's here)."""
        return self._side_stream(dev)

    def _shard_transfer(self, shard: int) -> _ShardCopy:
        """Start the pull of global shard ``shard`` unless it started, and
        return its copy: what :meth:`partitions_ready` waits through (a
        test slows one shard here). :meth:`_land` files the copy this
        method recorded, whatever a wrapper returns."""
        ext = self._runs(shard).extent          # pulls the seg matrix once
        j = self._ordinal(shard)
        with self._lock:
            got = self._copies.get(j)
            if got is not None:
                return got
            if j in self._shards:
                return _LANDED
            dev = self._rows_dev
            if dev is None:
                raise RuntimeError(
                    f"shard {shard}: the device rows of this view were "
                    f"dropped before it was pulled (consumed, or every "
                    f"partition fetched)")
            src = dev[j, :ext]
            if dev.device.type == "cpu":
                got = _ShardCopy(src.numpy())
            else:
                host = torch.empty(tuple(src.shape), dtype=src.dtype,
                                   pin_memory=True)
                stream = self._shard_stream(shard, dev.device)
                with torch.cuda.stream(stream):
                    host.copy_(src, non_blocking=True)
                event = torch.cuda.Event(blocking=True)
                event.record(stream)
                got = _ShardCopy(host, event, src)
            self._copies[j] = got
        return got

    def _land(self, j: int):
        """Wait (without the lock) for ordinal ``j``'s issued copy, then
        file its block once: count its bytes, and drop the device rows
        when it was the last shard of this view."""
        with self._lock:
            got = self._shards.get(j)
            copy = self._copies.get(j)
        if got is not None:
            return got
        copy.synchronize()
        freed, nbytes = None, 0
        with self._lock:
            got = self._shards.get(j)
            if got is not None:
                return got                       # another thread filed it
            host = copy.host
            if not isinstance(host, np.ndarray):
                nbytes = int(host.numel()) * host.element_size()
                host = host.numpy()
            self._shards[j] = got = host
            del self._copies[j]
            # an iterator's list or a waiter thread may still hold the
            # copy: it must not keep the device rows (nor the block) alive
            copy.host = copy.src = None
            if len(self._shards) == self._num_held:
                self._rows_dev = None         # free the device buffer
                freed, self._on_device_free = self._on_device_free, None
        if nbytes:
            self.note_d2h(nbytes)
        if freed is not None:
            freed()
        return got

    def _materialize(self) -> None:
        """Pull every shard this view holds: issue each copy not issued
        yet, then wait for them all (a waved read's drain, a distributed
        host view's settle, the lossless codec's input)."""
        held = self._held()
        for g in held:
            self._shard_transfer(g)
        for g in held:
            self._land(self._ordinal(g))

    def partitions_ready(self, poll_s: float = 0.002):
        """Every partition this view holds, once each, shard by shard in
        the order the shards' rows land on the host; within a shard,
        index order. A shard whose copy is slow holds up no other shard
        whose copy stream has a hardware queue of its own (below; the
        reference's deliver-blocks-as-they-arrive iterator,
        ``OnBlocksFetchCallback``).

        On one card the exchange writes all P shards in one launch, so
        what arrives in an order is each shard's D2H copy. Shards already
        on the host come first; the copies of all the others are issued
        at once, each on its own stream with its own event. One stream
        per shard is the point: copies queued on one stream finish in
        issue order, so one delayed shard would hold up every shard
        behind it. The streams share the device's hardware queues
        (``CUDA_DEVICE_MAX_CONNECTIONS``, 8 unless set before CUDA
        starts), and two streams on one queue still wait on each other:
        with PyTorch's pool under the default, shards s and s + 4 did on
        the H100. A look that never blocks posts the shards that already
        landed; each other shard gets a daemon thread parked in its
        event's wait, which posts it to a queue the consumer blocks on.
        An error seen by a waiter surfaces on that shard's
        ``partition()``. ``poll_s`` is the JAX package's signature:
        nothing here polls.

        Index order when nothing is left to pull (the device rows were
        dropped) and under ``fetch_granularity="partition"``, which pulls
        per partition on demand."""
        with self._lock:
            dropped = self._rows_dev is None
        if dropped or self.fetch_granularity == "partition":
            yield from self.partitions()
            return
        held = self._held()
        ready: "queue.Queue[int]" = queue.Queue()
        waiting = []
        for g in held:
            with self._lock:
                landed = self._ordinal(g) in self._shards
            if landed:
                ready.put(g)
            else:
                waiting.append(g)
        copies = [(g, self._shard_transfer(g)) for g in waiting]
        for g, copy in copies:
            if _landed(copy):
                ready.put(g)
            else:
                threading.Thread(target=_post_when_landed,
                                 args=(copy, g, ready), daemon=True,
                                 name=f"sxt-shard-wait-{g}").start()
        for _ in held:
            g = ready.get()
            # the blocked map is sorted: shard g's partitions are a range
            r_lo = int(np.searchsorted(self._part_to_shard, g, "left"))
            r_hi = int(np.searchsorted(self._part_to_shard, g, "right"))
            for r in range(r_lo, r_hi):
                yield r, self.partition(r)

    def _partition_block(self, r: int, shard: int) -> np.ndarray:
        if self.fetch_granularity != "partition":
            return super()._partition_block(r, shard)
        runs = self._runs(shard).runs(r)         # the seg matrix, small
        j = self._ordinal(shard)
        with self._lock:
            got = self._part_cache.get(r)
            dev = None if got is not None or j in self._shards \
                or self._rows_dev is None else self._rows_dev[j]
        if got is not None:
            return got
        if dev is None:                  # the shard is on the host
            return super()._partition_block(r, shard)
        block = self._fetch_runs(dev, runs)
        freed = None
        with self._lock:
            self._part_cache[r] = block
            local = sum(1 for q in range(self.num_partitions)
                        if self.is_local(q))
            if len(self._part_cache) == local:
                self._rows_dev = None       # every partition is on the host
                freed, self._on_device_free = self._on_device_free, None
        if freed is not None:
            freed()
        return block

    def _fetch_runs(self, dev: torch.Tensor, runs) -> np.ndarray:
        """The rows of ``runs`` (``(start, n)`` in ``dev``, one shard's
        ``[cap, W]``) as one host block: on the card, one pinned buffer
        of exactly those rows."""
        if not runs:
            return np.zeros((0, dev.shape[1]), dtype=np.int32)
        if dev.device.type == "cpu":
            host = dev.numpy()
            return host[runs[0][0]:runs[0][0] + runs[0][1]] \
                if len(runs) == 1 else np.concatenate(
                    [host[s:s + n] for s, n in runs])
        buf = torch.empty((sum(n for _, n in runs), dev.shape[1]),
                          dtype=dev.dtype, pin_memory=True)

        def copy_into():
            off = 0
            for s, n in runs:
                buf[off:off + n].copy_(dev[s:s + n], non_blocking=True)
                off += n

        self._to_host(copy_into)
        self.note_d2h(int(buf.numel()) * buf.element_size())
        return buf.numpy()

    def note_d2h(self, nbytes: int) -> None:
        """Count a payload pull of ``nbytes``: this view's ``d2h_bytes``,
        the ``C_D2H`` counter and, once the manager armed it, the owning
        read's report. Call it without the view's lock held."""
        with self._lock:
            self.d2h_bytes += nbytes
        if self._metrics is not None:
            self._metrics.inc(C_D2H, float(nbytes))
        if self._d2h_cb is not None:
            self._d2h_cb(nbytes)

    def key_lanes_to_host(self):
        """``(keys, totals)``: a host copy of the live device buffer's key
        lanes, ``[S, cap, 2]`` int32 over every shard of this view, and
        its delivered rows ``[S]``; None once the buffers were consumed
        or drained. The copy counts as D2H; the device buffers stay
        live (``integrity.verify=full`` on the device sink)."""
        with self._lock:
            rows, totals = self._rows_dev, self._totals_dev
        if rows is None or totals is None:
            return None
        if rows.device.type == "cpu":
            keys = rows[:, :, :2].numpy().copy()
            tot = totals.numpy().copy()
        else:
            keys_t = torch.empty(rows.shape[:2] + (2,), dtype=rows.dtype,
                                 pin_memory=True)
            tot_t = torch.empty(tuple(totals.shape), dtype=totals.dtype,
                                pin_memory=True)

            def copy_into():
                keys_t.copy_(rows[:, :, :2], non_blocking=True)
                tot_t.copy_(totals, non_blocking=True)

            self._to_host(copy_into)
            keys, tot = keys_t.numpy(), tot_t.numpy()
        self.note_d2h(int(keys.nbytes))
        return keys, tot

    def with_rows(self, rows_dev: torch.Tensor) -> "LazyShuffleReaderResult":
        """A new view over replacement rows ``[P, cap, W]`` with this
        view's seg matrix and layout: the after-consume check of the
        device sink (a consumer that passes the rows through hands its
        output here)."""
        with self._lock:
            out = type(self)(
                self.num_partitions, self._part_to_shard, rows_dev,
                self._seg_dev, self._val_shape, self._val_dtype,
                self._align_chunk, self._metrics,
                shard_ids=self.shard_ids)
            if self._seg_dev is None:
                out._seg = self._seg
            out._d2h_cb = self._d2h_cb
            # replacement rows come from the consumer's stream: no event
        return out

    def _shard_rows(self, shard: int) -> np.ndarray:
        j = self._ordinal(shard)
        with self._lock:
            got = self._shards.get(j)
        if got is None:
            self._shard_transfer(shard)
            got = self._land(j)
        if isinstance(got, LosslessBlock):
            with self._lock:
                got = self._shards[j]
                if isinstance(got, LosslessBlock):
                    # a2a.wire=lossless parked this shard compressed; the
                    # first touch restores the exact bytes and keeps them
                    got = self._shards[j] = decode_block(got)
        return got

    def compress_host_blocks(self, executor=None) -> Tuple[int, int]:
        """``a2a.wire=lossless``: re-encode every host-resident shard
        block as byte planes + deflate (``shuffle/wire.encode_block``),
        fanned over ``executor`` when given; a block decodes on its first
        touch (:meth:`_shard_rows`). Returns (raw bytes, compressed
        bytes) of what was encoded, (0, 0) when nothing is on the host
        yet."""
        with self._lock:
            todo = [(j, a) for j, a in self._shards.items()
                    if isinstance(a, np.ndarray)]
        if not todo:
            return 0, 0

        def enc(item):
            j, a = item
            return j, encode_block(a)

        done = list(executor.map(enc, todo)) if executor is not None \
            else [enc(t) for t in todo]
        raw = comp = 0
        with self._lock:
            for j, blk in done:
                # a view a consumer already holds keeps its base alive;
                # the block restores the same bytes on the next touch
                self._shards[j] = blk
                raw += blk.raw_bytes
                comp += blk.nbytes
        return raw, comp


def merge_sorted_rows(blocks) -> np.ndarray:
    """Merge per-wave key-sorted packed row blocks into one key-sorted
    block (host): one stable argsort over the concatenation restores the
    ``ordered`` contract across waves (key order only; the order of equal
    keys is unspecified, as on the device)."""
    rows = np.concatenate(blocks)
    keys = np.ascontiguousarray(
        rows[:, :KEY_WORDS]).view(np.int64).ravel()
    return rows[np.argsort(keys, kind="stable")]


def combine_packed_rows(blocks, val_words_n: int, val_dtype,
                        sum_words: int = 0) -> np.ndarray:
    """Merge per-wave COMBINED packed row blocks by key (host): a key
    that appeared in several waves has one row per wave here, and this
    pass sums them. Integer sums wrap at the dtype's width, floats
    accumulate in float32; ``sum_words`` transport words are summed
    (0 = all), the rest is carried from one row of the key."""
    rows = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
    n = rows.shape[0]
    if n == 0:
        return rows
    keys = np.ascontiguousarray(
        rows[:, :KEY_WORDS]).view(np.int64).ravel()
    order = np.argsort(keys, kind="stable")
    rows = rows[order]
    keys = keys[order]
    starts_mask = np.empty(n, dtype=bool)
    starts_mask[0] = True
    np.not_equal(keys[1:], keys[:-1], out=starts_mask[1:])
    starts = np.flatnonzero(starts_mask)
    out = rows[starts].copy()
    vdt = np.dtype(val_dtype)
    sw = sum_words if sum_words > 0 else val_words_n
    if sw:
        vals = np.ascontiguousarray(
            rows[:, KEY_WORDS:KEY_WORDS + sw]).view(vdt)
        acc_dt = np.float32 if np.issubdtype(vdt, np.floating) \
            else np.int64
        acc = np.add.reduceat(vals.astype(acc_dt), starts,
                              axis=0).astype(vdt)
        out[:, KEY_WORDS:KEY_WORDS + sw] = \
            np.ascontiguousarray(acc).view(np.int32)
    return out


# -- the device cross-wave merge (read.sink=device, ordered/combine) --------

def merge_step_body(plan: ShufflePlan, acc_cap: int, wave_cap: int,
                    merge_impl: str):
    """One fold step of the device cross-wave merge: ``step(acc_rows
    [P, acc_cap, W], acc_n [P], wave_rows [P, wave_cap, W], wave_n [P])``
    -> (rows ``[P, acc_cap, W]``, pcounts ``[P, R]``, total ``[P]``). A
    key-sorted merge for ``ordered``, merge + segment reduce for
    ``combine``. Validity is sentinel-encoded (partition R on rows at and
    past each side's count), because the two sides' valid rows do not
    form one prefix. The output keeps ``acc_cap`` rows: the capacity
    comes from every wave's delivered totals (:func:`device_merge_fold`),
    so every valid row fits."""
    R = plan.num_partitions
    part_fn = _make_part_fn(plan, R)

    def _parts(rows: torch.Tensor, n: torch.Tensor, cap: int):
        live = torch.arange(cap, device=rows.device)[None, :] \
            < n.reshape(-1, 1)
        return torch.where(live, part_fn(rows).to(torch.int32),
                           torch.full_like(live, R, dtype=torch.int32))

    def step(acc_rows, acc_n, wave_rows, wave_n):
        pa = _parts(acc_rows, acc_n, acc_cap)
        pw = _parts(wave_rows, wave_n, wave_cap)
        if plan.combine:
            rows_out, pcounts, _ = merge_reduce_rows(
                acc_rows, pa, wave_rows, pw, R, plan.combine_words,
                np.dtype(plan.combine_dtype), plan.combine,
                sum_words=plan.combine_sum_words,
                compaction=plan.combine_compaction, impl=merge_impl,
                out_cap=acc_cap)
        else:
            rows_out, _, pcounts = merge_rows(
                acc_rows, pa, wave_rows, pw, R, impl=merge_impl,
                out_cap=acc_cap)
        # real rows only: sentinel groups never count
        total = pcounts.sum(dim=1, dtype=torch.int32)
        return rows_out, pcounts, total

    return step


def _seed_acc(rows: torch.Tensor, acc_cap: int) -> torch.Tensor:
    """The fold's first step: wave 0's rows are already partition-major
    key-sorted (the exchange step merged within the wave) and its seg is
    the accumulator's counts, so seeding is a pad with zero rows or a
    cut to ``acc_cap`` (its valid rows are a prefix and fit), no merge."""
    P, cap, W = rows.shape
    if acc_cap <= cap:
        return rows[:, :acc_cap].contiguous()
    return torch.cat([rows, rows.new_zeros(P, acc_cap - cap, W)], dim=1)


def resolve_merge_impl(conf: ShuffleConf, plan: ShufflePlan,
                       device: torch.device) -> str:
    """``read.mergeImpl`` against what this plan's fold runs on
    ``device``, through :func:`~sparkucx_tpu_torch.ops.segmented.
    resolve_kernel_impl`: auto is the kernels on CUDA and the torch ops
    on the CPU; a combine whose value dtype is not a 4-byte lane takes
    the torch ops either way."""
    impl, reason = resolve_kernel_impl(
        conf.read_merge_impl, device,
        combine_dtype=plan.combine_dtype or None)
    if reason is not None:
        log.info("read.mergeImpl=%s resolves to jnp for this fold: %s",
                 conf.read_merge_impl, reason)
    return impl


def device_merge_fold(res: "DeviceShuffleReaderResult",
                      conf: ShuffleConf) -> "LazyShuffleReaderResult":
    """Fold a multi-wave ordered or combine DEVICE result into ONE merged
    device view, through the result's own ``consume`` chain, so each
    wave's buffers are dropped as the fold takes them (no payload D2H).

    The accumulator's capacity is the largest per-shard sum of delivered
    rows over all waves (one ``[P]`` pull per wave: metadata, not
    payload), on the cap-bucket ladder. Over a distributed read's partial
    views each wave's row is summed over every process
    (``distributed.local_totals_row``, a collective), so every process
    folds at the same capacity; the fold itself runs on the local
    shards."""
    plan = res._plan
    Pn = plan.num_shards
    R = plan.num_partitions
    views = res.wave_views()
    shard_ids = views[0].shard_ids
    if shard_ids is None:
        totals = np.stack([v._totals_dev.cpu().numpy() for v in views])
    else:
        from sparkucx_tpu_torch.shuffle.distributed import local_totals_row
        totals = np.stack([local_totals_row(v._totals_dev, shard_ids, Pn)
                           for v in views])
    L = views[0]._rows_dev.shape[0]
    need = int(totals.sum(axis=0).max()) if totals.size else 0
    acc_cap = bucket_cap_conf(max(8, -(-need // 8) * 8), conf)
    merge_impl = resolve_merge_impl(conf, plan, views[0]._rows_dev.device)
    # wave 0's seg is the accumulator's first counts: take it before
    # consume drops the view's buffers
    seg = {"seg": views[0]._seg_dev}

    def fold(carry, rows, tot):
        if carry is None:
            return _seed_acc(rows, acc_cap), tot
        acc_rows, acc_n = carry
        step = merge_step_body(plan, acc_cap, rows.shape[1], merge_impl)
        acc_rows, pcounts, acc_n = step(acc_rows, acc_n, rows, tot)
        seg["seg"] = pcounts.reshape(L, 1, R)
        return acc_rows, acc_n

    with GLOBAL_TRACER.span("shuffle.merge", waves=len(views),
                            impl=merge_impl):
        acc_rows, acc_n = res.consume(fold, None)
    view = type(views[0])(
        R, blocked_partition_map(R, Pn), acc_rows, seg["seg"],
        res._val_shape, res._val_dtype, metrics=views[0]._metrics,
        shard_ids=shard_ids)
    view._totals_dev = acc_n
    return view


def drain_wave_result(res: LazyShuffleReaderResult) -> None:
    """Drain one completed wave of a host-sink waved read: pull its seg
    matrix and its rows to the host NOW, which drops the wave's device
    buffers, so the waves behind it have the device memory."""
    res._materialize()


class WavedShuffleReaderResult(ShuffleReaderResult):
    """Host view over the W per-wave results of a wave-pipelined read.
    Each wave was a whole exchange over a slice of the staged rows, so
    partition r is the union of its rows in every wave:

    * plain    — the waves' runs concatenate in wave order;
    * ordered  — the per-wave key-sorted runs merge by key
                 (:func:`merge_sorted_rows`);
    * combine  — the per-wave combined rows merge by key, summed and
                 carried lanes as in the device combine
                 (:func:`combine_packed_rows`).

    A merged partition block is cached, so a repeated ``partition(r)``
    merges once."""

    def __init__(self, wave_results, plan: ShufflePlan, val_shape,
                 val_dtype):
        if not wave_results:
            raise ValueError("waved result needs at least one wave")
        first = wave_results[0]
        super().__init__(plan.num_partitions, first._part_to_shard, None,
                         None, val_shape, val_dtype,
                         shard_ids=first.shard_ids)
        self._waves = list(wave_results)
        self._plan = plan
        self.waves = len(wave_results)

    def wave_results(self):
        """The per-wave results, in wave order."""
        return list(self._waves)

    def _partition_block(self, r: int, shard: int) -> np.ndarray:
        got = self._block_cache.get(r)
        if got is not None:
            return got
        blocks = [b for b in (w._partition_block(r, shard)
                              for w in self._waves) if b.shape[0]]
        if not blocks:
            return self._waves[0]._partition_block(r, shard)
        if len(blocks) == 1:
            block = blocks[0]
        elif self._plan.combine:
            block = combine_packed_rows(
                blocks, self._plan.combine_words,
                np.dtype(self._plan.combine_dtype),
                self._plan.combine_sum_words)
        elif self._plan.ordered:
            block = merge_sorted_rows(blocks)
        else:
            block = np.concatenate(blocks)
        self._block_cache[r] = block
        return block

    def release_partition(self, r: int) -> None:
        """Drop partition r's merged block AND each wave's own cached
        block of it."""
        super().release_partition(r)
        for w in self._waves:
            w.release_partition(r)


class DeviceShuffleReaderResult:
    """Device-resident result of one read (``read.sink=device``): each
    wave's receive buffer stays the ``[P, cap, W]`` device tensor the step
    produced (a single-shot read is one wave), with no payload D2H.

    :meth:`consume` hands the waves to a consumer in wave order, dropping
    this result's own references to a wave before the call, so the
    consumer holds the only ones and a fold need not keep every wave
    resident. :meth:`host_view` is the way back to the numpy partition
    contract: over the live buffers it pulls (and counts) the D2H this
    sink defers; over consumer-returned rows (``wave_rows=``) it reads
    what the consumer passed through. ``partition`` fails closed."""

    sink = "device"

    def __init__(self, views, plan: ShufflePlan, val_shape, val_dtype):
        if not views:
            raise ValueError("device result needs at least one wave view")
        self._views: Optional[list] = list(views)
        self._plan = plan
        self._val_shape = val_shape
        self._val_dtype = val_dtype
        self.num_partitions = plan.num_partitions
        self.waves = len(views)
        self.consumed = False
        # the manager's capacity learning sees the plan capacity of a
        # single-shot read, as from the lazy result
        self.cap_out_used: Optional[int] = plan.cap_out if self.waves == 1 \
            else None
        self.recv_rows_needed: Optional[int] = None
        # the manager's a2a.maxBytesInFlight release: this result's
        # receive buffers stay on the device until consume(), close() or
        # the host_view() drain, so the reservation frees there
        self._release_hbm = None

    def wave_views(self):
        """The per-wave device views, in wave order."""
        return list(self._views or [])

    def _live_views(self) -> list:
        if self.consumed or self._views is None:
            raise RuntimeError(
                "device result already consumed or closed: its buffers "
                "went to the consumer; re-read the shuffle, or keep the "
                "consumer's outputs")
        return self._views

    def device_rows(self, wave: int = 0) -> torch.Tensor:
        """Wave ``wave``'s receive buffer, ``[P, cap, W]`` int32 in the
        packed transport format (keys + bit-cast value lanes)."""
        return self._live_views()[wave]._rows_dev

    def device_totals(self, wave: int = 0) -> torch.Tensor:
        """Wave ``wave``'s delivered rows per shard, ``[P]`` int32: shard
        p's delivered rows are ``device_rows(wave)[p, :totals[p]]``, rows
        at and past it are invalid."""
        return self._live_views()[wave]._totals_dev

    def consume(self, fn, carry=None):
        """``carry = fn(carry, rows, totals)`` per wave, in wave order;
        this result drops its references to a wave before handing it
        over. Returns the final carry. A second consume raises."""
        views = self._live_views()
        try:
            for v in views:
                with v._lock:
                    rows, totals = v._rows_dev, v._totals_dev
                    v._rows_dev = None
                    v._totals_dev = None
                if rows is None:
                    raise RuntimeError("device wave buffers already taken")
                carry = fn(carry, rows, totals)
                del rows, totals
        except BaseException:
            # the remaining waves' buffers must not stay pinned by a
            # consumer that died mid-fold
            self._views = None
            raise
        finally:
            self.consumed = True
            self._fire_release()
        return carry

    def host_view(self, wave_rows=None):
        """A host-readable result. Without arguments: over the live device
        buffers (pays and counts the D2H; invalid after :meth:`consume`).
        With ``wave_rows`` (one ``[P, cap, W]`` tensor per wave): over
        consumer-returned rows, valid any time."""
        if wave_rows is None:
            views = list(self._live_views())
            # the admission release moves to the drain: once every view
            # dropped its device rows, the reservation frees
            left = [len(views)]
            lock = threading.Lock()

            def one_freed():
                with lock:
                    left[0] -= 1
                    last = left[0] == 0
                if last:
                    self._fire_release()
            for v in views:
                v._on_device_free = one_freed
        else:
            base = self._views or []
            if len(wave_rows) != len(base):
                raise ValueError(f"wave_rows has {len(wave_rows)} entries "
                                 f"for {len(base)} waves")
            views = [v.with_rows(r) for v, r in zip(base, wave_rows)]
        if len(views) == 1:
            return views[0]
        return WavedShuffleReaderResult(views, self._plan, self._val_shape,
                                        self._val_dtype)

    def partition(self, r: int):
        raise RuntimeError(
            "device-sink results hold their partitions in device memory: "
            "consume() them, or host_view() for the numpy contract (which "
            "pays the D2H this sink defers); a numpy consumer should "
            "read(sink='host')")

    def partitions(self):
        self.partition(0)

    def partitions_ready(self, poll_s: float = 0.002):
        self.partition(0)

    def close(self) -> None:
        """Drop the device buffers without consuming them (and release
        their admission reservation)."""
        self.consumed = True
        self._views = None
        self._fire_release()

    def _fire_release(self) -> None:
        cb, self._release_hbm = self._release_hbm, None
        if cb is not None:
            cb()

    def __del__(self):
        try:
            self._fire_release()
        except Exception:
            pass


class PendingExchangeBase:
    """The lifecycle every pending exchange handle shares — the flat
    :class:`PendingShuffle` and the two-stage
    ``topology.PendingTieredShuffle`` (the JAX package's
    ``PendingExchangeBase``):

    * admission: ``admit`` is None (no ``a2a.maxBytesInFlight`` cap) or
      the manager's ``admit(block) -> bool``. When the non-blocking
      attempt at submit fails, the exchange is deferred — no H2D copy,
      no dispatch, ``done()`` False — and ``result()`` waits for the
      capacity, then starts it (a blocking submit would deadlock a caller
      that resolves its handles in order);
    * ``on_done(result_or_None)`` fires exactly once; it is armed after
      the first dispatch, so a dispatch failure in the constructor leaves
      the cleanup to the caller, never to the half-built handle;
    * each dispatch's overflow flag travels to pinned memory behind its
      step (:meth:`_arm_overflow`), so a join waits for THIS step's
      event, not for the whole stream (which also holds a waved read's
      later waves);
    * :meth:`_settle` turns a finished exchange's view into the sink's
      result: the device result, or the host view with the delivered-rows
      figure the manager's capacity hint learns from.

    Subclasses set ``_plan``, ``_val_shape`` and ``_val_dtype`` and
    implement ``_start()`` (the first H2D copy and dispatch),
    ``_result_inner()`` (the overflow-retry loop, returning the result)
    and ``_drop_buffers()`` (the device references a settled handle
    releases)."""

    def _admit_or_defer(self, admit, on_done) -> None:
        self._result = None
        self._dead = False
        self._event = None
        self._admit_cb = None
        self._on_done = None
        if admit is None or admit(False):
            self._start()
        else:
            self._admit_cb = admit       # deferred: started in result()
        self._on_done = on_done

    def _arm_overflow(self, ovf: torch.Tensor) -> None:
        """Keep the just-dispatched step's 0-d overflow flag; on CUDA copy
        it to pinned memory behind the step and record the step's
        event."""
        self._ovf = ovf
        self._event = None
        if ovf.device.type == "cuda":
            self._ovf_host = torch.empty((), dtype=torch.bool,
                                         pin_memory=True)
            self._ovf_host.copy_(ovf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(ovf.device))

    def _overflowed(self) -> bool:
        """Wait for the current step alone; its overflow verdict."""
        if self._event is not None:
            self._event.synchronize()
            return bool(self._ovf_host)
        return bool(self._ovf)

    def _outputs_ready(self) -> bool:
        """Stage-local poll: the outputs of the step dispatched last are
        computed (the wave pipeline's hidden-pack probe)."""
        if self._result is not None:
            return True
        if self._admit_cb is not None:
            return False                 # deferred by maxBytesInFlight
        return self._event is None or self._event.query()

    def done(self) -> bool:
        return self._outputs_ready()

    def result(self):
        if self._result is not None:
            return self._result
        if self._dead:
            raise RuntimeError(
                "exchange handle is dead: a previous result() failed and "
                "its buffers were released; re-submit the shuffle")
        try:
            if self._admit_cb is not None:
                # deferred submit: wait for the capacity (TimeoutError
                # when nothing frees it), then the first dispatch
                admit, self._admit_cb = self._admit_cb, None
                admit(True)
                # the deferred first dispatch runs here, outside the
                # manager's dispatch span
                with GLOBAL_TRACER.span("shuffle.dispatch", deferred=True):
                    self._start()
            res = self._result_inner()
            # the manager's post-exchange check (integrity.verify=full):
            # inside result(), so submit()/result() verifies as read()
            # does, and a raise takes the failure path below
            hook = getattr(self, "_post_result", None)
            if hook is not None:
                hook(res)
        except BaseException:
            # a failed exchange keeps nothing on the device: a replay
            # must not run beside this attempt's buffers
            self._dead = True
            self._drop_buffers()
            self._notify(None)
            raise
        # the staged rows and step outputs are no longer needed on the
        # device (the result holds what it serves)
        self._drop_buffers()
        self._result = res
        self._notify(res)
        return res

    def __del__(self):
        # an abandoned handle gives its pack buffer and its reservation
        # back (on_done(None)): a deferred one at once (nothing reached
        # the device), a dispatched one once its step's event says the
        # H2D copy out of the pinned buffer is done
        try:
            if self._result is None and not self._dead:
                if self._admit_cb is not None:
                    self._admit_cb = None
                elif self._event is not None:
                    self._event.synchronize()
                self._notify(None)
        except Exception:
            pass

    def _notify(self, res) -> None:
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb(res)

    def _settle(self, res: "LazyShuffleReaderResult", need_rows: bool):
        """The sink's result over ``res``: the device result on the
        device sink (the partitions stay in the device tensors: no drain,
        not even the seg matrix's, deferred to host_view); else ``res``
        itself, with ``recv_rows_needed`` (the max rows a shard received)
        when ``need_rows``."""
        plan = self._plan
        if plan.sink == "device":
            return DeviceShuffleReaderResult([res], plan, self._val_shape,
                                             self._val_dtype)
        if need_rows:
            res._seg_matrix(0)                  # pulls the whole matrix
            res.recv_rows_needed = max_recv_rows(
                res._seg, res._part_to_shard, plan.num_shards)
        return res


class PendingShuffle(PendingExchangeBase):
    """Handle of a dispatched exchange. ``done()`` polls without blocking;
    ``result()`` blocks, runs the overflow-retry loop and returns a
    :class:`LazyShuffleReaderResult` (admission and ``on_done`` as in
    :class:`PendingExchangeBase`). ``step_for(plan)`` builds the step
    each attempt dispatches (default :func:`step_body`; the fused
    hierarchical read passes its own)."""

    def __init__(self, plan: ShufflePlan, shard_rows: np.ndarray,
                 shard_nvalid: np.ndarray, val_shape, val_dtype,
                 device: torch.device, on_done=None, metrics=None,
                 wire_seed: int = 0, admit=None, step_for=step_body):
        self._plan = plan
        self._step_for = step_for
        # int8 noise base: attempt k of the overflow retry loop draws from
        # wire_seed + k, so a re-run gets fresh rounding noise
        self._wire_seed = int(wire_seed)
        self._val_shape = val_shape
        self._val_dtype = val_dtype
        self._device = device
        self._metrics = metrics
        self._attempt = 0
        # the staged rows stay owned by on_done until the exchange settles
        if not isinstance(shard_rows, torch.Tensor):
            shard_rows = torch.from_numpy(shard_rows)
        self._host = (shard_rows, shard_nvalid)
        self._admit_or_defer(admit, on_done)

    def _start(self) -> None:
        """One H2D copy from the (page-locked) pack buffer, then the
        first dispatch."""
        shard_rows, shard_nvalid = self._host
        self._host = None
        # pinned copies: a pageable one would wait for all earlier work on
        # the stream (a waved read's previous wave)
        self._rows = stage_to_device(shard_rows, self._device)
        self._nvalid = stage_to_device(
            np.asarray(shard_nvalid, dtype=np.int32), self._device)
        self._dispatch()

    def _dispatch(self) -> None:
        seeds = wire_shard_seeds(self._plan,
                                 self._wire_seed + self._attempt)
        self._out = self._step_for(self._plan)(self._rows, self._nvalid,
                                               seeds)
        self._arm_overflow(self._out[3])

    def _drop_buffers(self) -> None:
        self._rows = self._nvalid = self._out = None

    # the fabric tier the completion wait stands for (a cross-process
    # read's is "dcn")
    _wait_tier = "ici"

    def _result_inner(self):
        while True:
            rows_out, seg, total, _ = self._out
            with GLOBAL_TRACER.span("shuffle.exchange.wait",
                                    tier=self._wait_tier):
                overflowed = self._overflowed()
            if not overflowed:
                break
            if self._attempt >= self._plan.max_retries:
                raise RuntimeError(
                    f"shuffle still overflowing after "
                    f"{self._plan.max_retries} retries "
                    f"(cap_out={self._plan.cap_out}); extreme skew — "
                    f"repartition the data")
            log.info("shuffle overflow at cap_out=%d (attempt %d); "
                     "growing", self._plan.cap_out, self._attempt)
            self._plan = self._plan.grown()
            self._attempt += 1
            with GLOBAL_TRACER.span("shuffle.dispatch", retry=self._attempt):
                self._dispatch()
        plan = self._plan
        with GLOBAL_TRACER.span("shuffle.result", sink=plan.sink):
            align_chunk = 0
            if plan.impl == "pallas" and not (plan.combine or plan.ordered
                                              or plan.sink == "device"):
                # only the plain host-sink read keeps the chunk-aligned
                # layout
                align_chunk = chunk_rows_for(
                    wire_row_words(plan, rows_out.shape[2]))
            res = self._view(rows_out, seg, align_chunk)
            # the PLAN capacity, not the chunk-inflated buffer size
            res.cap_out_used = self._plan.cap_out
            res._totals_dev = total
            res._ready_event = self._event
            # true delivered rows (the aligned layout consumes slack; a
            # combine's counts are post-merge)
            return self._settle(res, not (plan.combine
                                          or plan.impl == "pallas"))

    def _view(self, rows_out, seg, align_chunk: int):
        """The lazy result over the step's outputs."""
        R = self._plan.num_partitions
        return LazyShuffleReaderResult(
            R, blocked_partition_map(R, self._plan.num_shards), rows_out,
            seg, self._val_shape, self._val_dtype, align_chunk=align_chunk,
            metrics=self._metrics)


def submit_shuffle(plan: ShufflePlan, shard_rows: np.ndarray,
                   shard_nvalid: np.ndarray,
                   val_shape: Optional[Tuple[int, ...]], val_dtype,
                   device: torch.device, on_done=None,
                   metrics=None, wire_seed: int = 0,
                   admit=None) -> PendingShuffle:
    """Dispatch the exchange without blocking (or defer it, see
    :class:`PendingShuffle`'s ``admit``).

    shard_rows   — [P, cap_in, width] fused int32 rows per shard
    shard_nvalid — [P] valid row counts
    wire_seed    — int8 noise base (the manager passes its exchange
                   sequence number)"""
    return PendingShuffle(plan, shard_rows, shard_nvalid, val_shape,
                          val_dtype, device, on_done=on_done,
                          metrics=metrics, wire_seed=wire_seed, admit=admit)


def read_shuffle(plan: ShufflePlan, shard_rows: np.ndarray,
                 shard_nvalid: np.ndarray,
                 val_shape: Optional[Tuple[int, ...]], val_dtype,
                 device: torch.device,
                 wire_seed: int = 0) -> ShuffleReaderResult:
    """Blocking exchange with overflow retry (submit + result)."""
    return submit_shuffle(plan, shard_rows, shard_nvalid, val_shape,
                          val_dtype, device,
                          wire_seed=wire_seed).result()
