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
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.config import PARTITIONERS
from sparkucx_tpu_torch.ops.aggregate import combine_rows, keysort_rows
from sparkucx_tpu_torch.ops.partition import (blocked_partition_map,
                                              destination_sort,
                                              hash_partition,
                                              partition_major_sort_aligned,
                                              range_partition_words)
from sparkucx_tpu_torch.ops.ragged_a2a import (align_rows, chunk_rows_for,
                                               ragged_a2a)
from sparkucx_tpu_torch.ops.segmented import segment_reduce_rows
from sparkucx_tpu_torch.shuffle.alltoall import ragged_shuffle
from sparkucx_tpu_torch.shuffle.plan import ShufflePlan, wire_row_words
from sparkucx_tpu_torch.utils.logging import get_logger
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


def _reduce_side_combine(plan: ShufflePlan, rows: torch.Tensor,
                         part: torch.Tensor, num_valid):
    """Merge the received rows per (partition, key): one keysort, then
    the segment-reduce kernel (``kernel_impl == 'pallas'``), or the
    torch-op ``combine_rows``. Returns (rows_out, pcounts ``[P, R]``)."""
    R = plan.num_partitions
    if plan.kernel_impl == "pallas":
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
    hi = torch.as_tensor(bounds[1:], dtype=torch.int64, device=cum.device)
    lo = torch.as_tensor(bounds[:-1], dtype=torch.int64, device=cum.device)
    return cum[:, hi] - cum[:, lo]


def step_body(plan: ShufflePlan):
    """The exchange step: ``step(payload [P, cap_in, W], nvalid [P])`` ->
    (rows ``[P, cap, W]``, seg, total ``[P]`` delivered rows, overflow
    0-d bool). seg is ``[P, R]`` per-sender partition counts on a plain
    read and each shard's own ``[P, 1, R]`` counts on a combine or
    ordered read.

    PARTITION-MAJOR: the send side sorts by global reduce-partition id;
    the blocked map is monotone, so this groups rows by destination shard
    AND leaves every delivered segment partition-sorted."""
    if plan.impl == "pallas":
        return _pallas_step_body(plan)
    R = plan.num_partitions
    Pn = plan.num_shards
    bounds = _device_bounds(R, Pn)
    part_fn = _make_part_fn(plan, R)

    def step(payload: torch.Tensor, nvalid: torch.Tensor):
        part = part_fn(payload)
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
        r = ragged_shuffle(send, _dev_counts(rcounts, bounds),
                           out_capacity=plan.cap_out, impl=plan.impl)
        if plan.combine or plan.ordered:
            if Pn == 1:
                # one sender: the send side already holds one key-sorted
                # run per partition
                return r.data, rcounts.reshape(1, 1, R), r.total, \
                    r.overflow
            out_part = part_fn(r.data)
            if plan.combine:
                rows_out, pcounts = _reduce_side_combine(plan, r.data,
                                                         out_part, r.total)
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

    def step(payload: torch.Tensor, nvalid: torch.Tensor):
        if not (plan.combine or plan.ordered):
            srows, rcounts, dev_counts, cap_eff = aligned_send(
                plan, payload, nvalid)
            out, recv_real, _, total_al = ragged_a2a(
                srows, dev_counts, out_capacity=cap_eff)
            total = recv_real.sum(dim=1, dtype=torch.int32)
            return out, rcounts, total, (total_al < 0).any()
        out, pkey, ovf = densified_receive(plan, payload, nvalid)
        cap_eff = out.shape[1]
        if plan.combine:
            rows_out, pcounts = _reduce_side_combine(plan, out, pkey,
                                                     cap_eff)
        else:
            _, rows_out, pcounts = keysort_rows(out, pkey, cap_eff, R)
        # the total from pcounts: sentinel groups never count
        total = pcounts.sum(dim=1, dtype=torch.int32)
        return rows_out, pcounts.reshape(Pn, 1, R), total, ovf

    return step


def densified_receive(plan: ShufflePlan, payload: torch.Tensor,
                      nvalid: torch.Tensor):
    """The segment move of a combine or ordered read, up to the receive
    side's grouping: map-side combine (combine reads), the aligned sort,
    the move, then every row outside a segment's real prefix gets the
    sentinel partition R. Returns (received rows ``[P, cap_eff, W]``,
    their partitions ``[P, cap_eff]`` with R on pad rows, overflow 0-d
    bool)."""
    R = plan.num_partitions
    Pn = plan.num_shards
    part_fn = _make_part_fn(plan, R)
    if plan.combine:
        # map-side combine first: one row per distinct (partition, key)
        # enters the move; the aligned sort re-lays the combined rows out
        comb, _, n_c = _combine(plan, payload, part_fn(payload), nvalid)
        srows, _, dev_counts, cap_eff = aligned_send(plan, comb, n_c)
    else:
        srows, _, dev_counts, cap_eff = aligned_send(plan, payload, nvalid)
    out, recv_real, recv_off, total_al = ragged_a2a(
        srows, dev_counts, out_capacity=cap_eff)
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
    (keys, values) of reduce partition r, densely packed."""

    def __init__(self, num_partitions: int, part_to_shard: np.ndarray,
                 rows: np.ndarray, seg_counts: np.ndarray,
                 val_shape: Optional[Tuple[int, ...]], val_dtype,
                 align_chunk: int = 0):
        self.num_partitions = num_partitions
        self._part_to_shard = part_to_shard
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

    def _seg_matrix(self, shard: int) -> np.ndarray:
        """The count matrix shard's runs are indexed by: the shared
        ``[P, R]`` per-sender matrix, or its own ``[1, R]`` row of a
        ``[P, 1, R]`` per-shard matrix."""
        return self._seg if self._seg.ndim == 2 else self._seg[shard]

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
        return self._rows[shard]

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
        """(keys, values) of reduce partition r."""
        if not 0 <= r < self.num_partitions:
            raise IndexError(f"partition {r} out of [0, "
                             f"{self.num_partitions})")
        shard = int(self._part_to_shard[r])
        return unpack_rows(self._partition_block(r, shard),
                           self._val_shape, self._val_dtype)

    def partitions(self):
        for r in range(self.num_partitions):
            yield r, self.partition(r)

    def release_partition(self, r: int) -> None:
        """Drop partition r's cached dense block."""
        self._block_cache.pop(r, None)


class LazyShuffleReaderResult(ShuffleReaderResult):
    """Result view over device tensors. The first ``partition()`` call
    pulls the seg matrix, then copies each shard's occupied prefix (the
    runs' extent, not the whole receive capacity) into ONE page-locked
    host buffer and drops the device tensors; later calls are host
    slicing. On a CPU device the "copy" is a view."""

    def __init__(self, num_partitions: int, part_to_shard: np.ndarray,
                 rows_dev: torch.Tensor, seg_dev: torch.Tensor,
                 val_shape, val_dtype, align_chunk: int = 0, metrics=None):
        super().__init__(num_partitions, part_to_shard, None, None,
                         val_shape, val_dtype, align_chunk)
        self._rows_dev = rows_dev
        self._seg_dev = seg_dev
        self._metrics = metrics
        self._shards: Optional[list] = None
        self.d2h_bytes = 0
        self._lock = threading.Lock()

    def _seg_matrix(self, shard: int) -> np.ndarray:
        with self._lock:
            if self._seg is None:
                self._seg = self._seg_dev.cpu().numpy()
                self._seg_dev = None
        return super()._seg_matrix(shard)

    def _materialize(self) -> list:
        with self._lock:
            if self._shards is not None:
                return self._shards
        P = self._rows_dev.shape[0]
        ext = [self._runs(p).extent for p in range(P)]
        with self._lock:
            if self._shards is not None:
                return self._shards
            dev = self._rows_dev
            if dev.device.type == "cpu":
                host = dev.numpy()
                shards = [host[p, :ext[p]] for p in range(P)]
            else:
                width = dev.shape[2]
                buf = torch.empty((sum(ext), width), dtype=dev.dtype,
                                  pin_memory=True)
                off = 0
                for p in range(P):
                    buf[off:off + ext[p]].copy_(dev[p, :ext[p]],
                                                non_blocking=True)
                    off += ext[p]
                torch.cuda.current_stream(dev.device).synchronize()
                host = buf.numpy()
                shards, off = [], 0
                for p in range(P):
                    shards.append(host[off:off + ext[p]])
                    off += ext[p]
                self.d2h_bytes = int(buf.numel()) * 4
                if self._metrics is not None:
                    self._metrics.inc(C_D2H, float(self.d2h_bytes))
            self._shards = shards
            self._rows_dev = None         # free the device buffer
            return shards

    def _shard_rows(self, shard: int) -> np.ndarray:
        return self._materialize()[shard]


class PendingShuffle:
    """Handle of a dispatched exchange. ``done()`` polls without blocking;
    ``result()`` blocks, runs the overflow-retry loop and returns a
    :class:`LazyShuffleReaderResult`. ``on_done(result_or_None)`` fires
    exactly once."""

    def __init__(self, plan: ShufflePlan, shard_rows: np.ndarray,
                 shard_nvalid: np.ndarray, val_shape, val_dtype,
                 device: torch.device, on_done=None, metrics=None):
        self._plan = plan
        self._val_shape = val_shape
        self._val_dtype = val_dtype
        self._device = device
        self._on_done = on_done
        self._metrics = metrics
        self._attempt = 0
        self._result: Optional[LazyShuffleReaderResult] = None
        # one H2D copy from the (page-locked) pack buffer; the buffer
        # stays owned by on_done until the exchange settles
        if not isinstance(shard_rows, torch.Tensor):
            shard_rows = torch.from_numpy(shard_rows)
        self._rows = shard_rows.to(device, non_blocking=True)
        self._nvalid = torch.as_tensor(
            np.asarray(shard_nvalid, dtype=np.int32)).to(device)
        self._dispatch()

    def _dispatch(self) -> None:
        self._out = step_body(self._plan)(self._rows, self._nvalid)
        self._event = None
        if self._device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._device))

    def done(self) -> bool:
        return self._result is not None or self._event is None \
            or self._event.query()

    def result(self) -> LazyShuffleReaderResult:
        if self._result is not None:
            return self._result
        try:
            res = self._result_inner()
        except BaseException:
            self._notify(None)
            raise
        # the staged rows and step outputs are no longer needed on the
        # device (the result holds what it serves)
        self._rows = self._nvalid = self._out = None
        self._result = res
        self._notify(res)
        return res

    def _notify(self, res) -> None:
        cb, self._on_done = self._on_done, None
        if cb is not None:
            cb(res)

    def _result_inner(self) -> LazyShuffleReaderResult:
        while True:
            rows_out, seg, _total, ovf = self._out
            if not bool(ovf):          # host read: waits for the step
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
            self._dispatch()
        R = self._plan.num_partitions
        Pn = self._plan.num_shards
        p2s = blocked_partition_map(R, Pn)
        plan = self._plan
        align_chunk = 0
        if plan.impl == "pallas" and not (plan.combine or plan.ordered):
            # only the plain read keeps the chunk-aligned layout
            align_chunk = chunk_rows_for(
                wire_row_words(plan, rows_out.shape[2]))
        res = LazyShuffleReaderResult(R, p2s, rows_out, seg,
                                      self._val_shape, self._val_dtype,
                                      align_chunk=align_chunk,
                                      metrics=self._metrics)
        # the PLAN capacity, not the chunk-inflated buffer size
        res.cap_out_used = self._plan.cap_out
        if not (plan.combine or plan.impl == "pallas"):
            # true delivered rows (the aligned layout consumes slack; a
            # combine's counts are post-merge)
            res._seg_matrix(0)                  # pulls the whole matrix
            res.recv_rows_needed = max_recv_rows(res._seg, p2s, Pn)
        return res


def submit_shuffle(plan: ShufflePlan, shard_rows: np.ndarray,
                   shard_nvalid: np.ndarray,
                   val_shape: Optional[Tuple[int, ...]], val_dtype,
                   device: torch.device, on_done=None,
                   metrics=None) -> PendingShuffle:
    """Dispatch the exchange without blocking.

    shard_rows   — [P, cap_in, width] fused int32 rows per shard
    shard_nvalid — [P] valid row counts"""
    return PendingShuffle(plan, shard_rows, shard_nvalid, val_shape,
                          val_dtype, device, on_done=on_done,
                          metrics=metrics)


def read_shuffle(plan: ShufflePlan, shard_rows: np.ndarray,
                 shard_nvalid: np.ndarray,
                 val_shape: Optional[Tuple[int, ...]], val_dtype,
                 device: torch.device) -> ShuffleReaderResult:
    """Blocking exchange with overflow retry (submit + result)."""
    return submit_shuffle(plan, shard_rows, shard_nvalid, val_shape,
                          val_dtype, device).result()
