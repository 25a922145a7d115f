"""Multi-process read plane (the JAX package's
``sparkucx_tpu/shuffle/distributed.py``): one process per executor, map
outputs that stay on their own process, and one collective read.

A distributed node (``runtime/node.Node`` with ``distributed=True`` and
``numProcesses`` = N > 1) owns the contiguous block of L = P / N global
shards its process id gives it (``parallel/mesh.local_shard_ids``). Every
process calls ``read`` (a collective, in the same order as every other
collective) and gets the partial view of the partitions its shards own;
``partition(r)`` raises ``KeyError`` for a partition another process
owns.

**The metadata plane.** Size rows, the schema, the presence bitmap,
overflow verdicts and agreement rounds cross processes through
:func:`allgather_blob` — ``torch.distributed.all_gather`` over the node's
gloo group, fenced by the process watchdog (``runtime/watchdog.py``). A
transport error of a fenced collective (gloo often fails fast with a
closed connection when a peer dies) becomes the same ``PeerLostError`` as
an expired deadline. ``allgather_blob`` keeps its ``[nproc, ...]``
contract with no process group too (the identity at one process).

**The data plane (the port's own design).** Each process packs its L
local shards ``[L, cap_in, W]`` into pinned memory, copies them to its
device, partitions them and sorts them by destination there
(:func:`distributed_step_body`). Then one :class:`CrossProcessHop`:

* the ``[L, P]`` per-destination counts are all-gathered into the
  ``[P, P]`` matrix on every process (the JAX step all-gathers the same
  matrix on the device);
* the segments bound for other processes' shards are gathered into one
  compact block on the device, copied into a buffer of the node's pinned
  pool and moved by one gloo ``all_to_all_single`` on CPU tensors, with
  split sizes from the matrix: real rows only, no pad. The received rows
  go back to the device in one copy;
* every sender's rows for this process's shards (the local senders'
  straight from their send buffers on the device, the others' from the
  received block) are laid out per sender, and the same dense
  ``ragged_shuffle`` as the single-process exchange moves them to the L
  receivers (``[P, L]`` sizes: each segment padded only to the largest
  real one, which the matrix gives), so the rows land at the reference's
  receive layout: per receiver, every sender's segment in sender order.

Gloo is the one transport: NCCL cannot put two ranks on one device, and
nothing quietly falls back. Each process's combine, quantize, finalize
and merge fold run on its own shards, on its own device.
``ExchangeReport.wire_bytes`` keeps the reference's arithmetic over the
P global shards; :attr:`CrossProcessHop.stats` counts the bytes the hop
staged through the host and its wall.

The two-tier read with S = N slices (:class:`PendingDistributedTieredShuffle`):
stage 1 (ICI) runs inside each process over its own slice, stage 2 (DCN)
is a cross-process hop, under per-tier deadlines; its overflow and regrow
decisions ride agreement rounds (``shuffle/agreement.py``)."""

from __future__ import annotations

import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sparkucx_tpu_torch.ops.aggregate import keysort_rows
from sparkucx_tpu_torch.ops.partition import (blocked_partition_map,
                                              destination_sort)
from sparkucx_tpu_torch.runtime.failures import PeerLostError
from sparkucx_tpu_torch.runtime.watchdog import current_watchdog
from sparkucx_tpu_torch.shuffle.alltoall import (ragged_shuffle,
                                                 wire_unpack_rows)
from sparkucx_tpu_torch.shuffle.plan import ShufflePlan, plan_takes_seed
from sparkucx_tpu_torch.shuffle.reader import (LazyShuffleReaderResult,
                                               PendingShuffle, _combine,
                                               _dev_counts, _device_bounds,
                                               _fused_wire_reduce,
                                               _make_part_fn,
                                               _reduce_side_combine,
                                               _wire_pack, wire_shard_seeds)
from sparkucx_tpu_torch.shuffle.topology import (PendingTieredShuffle,
                                                 TopologyDescriptor,
                                                 stage2_finalize)
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

log = get_logger("shuffle.distributed")

# the collective group of the live distributed node (runtime/node.py sets
# it); with none, an initialized default group serves, else the identity
_GROUP = None


def set_group(group):
    """Install the group the collectives run on; returns the previous."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    return prev


def _world():
    """(group, size): the installed group, else the default group when
    this process joined one, else (None, 1)."""
    import torch.distributed as dist
    group = _GROUP
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return None, 1
    return group, dist.get_world_size(group)


# what gloo says when a peer died or stopped answering (a closed or reset
# connection, or its own timeout); any other error of a collective (a
# size mismatch, a bad split) is a fault of this program and is raised
# as it is
_TRANSPORT_FAILURES = ("Connection closed by peer", "Connection reset by peer",
                       "Connection refused", "Broken pipe",
                       "Timed out waiting", "Socket Timeout")


def is_transport_failure(e: BaseException) -> bool:
    """Whether a collective's error means that a peer is gone."""
    import torch.distributed as dist
    net = getattr(dist, "DistNetworkError", ())
    return isinstance(e, net) or any(m in str(e)
                                     for m in _TRANSPORT_FAILURES)


def _fenced(fn, what: str, timeout_ms: Optional[float] = None):
    """``fn()`` under the process watchdog; a transport failure inside it
    (:func:`is_transport_failure`) is a lost peer."""
    def run():
        try:
            return fn()
        except RuntimeError as e:
            if not is_transport_failure(e):
                raise
            raise PeerLostError(
                f"collective {what!r} failed in its transport ({e}) — a "
                f"peer is unreachable or dead; remesh over the survivors "
                f"and re-run on a fresh world") from e
    return current_watchdog().call(run, what=what, timeout_ms=timeout_ms)


# -- the metadata plane ------------------------------------------------------
def allgather_blob(blob, what: str = "metadata allgather",
                   timeout_ms: Optional[float] = None,
                   group=None) -> np.ndarray:
    """COLLECTIVE: the ``[nproc, ...]`` stack of one small host array per
    process (same shape and dtype everywhere), in process order, fenced
    by the watchdog (``timeout_ms`` overrides its deadline for this
    round). ``group`` runs it on that group instead of the installed one
    (the node's ``replay_group``). With no process group it is
    ``blob[None]``."""
    arr = np.ascontiguousarray(blob)
    if group is None:
        group, n = _world()
    else:
        import torch.distributed as dist
        n = dist.get_world_size(group)

    def gather():
        if group is None:
            return arr[None].copy()
        import torch.distributed as dist
        t = torch.from_numpy(arr)
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
        return np.stack([o.numpy() for o in out])

    # no trace attr: trace-less callers (the anchor gather) share the
    # channel
    with GLOBAL_TRACER.span("shuffle.barrier", kind="allgather",
                            what=what):
        return _fenced(gather, what, timeout_ms)


def allgather_json(obj) -> list:
    """COLLECTIVE: one JSON-able object per process, in process order:
    two rounds (the lengths, then the payloads padded to the longest).
    An entry that fails to decode comes back as {}."""
    raw = np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)
    lens = allgather_blob(np.array([raw.size], dtype=np.int64))[:, 0]
    buf = np.zeros(max(int(lens.max()), 1), dtype=np.uint8)
    buf[:raw.size] = raw
    out = []
    for row, n in zip(allgather_blob(buf), lens):
        try:
            out.append(json.loads(bytes(row[:int(n)]).decode()))
        except ValueError:
            out.append({})
    return out


def gather_clock_anchors(tracer=None, process_id: int = 0) -> list:
    """COLLECTIVE: every process's wall/perf anchor pair
    (``Tracer.anchor()`` plus its ``process_id``), in process order: the
    alignment ``utils/export.merge_timeline`` needs for the processes'
    span clocks. The node gathers them at start."""
    a = (tracer or GLOBAL_TRACER).anchor()
    a["process_id"] = int(process_id)
    return allgather_json(a)


def gather_fleet_registry(entry) -> list:
    """COLLECTIVE: every process's fleet-registry entry (its live
    telemetry URL and boot anchor, ``utils/collector.registry_entry``),
    in process order — the one boot-time round of the fleet plane. A
    process whose live server is off still calls and publishes ``{}``;
    after this round the plane scrapes over HTTP only."""
    return allgather_json(entry if entry is not None else {})


def allgather_sizes(local_vals, shard_ids: Sequence[int],
                    num_shards: int) -> np.ndarray:
    """COLLECTIVE: this process's per-shard values scattered into a
    ``[num_shards]`` row and summed over every process — the full size
    row on every process."""
    row = np.zeros(num_shards, dtype=np.int64)
    row[list(shard_ids)] = np.asarray(local_vals, dtype=np.int64)
    return allgather_blob(row, what="size-row allgather").sum(axis=0)


def local_totals_row(totals_dev: torch.Tensor, shard_ids: Sequence[int],
                     num_shards: int) -> np.ndarray:
    """COLLECTIVE: the ``[P]`` delivered-totals row of a distributed
    device result (``[L]`` on this process), summed in over every process
    so the device merge fold sizes its accumulator alike everywhere."""
    return allgather_sizes(totals_dev.cpu().numpy(), shard_ids, num_shards)


def agree_wave_count(local_waves: int, metrics=None) -> int:
    """COLLECTIVE: the wave count of a waved read, agreed before any
    process enters its wave loop. The proposal derives from the
    allgathered size row, so it is the same everywhere unless a process
    runs another ``a2a.waveRows``; every distributed read calls it (a
    process with waves off proposes 1), and a mismatch raises on every
    process together."""
    from sparkucx_tpu_torch.shuffle.agreement import (
        AgreementDivergenceError, agree)
    try:
        return int(agree("a2a.waveRows",
                         np.array([local_waves], dtype=np.int64),
                         conf_key="spark.shuffle.tpu.a2a.waveRows",
                         metrics=metrics)[0])
    except AgreementDivergenceError as e:
        if e.kind != "value":
            raise
        raise AgreementDivergenceError(
            e.topic, e.kind, e.dissenters, e.proposals,
            conf_key=e.conf_key,
            detail="wave-count mismatch across processes (collective "
                   "reads derive waves from the same global size "
                   "row)") from None


def agree_wave_sizes(wave_sizes, metrics=None) -> np.ndarray:
    """COLLECTIVE: the per-wave real row counts of a waved read, agreed
    (the same everywhere unless a process's staged occupancy differs);
    returns the agreed vector."""
    from sparkucx_tpu_torch.shuffle.agreement import (
        AgreementDivergenceError, agree)
    mine = np.asarray(wave_sizes, dtype=np.int64).reshape(-1)
    try:
        return agree("a2a.waveSizes", mine,
                     conf_key="spark.shuffle.tpu.a2a.waveRows",
                     metrics=metrics)
    except AgreementDivergenceError as e:
        if e.kind != "value":
            raise
        raise AgreementDivergenceError(
            e.topic, e.kind, e.dissenters, e.proposals,
            conf_key=e.conf_key,
            detail="per-wave occupancy mismatch across processes — "
                   "every process must derive the same per-wave real "
                   "row counts from the allgathered size row (stale "
                   "staged outputs or divergent conf)") from None


# -- the partial views -------------------------------------------------------
class DistributedLazyReaderResult(LazyShuffleReaderResult):
    """The partial view of one distributed read over this process's
    device tensors (``[L, cap, W]`` rows for ``shard_ids``): a device-sink
    read hands it to the consumer (zero payload D2H), and it drains on
    first touch as the single-process view does. Only partitions on
    local shards are readable."""


class DistributedReaderResult(DistributedLazyReaderResult):
    """The host sink's partial view: the pending handle drains this
    process's shards to the host as the read settles
    (``_materialize``), so the device buffers are free when ``read``
    returns and the report counts the D2H."""


def _view_class(plan: ShufflePlan):
    return DistributedLazyReaderResult if plan.sink == "device" \
        else DistributedReaderResult


# -- the data plane -----------------------------------------------------------
def _ranges_index(starts, lens, device: torch.device) -> torch.Tensor:
    """The row indices ``starts[i] + k`` for ``k < lens[i]``, every range
    in order, as one int64 tensor on ``device``."""
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    lens = np.asarray(lens, dtype=np.int64).reshape(-1)
    total = int(lens.sum())
    if total == 0:
        return torch.empty(0, dtype=torch.int64, device=device)
    shift = torch.from_numpy(starts - (np.cumsum(lens) - lens)).to(device)
    base = torch.repeat_interleave(shift, torch.from_numpy(lens).to(device),
                                   output_size=total)
    return base + torch.arange(total, dtype=torch.int64, device=device)


class CrossProcessHop:
    """One exchange among the P global shards, of which this process holds
    the contiguous block ``shard_ids`` (module docstring, "The data
    plane"). ``what`` names its collectives for the fence, ``timeout_ms``
    is their deadline (None: the watchdog's), ``pool`` the node's
    staging pool. ``stats`` accumulates over calls: the rows that stayed
    on this process, the bytes staged through the host each way, and the
    wall of the host-staged part (``host_ms``: the device gather, then
    ``d2h_ms`` taking the pool blocks and copying into one,
    ``all_to_all_ms``, and ``h2d_ms`` the copy back)."""

    def __init__(self, shard_ids: Sequence[int], num_shards: int, pool,
                 what: str = "exchange", timeout_ms: Optional[float] = None):
        self.shard_ids = [int(g) for g in shard_ids]
        self.L = len(self.shard_ids)
        self.P = int(num_shards)
        if self.P % self.L or self.shard_ids != list(range(
                self.shard_ids[0], self.shard_ids[0] + self.L)):
            raise ValueError(f"shards {self.shard_ids} are not one "
                             f"contiguous block of {self.P}")
        self.nproc = self.P // self.L
        self.me = self.shard_ids[0] // self.L
        self.pool = pool
        self.what = what
        self.timeout_ms = timeout_ms
        self.stats = {"calls": 0, "local_rows": 0, "host_rows_sent": 0,
                      "host_bytes_sent": 0, "host_bytes_received": 0,
                      "host_ms": 0.0, "d2h_ms": 0.0, "all_to_all_ms": 0.0,
                      "h2d_ms": 0.0}

    def _all_to_all(self, send_rows: torch.Tensor, in_splits,
                    out_splits) -> torch.Tensor:
        """The rows for the other processes (``[n, Wt]`` on the device, in
        process order) through pinned host buffers and one gloo
        all-to-all; the received rows on the device."""
        import torch.distributed as dist
        dev = send_rows.device
        Wt = send_rows.shape[1]
        n_out = int(sum(out_splits))
        t0 = time.perf_counter()
        sbuf = self.pool.get(send_rows.shape[0] * Wt * 4)
        rbuf = self.pool.get(n_out * Wt * 4)
        try:
            host_in = sbuf[:send_rows.shape[0] * Wt * 4].view(torch.int32) \
                .reshape(-1, Wt)
            host_out = rbuf[:n_out * Wt * 4].view(torch.int32) \
                .reshape(-1, Wt)
            host_in.copy_(send_rows)
            t1 = time.perf_counter()
            group, _ = _world()
            _fenced(lambda: dist.all_to_all_single(
                host_out, host_in, [int(x) for x in out_splits],
                [int(x) for x in in_splits], group=group),
                what=f"{self.what} all_to_all", timeout_ms=self.timeout_ms)
            t2 = time.perf_counter()
            out = host_out.to(dev, copy=True)
            self.stats["d2h_ms"] += (t1 - t0) * 1e3
            self.stats["all_to_all_ms"] += (t2 - t1) * 1e3
            self.stats["h2d_ms"] += (time.perf_counter() - t2) * 1e3
            return out
        finally:
            self.pool.put(sbuf)
            self.pool.put(rbuf)

    def __call__(self, send: torch.Tensor, counts: torch.Tensor,
                 extra: Optional[torch.Tensor] = None, *,
                 out_capacity: int, impl: str = "dense"):
        """``send`` ``[L, cap, Wt]``: each local sender's rows grouped by
        destination shard in ascending order; ``counts`` ``[L, P]``: rows
        each sends each global shard; ``extra`` ``[L, X]``: per-shard
        metadata that rides the counts' allgather. Returns (rows ``[L,
        out_capacity, Wt]``, totals ``[L]``, overflow 0-d bool, the
        gathered ``[P, X]`` extra or None)."""
        L, P, me = self.L, self.P, self.me
        dev = send.device
        cap, Wt = send.shape[1], send.shape[2]
        meta = counts.to(torch.int64)
        if extra is not None:
            meta = torch.cat([meta, extra.to(torch.int64)], dim=1)
        got = allgather_blob(meta.cpu().numpy(), what=f"{self.what} counts",
                             timeout_ms=self.timeout_ms).reshape(P, -1)
        M = got[:, :P]
        extra_all = got[:, P:] if extra is not None else None
        off = np.zeros((P, P + 1), dtype=np.int64)
        off[:, 1:] = np.cumsum(M, axis=1)
        blk = off[:, ::L]                        # [P, nproc + 1]
        to_proc = blk[:, 1:] - blk[:, :-1]       # rows sender s -> process q
        lo = me * L
        owner = np.arange(P) // L
        crossing = to_proc[owner[:, None] != np.arange(self.nproc)[None, :]]
        flat = send.reshape(L * cap, Wt)
        recv_dev = None
        remote = owner != me
        if crossing.sum():               # the same verdict on every process
            t0 = time.perf_counter()
            others = [q for q in range(self.nproc) if q != me]
            starts = [j * cap + blk[lo + j, q] for q in others
                      for j in range(L)]
            lens = [to_proc[lo + j, q] for q in others for j in range(L)]
            in_splits = [0 if q == me else int(to_proc[lo:lo + L, q].sum())
                         for q in range(self.nproc)]
            out_splits = [0 if q == me else
                          int(to_proc[q * L:(q + 1) * L, me].sum())
                          for q in range(self.nproc)]
            rows_out = flat.index_select(0, _ranges_index(starts, lens, dev))
            recv_dev = self._all_to_all(rows_out, in_splits, out_splits)
            self.stats["host_rows_sent"] += int(sum(in_splits))
            self.stats["host_bytes_sent"] += int(sum(in_splits)) * Wt * 4
            self.stats["host_bytes_received"] += \
                int(sum(out_splits)) * Wt * 4
            self.stats["host_ms"] += (time.perf_counter() - t0) * 1e3
        # every sender's rows for this process's shards, one block each
        n_me = to_proc[:, me]
        capv = max(1, int(n_me.max(initial=0)))
        V = torch.zeros((P * capv, Wt), dtype=send.dtype, device=dev)
        loc = np.flatnonzero(~remote)
        dst = _ranges_index(loc * capv, n_me[loc], dev)
        V[dst] = flat.index_select(0, _ranges_index(
            (loc - lo) * cap + blk[loc, me], n_me[loc], dev))
        if recv_dev is not None:
            rem = np.flatnonzero(remote)
            r_off = np.cumsum(n_me[rem]) - n_me[rem]
            V[_ranges_index(rem * capv, n_me[rem], dev)] = \
                recv_dev.index_select(0, _ranges_index(r_off, n_me[rem],
                                                       dev))
        sizes = M[:, lo:lo + L]
        self.stats["calls"] += 1
        self.stats["local_rows"] += int(n_me[loc].sum())
        r = ragged_shuffle(V.reshape(P, capv, Wt),
                           torch.from_numpy(sizes.astype(np.int32)).to(dev),
                           out_capacity=out_capacity,
                           peer_capacity=max(1, int(sizes.max(initial=0))),
                           impl=impl)
        return r.data, r.total, r.overflow, extra_all


def distributed_step_body(plan: ShufflePlan, hop: CrossProcessHop):
    """The flat exchange step over this process's L shards:
    ``step(payload [L, cap_in, W], nvalid [L], seeds)`` -> (rows ``[L,
    cap, W]``, seg, total ``[L]``, overflow 0-d bool), ``reader.step_body``
    with the move a :class:`CrossProcessHop`. seg is every sender's
    ``[P, R]`` partition counts on a plain read (gathered with the
    destination counts) and each local shard's ``[L, 1, R]`` on a combine
    or ordered read. ``seeds`` are the int8 seeds of the local shards'
    GLOBAL ids."""
    R = plan.num_partitions
    bounds = _device_bounds(R, plan.num_shards)
    part_fn = _make_part_fn(plan, R)
    plain = not (plan.combine or plan.ordered)

    def step(payload: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        L, width = payload.shape[0], payload.shape[2]
        part = part_fn(payload)
        if plan.combine:
            send, rcounts, _ = _combine(plan, payload, part, nvalid)
        else:
            send, rcounts = destination_sort(payload, part, nvalid, R,
                                             method=plan.sort_impl)
        seeded = plan_takes_seed(plan)
        fused = _fused_wire_reduce(plan, width)
        if seeded:
            send = _wire_pack(plan, send, seeds)
        data, total, ovf, seg = hop(send, _dev_counts(rcounts, bounds),
                                    rcounts if plain else None,
                                    out_capacity=plan.cap_out,
                                    impl=plan.impl)
        if seeded and not fused:
            data = wire_unpack_rows(data, width, plan.wire_words)
        if plain:
            return data, torch.from_numpy(seg.astype(np.int32)), total, ovf
        out_part = part_fn(data)
        if plan.combine:
            rows_out, pcounts = _reduce_side_combine(plan, data, out_part,
                                                     total, width)
            total = pcounts.sum(dim=1, dtype=torch.int32)
        else:
            _, rows_out, pcounts = keysort_rows(data, out_part, total, R)
        return rows_out, pcounts.reshape(L, 1, R), total, ovf

    return step


class PendingDistributedShuffle(PendingShuffle):
    """Handle of a flat distributed read. Collective: every process
    submits (the dispatch runs the hop's allgather and all-to-all) and
    later calls ``result()`` in the same order. ``result()`` fences the
    local completion wait, ORs the overflow verdicts of every process
    (``allgather_blob``) and regrows and retries in lockstep, bounded by
    ``plan.max_retries``. Lifecycle as :class:`reader.PendingShuffle`."""

    def __init__(self, plan: ShufflePlan, local_rows, local_nvalid,
                 shard_ids: Sequence[int], val_shape, val_dtype,
                 device: torch.device, pool, on_done=None, metrics=None,
                 wire_seed: int = 0, admit=None):
        self._shard_ids = [int(g) for g in shard_ids]
        # set before the base constructor: the first dispatch runs in it
        self.hop = CrossProcessHop(self._shard_ids, plan.num_shards, pool)
        super().__init__(plan, local_rows, local_nvalid, val_shape,
                         val_dtype, device, on_done=on_done,
                         metrics=metrics, wire_seed=wire_seed, admit=admit,
                         step_for=lambda p: distributed_step_body(p,
                                                                  self.hop))

    def _dispatch(self) -> None:
        seeds = wire_shard_seeds(self._plan, self._wire_seed + self._attempt,
                                 self._shard_ids)
        self._out = self._step_for(self._plan)(self._rows, self._nvalid,
                                               seeds)
        self._arm_overflow(self._out[3])

    _wait_tier = "dcn"

    def _overflowed(self) -> bool:
        # the hop's collectives returned inside the dispatch: this waits
        # on this process's own device work
        mine = current_watchdog().call(super()._overflowed,
                                       what="exchange completion wait",
                                       local=True)
        return bool(allgather_blob(np.array([1 if mine else 0],
                                            dtype=np.int64),
                                   what="overflow verdict").any())

    def _view(self, rows_out, seg, align_chunk: int):
        R = self._plan.num_partitions
        return _view_class(self._plan)(
            R, blocked_partition_map(R, self._plan.num_shards), rows_out,
            seg, self._val_shape, self._val_dtype, metrics=self._metrics,
            shard_ids=self._shard_ids)

    def _settle(self, res, need_rows: bool):
        # only the flat plain read's [P, R] seg is the same on every
        # process, so only it feeds the capacity hint
        plan = self._plan
        out = super()._settle(res, need_rows and not (plan.combine
                                                      or plan.ordered))
        if isinstance(res, DistributedReaderResult):
            res._materialize()
        return out


def submit_shuffle_distributed(plan: ShufflePlan, local_rows, local_nvalid,
                               shard_ids: Sequence[int], val_shape,
                               val_dtype, device: torch.device, pool,
                               on_done=None, metrics=None,
                               wire_seed: int = 0,
                               admit=None) -> PendingDistributedShuffle:
    """Dispatch the flat distributed exchange (collective).

    local_rows   — [L, cap_in, width] fused rows of this process's shards
    local_nvalid — [L] valid counts
    shard_ids    — the global ids of those shards"""
    return PendingDistributedShuffle(plan, local_rows, local_nvalid,
                                     shard_ids, val_shape, val_dtype,
                                     device, pool, on_done=on_done,
                                     metrics=metrics, wire_seed=wire_seed,
                                     admit=admit)


def read_shuffle_distributed(plan: ShufflePlan, local_rows, local_nvalid,
                             shard_ids: Sequence[int], val_shape, val_dtype,
                             device: torch.device, pool, wire_seed: int = 0):
    """Blocking flat distributed exchange (submit + result)."""
    return submit_shuffle_distributed(plan, local_rows, local_nvalid,
                                      shard_ids, val_shape, val_dtype,
                                      device, pool,
                                      wire_seed=wire_seed).result()


# -- the split-tier distributed exchange ----------------------------------
def distributed_stage2_body(plan: ShufflePlan, topo: TopologyDescriptor,
                            out_cap: int, hop: CrossProcessHop):
    """Stage 2 (DCN) of the tiered read over this process's L relays:
    ``topology._stage2_body`` with the column exchanges one
    :class:`CrossProcessHop` (a relay sends only down its own column, so
    every receiver gets one segment from each relay of its column, in
    slice order, as on one process)."""
    R = plan.num_partitions
    S, D = topo.num_slices, topo.per_slice
    bounds = _device_bounds(R, plan.num_shards)
    part_fn = _make_part_fn(plan, R)
    plain = not (plan.combine or plan.ordered)
    ids = torch.tensor(hop.shard_ids, dtype=torch.int64)

    def step(relay: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        width = relay.shape[2]
        part2 = part_fn(relay)
        if plan.combine:
            send2, rcounts2, _ = _combine(plan, relay, part2, nvalid)
        else:
            send2, rcounts2 = destination_sort(relay, part2, nvalid, R,
                                               method=plan.sort_impl)
        seeded = plan_takes_seed(plan)
        if seeded:
            send2 = _wire_pack(plan, send2, seeds)
        rows, total, ovf, rc_all = hop(send2, _dev_counts(rcounts2, bounds),
                                       rcounts2 if plain else None,
                                       out_capacity=out_cap, impl=plan.impl)
        if seeded:
            rows = wire_unpack_rows(rows, width, plan.wire_words)
        if not plain:
            return stage2_finalize(plan, rows, total) + (ovf,)
        # receiver (s, d): the count rows of relays (s', d), s' = 0..S-1
        src = torch.arange(S)[None, :] * D + (ids % D)[:, None]   # [L, S]
        seg = torch.from_numpy(rc_all.astype(np.int32))[src]
        return rows, seg, total, ovf

    return step


class PendingDistributedTieredShuffle(PendingTieredShuffle):
    """The two-tier exchange over the shards of several processes, each
    holding whole slices: ``topology.PendingTieredShuffle`` with its
    distributed seams. Stage 1 runs inside each process; stage 2's move
    is a :class:`CrossProcessHop` fenced under ``failure.dcn.timeoutMs``.
    The overflow verdicts are ``any``-reduced agreement rounds and a
    regrown capacity a unanimous one, inside the tier's wall and
    deadline, so a dissenting peer raises ``AgreementDivergenceError`` on
    every process and a dead one ``PeerLostError`` naming the tier."""

    def __init__(self, topo: TopologyDescriptor, plan: ShufflePlan,
                 local_rows, local_nvalid, shard_ids: Sequence[int],
                 val_shape, val_dtype, device: torch.device, pool,
                 on_done=None, admit=None, wire_seed: int = 0, metrics=None,
                 timeouts: Optional[Dict[str, float]] = None, **hooks):
        self._shard_ids = [int(g) for g in shard_ids]
        if len(self._shard_ids) % max(topo.per_slice, 1):
            raise ValueError(
                f"a distributed tiered read needs whole slices on every "
                f"process: {len(self._shard_ids)} shards here, "
                f"{topo.per_slice} a slice (set mesh.numSlices to a "
                f"multiple of numProcesses)")
        dcn = float((timeouts or {}).get("dcn", 0.0))
        # set before the base constructor: the first dispatch runs in it
        self.hop = CrossProcessHop(self._shard_ids, plan.num_shards, pool,
                                   what="hierarchical dcn exchange",
                                   timeout_ms=dcn if dcn > 0 else None)
        super().__init__(topo, plan, local_rows, local_nvalid, val_shape,
                         val_dtype, device, on_done=on_done, admit=admit,
                         wire_seed=wire_seed, metrics=metrics,
                         timeouts=timeouts, **hooks)

    def _seed_nvalid(self, values, stream: int):
        return (self._stage_to_device(np.asarray(values, dtype=np.int32)),
                wire_shard_seeds(self._plan,
                                 (self._wire_seed + self._attempt) * 2
                                 + stream, self._shard_ids))

    def _agree_timeout(self, tier: str) -> Optional[float]:
        limit = float(self._timeouts.get(tier, 0.0))
        return limit if limit > 0 else None

    def _agree_overflow(self, tier: str, mine: bool) -> bool:
        from sparkucx_tpu_torch.shuffle.agreement import agree
        return bool(agree(f"hier.{tier}.overflow",
                          np.array([1 if mine else 0], dtype=np.int64),
                          reduce="any",
                          conf_key="spark.shuffle.tpu.a2a.capacityFactor",
                          timeout_ms=self._agree_timeout(tier),
                          metrics=self._metrics)[0])

    def _agree_regrow(self, tier: str, cap: int) -> int:
        from sparkucx_tpu_torch.shuffle.agreement import agree
        return int(agree(f"hier.{tier}.regrow",
                         np.array([int(cap)], dtype=np.int64),
                         conf_key="spark.shuffle.tpu.a2a.capacityFactor",
                         timeout_ms=self._agree_timeout(tier),
                         metrics=self._metrics)[0])

    def _stage2_step(self, plan: ShufflePlan):
        return distributed_stage2_body(plan, self._topo, plan.cap_out,
                                       self.hop)

    def _assemble(self, rows_out, seg, total):
        plan = self._plan
        R = plan.num_partitions
        res = _view_class(plan)(
            R, blocked_partition_map(R, plan.num_shards), rows_out, seg,
            self._val_shape, self._val_dtype, metrics=self._metrics,
            shard_ids=self._shard_ids)
        res.cap_out_used = plan.cap_out
        res._totals_dev = total
        res._ready_event = self._event
        out = self._settle(res, False)
        if isinstance(res, DistributedReaderResult):
            res._materialize()
        return out


def submit_shuffle_tiered_distributed(
        topo: TopologyDescriptor, plan: ShufflePlan, local_rows,
        local_nvalid, shard_ids: Sequence[int], val_shape, val_dtype,
        device: torch.device, pool, on_done=None, admit=None,
        wire_seed: int = 0, metrics=None,
        timeouts: Optional[Dict[str, float]] = None, **hooks
) -> PendingDistributedTieredShuffle:
    """Dispatch the distributed two-tier exchange (collective: every
    process submits and joins in lockstep); ``hooks`` are the
    ``faults`` / ``flight`` of ``topology.submit_shuffle_tiered``."""
    return PendingDistributedTieredShuffle(
        topo, plan, local_rows, local_nvalid, shard_ids, val_shape,
        val_dtype, device, pool, on_done=on_done, admit=admit,
        wire_seed=wire_seed, metrics=metrics, timeouts=timeouts, **hooks)
