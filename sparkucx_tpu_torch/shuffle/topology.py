"""Topology plane — the two-tier (ICI, DCN) exchange as a production path
(the JAX package's ``sparkucx_tpu/shuffle/topology.py``).

A node whose conf sets ``mesh.numSlices`` = S > 1 lays its P logical
shards out as an ``[S, D]`` grid, slice-major (``parallel/mesh``), so
global shard ``g = s * D + d``. The hierarchical read routes a row from
``(s, d)`` to ``(s', d')`` in two stages:

    stage 1 (ici): within each slice, exchange rows grouped by the
                   destination DEVICE INDEX ``d' = g % D``, so the row
                   reaches the relay ``(s, d')``;
    stage 2 (dcn): down each device column, exchange the relay's rows
                   grouped by destination SLICE ``s'`` — each row crosses
                   the slow tier exactly once.

On one card both tiers are emulated: stage 1 is one exchange for each of
the S slices among its D shards, stage 2 one for each of the D columns
among its S shards, both over the plan's dense-contract transport
(dense or gather). The column groups read strided views of the
slice-major send buffer; stacking their outputs along the grid's second
dim lays the received rows back out slice-major, which is the one copy
of each stage's output (as every stack makes). The tier walls are host
clocks around emulated exchanges, so they say nothing about real ICI or
DCN fabrics; the accounting (:func:`tier_layouts`, exact cross rows from
:func:`tier_cross_rows`) is the reference's.

* :func:`resolve_topology` — ``a2a.topology=flat|hier|auto`` against the
  node's grid, validated through the one ``ALLOWED_TOPOLOGIES`` seam.
* :func:`tier_layouts` / :func:`settle_tier_walls` — the
  ``ExchangeReport.tiers`` entries.
* :class:`PendingTieredShuffle` — the two stages as two dispatches
  driven from the host, each staged with ``io/dlpack.stage_to_device``:
  per-tier walls, a per-tier overflow retry (a stage-2 overflow re-runs
  only stage 2, from the relay still on the card) and the int8 wire on
  both hops (each hop quantizes its own rows in one launch for all
  groups; key, partition and size lanes stay exact, so the partition
  recompute between the stages sees full rows).

Each tier runs under its own watchdog deadline (``failure.ici.timeoutMs``
/ ``failure.dcn.timeoutMs``, :func:`tier_timeouts`; ``runtime/watchdog.py``):
its collectives (on a distributed node) raise a ``PeerLostError`` naming
the tier, and its local completion wait a ``DeviceUnhealthy`` naming it.
The
handle's distributed seams (``_stage_to_device``, ``_seed_nvalid``,
``_local_overflow``, ``_agree_overflow``, ``_agree_regrow``,
``_totals_host``, ``_stage2_step``, ``_assemble``) are identities here;
``shuffle/distributed.PendingDistributedTieredShuffle`` overrides them to
run the same two stages over the shards of several processes.

Each tier's join checks its fault site (``tier.ici`` / ``tier.dcn``,
:data:`TIER_FAULT_SITES`, the node's ``FaultInjector``) and records a
``tier_fault`` event naming the tier in the node's flight recorder when
the join fails; the manager replays the whole exchange under
``failure.policy=replay``. Not ported: the JAX package's compiled-step
cache key (eager PyTorch compiles nothing per shape) and its span
tracer's tier spans.

One deliberate difference from the JAX package: :func:`tier_layouts`
sizes stage 1's dense wire by the relay capacity stage 1 really pads to,
so a relay regrow shows in the ICI wire bytes (the reference keeps
``cap_out`` there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.io.dlpack import stage_to_device
from sparkucx_tpu_torch.ops.aggregate import keysort_rows
from sparkucx_tpu_torch.ops.partition import (blocked_partition_map,
                                              destination_sort, to_device)
from sparkucx_tpu_torch.parallel.mesh import DCN_AXIS, ICI_AXIS, SliceGrid
from sparkucx_tpu_torch.runtime.failures import NULL_FLIGHT_RECORDER
from sparkucx_tpu_torch.runtime.watchdog import current_watchdog
from sparkucx_tpu_torch.shuffle.alltoall import (ragged_shuffle,
                                                 resolved_wire_impl,
                                                 validate_topology,
                                                 wire_pack_rows,
                                                 wire_uniforms,
                                                 wire_unpack_rows)
from sparkucx_tpu_torch.shuffle.plan import (ShufflePlan, plan_takes_seed,
                                             wire_row_words)
from sparkucx_tpu_torch.shuffle.reader import (LazyShuffleReaderResult,
                                               PendingExchangeBase,
                                               _combine, _device_bounds,
                                               _make_part_fn,
                                               wire_shard_seeds)
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

log = get_logger("shuffle.topology")


@dataclass(frozen=True)
class TopologyDescriptor:
    """The resolved exchange topology of one manager binding.

    ``kind``       — "flat" | "hier" (never "auto").
    ``ici_axis``   — the intra-slice axis (every topology has one).
    ``dcn_axis``   — the cross-slice axis ("" on flat).
    ``num_slices`` — S (1 on flat).
    ``per_slice``  — D, shards per slice (the flat axis size on flat).
    """

    kind: str
    ici_axis: str
    dcn_axis: str = ""
    num_slices: int = 1
    per_slice: int = 0

    @property
    def hierarchical(self) -> bool:
        return self.kind == "hier"

    @property
    def tiers(self) -> tuple:
        """The tiers an exchange of this topology rides, in dispatch
        order."""
        return ("ici", "dcn") if self.kind == "hier" else ("ici",)

    def tier_axis(self, tier: str) -> str:
        return self.ici_axis if tier == "ici" else self.dcn_axis

    def describe(self) -> Dict:
        return {"kind": self.kind, "ici_axis": self.ici_axis,
                "dcn_axis": self.dcn_axis,
                "num_slices": self.num_slices,
                "per_slice": self.per_slice}


def resolve_topology(grid: SliceGrid, conf) -> TopologyDescriptor:
    """Resolve ``a2a.topology`` against the node's shard grid.

    ``auto`` (default): hier exactly when the grid is 2-D ``(dcn, ici)``
    with more than one slice. An explicit ``hier`` on a grid that cannot
    run two tiers is a conf error naming the key."""
    want = validate_topology(conf.a2a_topology)
    names = tuple(grid.axis_names)
    S = int(grid.shape[0]) if len(names) == 2 else 1
    D = int(grid.shape[-1])
    if want == "hier" and S < 2:
        raise ValueError(
            f"spark.shuffle.tpu.a2a.topology=hier needs a 2-D "
            f"({DCN_AXIS!r}, {ICI_AXIS!r}) mesh with >1 slice; this mesh is "
            f"{dict(zip(names, grid.shape))} — use mesh.numSlices "
            f"(connect / Node) to shape it, or a2a.topology=auto to "
            f"fall back to flat")
    if want != "flat" and S > 1:
        return TopologyDescriptor("hier", ici_axis=ICI_AXIS,
                                  dcn_axis=DCN_AXIS, num_slices=S,
                                  per_slice=D)
    return TopologyDescriptor("flat", ici_axis=ICI_AXIS, per_slice=D)


# the fault-injection site each tier's join checks
TIER_FAULT_SITES = {"ici": "tier.ici", "dcn": "tier.dcn"}


def tier_timeouts(conf) -> Dict[str, float]:
    """Per-tier watchdog deadlines of one read: ``failure.ici.timeoutMs``
    and ``failure.dcn.timeoutMs``, each defaulting to
    ``failure.collectiveTimeoutMs`` (0 = off)."""
    return {"ici": conf.ici_timeout_ms, "dcn": conf.dcn_timeout_ms}


# -- per-tier accounting ---------------------------------------------------
def tier_cross_rows(dev_matrix, topo: TopologyDescriptor) -> Dict[str, int]:
    """Rows that cross each tier, exact, from the ``[P, P]`` source-shard
    x destination-shard row matrix (the metadata table's
    ``device_matrix``). Stage 1 moves a row from (s, d) to (s, d') — an
    ICI move iff the column changes; stage 2 from (s, d') to (s', d') — a
    DCN move iff the slice changes, so a row counts at most once on
    DCN."""
    m = np.asarray(dev_matrix, dtype=np.int64)
    D = max(1, topo.per_slice)
    src = np.arange(m.shape[0])
    dst = np.arange(m.shape[1])
    ici = int(m[(src[:, None] % D) != (dst[None, :] % D)].sum())
    dcn = int(m[(src[:, None] // D) != (dst[None, :] // D)].sum())
    return {"ici": ici, "dcn": dcn}


def tier_layouts(plan: ShufflePlan, topo: TopologyDescriptor,
                 shard_rows, width: int, dev_matrix=None,
                 relay_cap: Optional[int] = None) -> List[Dict]:
    """The per-tier entries of one hierarchical exchange:

    * ``payload_rows/bytes`` — the rows that cross this tier: exact with
      the ``[P, P]`` device matrix (``cross_exact: true``), else every
      row entering the stage;
    * ``wire_rows/bytes`` — what the transport moves for them, padded as
      the flat accounting pads: dense pays ``S x D² x relay_cap`` segments
      in stage 1 and ``D x S² x cap_out`` in stage 2, gather replicates
      the ``cap_in`` send buffers (stage 1) and the ``relay_cap`` relays
      (stage 2), each row at its wire-tier cost;
    * ``pad_ratio`` — wire over payload.

    ``relay_cap`` is stage 1's output capacity, which is stage 2's input
    capacity (default ``plan.cap_out``; it doubles on each stage-1
    retry)."""
    # hier needs S > 1 and D >= 1: a group of at least 2 shards, so
    # 'auto' can never resolve to the one-shard local move here
    impl = resolved_wire_impl(plan.impl, max(2, topo.per_slice))
    total = int(np.sum(np.asarray(shard_rows, dtype=np.int64)))
    S, D = topo.num_slices, topo.per_slice
    row_w = wire_row_words(plan, width)
    relay_cap = int(plan.cap_out if relay_cap is None else relay_cap)
    cross = tier_cross_rows(dev_matrix, topo) \
        if dev_matrix is not None else None
    out: List[Dict] = []
    for tier in topo.tiers:
        xrows = None if cross is None else cross[tier]
        if tier == "ici":
            groups, gshards = S, D
            dense_rows = S * D * D * relay_cap
            gather_rows = S * D * D * plan.cap_in
        else:
            groups, gshards = D, S
            dense_rows = D * S * S * plan.cap_out
            gather_rows = D * S * S * relay_cap
        payload_rows = total if xrows is None else xrows
        wire_rows = gather_rows if impl == "gather" else dense_rows
        payload_bytes = payload_rows * width * 4
        wire_bytes = wire_rows * row_w * 4
        out.append({
            "tier": tier,
            "axis": topo.tier_axis(tier),
            "impl": impl,
            "groups": groups,
            "group_shards": gshards,
            "rows_in": total,
            "payload_rows": int(payload_rows),
            "payload_bytes": int(payload_bytes),
            "cross_exact": xrows is not None,
            "wire_rows": int(wire_rows),
            "wire_bytes": int(wire_bytes),
            "pad_ratio": round(wire_bytes / payload_bytes, 6)
            if payload_bytes else 0.0,
            "wire": plan.wire,
            # walls and rates land when the read settles
            "ms": 0.0,
            "bw_gbps": 0.0,
            "effective_bw_gbps": 0.0,
        })
    return out


def settle_tier_walls(tiers: List[Dict],
                      tier_walls: Dict[str, float]) -> None:
    """Stamp measured per-tier walls onto the entries, in place:
    ``bw_gbps`` = the tier's payload bytes over its wall,
    ``effective_bw_gbps`` the rate a raw wire would have needed (equal to
    ``bw_gbps`` off the int8 tier)."""
    for t in tiers:
        ms = float(tier_walls.get(t.get("tier", ""), 0.0))
        t["ms"] = round(ms, 3)
        if ms > 0 and t.get("payload_bytes"):
            gbps = t["payload_bytes"] / (ms * 1e6)
            t["bw_gbps"] = round(gbps, 6)
            raw_row = t["payload_bytes"] / max(t["payload_rows"], 1)
            wire_row = t["wire_bytes"] / max(t["wire_rows"], 1)
            gain = raw_row / wire_row if wire_row else 1.0
            t["effective_bw_gbps"] = round(gbps * max(gain, 1.0), 6)


# -- the stage bodies ------------------------------------------------------
def _tier_wire_shuffle(plan: ShufflePlan, send: torch.Tensor,
                       sizes: torch.Tensor, seeds, out_capacity: int,
                       tier: str):
    """One tier's exchanges on the plan's wire tier. ``send`` is the
    ``[S, D, cap, W]`` slice-major send buffer, ``sizes`` ``[S, D, n]``
    rows each shard sends each member of its group: on 'ici' the groups
    are the S slices (n = D), on 'dcn' the D columns (n = S). On int8 the
    value lanes of every shard are quantized in one launch before the
    exchanges (``seeds`` per global shard) and dequantized after.
    Returns (rows ``[S, D, out_capacity, W]``, totals ``[S, D]``,
    overflow 0-d bool)."""
    S, D, cap, width = send.shape
    seeded = plan_takes_seed(plan)
    if seeded:
        u = wire_uniforms((S * D, cap, plan.wire_words), seeds, send.device)
        send = wire_pack_rows(send, plan.wire_words,
                              u.reshape(S, D, cap, plan.wire_words))
    by_slice = tier == "ici"
    groups = [(g, slice(None)) if by_slice else (slice(None), g)
              for g in range(S if by_slice else D)]
    rs = [ragged_shuffle(send[sel], sizes[sel], out_capacity=out_capacity,
                         impl=plan.impl) for sel in groups]
    dim = 0 if by_slice else 1
    data = torch.stack([r.data for r in rs], dim=dim)
    if seeded:
        data = wire_unpack_rows(data, width, plan.wire_words)
    return (data, torch.stack([r.total for r in rs], dim=dim),
            torch.stack([r.overflow for r in rs]).any())


def _stage1_body(plan: ShufflePlan, topo: TopologyDescriptor,
                 relay_cap: int):
    """Stage 1 — ICI: the map-side combine when the read combines
    (shrinking both hops), then within each slice the rows grouped by
    destination device index ``g % D``. ``step(payload [L, cap, W],
    nvalid [L], seeds)`` -> (relay ``[L, relay_cap, W]``, totals ``[L]``,
    overflow 0-d bool), over the L shards of whole slices the caller holds
    (all P on one process; a distributed process's own slices)."""
    R = plan.num_partitions
    Pn = plan.num_shards
    D = topo.per_slice
    part_to_dest = blocked_partition_map(R, Pn)
    part_fn = _make_part_fn(plan, R)

    def step(payload: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        L = payload.shape[0]
        S = L // D
        n0 = nvalid
        if plan.combine:
            payload, _, n0 = _combine(plan, payload, part_fn(payload),
                                      nvalid)
        g = to_device(part_to_dest, payload.device)[part_fn(payload)]
        send1, counts1 = destination_sort(payload, g % D, n0, D,
                                          method=plan.sort_impl)
        cap, width = send1.shape[1], send1.shape[2]
        relay, tot, ovf = _tier_wire_shuffle(
            plan, send1.reshape(S, D, cap, width), counts1.reshape(S, D, D),
            seeds, relay_cap, "ici")
        return relay.reshape(L, relay_cap, width), tot.reshape(L), ovf

    return step


def _stage2_body(plan: ShufflePlan, topo: TopologyDescriptor, out_cap: int):
    """Stage 2 — DCN: the relay's rows grouped by global partition id
    (monotone in the destination slice at a fixed device index, so the
    sort groups by destination slice AND leaves each delivered segment
    partition-sorted), after the relay combine when the read combines;
    then down each column the exchange, and the finalize: combine ->
    ``combine_rows``, ordered -> ``keysort_rows``, plain -> the relays'
    per-partition counts as each receiver's ``[S, R]`` seg matrix.
    ``step(relay, nvalid, seeds)`` -> (rows ``[P, out_cap, W]``, seg,
    totals ``[P]``, overflow 0-d bool)."""
    R = plan.num_partitions
    Pn = plan.num_shards
    S, D = topo.num_slices, topo.per_slice
    bounds = _device_bounds(R, Pn)
    part_fn = _make_part_fn(plan, R)

    def step(relay: torch.Tensor, nvalid: torch.Tensor, seeds=None):
        dev = relay.device
        part2 = part_fn(relay)
        if plan.combine:
            send2, rcounts2, _ = _combine(plan, relay, part2, nvalid)
        else:
            # ordered needs no key order at the relay: the finalize fully
            # re-sorts, so the plain partition sort does
            send2, rcounts2 = destination_sort(relay, part2, nvalid, R,
                                               method=plan.sort_impl)
        # rows relay (s, d) sends slice s': its counts over the partition
        # range of global shard s' * D + d
        cum2 = torch.zeros((Pn, R + 1), dtype=torch.int32, device=dev)
        cum2[:, 1:] = torch.cumsum(rcounts2, dim=1, dtype=torch.int32)
        gs = torch.arange(S, device=dev)[None, :] * D \
            + (torch.arange(Pn, device=dev) % D)[:, None]         # [P, S]
        b = to_device(bounds, dev)
        counts2 = torch.gather(cum2, 1, b[gs + 1]) \
            - torch.gather(cum2, 1, b[gs])
        cap, width = send2.shape[1], send2.shape[2]
        got, tot, ovf = _tier_wire_shuffle(
            plan, send2.reshape(S, D, cap, width), counts2.reshape(S, D, S),
            seeds, out_cap, "dcn")
        rows = got.reshape(Pn, out_cap, width)
        total = tot.reshape(Pn)
        if plan.combine or plan.ordered:
            return stage2_finalize(plan, rows, total) + (ovf,)
        # receiver (s, d) got one segment from each relay (s', d) of its
        # column, in slice order: its seg matrix is their count rows
        rc = rcounts2.reshape(S, D, R).transpose(0, 1)           # [D, S, R]
        seg = rc.unsqueeze(0).expand(S, D, S, R).reshape(Pn, S, R)
        return rows, seg, total, ovf

    return step


def stage2_finalize(plan: ShufflePlan, rows: torch.Tensor,
                    total: torch.Tensor):
    """A combine or ordered read's receive side after stage 2: combine ->
    ``combine_rows``, ordered -> ``keysort_rows``; (rows, seg ``[L, 1,
    R]``, totals ``[L]``) over the L receivers ``rows`` holds."""
    R = plan.num_partitions
    L = rows.shape[0]
    part_fn = _make_part_fn(plan, R)
    if plan.combine:
        rows_out, pcounts, n_out = _combine(plan, rows, part_fn(rows), total)
        return rows_out, pcounts.reshape(L, 1, R), n_out
    _, rows_out, pcounts = keysort_rows(rows, part_fn(rows), total, R)
    return rows_out, pcounts.reshape(L, 1, R), total


def check_hier_grid(grid: SliceGrid, topo: TopologyDescriptor) -> None:
    if tuple(grid.axis_names) != (topo.dcn_axis, topo.ici_axis) \
            or tuple(grid.shape) != (topo.num_slices, topo.per_slice):
        raise ValueError(
            f"tiered shuffle needs a {topo.num_slices} x {topo.per_slice} "
            f"grid with axes ({topo.dcn_axis!r}, {topo.ici_axis!r}) in "
            f"that order, got {tuple(grid.shape)} {tuple(grid.axis_names)}")


# -- the tiered pending handle ---------------------------------------------
class PendingTieredShuffle(PendingExchangeBase):
    """Handle of a two-tier exchange driven as two dispatches with a host
    join between them:

    * stage 1 dispatches at submit (or, deferred by admission, in
      ``result()``); ``result()`` joins it, regrows ONLY the relay
      capacity on a relay overflow, then dispatches stage 2 over the
      relay still on the card (only the ``[P]`` totals cross to the host)
      and joins it; a stage-2 overflow regrows ``cap_out`` and re-runs
      only stage 2. Each stage's loop is bounded by ``plan.max_retries``
      on its own; ``_attempt`` counts both.
    * ``tier_walls`` — a host clock per tier, from dispatch to the join
      of its overflow flag, summed over retries.
    * the int8 noise of stage ``1 + stream`` is seeded from
      ``(wire_seed + attempt) * 2 + stream``, so the two hops never share
      a realization and every retry draws fresh noise.
    * ``done()`` stays False until stage 2 has dispatched.
    * each tier's join runs under its deadline (``timeouts``, from
      :func:`tier_timeouts`) through the process watchdog: its local
      completion wait raises ``DeviceUnhealthy`` naming the tier, and
      its collectives (the distributed seams) ``PeerLostError``.

    Admission and ``on_done`` follow :class:`reader.PendingExchangeBase`."""

    def __init__(self, topo: TopologyDescriptor, plan: ShufflePlan,
                 shard_rows, shard_nvalid: np.ndarray, val_shape, val_dtype,
                 device: torch.device, on_done=None, admit=None,
                 wire_seed: int = 0, metrics=None,
                 timeouts: Optional[Dict[str, float]] = None,
                 faults=None, flight=NULL_FLIGHT_RECORDER,
                 trace_id: str = ""):
        if not topo.hierarchical:
            raise ValueError(f"a tiered shuffle needs a hier topology, got "
                             f"{topo.kind!r}")
        if plan.num_shards != topo.num_slices * topo.per_slice:
            raise ValueError(
                f"plan has {plan.num_shards} shards for a "
                f"{topo.num_slices} x {topo.per_slice} grid")
        if plan.impl == "pallas":
            raise ValueError("the tiered exchange runs the dense-contract "
                             "transports (dense, gather), not 'pallas'")
        self._topo = topo
        self._plan = plan
        self._relay_cap = int(plan.cap_out)
        self._host = (shard_rows, shard_nvalid)
        self._val_shape = val_shape
        self._val_dtype = val_dtype
        self._device = device
        self._metrics = metrics
        self._wire_seed = int(wire_seed)
        self._timeouts = dict(timeouts or {})
        self._faults = faults
        self._flight = flight
        self._trace_id = trace_id
        self.tier_walls: Dict[str, float] = {"ici": 0.0, "dcn": 0.0}
        self._t_stage = 0.0
        self._attempt = 0
        self._retries1 = 0
        self._retries2 = 0
        # which stage the current outputs belong to (done() is False
        # until stage 2 has dispatched)
        self._stage = 1
        self._rows = self._nvalid = self._out = None
        self._admit_or_defer(admit, on_done)

    # -- the distributed seams (identities on one process) -----------------
    def _stage_to_device(self, arr):
        return stage_to_device(arr, self._device)

    def _seed_nvalid(self, values, stream: int):
        """Stage ``1 + stream``'s valid counts on the device and its int8
        noise seeds (None off int8), from ``(wire_seed + attempt) * 2 +
        stream``, so the hops never share a realization."""
        return (self._stage_to_device(np.asarray(values, dtype=np.int32)),
                wire_shard_seeds(self._plan,
                                 (self._wire_seed + self._attempt) * 2
                                 + stream))

    def _local_overflow(self) -> bool:
        return self._overflowed()

    def _agree_overflow(self, tier: str, mine: bool) -> bool:
        """The overflow verdict every process acts on."""
        return mine

    def _agree_regrow(self, tier: str, cap: int) -> int:
        """The regrown capacity every process dispatches."""
        return int(cap)

    def _totals_host(self, tot1) -> np.ndarray:
        """Stage 1's per-shard totals as the host row stage 2 seeds
        from."""
        return tot1.cpu().numpy().astype(np.int32)

    def _stage2_step(self, plan: ShufflePlan):
        return _stage2_body(plan, self._topo, plan.cap_out)

    def _start(self) -> None:
        rows, nvalid = self._host
        self._host = None
        self._rows = self._stage_to_device(rows)
        self._nvalid_host = nvalid
        self._dispatch()

    def _dispatch(self) -> None:
        """(Re)dispatch stage 1 over the staged rows."""
        step = _stage1_body(self._plan, self._topo, self._relay_cap)
        nvalid, seeds = self._seed_nvalid(self._nvalid_host, 0)
        self._t_stage = time.perf_counter()
        self._stage = 1
        self._out = step(self._rows, nvalid, seeds)
        self._arm_overflow(self._out[2])

    def done(self) -> bool:
        if self._result is not None:
            return True
        if self._stage < 2:
            return False
        return self._outputs_ready()

    def _drop_buffers(self) -> None:
        self._rows = self._nvalid = self._out = None

    def _join(self, tier: str) -> bool:
        """Join the tier in flight under its deadline: the overflow
        verdict every process acts on. The tier's fault site
        (``tier.ici`` / ``tier.dcn``) is checked inside the watched wait,
        so an armed delay counts against this tier's wall and deadline;
        any failure of the join records a ``tier_fault`` event naming the
        tier. The wall from its dispatch accumulates across retries,
        failures included."""
        faults = self._faults

        def join():
            if faults is not None:
                faults.check(TIER_FAULT_SITES[tier])
            return self._local_overflow()

        try:
            # the tier's collectives (stage 2's hop on a distributed
            # node) returned inside its dispatch: this waits on this
            # process's own device work; the agreement round rides
            # inside the tier's span and wall
            with self._span("shuffle.tier", tier=tier):
                mine = current_watchdog().call(
                    join, what=f"hierarchical {tier} exchange",
                    timeout_ms=float(self._timeouts.get(tier, 0.0)),
                    local=True)
                return self._agree_overflow(tier, mine)
        except BaseException as e:
            self._flight.record("tier_fault", tier=tier,
                                error=repr(e)[:200])
            raise
        finally:
            self.tier_walls[tier] += (time.perf_counter()
                                      - self._t_stage) * 1e3

    def _span(self, name: str, **attrs):
        """A span tagged with the read's trace id."""
        return GLOBAL_TRACER.span(name, trace=self._trace_id, **attrs)

    def _result_inner(self):
        plan = self._plan
        # -- stage 1: ICI, relay-capacity retry loop ----------------------
        while True:
            relay, tot1, _ = self._out
            if not self._join("ici"):
                break
            if self._retries1 >= plan.max_retries:
                raise RuntimeError(
                    f"hierarchical stage-1 (ICI) still overflowing after "
                    f"{plan.max_retries} retries (relay capacity "
                    f"{self._relay_cap}); extreme skew — repartition")
            log.info("hier ICI overflow at relay_cap=%d (attempt %d); "
                     "growing", self._relay_cap, self._attempt)
            self._relay_cap = self._agree_regrow("ici", self._relay_cap * 2)
            self._retries1 += 1
            self._attempt += 1
            with self._span("shuffle.dispatch", stage=1,
                            retry=self._retries1):
                self._dispatch()
        # only the [P] totals cross to the host (a wait on stage 1)
        with self._span("shuffle.tier", tier="ici"):
            totals1 = self._totals_host(tot1)
        # -- stage 2: DCN, output-capacity retry loop ---------------------
        while True:
            with self._span("shuffle.dispatch", stage=2):
                step2 = self._stage2_step(plan)
                self._t_stage = time.perf_counter()
                nv2, seeds2 = self._seed_nvalid(totals1, 1)
                self._stage = 2
                self._out = step2(relay, nv2, seeds2)
                self._arm_overflow(self._out[3])
            rows_out, seg, total, _ = self._out
            if not self._join("dcn"):
                break
            if self._retries2 >= plan.max_retries:
                raise RuntimeError(
                    f"hierarchical stage-2 (DCN) still overflowing after "
                    f"{plan.max_retries} retries "
                    f"(cap_out={plan.cap_out}); extreme skew — "
                    f"repartition the data")
            log.info("hier DCN overflow at cap_out=%d (attempt %d); "
                     "growing", plan.cap_out, self._attempt)
            plan = plan.grown()
            self._agree_regrow("dcn", plan.cap_out)
            self._plan = plan
            self._retries2 += 1
            self._attempt += 1
        with self._span("shuffle.result", sink=plan.sink):
            return self._assemble(rows_out, seg, total)

    def _assemble(self, rows_out, seg, total):
        plan = self._plan
        R = plan.num_partitions
        res = LazyShuffleReaderResult(
            R, blocked_partition_map(R, plan.num_shards), rows_out, seg,
            self._val_shape, self._val_dtype, metrics=self._metrics)
        res.cap_out_used = plan.cap_out
        res._totals_dev = total
        res._ready_event = self._event
        # plain/ordered: the delivered rows the manager's capacity hint
        # learns from (a combine's counts are post-merge); the stage-2
        # output is partition-sorted on the card, so the device sink holds
        # it as the flat single-shot read does
        return self._settle(res, not plan.combine)


def submit_shuffle_tiered(topo: TopologyDescriptor, plan: ShufflePlan,
                          shard_rows, shard_nvalid: np.ndarray, val_shape,
                          val_dtype, device: torch.device, on_done=None,
                          admit=None, wire_seed: int = 0, metrics=None,
                          timeouts: Optional[Dict[str, float]] = None,
                          faults=None, flight=NULL_FLIGHT_RECORDER,
                          trace_id: str = "") -> PendingTieredShuffle:
    """Dispatch the two-tier exchange without blocking (the submit/poll
    contract of ``reader.submit_shuffle``).

    shard_rows   — [P, cap_in, width] fused int32 rows per shard
    shard_nvalid — [P] valid row counts
    wire_seed    — int8 noise base (the manager's exchange sequence
                   number)
    faults       — the node's FaultInjector (the tier sites), or None
    flight       — the node's flight recorder (``tier_fault`` events)
    trace_id     — the read's trace id, on its tier spans"""
    return PendingTieredShuffle(topo, plan, shard_rows, shard_nvalid,
                                val_shape, val_dtype, device,
                                on_done=on_done, admit=admit,
                                wire_seed=wire_seed, metrics=metrics,
                                timeouts=timeouts, faults=faults,
                                flight=flight, trace_id=trace_id)


def read_shuffle_tiered(topo: TopologyDescriptor, plan: ShufflePlan,
                        shard_rows, shard_nvalid: np.ndarray, val_shape,
                        val_dtype, device: torch.device):
    """Blocking two-tier exchange (submit + immediate result)."""
    return submit_shuffle_tiered(topo, plan, shard_rows, shard_nvalid,
                                 val_shape, val_dtype, device).result()
