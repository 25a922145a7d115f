"""The multi-tenant service plane: per-tenant policy, fair-share admission
and the async read plane (the JAX package's ``shuffle/tenancy.py``).

One node serves many concurrent shuffles of very different sizes; this
module gives each tenant its own policy over the shared card:

* :class:`TenantSpec` / :class:`TenantRegistry` — per-tenant policy
  resolved from conf (``spark.shuffle.tpu.tenant.*``,
  :meth:`~sparkucx_tpu_torch.config.ShuffleConf.tenant_policy`): a
  priority class (a weight in fair-share scheduling), an admission quota
  under the global ``a2a.maxBytesInFlight``, an async in-flight cap, and
  replay-budget, integrity-level and wave-depth overrides.
* :class:`FairShareQueue` — the deficit-round-robin admission queue the
  manager defers exchanges into past the in-flight cap: grants interleave
  across tenants by priority weight instead of by arrival, so a whale's
  queued reads do not park every minnow behind them. FIFO within a
  tenant. :class:`FifoAdmitQueue` is the strictly FIFO queue
  (``tenant.fairShare=false``).
* :class:`AsyncShuffleExecutor` / :class:`ShuffleFuture` — the async
  plane behind ``read_async`` / ``submit_async``: ``tenant.asyncWorkers``
  threads run facade reads concurrently, a tenant's
  ``maxInflightReads`` is enforced at submit, and on a distributed node
  each batch's order is agreed collectively and enforced by a
  :class:`~sparkucx_tpu_torch.shuffle.agreement.CollectiveTurnstile`.

Conf keys (under ``spark.shuffle.tpu.``)::

    tenant.id                      this process's default tenant ("default")
    tenant.priority                default priority class (high|normal|batch)
    tenant.fairShare               DRR admission (default on; off = FIFO)
    tenant.asyncWorkers            async read workers (default 4)
    tenant.asyncAgreedOrder        distributed K-worker async agrees each
                                   batch's order (default on; off clamps
                                   the pool to 1 worker, warned once)
    tenant.<id>.priority           per-tenant priority class
    tenant.<id>.maxBytesInFlight   per-tenant admission quota (0 = none)
    tenant.<id>.maxInflightReads   async reads in flight (0 = unlimited)
    tenant.<id>.replayBudget       failure.replayBudget override
    tenant.<id>.integrity.verify   integrity.verify override
    tenant.<id>.waveDepth          a2a.waveDepth override

Everything here is host-side Python: the reads it schedules run the
kernels the read paths already launch."""

from __future__ import annotations

import math
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import C_SUBMIT_THROTTLED, labeled

log = get_logger("shuffle.tenancy")

# Priority classes and their fair-share weights: a high tenant accrues
# deficit 4x as fast as a batch tenant. A closed set: a typo fails at
# registration, never schedules as an unknown zero-weight class.
PRIORITY_WEIGHTS: Dict[str, int] = {"high": 4, "normal": 2, "batch": 1}
PRIORITIES = tuple(PRIORITY_WEIGHTS)

DEFAULT_TENANT = "default"

# One DRR quantum: the deficit a tenant accrues (times its weight) per
# scheduling round, in bytes like the grants. 1 MiB grants a small
# exchange within a round or two while a whale accrues across rounds.
DRR_QUANTUM = 1 << 20


def validate_priority(value: str, conf_key: str = "tenant.priority") -> str:
    v = str(value).strip().lower()
    if v not in PRIORITY_WEIGHTS:
        raise ValueError(f"{conf_key}={value!r}: want one of {PRIORITIES}")
    return v


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's resolved policy. ``None`` overrides inherit the
    global key, resolved where it is used."""

    tenant_id: str
    priority: str = "normal"
    # admission quota under a2a.maxBytesInFlight (0 = only the global
    # cap); an exchange bigger than it is admitted when the tenant holds
    # nothing else, like the global cap's rule
    max_bytes_in_flight: int = 0
    # async submissions in flight at once (0 = unlimited), enforced at
    # submit by AsyncShuffleExecutor
    max_inflight_reads: int = 0
    replay_budget: Optional[int] = None        # None = failure.replayBudget
    integrity_verify: Optional[str] = None     # None = integrity.verify
    wave_depth: Optional[int] = None           # None = a2a.waveDepth

    @property
    def weight(self) -> int:
        return PRIORITY_WEIGHTS[self.priority]


class TenantRegistry:
    """Per-tenant policy from conf, cached per tenant id. A tenant exists
    once a shuffle is registered under its id; an id with no keys gets
    the default priority and no overrides."""

    def __init__(self, conf):
        self._conf = conf
        self._lock = threading.Lock()
        self._specs: Dict[str, TenantSpec] = {}
        self.default_id = conf.tenant_id
        self.default_priority = conf.tenant_priority
        self.fair_share = conf.tenant_fair_share

    def resolve(self, tenant: Optional[str]) -> str:
        """The caller's tenant id, or the conf default."""
        t = (tenant or "").strip()
        return t or self.default_id

    def spec(self, tenant: Optional[str]) -> TenantSpec:
        tid = self.resolve(tenant)
        with self._lock:
            spec = self._specs.get(tid)
        if spec is not None:
            return spec
        spec = TenantSpec(tid, **self._conf.tenant_policy(
            tid, self.default_priority))
        with self._lock:
            return self._specs.setdefault(tid, spec)


class FairShareQueue:
    """Deficit-round-robin admission queue across tenants.

    Tickets queue per tenant (FIFO within a tenant: submit order is the
    collective order). :meth:`grantable` names the next ticket: each
    tenant with queued work accrues ``DRR_QUANTUM x weight`` of deficit
    when the round-robin pointer arrives at it, and its head ticket is
    served once the deficit covers the ticket's bytes; the pointer stays
    on a tenant while its credit covers its next head. A whale ticket
    waits out the rounds its size needs while minnow tickets are granted
    past it. A tenant whose queue empties forfeits its deficit.

    Every method runs under the manager's admission lock."""

    def __init__(self, registry: TenantRegistry,
                 quantum: int = DRR_QUANTUM):
        self._registry = registry
        self._quantum = int(quantum)
        self._queues: Dict[str, deque] = {}     # tid -> deque[(ticket, nb)]
        self._order: list = []                  # round-robin tenant order
        self._deficit: Dict[str, float] = {}
        self._where: Dict[int, str] = {}        # ticket -> tid
        self._rr = 0                            # round-robin pointer
        # whether the tenant under the pointer got its quantum for this
        # visit: serving while covered and re-polls by waiters accrue
        # nothing (poll frequency must not set the shares)
        self._charged = False
        # the cached head: computed once per grant, dropped by pop or
        # discard of the head ticket, not by capacity checks
        self._head = None                       # (ticket, tid, nb)

    def __len__(self) -> int:
        return len(self._where)

    def __bool__(self) -> bool:
        return bool(self._where)

    def __contains__(self, ticket: int) -> bool:
        return ticket in self._where

    def enqueue(self, ticket: int, tenant: str, nbytes: int) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._order.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
        q.append((ticket, int(nbytes)))
        self._where[ticket] = tenant

    def discard(self, ticket: int) -> None:
        """Remove an abandoned ticket wherever it sits (a no-op for an
        unknown ticket)."""
        tid = self._where.pop(ticket, None)
        if tid is None:
            return
        if self._head is not None and self._head[0] == ticket:
            self._head = None
        q = self._queues[tid]
        for item in q:
            if item[0] == ticket:
                q.remove(item)
                break
        if not q:
            self._drop_tenant(tid)

    def _drop_tenant(self, tid: str) -> None:
        # an emptied tenant forfeits its deficit
        self._queues.pop(tid, None)
        self._deficit.pop(tid, None)
        i = self._order.index(tid)
        self._order.remove(tid)
        if i < self._rr:
            self._rr -= 1
        elif i == self._rr:
            self._charged = False
        if self._order:
            self._rr %= len(self._order)
        else:
            self._rr = 0
        if self._head is not None and self._head[1] == tid:
            self._head = None

    def _weight(self, tid: str) -> int:
        return self._registry.spec(tid).weight

    def _ensure_head(self):
        """Compute (and cache) the ticket DRR serves next. Deficit accrues
        only when the pointer arrives at a tenant. When a full cycle
        covers no head, virtual time fast-forwards: every queued tenant
        gets the number of weighted quanta that makes the nearest head
        servable."""
        if self._head is not None or not self._order:
            return self._head
        for _attempt in range(2):
            for _k in range(len(self._order) + 1):
                tid = self._order[self._rr]
                if not self._charged:
                    self._deficit[tid] += self._quantum * self._weight(tid)
                    self._charged = True
                ticket, nb = self._queues[tid][0]
                if self._deficit[tid] >= nb:
                    self._head = (ticket, tid, nb)
                    return self._head
                # not covered: the pointer moves on, the credit stays
                self._rr = (self._rr + 1) % len(self._order)
                self._charged = False
            rounds = max(1, min(
                math.ceil((q[0][1] - self._deficit[t])
                          / (self._quantum * self._weight(t)))
                for t, q in self._queues.items()))
            for t in self._queues:
                self._deficit[t] += rounds * self._quantum * self._weight(t)
        return self._head

    def grantable(self, fits: Callable[[str, int], bool],
                  quota_blocked: Optional[Callable[[str, int], bool]]
                  = None) -> Optional[int]:
        """The ticket DRR serves next if it fits now (``fits(tenant,
        nbytes)``: global room and the tenant's quota room), else None.
        A head blocked by its tenant's OWN quota (``quota_blocked``) is
        bypassed: the other tenants' covered fronts are offered in
        pointer order, and the blocked head keeps its place and credit.
        A head blocked by the GLOBAL cap is not bypassed: smaller tickets
        streaming past it would starve it until the drain."""
        head = self._ensure_head()
        if head is None:
            return None
        ticket, tid, nb = head
        if fits(tid, nb):
            return ticket
        if quota_blocked is None or not quota_blocked(tid, nb):
            return None
        candidates = []
        for k in range(1, len(self._order)):
            other = self._order[(self._rr + k) % len(self._order)]
            oticket, onb = self._queues[other][0]
            if not fits(other, onb):
                continue
            if self._deficit[other] >= onb:
                return oticket
            candidates.append((other, oticket, onb))
        if not candidates:
            return None
        # the blocked head may stay blocked: fast-forward the others'
        # virtual time to the nearest servable front (idempotent: after
        # the jump the covered branch above answers)
        rounds = max(1, min(
            math.ceil((onb - self._deficit[t])
                      / (self._quantum * self._weight(t)))
            for t, _tk, onb in candidates))
        for t, _tk, _onb in candidates:
            self._deficit[t] += rounds * self._quantum * self._weight(t)
        for t, tk, onb in candidates:
            if self._deficit[t] >= onb:
                return tk
        return None

    def pop(self, ticket: int, nbytes: int) -> None:
        """Consume a granted ticket: its bytes come off its tenant's
        deficit (an emptied tenant forfeits the rest). The pointer stays
        on the tenant; :meth:`_ensure_head` moves it when the credit runs
        out."""
        tid = self._where.pop(ticket, None)
        if tid is None:
            return
        if self._head is not None and self._head[0] == ticket:
            self._head = None
        q = self._queues[tid]
        if q and q[0][0] == ticket:
            q.popleft()
        else:
            for item in q:
                if item[0] == ticket:
                    q.remove(item)
                    break
        if not q:
            self._drop_tenant(tid)
        else:
            self._deficit[tid] = max(0.0, self._deficit[tid] - nbytes)

    def depth(self) -> int:
        return len(self._where)


class FifoAdmitQueue:
    """The strictly FIFO deferral order behind :class:`FairShareQueue`'s
    interface (``tenant.fairShare=false``)."""

    def __init__(self):
        self._q: deque = deque()                # (ticket, tenant, nbytes)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __contains__(self, ticket: int) -> bool:
        return any(t == ticket for t, _, _ in self._q)

    def enqueue(self, ticket: int, tenant: str, nbytes: int) -> None:
        self._q.append((ticket, tenant, int(nbytes)))

    def discard(self, ticket: int) -> None:
        for item in self._q:
            if item[0] == ticket:
                self._q.remove(item)
                return

    def grantable(self, fits, quota_blocked=None) -> Optional[int]:
        if not self._q:
            return None
        ticket, tenant, nb = self._q[0]
        return ticket if fits(tenant, nb) else None

    def pop(self, ticket: int, nbytes: int) -> None:
        self.discard(ticket)

    def depth(self) -> int:
        return len(self._q)


def agreed_submission_order(pending, weight_of) -> list:
    """The tenant-DRR dispatch order of one async batch. ``pending``:
    ``(seq, tenant_id)`` pairs in local submission order;
    ``weight_of(tenant_id)``: the tenant's weight. Returns the seqs:
    round-robin over the tenants in first-appearance order, each serving
    up to ``weight`` reads a round (the quantum is a read), FIFO within a
    tenant. A pure function of the batch, so every process holding the
    same pairs computes the same order."""
    queues: Dict[str, deque] = {}
    order = []
    for seq, tid in pending:
        q = queues.get(tid)
        if q is None:
            q = queues[tid] = deque()
            order.append(tid)
        q.append(seq)
    out = []
    while queues:
        for tid in list(order):
            q = queues.get(tid)
            if q is None:
                continue
            for _ in range(max(1, int(weight_of(tid)))):
                if not q:
                    break
                out.append(q.popleft())
            if not q:
                del queues[tid]
                order.remove(tid)
    return out


class ShuffleFuture:
    """Handle to one async read: ``done()`` / ``result()`` /
    ``exception()`` / ``add_done_callback()``. After completion
    ``wall_ms`` is the read's wall on its worker (queue wait excluded)
    and ``queued_ms`` the time it waited for a worker."""

    __slots__ = ("_fut", "_times", "tenant", "shuffle_id")

    def __init__(self, fut, times: Dict[str, float], tenant: str,
                 shuffle_id: int):
        self._fut = fut
        self._times = times
        self.tenant = tenant
        self.shuffle_id = shuffle_id

    @property
    def wall_ms(self) -> float:
        return self._times.get("wall_ms", 0.0)

    @property
    def queued_ms(self) -> float:
        return self._times.get("queued_ms", 0.0)

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        return self._fut.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)

    def add_done_callback(self, fn) -> None:
        self._fut.add_done_callback(lambda _f: fn(self))


class AsyncShuffleExecutor:
    """The async read plane behind ``read_async`` / ``submit_async``.

    One process: ``tenant.asyncWorkers`` threads (default 4) run facade
    reads concurrently, arbitrated by the admission plane.

    Distributed, with more than one worker and ``tenant.asyncAgreedOrder``
    on (the default): one dispatcher thread drains submissions in
    batches. It agrees the batch size (``async.batch``, the minimum of
    the pending counts: no process dispatches work a peer has not
    submitted), computes :func:`agreed_submission_order` and confirms it
    unanimously (``async.order``) before releasing the batch. A divergent
    order fails the whole batch's futures with the typed divergence
    error. Each released read then runs its whole body under a
    :class:`~sparkucx_tpu_torch.shuffle.agreement.CollectiveTurnstile`
    ticket issued in the agreed order, so the reads' collectives run in
    the same order on every process while the workers still overlap
    submission, queueing and the futures. ``tenant.asyncAgreedOrder=
    false`` clamps the pool to one worker (warned once): execution order
    is submission order, with no agreement traffic.

    A tenant at its ``maxInflightReads`` blocks in :meth:`submit` until
    one of its reads resolves (``shuffle.submit.throttled.count
    {tenant=...}``); :meth:`stop` wakes it with an error."""

    def __init__(self, conf, registry: TenantRegistry, metrics,
                 distributed: bool):
        self._registry = registry
        self._metrics = metrics
        workers = conf.tenant_async_workers
        self._agreed_order = conf.tenant_async_agreed_order
        if distributed and workers != 1 and not self._agreed_order:
            log.warning(
                "tenant.asyncWorkers=%d clamped to 1: "
                "tenant.asyncAgreedOrder=false opts out of the "
                "collectively agreed submission order, and distributed "
                "async reads without it must execute strictly in "
                "submission order — set "
                "spark.shuffle.tpu.tenant.asyncAgreedOrder=true "
                "(default) to run K workers over the agreement channel",
                workers)
            workers = 1
        self.workers = workers
        self._dispatching = distributed and workers > 1 \
            and self._agreed_order
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: Dict[str, int] = {}
        self._closed = False
        self._seq = 0                 # local submission counter
        # (seq, tid, run, outer future, release_slot)
        self._queue: deque = deque()
        self._dispatcher: Optional[threading.Thread] = None
        self._turnstile = None
        if self._dispatching:
            from sparkucx_tpu_torch.shuffle.agreement import \
                CollectiveTurnstile
            self._turnstile = CollectiveTurnstile(metrics)

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._closed:
                raise RuntimeError("async executor is stopped")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="sxt-async")
            return self._pool

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def submit(self, fn, tenant: Optional[str], shuffle_id: int,
               timeout: Optional[float] = None) -> ShuffleFuture:
        """Run ``fn()`` on the async plane as ``tenant``; returns a
        :class:`ShuffleFuture`. Blocks at the tenant's in-flight cap
        (``TimeoutError`` after ``timeout`` seconds)."""
        tid = self._registry.resolve(tenant)
        cap = self._registry.spec(tid).max_inflight_reads
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            throttled = False
            while cap and self._inflight.get(tid, 0) >= cap:
                if self._closed:
                    # stop() cancelled the queued runs: this slot would
                    # never free
                    raise RuntimeError("async executor is stopped")
                if not throttled:
                    throttled = True
                    self._metrics.inc(
                        labeled(C_SUBMIT_THROTTLED, tenant=tid), 1)
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"tenant {tid!r} is at "
                        f"tenant.{tid}.maxInflightReads={cap} and no "
                        f"read resolved within {timeout}s")
                self._cv.wait(1.0 if remaining is None
                              else min(remaining, 1.0))
            self._inflight[tid] = self._inflight.get(tid, 0) + 1
        t_submit = time.perf_counter()
        times: Dict[str, float] = {}

        def _release_slot():
            with self._cv:
                n = self._inflight.get(tid, 1) - 1
                if n > 0:
                    self._inflight[tid] = n
                else:
                    self._inflight.pop(tid, None)
                self._cv.notify_all()

        def run():
            t0 = time.perf_counter()
            times["queued_ms"] = (t0 - t_submit) * 1e3
            try:
                return fn()
            finally:
                times["wall_ms"] = (time.perf_counter() - t0) * 1e3
                _release_slot()

        if self._dispatching:
            # the run waits on the dispatcher's queue, which batches,
            # agrees the order and releases it to the pool in that order
            outer = Future()
            with self._cv:
                if self._closed:
                    _release_slot()
                    raise RuntimeError("async executor is stopped")
                self._seq += 1
                self._queue.append((self._seq, tid, run, outer,
                                    _release_slot))
                if self._dispatcher is None:
                    self._dispatcher = threading.Thread(
                        target=self._dispatch_loop,
                        name="sxt-async-dispatch", daemon=True)
                    self._dispatcher.start()
                self._cv.notify_all()
            return ShuffleFuture(outer, times, tid, shuffle_id)

        try:
            fut = self._executor().submit(run)
        except BaseException:
            _release_slot()
            raise
        # a run cancelled by stop() never reaches its finally
        fut.add_done_callback(
            lambda f: _release_slot() if f.cancelled() else None)
        return ShuffleFuture(fut, times, tid, shuffle_id)

    # -- agreed-order dispatch (distributed, K workers) --------------------
    def _dispatch_loop(self):
        """The dispatcher: drains the queue in agreed batches until the
        executor stops."""
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._closed:
                        self._cv.wait(0.2)
                    if self._closed:
                        return
                    n_local = len(self._queue)
                try:
                    self._dispatch_batch(n_local)
                except Exception as e:
                    if getattr(e, "_sxt_batch_failed", False):
                        # the popped batch is resolved already; reads
                        # still queued were never part of it
                        log.warning("async dispatch batch failed; "
                                    "dispatcher continues", exc_info=True)
                        continue
                    log.error("async dispatcher died; failing queued "
                              "reads", exc_info=True)
                    # unregister before draining, under one lock hold: a
                    # later submit starts a fresh dispatcher
                    with self._cv:
                        drained, self._queue = list(self._queue), deque()
                        if self._dispatcher is threading.current_thread():
                            self._dispatcher = None
                    self._fail_items(drained, RuntimeError(
                        "async agreed-order dispatcher failed"))
                    return
        finally:
            with self._cv:
                if self._dispatcher is threading.current_thread():
                    self._dispatcher = None

    def _dispatch_batch(self, n_local: int):
        # the module attribute, looked up per call (tests replace it)
        from sparkucx_tpu_torch.shuffle import agreement
        conf_key = "spark.shuffle.tpu.tenant.asyncAgreedOrder"
        gate = self._turnstile
        my = gate.issue()
        try:
            # the dispatcher's own rounds take a turn, so they never
            # interleave with a running read's collectives
            gate.acquire(my)
            n = int(agreement.agree(
                "async.batch", np.array([n_local], dtype=np.int64),
                reduce="min", conf_key=conf_key,
                metrics=self._metrics)[0])
        except BaseException:
            gate.release(my)
            raise
        if n < 1:
            gate.release(my)
            return
        with self._cv:
            take = min(n, len(self._queue))
            batch = [self._queue.popleft() for _ in range(take)]
        if len(batch) < n:
            # stop() drained the queue between the round and the pop
            gate.release(my)
            self._fail_items(batch, RuntimeError(
                "async executor is stopped"))
            return
        # the batch is ours now: every exit below resolves its futures
        # and frees its tenant slots
        submitted = set()
        tickets: Dict[int, int] = {}
        try:
            by_seq = {item[0]: item for item in batch}
            order = agreed_submission_order(
                [(seq, tid) for seq, tid, _r, _f, _rel in batch],
                lambda t: self._registry.spec(t).weight)
            # unanimity over (seq, tenant) pairs: a process that queued
            # other work fails the whole batch typed, naming it
            proposal = np.array(
                [x for seq in order
                 for x in (seq, zlib.crc32(by_seq[seq][1].encode()))],
                dtype=np.int64)
            agreement.agree("async.order", proposal, conf_key=conf_key,
                            metrics=self._metrics)
            tickets = {seq: gate.issue() for seq in order}
            gate.release(my)
            pool = self._executor()
            for seq in order:
                _s, _tid, run, outer, release = by_seq[seq]
                fut = pool.submit(self._turnstiled(run, release,
                                                   tickets[seq]))
                submitted.add(seq)
                # a run cancelled by stop() frees its slot and ticket here
                fut.add_done_callback(
                    lambda f, rel=release, t=tickets[seq]:
                    (rel(), gate.release(t)) if f.cancelled() else None)
                self._chain(fut, outer)
        except agreement.AgreementDivergenceError as e:
            gate.release(my)
            self._fail_items(batch, e)
            return
        except BaseException as e:
            # fail the undispatched rest, release its tickets so later
            # batches are not wedged, then tell the loop to go on
            gate.release(my)
            for seq, t in tickets.items():
                if seq not in submitted:
                    gate.release(t)
            self._fail_items(
                [it for it in batch if it[0] not in submitted], e)
            e._sxt_batch_failed = True
            raise

    def _turnstiled(self, run, release_slot, ticket: int):
        """``run`` inside its collective turn."""
        gate = self._turnstile

        def wrapped():
            try:
                gate.acquire(ticket)
            except BaseException:
                # run() never started: its finally cannot free the slot
                release_slot()
                raise
            try:
                return run()
            finally:
                gate.release(ticket)
        return wrapped

    @staticmethod
    def _fail_items(items, err: BaseException) -> None:
        for _seq, _tid, _run, outer, release in items:
            release()
            if not outer.done():
                outer.set_exception(err)

    @staticmethod
    def _chain(fut, outer):
        def done(f):
            if f.cancelled():
                outer.cancel()
            elif f.exception() is not None:
                outer.set_exception(f.exception())
            else:
                outer.set_result(f.result())
        fut.add_done_callback(done)

    def _fail_queued(self, err: BaseException) -> None:
        with self._cv:
            drained, self._queue = list(self._queue), deque()
        self._fail_items(drained, err)

    def stop(self, wait: bool = True) -> None:
        """Refuse new submits, wake capped submitters, fail the queued
        reads, and drain (``wait``) the running ones."""
        with self._cv:
            self._closed = True
            pool, self._pool = self._pool, None
            dispatcher = self._dispatcher
            self._cv.notify_all()
        if self._turnstile is not None:
            # reads parked on their turn fail before the pool drain
            self._turnstile.close()
        if dispatcher is not None:
            # past the join's timeout a dispatcher inside a round is
            # fenced: _executor() refuses and the closed turnstile fails
            # its acquires, so its batch resolves through its own
            # failure path
            dispatcher.join(timeout=5.0)
        self._fail_queued(RuntimeError("async executor is stopped"))
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=True)
