"""Epoch-scoped cross-process agreement — the distributed control plane
(the JAX package's ``sparkucx_tpu/shuffle/agreement.py``).

Every process of a distributed node computes its own copy of every
decision (wave counts, overflow verdicts, regrown capacities). A process
booted with a divergent conf, or one that missed a remesh, would compute
a different decision and desync the group into a hang at the next
collective. :func:`agree` is a named, sequenced round that every process
enters in lockstep, over the watchdog-fenced metadata channel
(``shuffle/distributed.allgather_blob``), so each failure class surfaces
typed, on every process together:

* a divergent proposal — :class:`AgreementDivergenceError` naming the
  topic, the dissenting process ids and every proposal (the evidence
  rides the allgather, so every process computes the same verdict);
* a sequencing split (another topic, sequence number or epoch) — the
  same error from the fixed-shape header round, before a payload of
  another shape could wedge the transport;
* a dead peer — ``PeerLostError`` from the channel's fence.

One round is two allgathers: a fixed 6-int64 header (epoch, seq, topic
code, payload length, reduction, a send stamp excluded from the check),
then the payload. ``seq`` resets at each epoch bump (the node wires
:func:`reset_epoch` as a bump listener). Every round, on every exit
(agreed, reduced, divergent, peer lost), counts
``shuffle.agreement.rounds.count`` (and its ``{topic=}`` twin) and
observes ``shuffle.agreement.round_ms`` (and its twin) into the
``metrics`` it is given (the caller's node metrics: the port has no
process-global metrics), runs inside one ``shuffle.agree`` span, and
lands one record in the decision ledger (``shuffle/decisions.py``,
:func:`~sparkucx_tpu_torch.shuffle.decisions.current_ledger`): the
winner and per-peer proposal digests, the per-peer header arrival lag
recovered from the header's send stamps, and the round's audit contract
(``agree(audit=)``).

:class:`CollectiveTurnstile` orders whole collective sections (one
distributed read each) in an agreed sequence on every process: the
tenancy plane's async dispatcher issues its tickets
(``shuffle/tenancy.AsyncShuffleExecutor``)."""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from sparkucx_tpu_torch.shuffle.decisions import current_ledger, digest_row
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import (C_AGREE_DIVERGENCE,
                                              C_AGREE_ROUNDS, H_AGREE_ROUND,
                                              C_TURNSTILE_ABANDONED,
                                              G_TURNSTILE_DEPTH,
                                              H_TURNSTILE_WAIT, labeled)
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

log = get_logger("shuffle.agreement")


class AgreementDivergenceError(RuntimeError):
    """The verdict of a failed round, raised on every process together.

    ``topic``, ``kind`` ("value": same round, other proposals;
    "sequencing": processes entered other rounds), ``dissenters`` (the
    process ids off the majority), ``proposals`` (every process's, in
    process order) and ``conf_key`` (the key whose divergence most likely
    split the round)."""

    def __init__(self, topic: str, kind: str, dissenters: Sequence[int],
                 proposals: List[list], conf_key: str = "",
                 detail: str = ""):
        self.topic = topic
        self.kind = kind
        self.dissenters = [int(d) for d in dissenters]
        self.proposals = proposals
        self.conf_key = conf_key
        msg = (f"agreement divergence on topic {topic!r} ({kind}): "
               f"process(es) {self.dissenters} disagree — proposals by "
               f"process: {proposals}")
        if detail:
            msg += f"; {detail}"
        if conf_key:
            msg += f" — check {conf_key} is identical on every process"
        super().__init__(msg)


# One (epoch, seq) stream per process, identical on every process by the
# lockstep. _LOCK covers the counters; _ROUND_LOCK is held across a whole
# round (seq assignment and both allgathers), so two threads never
# interleave one round's header with another's payload.
_LOCK = threading.Lock()
_ROUND_LOCK = threading.RLock()
_STATE = {"epoch": 0, "seq": 0}


def reset_epoch(epoch: int) -> None:
    """Start the round stream of epoch ``epoch`` (seq back to 0)."""
    with _LOCK:
        _STATE["epoch"] = int(epoch)
        _STATE["seq"] = 0


def current_round() -> tuple:
    """(epoch, next sequence number)."""
    with _LOCK:
        return _STATE["epoch"], _STATE["seq"]


def _topic_code(topic: str) -> int:
    # stable across processes (hash() is salted per process)
    return zlib.crc32(topic.encode("utf-8")) & 0x7FFFFFFF


_REDUCE_CODES = {"unanimous": 0, "max": 1, "min": 2, "sum": 3, "any": 4,
                 "all": 5}
_REDUCERS = {
    "max": lambda rows: rows.max(axis=0),
    "min": lambda rows: rows.min(axis=0),
    "sum": lambda rows: rows.sum(axis=0),
    "any": lambda rows: (rows != 0).any(axis=0).astype(np.int64),
    "all": lambda rows: (rows != 0).all(axis=0).astype(np.int64),
}


def _majority_row(rows: np.ndarray) -> np.ndarray:
    """The most common row, ties toward the lowest process index."""
    _, inv, counts = np.unique(rows, axis=0, return_inverse=True,
                               return_counts=True)
    inv = np.asarray(inv).reshape(-1)
    best = counts.max()
    for i in range(rows.shape[0]):
        if counts[inv[i]] == best:
            return rows[i]
    return rows[0]


def _count(metrics, name: str, topic: str) -> None:
    if metrics is not None:
        metrics.inc(name, 1.0)
        metrics.inc(labeled(name, topic=topic), 1.0)


def agree(topic: str, payload,
          reduce: Optional[Union[str, Callable]] = None,
          conf_key: str = "", timeout_ms: Optional[float] = None,
          metrics=None, group=None,
          audit: Optional[str] = None) -> np.ndarray:
    """COLLECTIVE: one agreement round over an int64 payload vector.
    Every process calls with the same topic, in the same order relative
    to every other collective.

    ``reduce=None`` (unanimity): every process proposes the same vector
    and gets it back, else :class:`AgreementDivergenceError` on every
    process. ``reduce`` in {max, min, sum, any, all} or a callable
    ``rows -> row`` over the ``[nproc, n]`` proposals: the reduction
    returns. A sequencing split raises from the header round either way.
    ``timeout_ms`` overrides the fence's deadline for both rounds;
    ``group`` runs both on that process group (``distributed.
    allgather_blob``).

    ``audit`` is the round's contract in the decision ledger:
    ``"strict"`` (every peer derives its proposal from conf, so
    differing proposals under a reducer are a silent conf split the
    audit flags) or ``"aggregate"`` (per-peer shares that differ by
    design). Default: strict for unanimity rounds, aggregate under a
    reducer."""
    mine = np.atleast_1d(np.asarray(payload, dtype=np.int64)).reshape(-1)
    if callable(reduce):
        reduce_code = len(_REDUCE_CODES)
    else:
        if reduce is not None and reduce not in _REDUCERS:
            raise ValueError(
                f"unknown agreement reduction {reduce!r}; want one of "
                f"{sorted(_REDUCERS)} or a callable")
        reduce_code = _REDUCE_CODES[reduce or "unanimous"]
    reduce_name = ("callable" if callable(reduce)
                   else (reduce or "unanimous"))
    if audit is None:
        audit = "strict" if reduce is None else "aggregate"
    elif audit not in ("strict", "aggregate"):
        raise ValueError(f"unknown audit contract {audit!r}; want "
                         f"'strict' or 'aggregate'")
    with _ROUND_LOCK:
        with _LOCK:
            epoch, seq = _STATE["epoch"], _STATE["seq"]
            _STATE["seq"] += 1
        # counted before either gather: divergent and peer-lost rounds
        # show in rounds.count too
        _count(metrics, C_AGREE_ROUNDS, topic)
        # what _run_round learns, for the settlement on every exit
        note = {"winner": 0, "proposals": [], "lag": [], "nprocs": 1,
                "ok": True, "error": ""}
        t0 = time.perf_counter()
        try:
            with GLOBAL_TRACER.span("shuffle.agree", topic=topic):
                return _run_round(topic, mine, reduce, reduce_code,
                                  conf_key, timeout_ms, epoch, seq,
                                  metrics, group, note)
        except BaseException as e:
            note["ok"] = False
            if not note["error"]:
                note["error"] = type(e).__name__
            raise
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            if metrics is not None:
                metrics.observe(H_AGREE_ROUND, ms)
                metrics.observe(labeled(H_AGREE_ROUND, topic=topic), ms)
            current_ledger().record(
                epoch=epoch, seq=seq, topic=topic, reduce=reduce_name,
                nprocs=note["nprocs"], winner=note["winner"],
                proposals=note["proposals"], round_ms=ms,
                lag_ms=note["lag"], conf_key=conf_key, ok=note["ok"],
                error=note["error"], audit=audit)


def _run_round(topic, mine, reduce, reduce_code, conf_key, timeout_ms,
               epoch, seq, metrics, group, note):
    # the module attribute, looked up per call (tests replay a 3-process
    # gather through it)
    from sparkucx_tpu_torch.shuffle import distributed

    header = np.array([epoch, seq, _topic_code(topic), mine.shape[0],
                       reduce_code, int(time.time() * 1e3)],
                      dtype=np.int64)
    kw = {} if group is None else {"group": group}
    got_h = np.asarray(distributed.allgather_blob(
        header, what=f"agreement header {topic!r} #{seq}",
        timeout_ms=timeout_ms, **kw)).reshape(-1, 6)
    note["nprocs"] = int(got_h.shape[0])
    # per-peer arrival lag from the send stamps (excluded from the check)
    stamps = got_h[:, 5]
    note["lag"] = [float(v) for v in (stamps - stamps.min())]
    if (got_h[:, :5] != got_h[0, :5]).any():
        maj = _majority_row(got_h[:, :5])
        dissent = [i for i in range(got_h.shape[0])
                   if (got_h[i, :5] != maj).any()]
        _count(metrics, C_AGREE_DIVERGENCE, topic)
        note["error"] = "sequencing"
        note["proposals"] = [digest_row(r) for r in got_h[:, :5]]
        raise AgreementDivergenceError(
            topic, "sequencing", dissent,
            [r.tolist() for r in got_h[:, :5]], conf_key=conf_key,
            detail="processes entered different agreement rounds "
                   "(header = [epoch, seq, topic, len, reduce]) — a "
                   "divergent conf or a missed remesh")
    got = np.asarray(distributed.allgather_blob(
        mine, what=f"agreement {topic!r} #{seq}",
        timeout_ms=timeout_ms, **kw)).reshape(-1, mine.shape[0])
    note["proposals"] = [digest_row(r) for r in got]
    if callable(reduce):
        out = np.asarray(reduce(got), dtype=np.int64)
        note["winner"] = digest_row(out)
        return out
    if reduce is not None:
        out = _REDUCERS[reduce](got).astype(np.int64)
        note["winner"] = digest_row(out)
        return out
    if (got != got[0]).any():
        maj = _majority_row(got)
        dissent = [i for i in range(got.shape[0])
                   if (got[i] != maj).any()]
        _count(metrics, C_AGREE_DIVERGENCE, topic)
        note["error"] = "value"
        raise AgreementDivergenceError(
            topic, "value", dissent, [r.tolist() for r in got],
            conf_key=conf_key)
    note["winner"] = digest_row(got[0])
    return got[0].copy()


class CollectiveTurnstile:
    """Per-process gate that runs collective SECTIONS in one order on
    every process.

    :func:`agree` makes one round atomic, but a section that issues many
    collectives (a whole distributed read: the completeness barrier, the
    schema, the wave agreements, the exchange, overflow rounds) must run
    them all before another thread's section starts, or two processes
    could interleave read X's collectives with read Y's differently and
    cross. Tickets are issued in an agreed order (the async dispatcher
    issues them from the agreed batch schedule, so ticket k is the same
    work everywhere); :meth:`acquire` blocks until every earlier ticket
    has released.

    :meth:`release` is idempotent and legal out of turn: an abandoned
    ticket (a dispatch failure, an executor stop) marks itself done and
    the turn skips it. :meth:`close` fails every waiter typed.

    Each ticket's issue-to-enter wait goes to ``shuffle.turnstile.
    wait_ms``, the issued-but-unreleased count to the ``shuffle.
    turnstile.depth`` gauge, and a ticket released without entering to
    ``shuffle.turnstile.abandoned.count``, in ``metrics`` (a node's;
    none: not counted). A metrics fault never fails a section."""

    def __init__(self, metrics=None):
        self._cv = threading.Condition()
        self._next = 0          # next unissued ticket
        self._turn = 0          # lowest unreleased ticket
        self._done = set()      # released out of turn, not yet passed
        self._closed = False
        self._m = metrics
        self._issued_at = {}    # ticket -> perf_counter at issue
        self._entered = set()   # tickets that reached their turn

    def _metric(self, fn, *args) -> None:
        if self._m is None:
            return
        try:
            fn(*args)
        except Exception:
            log.debug("turnstile metrics failed", exc_info=True)

    def _gauge_depth_locked(self) -> None:
        if self._m is not None:
            self._metric(self._m.set_gauge, G_TURNSTILE_DEPTH,
                         float(self._next - self._turn))

    def issue(self) -> int:
        """Take the next ticket. Call in the agreed order (one issuing
        thread a process: the async dispatcher)."""
        with self._cv:
            t = self._next
            self._next += 1
            self._issued_at[t] = time.perf_counter()
            self._gauge_depth_locked()
            return t

    def acquire(self, ticket: int) -> None:
        """Block until ``ticket``'s turn. Raises once closed, so a worker
        parked behind a long section fails typed at shutdown."""
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError(
                        "collective turnstile is closed (executor "
                        "stopped)")
                if ticket < self._turn or ticket in self._done:
                    raise RuntimeError(
                        f"collective ticket {ticket} was already "
                        f"released")
                if self._turn == ticket:
                    self._entered.add(ticket)
                    t0 = self._issued_at.get(ticket)
                    if t0 is not None and self._m is not None:
                        self._metric(self._m.observe, H_TURNSTILE_WAIT,
                                     (time.perf_counter() - t0) * 1e3)
                    return
                self._cv.wait(0.2)

    def release(self, ticket: int) -> None:
        """Mark ``ticket`` done (idempotent, legal before its turn): the
        turn advances past every consecutive done ticket."""
        with self._cv:
            if ticket < self._turn or ticket in self._done:
                return
            if ticket not in self._entered and ticket in self._issued_at \
                    and self._m is not None:
                self._metric(self._m.inc, C_TURNSTILE_ABANDONED, 1.0)
            self._issued_at.pop(ticket, None)
            self._entered.discard(ticket)
            self._done.add(ticket)
            while self._turn in self._done:
                self._done.discard(self._turn)
                self._turn += 1
            self._gauge_depth_locked()
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
