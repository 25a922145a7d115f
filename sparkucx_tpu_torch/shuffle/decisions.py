"""Decision ledger — the agreement plane's auditable log (the JAX
package's ``sparkucx_tpu/shuffle/decisions.py``).

Every process of a distributed node appends every agreement round it
closes (``shuffle/agreement.agree``) — ``{epoch, seq, topic, winner
digest, per-peer proposal digests, round wall ms, per-peer header
arrival lag, implicated conf key, audit contract}`` — to a bounded ring
and, when ``history.dir`` is set, to a rank-keyed
``decisions_p<rank>.jsonl`` beside the history log: appended live,
compacted by an atomic rewrite (``utils/atomicio``) once it holds twice
``decisions.retain`` lines, and adopted by a restarted rank.

Each record is a pure function of the gathered round, so N processes'
ledgers are byte-comparable: :func:`align_rounds` joins them by
``(epoch, seq)`` and :func:`audit_round` grades each aligned round.
Topic and winner digest must agree everywhere; on a reduced topic
(min/max/sum/any/all/callable, which settles without a unanimity check)
differing proposal digests are a silent conf split when the round's
contract is ``"strict"`` (every peer derives the proposal from conf),
and by design when it is ``"aggregate"`` (per-peer shares).

Recording never raises (warn once), and the disabled plane
(``decisions.enabled=false``) is :data:`NULL_DECISION_LEDGER`, whose
``record`` is a constant-time no-op. The node installs its ledger
through :func:`set_ledger`; ``agree`` records through
:func:`current_ledger`.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("shuffle.decisions")

DECISION_KIND = "decision"
DEFAULT_RETAIN = 256

# reduce codes whose rounds settle WITHOUT a unanimity check — per-peer
# proposals may legitimately differ, so a conf split under them wins
# silently at agree() time and only the after-the-fact audit can see it
REDUCED = ("max", "min", "sum", "any", "all", "callable")


def digest_row(row) -> int:
    """Stable digest of one proposal/winner vector: crc32 over its
    int64 little-endian bytes, identical on every process (and in both
    packages) for identical values."""
    arr = np.ascontiguousarray(np.asarray(row, dtype=np.int64))
    return zlib.crc32(arr.astype("<i8", copy=False).tobytes()) & 0xFFFFFFFF


class DecisionLedger:
    """Bounded ring + rank-keyed JSONL of closed agreement rounds.

    ``record()`` never raises (warn once on disk faults); ``tail()`` /
    ``position()`` serve the snapshot and the postmortem; ``total`` is
    the monotonic append count (the mark the exchange report's
    ``agreement`` summary diffs against; safe across ring wrap)."""

    def __init__(self, retain: int = DEFAULT_RETAIN,
                 out_dir: Optional[str] = None, process_id: int = 0):
        self.enabled = True
        self.retain = max(1, int(retain))
        self.out_dir = out_dir
        self.process_id = process_id
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.retain)
        self.total = 0            # monotonic appends (never wraps)
        self._warned = False
        self._disk_lines: Optional[int] = None   # counted lazily
        # serialized lines mirroring the on-disk tail (the history.py
        # retention discipline): at capacity the rewrite comes straight
        # from here, never reading back the file it replaces
        self._disk_ring: deque = deque(maxlen=self.retain)
        self._dir_ready = False
        self._fh = None          # persistent append handle (hot path)
        self._path = (os.path.join(
            out_dir, f"decisions_p{process_id}.jsonl")
            if out_dir else None)

    @property
    def path(self) -> Optional[str]:
        # keyed by the cluster rank, not the pid: a restarted rank adopts
        # its predecessor's log, so the retention bound spans restarts
        return self._path

    def record(self, *, epoch: int, seq: int, topic: str,
               reduce: str = "unanimous", nprocs: int = 1,
               winner: int = 0, proposals: Optional[List[int]] = None,
               round_ms: float = 0.0,
               lag_ms: Optional[List[float]] = None,
               conf_key: str = "", ok: bool = True,
               error: str = "", audit: str = "strict") -> Optional[Dict]:
        """Append one closed round. ``agree`` calls it on every exit
        (unanimous, reduced, divergent, peer lost), so a divergent round
        is in the ledger too. Never raises."""
        try:
            rec = {
                "kind": DECISION_KIND,
                "n": 0,                      # monotonic index, set below
                "ts": time.time(),
                "pid": os.getpid(),
                "process_id": self.process_id,
                "epoch": int(epoch), "seq": int(seq), "topic": str(topic),
                "reduce": str(reduce), "nprocs": int(nprocs),
                "winner": int(winner),
                "proposals": [int(p) for p in (proposals or [])],
                "round_ms": round(float(round_ms), 3),
                "lag_ms": [round(float(v), 3) for v in (lag_ms or [])],
                "conf_key": str(conf_key),
                "ok": bool(ok),
                "audit": str(audit),
            }
            if error:
                rec["error"] = str(error)[:200]
            with self._lock:
                self.total += 1
                rec["n"] = self.total
                self._ring.append(rec)
            self._append_disk(rec)
            return rec
        except Exception:
            if not self._warned:
                self._warned = True
                log.exception("decision record failed; further failures "
                              "are silenced")
            return None

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        """Newest-last retained records (all, or the last ``n``)."""
        with self._lock:
            recs = list(self._ring)
        return recs if n is None else recs[-int(n):]

    def since(self, mark: int) -> List[Dict]:
        """Records appended after monotonic index ``mark`` (records the
        ring already dropped are gone, never counted twice)."""
        with self._lock:
            return [r for r in self._ring if r.get("n", 0) > mark]

    def position(self) -> Optional[Dict]:
        """The newest record's (epoch, seq, topic, ok, ts): the
        last-decision position a postmortem prints."""
        with self._lock:
            if not self._ring:
                return None
            r = self._ring[-1]
        return {"epoch": r["epoch"], "seq": r["seq"],
                "topic": r["topic"], "ok": r["ok"], "ts": r["ts"]}

    # -- on-disk JSONL ----------------------------------------------------
    def _append_disk(self, rec: Dict) -> None:
        path = self.path
        if not path:
            return
        try:
            if not self._dir_ready:
                os.makedirs(self.out_dir, exist_ok=True)
                self._dir_ready = True
            if self._disk_lines is None:
                # adopt a predecessor's log ONCE, at first append, so
                # the retention bound spans restarts
                self._disk_lines = 0
                if os.path.exists(path):
                    with open(path) as f:
                        prior = [ln for ln in f if ln.strip()]
                    self._disk_lines = len(prior)
                    self._disk_ring.extend(
                        ln.rstrip("\n") for ln in prior)
            line = json.dumps(rec, sort_keys=True, default=repr,
                              separators=(",", ":"))
            self._disk_ring.append(line)
            if self._disk_lines < 2 * self.retain:
                # amortized compaction: append through a persistent
                # line-flushed handle (on disk for a postmortem after a
                # SIGKILL) until the file holds 2x the retention target,
                # then rewrite it to the newest ``retain`` lines, so the
                # rewrite costs O(1) a round
                if self._fh is None:
                    self._fh = open(path, "a")
                self._fh.write(line + "\n")
                self._fh.flush()
                self._disk_lines += 1
            else:
                from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                atomic_write_text(
                    path, "\n".join(self._disk_ring) + "\n",
                    fsync=False)
                self._disk_lines = len(self._disk_ring)
        except Exception:
            if not self._warned:
                self._warned = True
                log.exception("decision append to %s failed; further "
                              "failures are silenced", path)

    def close(self) -> None:
        """Release the persistent append handle (node teardown). Records
        after close still land in the ring and re-open the file."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None


class _NullDecisionLedger:
    """The disabled plane: constant-time no-ops, no state, no disk."""

    __slots__ = ()
    enabled = False
    total = 0
    path = None
    process_id = 0

    def record(self, **kw):
        return None

    def close(self):
        return None

    def tail(self, n=None):
        return []

    def since(self, mark):
        return []

    def position(self):
        return None


NULL_DECISION_LEDGER = _NullDecisionLedger()

# module seam (the current_watchdog() pattern): agree() has no node
# handle, so the node installs its ledger here at start and restores the
# null ledger at close
_CURRENT: object = NULL_DECISION_LEDGER
_CURRENT_LOCK = threading.Lock()


def set_ledger(ledger) -> object:
    """Install the process-wide ledger; returns the previous one (the
    node restores NULL_DECISION_LEDGER at close)."""
    global _CURRENT
    with _CURRENT_LOCK:
        prev = _CURRENT
        _CURRENT = ledger if ledger is not None else NULL_DECISION_LEDGER
    return prev


def current_ledger():
    return _CURRENT


# -- replay (restart, offline audit) -----------------------------------------
def load_decisions_file(path: str) -> List[Dict]:
    """Parse one ``decisions_*.jsonl`` into records, oldest first. Torn
    or foreign lines are skipped with a warning (a SIGKILLed append must
    not take the whole audit down)."""
    recs: List[Dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                log.warning("%s:%d: unparseable decision line skipped",
                            path, i + 1)
                continue
            if isinstance(doc, dict) and doc.get("kind") == DECISION_KIND:
                recs.append(doc)
    return recs


def decisions_files(directory: str) -> List[str]:
    """The decision ledgers in a dump or history directory."""
    import glob
    return sorted(glob.glob(os.path.join(directory,
                                         "decisions_*.jsonl")))


def decisions_to_doc(records: List[Dict],
                     source: str = "decisions") -> Dict:
    """Wrap replayed records as a snapshot-shaped doc (``decisions``
    key), as ``utils/history.frames_to_doc`` wraps frames, so
    ``utils/export.dedupe_process_docs`` unions it with the process's
    other captures."""
    if not records:
        raise ValueError(f"{source}: no decision records")
    last = records[-1]
    return {
        "ts": last.get("ts"),
        "pid": last.get("pid"),
        "process_id": last.get("process_id"),
        "counters": {},
        "histograms": {},
        "decisions": list(records),
    }


# -- the consistency audit ---------------------------------------------------
def align_rounds(ledgers: Dict[int, List[Dict]]) -> List[Dict]:
    """Join N peers' ledgers by ``(epoch, seq)``, oldest round first.

    Each aligned round is ``{"epoch", "seq", "records": {peer: rec}}``.
    A peer whose retention window no longer covers a round simply has
    no entry — the audit degrades to the peers that do (warn, never
    crash: the missing-peer contract)."""
    by_round: Dict[tuple, Dict[int, Dict]] = {}
    for peer, recs in ledgers.items():
        for r in recs:
            if not isinstance(r, dict) or "epoch" not in r:
                continue
            key = (int(r["epoch"]), int(r.get("seq", -1)))
            by_round.setdefault(key, {})[peer] = r
    return [{"epoch": e, "seq": s, "records": peers}
            for (e, s), peers in sorted(by_round.items())]


def audit_round(aligned: Dict) -> Optional[Dict]:
    """Grade one aligned round; ``None`` = consistent.

    Three split shapes, in severity order: **topic** (peers closed
    DIFFERENT rounds under the same (epoch, seq) — the sequencing split
    after the fact), **winner** (same round, different agreed result —
    should be impossible while the reduction is deterministic, so it
    means broken determinism), **proposal** (reduced topic, identical
    winner, differing proposals — the silent conf split min/max-reduce
    settles without raising; THE case the auditor exists for).
    Divergent rounds the primitive already fenced typed (``ok=False``)
    are skipped here. The dissenting peer set is the minority by value
    (ties toward the lowest peer, as ``agreement._majority_row``)."""
    recs = aligned["records"]
    if len(recs) < 2:
        return None
    if not all(r.get("ok", True) for r in recs.values()):
        return None

    def _minority(values: Dict[int, object]) -> List[int]:
        counts: Dict[object, int] = {}
        for v in values.values():
            counts[v] = counts.get(v, 0) + 1
        best = max(counts.values())
        # majority value = the lowest peer holding a maximally-common
        # value (ties toward the lowest peer, agreement._majority_row)
        majority = None
        for p in sorted(values):
            if counts[values[p]] == best:
                majority = values[p]
                break
        return [p for p in sorted(values) if values[p] != majority]

    topics = {p: r.get("topic", "") for p, r in recs.items()}
    if len(set(topics.values())) > 1:
        return {"split": "topic", "dissenters": _minority(topics),
                "values": topics}
    winners = {p: r.get("winner", 0) for p, r in recs.items()}
    if len(set(winners.values())) > 1:
        return {"split": "winner", "dissenters": _minority(winners),
                "values": winners}
    any_rec = next(iter(recs.values()))
    if any_rec.get("reduce", "unanimous") in REDUCED:
        props = {p: tuple(r.get("proposals") or ())
                 for p, r in recs.items()}
        # each peer logged the same gathered matrix, so every peer's
        # proposal LIST must agree regardless of contract; a cross-peer
        # list mismatch means the gather itself delivered different
        # matrices — broken transport/determinism, always a split
        rows = [r.get("proposals") or [] for r in recs.values()]
        base = rows[0]
        if any(tuple(r) != tuple(base) for r in rows[1:]):
            return {"split": "proposal", "dissenters": _minority(props),
                    "values": {p: list(v) for p, v in props.items()}}
        # within-list divergence is contract-dependent: an "aggregate"
        # round reduces BY-DESIGN-divergent shares (async.batch queue
        # depths, tier.crossRows sums, hier overflow votes) and is
        # clean; a "strict" round reduces a value every peer derives
        # from conf, so differing digests ARE the silent conf split
        # the reducer settled without raising — THE case this auditor
        # exists for. The contract rides each record (agree(audit=)).
        if any_rec.get("audit", "strict") == "strict" \
                and base and len(set(base)) > 1:
            counts: Dict[int, int] = {}
            for d in base:
                counts[d] = counts.get(d, 0) + 1
            best = max(counts.values())
            maj = next(d for d in base if counts[d] == best)
            dissent = [i for i, d in enumerate(base) if d != maj]
            return {"split": "proposal", "dissenters": dissent,
                    "values": {"proposal_digests": list(base)}}
    return None
