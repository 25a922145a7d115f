"""Windowed telemetry history — the time axis of the metrics plane (the
JAX package's ``sparkucx_tpu/utils/history.py``).

Counters and histograms are cumulative since start; a
:class:`TelemetryHistory` turns successive snapshots of them (the
node's lean collect, ``runtime/node.Node._history_collect``) into
fixed-cadence **window frames**:

* counters subtract (a frame carries the window's deltas, zero-delta
  names dropped);
* histograms subtract bucket-wise (:meth:`Histogram.snapshot_delta`:
  one fixed ladder, so the window's p50/p99 are quantiles of the
  window);
* gauges sample point-in-time.

Frames live in a bounded ring and, when ``spark.shuffle.tpu.history.
dir`` is set, in a JSONL log ``history_p<process_id>.jsonl`` (keyed by
the cluster rank, so a restarted rank adopts its predecessor's log),
bounded to ``history.retainWindows`` lines by an atomic rewrite
(``utils/atomicio``). No sampling thread of its own: the service's
``utils/export.PeriodicDumper`` calls :meth:`TelemetryHistory.tick`,
which closes a window once ``history.windowSecs`` elapsed; ``roll()``
closes one now.

Conf keys (under ``spark.shuffle.tpu.``)::

    history.dir            on-disk JSONL directory (unset = ring only)
    history.windowSecs     window length (default 60)
    history.retainWindows  ring + on-disk retention (default 120)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import Histogram

log = get_logger("history")

DEFAULT_WINDOW_SECS = 60.0
DEFAULT_RETAIN = 120

FRAME_KIND = "history_frame"


def counters_delta(cur: Dict[str, float],
                   prev: Dict[str, float]) -> Dict[str, float]:
    """Per-name counter deltas between two cumulative snapshots.
    Zero-delta names are dropped (frames stay compact); a counter that
    SHRANK means the source registry restarted mid-window — the honest
    window value is the current cumulative count, not a negative."""
    out: Dict[str, float] = {}
    for name, v in cur.items():
        try:
            d = float(v) - float(prev.get(name, 0.0))
        except (TypeError, ValueError):
            continue
        if d < 0:
            d = float(v)
        if d:
            out[name] = d
    return out


def histograms_delta(cur: Dict[str, Dict],
                     prev: Dict[str, Dict]) -> Dict[str, Dict]:
    """Bucket-wise histogram deltas; empty windows are dropped."""
    out: Dict[str, Dict] = {}
    for name, snap in cur.items():
        d = Histogram.snapshot_delta(snap, prev.get(name), name)
        if int(d.get("count", 0)):
            out[name] = d
    return out


class TelemetryHistory:
    """Fixed-cadence window frames over a snapshot callable.

    ``collect()`` returns a snapshot document (``export.
    collect_snapshot``'s shape: counters / histograms / gauges /
    anchor). Each :meth:`roll` computes one frame as the delta against
    the previous snapshot, appends it to the bounded ring and (when
    ``out_dir`` is set) to the JSONL log. ``extra`` rides into every
    frame verbatim."""

    def __init__(self, collect: Callable[[], Dict],
                 window_secs: float = DEFAULT_WINDOW_SECS,
                 retain_windows: int = DEFAULT_RETAIN,
                 out_dir: Optional[str] = None,
                 process_id: int = 0,
                 extra: Optional[Dict] = None):
        self._collect = collect
        self.window_secs = max(0.1, float(window_secs))
        self.retain = max(1, int(retain_windows))
        self.out_dir = out_dir
        self.process_id = process_id
        self._extra = dict(extra or {})
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=self.retain)
        self._prev: Optional[Dict] = None
        self._prev_ts = time.time()
        self._seq = 0
        self.version = 0          # bumps per rolled frame
        self._warned_tick = False
        self._warned_disk = False
        self._disk_lines: Optional[int] = None   # counted lazily
        # serialized lines mirroring the on-disk tail: once the log is
        # at capacity, retention rewrites come straight from here —
        # no read-back of the file it is about to replace
        self._disk_ring: deque = deque(maxlen=self.retain)
        self._dir_ready = False

    @property
    def path(self) -> Optional[str]:
        # keyed by the stable cluster rank: a restarted rank writes the
        # SAME file (adoption keeps the retention bound spanning
        # restarts) instead of leaving one orphan per dead pid — the
        # frames themselves carry the writing pid
        if not self.out_dir:
            return None
        return os.path.join(self.out_dir,
                            f"history_p{self.process_id}.jsonl")

    def frames(self) -> List[Dict]:
        """Retained frames, oldest first."""
        with self._lock:
            return list(self._frames)

    def tick(self) -> Optional[Dict]:
        """The PeriodicDumper cadence hook: roll iff a full window
        elapsed since the last frame. Never raises."""
        try:
            if time.time() - self._prev_ts >= self.window_secs:
                return self.roll()
        except Exception:
            if not self._warned_tick:
                self._warned_tick = True
                log.exception("history tick failed; further failures "
                              "are silenced")
        return None

    def roll(self, now: Optional[float] = None) -> Optional[Dict]:
        """Close the current window into one frame now (the first call
        only opens the window and returns None)."""
        now = time.time() if now is None else float(now)
        doc = self._collect()
        with self._lock:
            prev, t0 = self._prev, self._prev_ts
            self._prev = {
                "counters": dict(doc.get("counters") or {}),
                "histograms": dict(doc.get("histograms") or {}),
            }
            self._prev_ts = now
            if prev is None:
                # the first snapshot only opens the window: a frame
                # needs two endpoints
                return None
            self._seq += 1
            frame = {
                "kind": FRAME_KIND,
                "seq": self._seq,
                "t_start": t0,
                "t_end": now,
                "window_s": round(now - t0, 3),
                "pid": os.getpid(),
                "process_id": self.process_id,
                "anchor": doc.get("anchor"),
                "counters": counters_delta(
                    doc.get("counters") or {}, prev["counters"]),
                "histograms": histograms_delta(
                    doc.get("histograms") or {}, prev["histograms"]),
                "gauges": dict(doc.get("gauges") or {}),
            }
            frame.update(self._extra)
            self._frames.append(frame)
            self.version += 1
        self._append_disk(frame)
        return frame

    # -- on-disk JSONL -----------------------------------------------------
    def _append_disk(self, frame: Dict) -> None:
        """Size-bounded JSONL append: one plain append below capacity;
        at capacity an atomic whole-file rewrite from the in-memory line
        ring (never a read-back of the file it replaces). An existing
        log (a restart) is adopted once, at the first append, so the
        bound spans restarts."""
        path = self.path
        if not path:
            return
        try:
            if not self._dir_ready:
                os.makedirs(self.out_dir, exist_ok=True)
                self._dir_ready = True
            if self._disk_lines is None:
                self._disk_lines = 0
                if os.path.exists(path):
                    with open(path) as f:
                        prior = [ln for ln in f if ln.strip()]
                    self._disk_lines = len(prior)
                    self._disk_ring.extend(
                        ln.rstrip("\n") for ln in prior)
            line = json.dumps(frame, sort_keys=True, default=repr)
            self._disk_ring.append(line)
            if self._disk_lines < self.retain:
                with open(path, "a") as f:
                    f.write(line + "\n")
                self._disk_lines += 1
            else:
                from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
                atomic_write_text(
                    path, "\n".join(self._disk_ring) + "\n",
                    fsync=False)
                self._disk_lines = len(self._disk_ring)
        except Exception:
            if not self._warned_disk:
                self._warned_disk = True
                log.exception("history append to %s failed; further "
                              "failures are silenced", path)


# -- replay (restart, offline) -----------------------------------------------
def load_history_file(path: str) -> List[Dict]:
    """Parse one ``history_*.jsonl`` into frames, oldest first. Torn or
    foreign lines are skipped with a warning (an append interrupted by
    SIGKILL must not take the whole replay down)."""
    frames: List[Dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                log.warning("%s:%d: unparseable history line skipped",
                            path, i + 1)
                continue
            if isinstance(doc, dict) and doc.get("kind") == FRAME_KIND:
                frames.append(doc)
    return frames


def history_files(directory: str) -> List[str]:
    """The window logs in a dump or history directory."""
    import glob
    return sorted(glob.glob(os.path.join(directory, "history_*.jsonl")))


def frames_to_doc(frames: List[Dict], source: str = "history") -> Dict:
    """Wrap replayed frames as a snapshot-shaped doc (``history_frames``
    key) with the newest frame's anchor and identity; counters and
    histograms stay empty (the cumulative state did not survive the
    restart)."""
    if not frames:
        raise ValueError(f"{source}: no history frames")
    last = frames[-1]
    doc = {
        "ts": last.get("t_end"),
        "pid": last.get("pid"),
        "process_id": last.get("process_id"),
        "anchor": last.get("anchor"),
        "counters": {},
        "histograms": {},
        "history_frames": list(frames),
    }
    objs = last.get("slo_objectives")
    if objs:
        doc["slo_objectives"] = objs
    return doc
