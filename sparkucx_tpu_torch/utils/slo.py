"""Service-level objectives over windowed telemetry history (the JAX
package's ``utils/slo.py``).

Objectives come from conf, are evaluated over
:mod:`~sparkucx_tpu_torch.utils.history` frames (windowed deltas, never
start-to-now aggregates), and come out as error budgets and
multi-window burn rates:

* a latency objective (``slo.read.p99Ms``) declares "``target``
  (default 99%) of reads complete within ``threshold_ms``". Per window,
  the error fraction is the share of reads slower than the bound,
  computed from the window histogram's bucket series
  (``shuffle.read.wait_ms``), so a frame is graded by its own reads.
* an availability objective (``slo.availability``) declares "at least
  ``target`` of reads succeed without burning the failure plane":
  errors are the window's replay and collective-deadline counts.

Burn rate = window error rate / allowed error rate (1 - target). A burn
of 1.0 spends budget exactly as provisioned; the fast/slow pair
(defaults 14.4x over 5 minutes, 6x over 1 hour) is the page-now versus
ticket-later split. The error budget accrues over the retained frames:
as bad windows age out of retention the budget re-accrues.

Per-tenant objectives (``tenant.<id>.slo.*``) ride the tenant-labeled
series (``shuffle.read.wait_ms{tenant=...}`` etc.), so a whale burning
its own budget cannot move a quiet minnow's.

Conf surface (all under ``spark.shuffle.tpu.``)::

    slo.read.p99Ms              global latency bound in ms (unset = off)
    slo.read.target             good-fraction target (default 0.99)
    slo.availability            global availability target (unset = off)
    slo.fastWindowSecs          fast burn window (default 300)
    slo.slowWindowSecs          slow burn window (default 3600)
    slo.fastBurn                fast-burn multiple (default 14.4)
    slo.slowBurn                slow-burn multiple (default 6)
    slo.minEvents               events floor per graded window (default 4)
    tenant.<id>.slo.read.p99Ms  per-tenant latency override
    tenant.<id>.slo.availability  per-tenant availability override
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from sparkucx_tpu_torch.utils.metrics import (C_PEER_TIMEOUT, C_REPLAYS,
                                              H_FETCH_WAIT, labeled)

CONF_PREFIX = "spark.shuffle.tpu."
C_READS = "shuffle.read.count"

_TENANT_SLO_RE = re.compile(
    r"^spark\.shuffle\.tpu\.tenant\.([^.]+)\.slo\.(read\.p99Ms|"
    r"availability)$", re.I)


@dataclass(frozen=True)
class Objective:
    """One declared objective. ``tenant=""`` grades the global series;
    a tenant id grades that tenant's labeled series with its own
    budget."""

    key: str                  # short conf key that declared it
    kind: str                 # latency | availability
    tenant: str = ""
    threshold_ms: float = 0.0  # latency bound (latency kind only)
    target: float = 0.99       # good-event fraction the SLO promises

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @property
    def name(self) -> str:
        return f"{self.key}[tenant={self.tenant}]" if self.tenant \
            else self.key


def objectives_from_dicts(raw: Iterable[Dict]) -> List[Objective]:
    out, seen = [], set()
    for d in raw or []:
        try:
            o = Objective(key=str(d["key"]), kind=str(d["kind"]),
                          tenant=str(d.get("tenant", "")),
                          threshold_ms=float(d.get("threshold_ms", 0.0)),
                          target=float(d.get("target", 0.99)))
        except (KeyError, TypeError, ValueError):
            continue
        k = (o.key, o.tenant)
        if k not in seen:
            seen.add(k)
            out.append(o)
    return out


def _target(conf, short: str, default: float) -> float:
    t = conf.get_float(short, default)
    if not 0.0 < t < 1.0:
        raise ValueError(
            f"conf key {CONF_PREFIX}{short}={t}: want a fraction in "
            f"(0, 1) — the allowed error budget is 1 - target")
    return t


def objectives_from_conf(conf) -> List[Objective]:
    """Parse the declared objective surface. Unset keys mean NO
    objective of that kind — the SLO plane is opt-in, and a node
    without objectives never degrades /healthz over it."""
    out: List[Objective] = []
    p99 = str(conf._get("slo.read.p99Ms", "")).strip()
    if p99:
        ms = float(p99)
        if ms <= 0:
            raise ValueError(
                f"conf key {CONF_PREFIX}slo.read.p99Ms={ms}: want > 0")
        out.append(Objective(
            key="slo.read.p99Ms", kind="latency", threshold_ms=ms,
            target=_target(conf, "slo.read.target", 0.99)))
    avail = str(conf._get("slo.availability", "")).strip()
    if avail:
        out.append(Objective(
            key="slo.availability", kind="availability",
            target=_target(conf, "slo.availability", 0.999)))
    # per-tenant overrides: a tenant named in conf gets its OWN budget
    # over its labeled series (inheriting the global target where the
    # override only names the bound)
    for key, val in conf.items():
        m = _TENANT_SLO_RE.match(key)
        if not m:
            continue
        tid, what = m.group(1), m.group(2)
        if what.lower() == "read.p99ms":
            ms = float(val)
            if ms <= 0:
                raise ValueError(f"conf key {key}={val}: want > 0")
            out.append(Objective(
                key="slo.read.p99Ms", kind="latency", tenant=tid,
                threshold_ms=ms,
                target=_target(conf, "slo.read.target", 0.99)))
        else:
            t = float(val)
            if not 0.0 < t < 1.0:
                raise ValueError(
                    f"conf key {key}={val}: want a fraction in (0, 1)")
            out.append(Objective(key="slo.availability",
                                 kind="availability", tenant=tid,
                                 target=t))
    return out


@dataclass(frozen=True)
class BurnPolicy:
    """Window lengths + burn multiples (the SRE fast/slow pair)."""

    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    min_events: int = 4

    @classmethod
    def from_conf(cls, conf) -> "BurnPolicy":
        return cls(
            fast_window_s=conf.get_float("slo.fastWindowSecs", 300.0),
            slow_window_s=conf.get_float("slo.slowWindowSecs", 3600.0),
            fast_burn=conf.get_float("slo.fastBurn", 14.4),
            slow_burn=conf.get_float("slo.slowBurn", 6.0),
            min_events=conf.get_int("slo.minEvents", 4))

    @classmethod
    def from_dict(cls, raw: Optional[Dict]) -> "BurnPolicy":
        """Rebuild from a dump/frame's ``slo_policy`` dict, ignoring
        unknown keys — ONE reconstruction shared by the doctor's
        slo_burn rule and the CLI replay path, so they cannot drift on
        how a policy deserializes."""
        if not raw:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# -- per-frame event extraction ---------------------------------------------
def _series(base: str, tenant: str) -> str:
    return labeled(base, tenant=tenant) if tenant else base


def good_count(snap: Dict, threshold: float) -> int:
    """Observations <= ``threshold`` from a window histogram's
    cumulative bucket series. The bucket SPANNING the bound counts as
    bad (conservative — the ladder's ~9% spacing bounds the error)."""
    best = 0
    for le, cum in snap.get("buckets", []):
        le = float(le)
        if le <= threshold and le != math.inf:
            best = max(best, int(cum))
    return best


def frame_events(frame: Dict, obj: Objective) -> tuple:
    """(events, errors) one frame contributes to one objective."""
    if obj.kind == "latency":
        snap = (frame.get("histograms") or {}).get(
            _series(H_FETCH_WAIT, obj.tenant))
        if not snap:
            return 0, 0
        events = int(snap.get("count", 0))
        return events, max(0, events - good_count(snap,
                                                  obj.threshold_ms))
    counters = frame.get("counters") or {}
    events = int(counters.get(_series(C_READS, obj.tenant), 0))
    errors = int(counters.get(_series(C_REPLAYS, obj.tenant), 0))
    if not obj.tenant:
        # deadline expiries carry no tenant label; they grade the
        # global objective only
        errors += int(counters.get(C_PEER_TIMEOUT, 0))
    if not events:
        return 0, 0
    return events, min(errors, events)


# -- evaluation --------------------------------------------------------------
def _window(frames: List[Dict], obj: Objective, now: float,
            horizon_s: Optional[float]) -> Dict:
    events = errors = n = 0
    for f in frames:
        t_end = float(f.get("t_end", 0.0))
        if horizon_s is not None and now - t_end > horizon_s:
            continue
        e, x = frame_events(f, obj)
        events += e
        errors += x
        n += 1
    rate = errors / events if events else 0.0
    return {"frames": n, "events": events, "errors": errors,
            "error_rate": round(rate, 6)}


def evaluate(frames: List[Dict], objectives: List[Objective],
             policy: Optional[BurnPolicy] = None,
             now: Optional[float] = None) -> Dict:
    """The SLO verdict document over retained frames (possibly folded
    from N processes — events sum across frames regardless of which
    process contributed a window). ``now`` defaults to the newest
    frame's end so replayed history grades as of when it was written,
    not as of the replay."""
    policy = policy or BurnPolicy()
    frames = sorted(frames or [], key=lambda f: f.get("t_end", 0.0))
    if now is None:
        now = float(frames[-1]["t_end"]) if frames else time.time()
    out: List[Dict] = []
    for obj in objectives:
        allowed = 1.0 - obj.target
        fast = _window(frames, obj, now, policy.fast_window_s)
        slow = _window(frames, obj, now, policy.slow_window_s)
        total = _window(frames, obj, now, None)

        def _burn(w):
            if w["events"] < policy.min_events:
                return 0.0
            return round(w["error_rate"] / allowed, 3)

        burn_fast, burn_slow = _burn(fast), _burn(slow)
        budget_allowed = allowed * total["events"]
        remaining = 1.0
        if budget_allowed > 0:
            remaining = max(0.0, 1.0 - total["errors"] / budget_allowed)
        elif total["errors"]:
            remaining = 0.0
        out.append({
            "objective": obj.key,
            "tenant": obj.tenant,
            "kind": obj.kind,
            "threshold_ms": obj.threshold_ms,
            "target": obj.target,
            "windows": {"fast": fast, "slow": slow},
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "fast_burn": burn_fast >= policy.fast_burn,
            "slow_burn": burn_slow >= policy.slow_burn,
            "budget": {"events": total["events"],
                       "errors": total["errors"],
                       "allowed_errors": round(budget_allowed, 3),
                       "remaining": round(remaining, 4)},
        })
    burning = [o for o in out if o["fast_burn"]]
    return {
        "ts": now,
        "frames": len(frames),
        "window_s": float(frames[-1].get("window_s", 0.0)) if frames
        else 0.0,
        "policy": policy.to_dict(),
        "objectives": out,
        "fast_burn": bool(burning),
        "slow_burn": any(o["slow_burn"] for o in out),
        "burning": [
            f"{o['objective']}"
            + (f"[tenant={o['tenant']}]" if o["tenant"] else "")
            for o in burning],
        "healthy": not burning,
    }


def render_verdict(verdict: Dict) -> str:
    """The verdict as text (``ShuffleService.slo(format="text")``)."""
    objs = verdict.get("objectives", [])
    if not objs:
        return ("slo: no objectives declared (set "
                "spark.shuffle.tpu.slo.read.p99Ms / slo.availability)\n")
    lines = [f"slo: {len(objs)} objective(s) over "
             f"{verdict.get('frames', 0)} retained window(s)"]
    for o in objs:
        state = "FAST BURN" if o["fast_burn"] else (
            "slow burn" if o["slow_burn"] else "ok")
        who = f" tenant={o['tenant']}" if o["tenant"] else ""
        bound = (f" <= {o['threshold_ms']:g} ms"
                 if o["kind"] == "latency" else "")
        lines.append(
            f"[{state:>9}] {o['objective']}{who}: target "
            f"{o['target']:.3%}{bound} — burn fast "
            f"{o['burn_fast']}x / slow {o['burn_slow']}x, budget "
            f"{o['budget']['remaining']:.1%} remaining "
            f"({o['budget']['errors']}/{o['budget']['events']} bad over "
            f"retention)")
    return "\n".join(lines) + "\n"
