"""Collective watchdog — a deadline everywhere a peer can hang this process
(the JAX package's ``sparkucx_tpu/runtime/watchdog.py``).

A dead process can leave every survivor parked inside a collective of
``torch.distributed``. :meth:`Watchdog.call` runs a blocking collective
step on a watched thread and joins it against
``failure.collectiveTimeoutMs``; on expiry it probes the device through
the :class:`~sparkucx_tpu_torch.runtime.failures.HealthMonitor`, counts
``failure.peer_timeout.count``, scrapes the fleet out of band when the
node wired :attr:`Watchdog.peer_scrape` (``utils/collector.
ClusterCollector.postmortem``: HTTP, never a collective), records a
``peer_timeout`` event and dumps a flight-recorder postmortem tagged with
the stuck exchange's trace id, and raises
:class:`~sparkucx_tpu_torch.runtime.failures.PeerLostError` naming the
section and the trace. The abandoned worker thread stays parked in the
collective and is tracked (:meth:`Watchdog.leaked`); the process group it
sits in is unusable, so recovery is a fresh world, not a retry into the
old one.

The fence is process-global (:func:`set_global_watchdog` /
:func:`current_watchdog`): the node installs its own at start
(:func:`configure_from_conf`) and removes it at close, so the
module-level collectives of ``shuffle/distributed.py`` fence themselves.
Off by default (``failure.collectiveTimeoutMs=0``): ``call`` is then a
direct call on the caller's thread.

A wait on this process's own device work (``call(..., local=True)``:
the completion wait of an exchange whose collectives already returned)
takes part in no collective, so its expiry raises
:class:`~sparkucx_tpu_torch.runtime.failures.DeviceUnhealthy` instead:
no peer is blamed, ``failure.peer_timeout.count`` does not move, no peer
is scraped, and the postmortem's document is ``device_timeout``.

The gloo transport often fails fast instead of hanging when a peer dies
(a closed connection); ``shuffle/distributed.py`` maps that error, on a
fenced collective, to the same ``PeerLostError``, and the node sets the
process group's own timeout to the fence so that gloo never waits past
it."""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from sparkucx_tpu_torch.runtime.failures import (NULL_FLIGHT_RECORDER,
                                                 DeviceUnhealthy,
                                                 PeerLostError,
                                                 ThreadLeakCensus)
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import C_PEER_TIMEOUT, C_PROBE_DEAD

log = get_logger("runtime.watchdog")


class Watchdog:
    """Deadline fence for blocking collective steps.

    ``timeout_ms <= 0`` disables it: ``call`` runs the function inline.
    Enabled, the function runs on a fresh daemon thread and the caller
    joins it with the deadline (a collective inside C code cannot be
    interrupted from Python)."""

    def __init__(self, timeout_ms: float = 0.0, health=None,
                 flight=NULL_FLIGHT_RECORDER, metrics=None,
                 name: str = "watchdog"):
        self.timeout_ms = float(timeout_ms)
        self.health = health          # runtime.failures.HealthMonitor
        self.flight = flight
        self.metrics = metrics
        self.name = name
        self._lock = threading.Lock()
        self._armed: List[dict] = []     # nested fenced sections
        # one leaked worker is normal (each expiry abandons one); the
        # census warns when they start to accumulate
        self._leaked = ThreadLeakCensus(
            warn_at=2, logger=log,
            warning=("%d watchdog worker threads are parked in dead "
                     "collectives; further leaks are silenced — remesh or "
                     "restart the world instead of retrying into it"))
        self._probe_lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None
        self.expiries = 0
        # the out-of-band fleet scrape at a collective's expiry
        # (utils/collector.ClusterCollector.postmortem, wired by the node
        # when its fleet registry has entries): called with (what=,
        # trace=); its result lands in the postmortem as
        # peer_timeout.peer_postmortem
        self.peer_scrape: Optional[Callable[..., dict]] = None

    @property
    def enabled(self) -> bool:
        return self.timeout_ms > 0

    def armed(self) -> List[dict]:
        """The fenced sections running now, oldest first: ``{what,
        trace, deadline}`` each."""
        with self._lock:
            return [dict(e) for e in self._armed]

    def leaked(self) -> int:
        """Worker threads abandoned in a dead collective and still
        parked."""
        return self._leaked.count()

    def call(self, fn: Callable, *args, what: str = "collective",
             trace: Optional[str] = None,
             timeout_ms: Optional[float] = None, local: bool = False,
             **kwargs):
        """``fn(*args, **kwargs)`` under the deadline (``timeout_ms``
        overrides the standing one for this call): its value, its
        exception, or on expiry (after the probe and the postmortem)
        :class:`PeerLostError`, or :class:`DeviceUnhealthy` when ``fn`` is
        a ``local`` wait on this process's own device work. ``trace``
        defaults to the flight recorder's newest in-flight exchange, the
        id its report, spans and flight events carry."""
        limit = self.timeout_ms if timeout_ms is None else float(timeout_ms)
        if limit <= 0:
            return fn(*args, **kwargs)
        if trace is None:
            trace = self.flight.current_trace()
        box: dict = {}
        done = threading.Event()

        def run():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:   # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                done.set()

        entry = {"what": what, "trace": trace or "",
                 "deadline": time.monotonic() + limit / 1e3}
        t = threading.Thread(target=run, daemon=True,
                             name=f"sxt-fence-{what[:24]}")
        with self._lock:
            self._armed.append(entry)
        try:
            t.start()
            done.wait(limit / 1e3)
            if not done.is_set():
                # while the entry is still armed: the postmortem's
                # stuck_sections name the section that expired
                self._expired(what, trace, t, limit, local)
        finally:
            with self._lock:
                try:
                    self._armed.remove(entry)
                except ValueError:
                    pass
        if not done.is_set() and local:
            raise DeviceUnhealthy(
                f"device completion wait expired: {what!r} blocked "
                f">{limit:.0f} ms on this process's own device work (no "
                f"peer takes part in it) — the device or its stream is "
                f"wedged or oversubscribed")
        if not done.is_set():
            raise PeerLostError(
                f"collective deadline expired: {what!r} blocked "
                f">{limit:.0f} ms"
                + (f" in exchange {trace}" if trace else "")
                + " — a peer is unreachable or dead "
                "(spark.shuffle.tpu.failure.collectiveTimeoutMs); remesh "
                "over the survivors and re-run on a fresh world")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _expired(self, what: str, trace: Optional[str], t: threading.Thread,
                 limit: float, local: bool) -> None:
        """Count, track the parked thread, probe, scrape the fleet, record
        and dump; nothing here may raise past the caller's error."""
        self.expiries += 1
        if self.metrics is not None and not local:
            self.metrics.inc(C_PEER_TIMEOUT, 1.0)
        n_leaked = self._leaked.add(str(id(t)), t)
        with self._lock:
            stuck = [dict(e) for e in self._armed]
        verdict = self._probe_once()
        dead = sorted(d for d, ok in (verdict or {}).items() if not ok)
        if dead and self.metrics is not None:
            self.metrics.inc(C_PROBE_DEAD, float(len(dead)))
        # the fleet's view over HTTP (a collective just proved dead; a
        # local wait involves no peer), best-effort like the probe
        postmortem = None
        if self.peer_scrape is not None and not local:
            try:
                postmortem = self.peer_scrape(what=what, trace=trace or "")
            except Exception:
                log.debug("out-of-band peer scrape failed at expiry",
                          exc_info=True)
        log.error("%s deadline expired after %.0f ms at %s (trace %s); "
                  "probe verdict: %s", "local" if local else "collective",
                  limit, what, trace or "-",
                  verdict if verdict is not None else "unavailable")
        if postmortem is not None:
            for pid, cell in (postmortem.get("peers") or {}).items():
                lk = cell.get("last_known") or {}
                if cell.get("ok") and not lk.get("settled"):
                    log.error(
                        "peer %s is reachable but unsettled: last span "
                        "%s (phase %s) ended %.1f s ago", pid,
                        lk.get("last_span"), lk.get("phase"),
                        lk.get("since_s") or -1.0)
        kind = "device_timeout" if local else "peer_timeout"
        doc = {"what": what, "trace": trace or "", "timeout_ms": limit,
               "probe": verdict, "dead_devices": dead,
               "stuck_sections": stuck, "leaked_threads": n_leaked}
        if not local:
            doc["peer_postmortem"] = postmortem
        self.flight.record(kind, what=what, trace=trace or "",
                           timeout_ms=limit, dead_devices=dead,
                           leaked_threads=n_leaked)
        self.flight.dump(
            f"{'DeviceUnhealthy' if local else 'PeerLostError'}: {what} "
            f"blocked >{limit:.0f} ms", extra={kind: doc})

    def _probe_once(self):
        """One bounded liveness probe; while an earlier probe is still
        stuck, skip it (None) instead of stacking another thread."""
        if self.health is None:
            return None
        with self._probe_lock:
            if self._probe_thread is not None \
                    and self._probe_thread.is_alive():
                log.warning("previous device probe is still stuck; "
                            "skipping re-probe (verdict unavailable)")
                return None
            box: dict = {}

            def run():
                try:
                    box["verdict"] = self.health.probe()
                except Exception as e:
                    log.warning("probe failed during watchdog expiry: %s",
                                e)

            t = threading.Thread(target=run, daemon=True,
                                 name="sxt-fence-probe")
            self._probe_thread = t
            t.start()
        t.join(max(1.0, getattr(self.health, "timeout_ms", 1e3) / 1e3
                   + 1.0))
        return box.get("verdict")


# the disabled process-global default; a node installs its own
NULL_WATCHDOG = Watchdog(0.0)
_GLOBAL = NULL_WATCHDOG


def set_global_watchdog(wd: Optional[Watchdog]) -> None:
    global _GLOBAL
    _GLOBAL = wd if wd is not None else NULL_WATCHDOG


def current_watchdog() -> Watchdog:
    return _GLOBAL


def configure_from_conf(conf, health=None, flight=NULL_FLIGHT_RECORDER,
                        metrics=None) -> Watchdog:
    """Build the node's watchdog from ``failure.collectiveTimeoutMs`` and
    install it as the process-global fence (0 = a disabled instance, so
    call sites stay unconditional)."""
    wd = Watchdog(conf.collective_timeout_ms, health=health,
                  flight=flight, metrics=metrics)
    set_global_watchdog(wd)
    return wd
