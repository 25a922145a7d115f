"""The device-memory sampler and the doctor watcher (the JAX package's
``sparkucx_tpu/runtime/devmon.py``).

:class:`DeviceMonitor` is a daemon thread (``spark.shuffle.tpu.devmon.
enabled`` / ``devmon.intervalMs``; default off, :data:`NULL_DEVMON`
then) that polls the memory of the device the node's shards live on and
the node's host staging pool, and publishes them as gauges into the
node's metrics: ``devmon.hbm.in_use`` / ``.limit`` / ``.peak`` labeled
``{device="<index>"}`` and ``pool.*`` (``Node.publish_pool_gauges``).
On a CUDA device the figures come from ``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` is ``in_use``, ``allocated_bytes.all.
peak`` is ``peak``, and the device's total memory is ``limit``. A CPU
node has no device memory to read: its sample still lands, with null
device fields (the record and its data are separate facts).

A sample taken while an exchange is in flight carries that read's trace
id (``FlightRecorder.current_trace``; None with the recorder off), and
then also lands in the flight recorder's ring.

:class:`DoctorWatcher` (``doctor.watchIntervalSecs`` > 0, started by the
node) runs the doctor over the node's ``doctor_provider`` every interval.
The first pass that shows a critical finding not captured yet takes a
deep capture: a ``torch.profiler`` window of ``doctor.captureMs`` (the
card's kernels with CUDA activity; the window opens
:data:`PROFILER_LEAD_S` early, since a trace can lack the launches made
just after the profiler starts) and a flight postmortem tagged with the
finding. A finding is its rule plus the exchanges it names; a captured
one captures again only after ``doctor.rearmHealthyPasses`` passes
without it, and each rule captures at most
:attr:`DoctorWatcher.RULE_CAPTURE_CAP` times until it stays quiet that
long.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import (G_HBM_IN_USE, G_HBM_LIMIT,
                                              G_HBM_PEAK, labeled)
from sparkucx_tpu_torch.utils.trace import start_profiler

log = get_logger("runtime.devmon")

# host wait between the profiler's start and the window the watcher
# keeps: a torch.profiler trace on the card can lack the launches made
# right after it starts (tools/profiler_margin_probe.py)
PROFILER_LEAD_S = 0.05


class _NullDeviceMonitor:
    """Stand-in when ``devmon.enabled`` is off: call sites stay
    unconditional."""

    __slots__ = ()
    enabled = False

    def start(self) -> "_NullDeviceMonitor":
        return self

    def stop(self) -> None:
        pass

    def sample_once(self) -> None:
        pass

    def samples(self) -> List[Dict]:
        return []


NULL_DEVMON = _NullDeviceMonitor()


def device_memory(device: torch.device) -> Dict[str, Optional[int]]:
    """``{in_use, limit, peak}`` bytes of ``device``: the CUDA caching
    allocator's current and peak allocated bytes and the device's total
    memory; all None on a device with no memory statistics (the CPU)."""
    if device.type != "cuda":
        return {"in_use": None, "limit": None, "peak": None}
    ms = torch.cuda.memory_stats(device)
    return {"in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "limit": int(torch.cuda.get_device_properties(device)
                         .total_memory),
            "peak": int(ms.get("allocated_bytes.all.peak", 0))}


class DeviceMonitor:
    """Daemon-thread device-memory sampler (see the module docstring).
    Keeps a bounded ring of raw samples (:meth:`samples`); a sample
    never raises (a failing probe is logged at debug level)."""

    enabled = True

    def __init__(self, node, interval_s: float = 1.0,
                 capacity: int = 256):
        self._node = node
        self._interval = max(0.02, float(interval_s))
        self._samples: deque = deque(maxlen=max(1, capacity))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="sparkucx-devmon", daemon=True)

    def start(self) -> "DeviceMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.sample_once()

    def sample_once(self) -> None:
        """Take one sample now."""
        try:
            self._sample()
        except Exception:
            log.debug("devmon sample failed", exc_info=True)

    def _sample(self) -> None:
        node = self._node
        metrics = node.metrics
        trace = node.flight.current_trace()
        dev = node.device
        i = dev.index if dev.index is not None else 0
        try:
            mem = device_memory(dev)
        except Exception:
            log.debug("device memory read failed", exc_info=True)
            mem = {"in_use": None, "limit": None, "peak": None}
        # a None clears the gauge: no stale watermark for a scrape
        metrics.set_gauge(labeled(G_HBM_IN_USE, device=i), mem["in_use"])
        metrics.set_gauge(labeled(G_HBM_LIMIT, device=i), mem["limit"])
        metrics.set_gauge(labeled(G_HBM_PEAK, device=i), mem["peak"])
        devices = [{"index": i, "device": str(dev), **mem}]
        pool = node.pool.stats()
        node.publish_pool_gauges(pool)
        metrics.inc("devmon.samples")
        self._samples.append({
            "t": time.time(), "trace": trace, "devices": devices,
            "pool_in_use_bytes": pool.get("in_use_bytes"),
            "pool_peak_bytes": pool.get("peak_bytes")})
        hbm_total = sum(d["in_use"] for d in devices
                        if d["in_use"] is not None)
        # ring events only while an exchange is in flight: an idle
        # sampler must not evict the events the ring exists to keep
        if trace is not None:
            node.flight.record("devmon", hbm_in_use=hbm_total,
                               pool_in_use=pool.get("in_use_bytes", 0))
        if node.tracer.live:
            node.tracer.instant("devmon.sample", hbm_in_use=hbm_total,
                                trace=trace or "")

    def samples(self) -> List[Dict]:
        """The bounded ring of raw samples, oldest first."""
        return list(self._samples)


class DoctorWatcher:
    """The rolling doctor pass and its deep capture (see the module
    docstring). :meth:`check_once` is the loop body, public so a caller
    can drive it synchronously."""

    # captures a rule may take before it stays quiet for the re-arm
    # streak: a persistent condition mints a new finding key every pass
    # (the worst exchange changes), and without a cap each would cost a
    # profiler window and a postmortem
    RULE_CAPTURE_CAP = 5

    def __init__(self, node, interval_s: float,
                 profile_ms: float = 200.0,
                 capture_dir: Optional[str] = None,
                 rearm_passes: int = 3):
        self._node = node
        self._interval = max(0.1, float(interval_s))
        self._profile_ms = max(0.0, float(profile_ms))
        self._capture_dir = capture_dir
        self._seen = set()
        self._rearm_passes = max(1, int(rearm_passes))
        self._healthy_passes: Dict[tuple, int] = {}
        self._rule_healthy: Dict[str, int] = {}
        self._rule_captures: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.captures: List[Dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="sparkucx-doctor-watch", daemon=True)

    def start(self) -> "DoctorWatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0 + self._profile_ms / 1e3)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.check_once()
            except Exception:
                log.debug("doctor watch pass failed", exc_info=True)

    @staticmethod
    def _finding_key(f) -> tuple:
        """A finding's identity: its rule and the exchanges it names (a
        finding on new exchanges is new evidence)."""
        return (f.rule, tuple(sorted(t for t in f.trace_ids if t)))

    def check_once(self) -> List[Dict]:
        """One doctor pass over ``node.doctor_provider()``; returns the
        captures it took (possibly none)."""
        findings = self._node.doctor_provider()
        current = {self._finding_key(f) for f in findings
                   if f.grade == "critical"}
        current_rules = {k[0] for k in current}
        with self._lock:
            # a captured key absent from this pass accrues a healthy
            # pass; the streak re-arms it, and a present key resets it
            for key in list(self._seen):
                if key in current:
                    self._healthy_passes.pop(key, None)
                    continue
                n = self._healthy_passes.get(key, 0) + 1
                if n >= self._rearm_passes:
                    self._seen.discard(key)
                    self._healthy_passes.pop(key, None)
                    log.info("doctor watcher re-armed %s after %d "
                             "healthy pass(es)", key, n)
                else:
                    self._healthy_passes[key] = n
            # a rule's capture budget refunds only when the whole rule
            # stayed quiet for the streak
            for rule in list(self._rule_captures):
                if rule in current_rules:
                    self._rule_healthy.pop(rule, None)
                    continue
                n = self._rule_healthy.get(rule, 0) + 1
                if n >= self._rearm_passes:
                    self._rule_healthy.pop(rule, None)
                    self._rule_captures.pop(rule, None)
                else:
                    self._rule_healthy[rule] = n
        fired = []
        for f in findings:
            if f.grade != "critical":
                continue
            key = self._finding_key(f)
            with self._lock:
                if key in self._seen or \
                        self._rule_captures.get(f.rule, 0) \
                        >= self.RULE_CAPTURE_CAP:
                    continue
                self._seen.add(key)
                self._rule_captures[f.rule] = \
                    self._rule_captures.get(f.rule, 0) + 1
            fired.append(self._capture(f))
        return fired

    def _capture(self, f) -> Dict:
        """One finding's deep capture: the profiler window (its
        ``profile_dir`` holds the Chrome trace; None, with the reason in
        ``profile_error``, when the profiler cannot start, for instance
        because another profiler of the process is running) and a flight
        postmortem carrying the finding. Neither failure propagates."""
        cap = {"rule": f.rule, "grade": f.grade, "ts": time.time(),
               "profile_dir": None, "profile_error": None,
               "flight_dump": None}
        base = self._capture_dir or self._node.flight_capture_dir()
        if self._profile_ms > 0:
            pdir = os.path.join(
                base, f"profile_{f.rule}_{int(time.time() * 1e3)}")
            try:
                cap["profile_dir"] = self._profile_window(pdir)
            except Exception as e:
                cap["profile_error"] = repr(e)[:300]
                log.info("doctor capture: profiler window unavailable "
                         "(%s)", e)
        try:
            cap["flight_dump"] = self._node.flight.dump(
                f"doctor finding: {f.rule}",
                extra={"finding": f.to_dict()})
        except Exception:
            log.debug("doctor capture: flight dump failed", exc_info=True)
        log.warning("doctor watcher captured %s (%s): profile=%s "
                    "flight=%s", f.rule, f.grade, cap["profile_dir"],
                    cap["flight_dump"])
        self.captures.append(cap)
        return cap

    def _profile_window(self, pdir: str) -> str:
        """Trace whatever the process and its card do for the next
        ``profile_ms`` (after the lead) into ``pdir/trace.json``."""
        prof = start_profiler(cuda=self._node.device.type == "cuda")
        try:
            time.sleep(PROFILER_LEAD_S + self._profile_ms / 1e3)
        finally:
            prof.__exit__(None, None, None)
        os.makedirs(pdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(pdir, "trace.json"))
        return pdir
