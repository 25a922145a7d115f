"""The device-memory sampler (the JAX package's
``sparkucx_tpu/runtime/devmon.py``, without its ``DoctorWatcher``,
which runs the doctor: ROADMAP item 6b).

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
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import (G_HBM_IN_USE, G_HBM_LIMIT,
                                              G_HBM_PEAK, labeled)

log = get_logger("runtime.devmon")


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
        if node.tracer.enabled:
            node.tracer.instant("devmon.sample", hbm_in_use=hbm_total,
                                trace=trace or "")

    def samples(self) -> List[Dict]:
        """The bounded ring of raw samples, oldest first."""
        return list(self._samples)
