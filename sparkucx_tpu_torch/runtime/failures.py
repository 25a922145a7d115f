"""Typed failures, the device probe and the epoch plane (the JAX
package's ``sparkucx_tpu/runtime/failures.py``).

* the errors: :class:`TransientError` (worth retrying) and under it
  :class:`PeerLostError` (a collective outlived its deadline or its
  transport failed: a peer is dead) and :class:`BlockCorruptionError`
  with :class:`TruncatedBlockError` (the spill files raise it); the
  fatal :class:`StaleEpochError` and :class:`DeviceUnhealthy` (the probe
  found the device dead, or a local completion wait outlived its
  deadline);
* :class:`ThreadLeakCensus` — the account of threads abandoned in a
  wedged device op or a dead collective, shared by the probe and the
  watchdog (``runtime/watchdog.py``);
* :class:`HealthMonitor` — a deadline-bound liveness probe of the node's
  device (one tiny device op joined on a watched thread);
* :class:`EpochManager` — monotonic membership epochs: a remesh bumps
  the epoch, and work pinned to an older one fails fast with
  :class:`StaleEpochError` instead of entering a collective that would
  hang.

The JAX package's fault injector, flight recorder, ``RetryPolicy``,
``NumericFailure`` and ``HealthMonitor.check_finite`` are not ported:
nothing in this package retries in place or checks values yet (a
``PeerLostError`` reaches the caller typed)."""

from __future__ import annotations

import threading
from typing import Callable, Dict

import numpy as np
import torch

from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.failures")


# -- errors ---------------------------------------------------------------
class TransientError(RuntimeError):
    """A failure worth retrying."""


class PeerLostError(TransientError):
    """A collective outlived ``failure.collectiveTimeoutMs``, or its
    transport failed because a peer went away: a peer is unreachable or
    dead (``runtime/watchdog.py``). Raised instead of hanging the
    survivors, so a recovery controller can remesh and re-run."""


class BlockCorruptionError(TransientError):
    """A staged or spilled block no longer matches what its commit
    published."""


class TruncatedBlockError(BlockCorruptionError):
    """A spill file is shorter than its sealed sidecar declares — a torn
    write or an external truncation. Raised before the file is mapped,
    naming the file, so a reader never gets a short or garbage view."""


class StaleEpochError(RuntimeError):
    """Work references a membership epoch that a remesh invalidated."""


class DeviceUnhealthy(RuntimeError):
    """A device failed the liveness probe, or a wait on its own work
    outlived the deadline."""


# -- health ---------------------------------------------------------------
class ThreadLeakCensus:
    """Daemon threads abandoned in a wedged device op or a dead
    collective, by key; finished threads age out on every access. Warns
    exactly once, the first time the census reaches ``warn_at``."""

    def __init__(self, warn_at: int, warning: str, logger=None):
        self._lock = threading.Lock()
        self._items: Dict[str, threading.Thread] = {}
        self._warn_at = int(warn_at)
        self._warning = warning          # one %d slot: the census size
        self._logger = logger if logger is not None else log
        self._warned = False

    def _sweep_locked(self) -> None:
        self._items = {k: t for k, t in self._items.items()
                       if t.is_alive()}

    def count(self) -> int:
        with self._lock:
            self._sweep_locked()
            return len(self._items)

    def keys(self) -> set:
        """Keys of the threads still parked."""
        with self._lock:
            self._sweep_locked()
            return set(self._items)

    def add(self, key: str, thread: threading.Thread) -> int:
        """Track one abandoned thread; returns the census size after."""
        with self._lock:
            self._sweep_locked()
            self._items[key] = thread
            n = len(self._items)
            warn = n >= self._warn_at and not self._warned
            if warn:
                self._warned = True
        if warn:
            self._logger.warning(self._warning, n)
        return n


class HealthMonitor:
    """Liveness probe of the node's device.

    ``probe()`` runs a tiny op on the device (a sum of 8 ones, read back
    to the host) on a daemon thread and joins it against ``timeout_ms``.
    A probe thread that outlives its deadline stays parked in the wedged
    op; it is tracked, and the device is reported dead without another
    thread until that one returns."""

    def __init__(self, device, timeout_ms: float = 30_000.0):
        self.device = torch.device(device)
        self.timeout_ms = float(timeout_ms)
        self._stuck = ThreadLeakCensus(
            warn_at=1,
            warning=("%d probe thread(s) exceeded the "
                     f"{self.timeout_ms:.0f} ms deadline and remain parked;"
                     " the device stays marked dead until they return"))

    def _run_one(self, out: list) -> None:
        """The device op (seam: tests wedge the device here)."""
        try:
            x = torch.ones(8, dtype=torch.float32, device=self.device)
            out[0] = bool(np.isfinite(float(x.sum().item())))
        except Exception as e:
            log.warning("probe failed on %s: %s", self.device, e)
            out[0] = False

    @property
    def leaked_probe_threads(self) -> int:
        return self._stuck.count()

    def probe(self) -> Dict[str, bool]:
        """``{device: alive}``."""
        name = str(self.device)
        if name in self._stuck.keys():
            return {name: False}
        out = [False]
        t = threading.Thread(target=self._run_one, args=(out,), daemon=True,
                             name="sxt-probe")
        t.start()
        t.join(self.timeout_ms / 1e3)
        if t.is_alive():
            self._stuck.add(name, t)
            return {name: False}
        return {name: out[0]}

    def assert_healthy(self) -> None:
        bad = [d for d, ok in self.probe().items() if not ok]
        if bad:
            raise DeviceUnhealthy(f"devices failed liveness probe: {bad}")


# -- epochs ---------------------------------------------------------------
class EpochManager:
    """Monotonic membership epochs. Every shuffle registration captures
    ``current``; a membership change calls :meth:`bump`; stale work
    raises :class:`StaleEpochError` at its next :meth:`validate` instead
    of issuing a collective that would hang. Bump listeners run after the
    epoch moved (the agreement plane resets its round sequence there)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch = 0
        self._listeners = []

    @property
    def current(self) -> int:
        with self._lock:
            return self._epoch

    def bump(self, reason: str = "") -> int:
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            listeners = list(self._listeners)
        log.info("mesh epoch -> %d (%s)", epoch, reason or "remesh")
        for fn in listeners:
            fn(epoch)
        return epoch

    def on_bump(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[int], None]) -> None:
        """Deregister a bump listener (no-op if absent)."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def validate(self, epoch: int, what: str = "work") -> None:
        cur = self.current
        if epoch != cur:
            raise StaleEpochError(
                f"{what} pinned to epoch {epoch}, mesh is at {cur}; "
                f"re-register after remesh")
