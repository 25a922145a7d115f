"""Counters and a wall timer — the subset of the metrics plane the ported
reads increment (``shuffle.read.ms``, ``shuffle.read.count``,
``shuffle.rows``, ``shuffle.bytes``, ``shuffle.retries``, the D2H byte
counter :data:`C_D2H` and the kernel-fallback counter
:data:`C_KERNEL_FALLBACK`)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

# payload bytes a reader result pulled device-to-host
C_D2H = "shuffle.read.d2h.bytes"
# combine reads whose read.mergeImpl offered the kernel but resolved to
# the torch-op path; labeled(C_KERNEL_FALLBACK, reason=...) counts by reason
C_KERNEL_FALLBACK = "shuffle.kernel.fallback.count"


def labeled(name: str, **labels) -> str:
    """Labeled-metric identity ``name{k="v",...}`` (sorted keys)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Timer:
    """Context-manager wall timer; ``.ms`` after exit."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.ms = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3


class Metrics:
    """Thread-safe named counters, owned by a :class:`~sparkucx_tpu_torch.
    runtime.node.Node`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)
