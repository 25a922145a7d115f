"""What the drivers share: the device's synchronize, the port's conf with
the benchmark's kernel cache, and the comparisons' arithmetic."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

CACHE_KEY = "spark.shuffle.tpu.compile.cacheDir"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_conf(traffic: dict, kernel_cache: Path) -> Dict[str, str]:
    """The mix's ``spark.shuffle.tpu.*`` settings, with the kernel build
    cache at the benchmark's fixed directory."""
    conf = {k: str(v) for k, v in traffic.get("conf", {}).items()}
    conf[CACHE_KEY] = str(kernel_cache)
    return conf


def bind_kernel_cache(kernel_cache: Path) -> None:
    """Builds of the port's kernels go to ``kernel_cache`` (for a driver
    that starts no node, which would bind it from its conf)."""
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.runtime.compile_cache import \
        configure_compile_cache
    configure_compile_cache(ShuffleConf({CACHE_KEY: str(kernel_cache)},
                                        use_env=False))


def log_detail(detail: dict) -> None:
    """The comparison's parts, one JSON line on standard error (before
    the compared numbers, which stay the last lines)."""
    import json
    import sys
    print("detail " + json.dumps(detail), file=sys.stderr, flush=True)


def limit_of(traffic: dict, name: str) -> float:
    return float(traffic["limits"][name])


def check(traffic: dict, name: str, value: float) -> dict:
    return {"name": name, "value": float(value),
            "limit": limit_of(traffic, name)}


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def row_mismatches(got: np.ndarray, want: np.ndarray, sort_lanes) -> int:
    """Rows of ``want`` that ``got`` (int32 ``[n, W]`` each) lacks, as
    multisets: both sorted by ``sort_lanes`` (last lane first), then
    compared row by row; a length difference counts in full."""
    def order(a):
        return a[np.lexsort(tuple(a[:, k] for k in reversed(sort_lanes)))]
    n = min(len(got), len(want))
    a, b = order(got)[:n], order(want)[:n]
    return int((a != b).any(axis=1).sum()) + abs(len(got) - len(want))


def span(name: str, on: bool = True):
    """A host range named ``name`` in the device trace (a no-op when
    ``on`` is false): the trace labels the card's idle gaps with it."""
    import contextlib
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class Clock:
    """Host time of a stretch that ends in a device synchronize."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.ms = (time.perf_counter() - self.t0) * 1e3


class Phases:
    """Wall time of each named stretch of set-up, printed to standard
    error as one line (``setup phases: name=seconds ...``)."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()
        self.done: List[tuple] = []

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        import sys
        print("setup phases: " + " ".join(f"{n}={s:.3f}"
                                          for n, s in self.done),
              file=sys.stderr, flush=True)
