"""The arithmetic the per-layer readers share."""

from __future__ import annotations

from typing import Optional

import numpy as np


def span_median(ctx: dict, key: str) -> Optional[float]:
    """The median of a host span over the window's steps."""
    xs = ctx["facts"]["spans"].get(key) or []
    return float(np.median(xs)) if xs else None


def span_percentile(ctx: dict, key: str, q: float) -> Optional[float]:
    """The ``q``-th percentile of a host span over the window's steps."""
    xs = ctx["facts"]["spans"].get(key) or []
    return float(np.percentile(xs, q)) if xs else None


def roofline(ctx: dict, work: str) -> Optional[float]:
    """A kernel's share of its roofline, in %: the least time the card
    could take for the traced calls (per call, the larger of its
    operations over the TF32 peak and its bytes over the memory peak),
    over the calls' traced device time. A call is one launch of each of
    the work's kernels; launches are matched by kernel name."""
    w = ctx["facts"]["kernel_work"].get(work)
    peaks = ctx["peaks"]
    if w is None or peaks is None:
        return None
    counts, seconds = [], 0.0
    for sym in w["symbols"]:
        runs = [t for name, ts in ctx["trace"]["kernels"].items()
                if sym in name for t in ts]
        counts.append(len(runs))
        seconds += sum(runs)
    if not seconds or not min(counts):
        return None
    calls = sum(counts) / len(counts)
    bound = max(w["flops"] / peaks["tf32_flops_per_s"],
                w["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * calls * bound / seconds


def mfu(ctx: dict) -> Optional[float]:
    """The window's model FLOPs per second over the TF32 peak, in %."""
    peaks, tr = ctx["peaks"], ctx["trace"]
    flops = ctx["facts"].get("model_flops")
    if peaks is None or not flops or not tr["window_s"]:
        return None
    return 100.0 * flops / tr["window_s"] / peaks["tf32_flops_per_s"]


def idle(ctx: dict) -> Optional[float]:
    """The share of the window in which no device activity ran, in %."""
    tr = ctx["trace"]
    if not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
