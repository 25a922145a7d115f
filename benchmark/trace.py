"""The device trace of a measured window: ``torch.profiler`` over the
card's activity and the host's, reduced to the device's busy time (the
union of its activity intervals inside the window), time by device
operation, and the device's idle gaps by what the host was doing.

The union of intervals is ``chip_smoke.device_busy``'s arithmetic,
copied here so that later changes to the program leave it alone."""

from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
# A trace can lack its first launches; a short host wait after the
# profiler starts keeps them in most traces.
PROFILER_LEAD_S = 0.05
# how far back to look for the innermost host event over a gap
_SCAN = 4000

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval]) -> float:
    """Length of the union of ``(start, end)`` intervals: overlapping
    activity is counted once."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def idle_gaps(busy: List[Interval], lo: float,
              hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval of ``busy`` (merged,
    sorted) covers."""
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def label_gaps(gaps: List[Interval], host: List[Tuple[float, float, str]]
               ) -> Dict[str, float]:
    """Idle time by the innermost host event (``(start, end, name)``, any
    thread) that covers each gap's midpoint; ``host idle`` where none
    does. Seconds for microsecond inputs."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        name = "host idle"
        best = float("inf")
        for j in range(i - 1, max(-1, i - 1 - _SCAN), -1):
            hs, he, hn = host[j]
            if he >= mid and he - hs < best:
                best, name = he - hs, hn
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class DeviceTrace:
    """``with DeviceTrace() as tr:`` profiles the body; wrap the measured
    window in ``tr.window()``. After the block, :meth:`reduce` gives the
    busy time, the window and the breakdown."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        time.sleep(PROFILER_LEAD_S)
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    @staticmethod
    def window():
        from torch.profiler import record_function
        return record_function(WINDOW_SPAN)

    def reduce(self) -> Optional[dict]:
        """``{"busy_s", "window_s", "kernels" {name: [seconds, ...]},
        "breakdown"}`` over the window, or None if the trace lacks it."""
        import torch
        dev_type = torch.autograd.DeviceType.CUDA
        device, host, win = [], [], None
        for evt in self._prof.events():
            s, e = evt.time_range.start, evt.time_range.end
            if evt.device_type == dev_type:
                # a host range mirrored on the device's timeline is no
                # device activity
                if not getattr(evt, "is_user_annotation", False) and \
                        evt.name != WINDOW_SPAN:
                    device.append((s, e, evt.name))
            elif evt.name == WINDOW_SPAN:
                win = (s, e)
            else:
                host.append((s, e, evt.name[:80]))
        if win is None:
            return None
        lo, hi = win
        inside = [(max(s, lo), min(e, hi), n) for s, e, n in device
                  if e > lo and s < hi]
        busy = merged((s, e) for s, e, _ in inside)
        kernels: Dict[str, List[float]] = {}
        by_name: Dict[str, float] = {}
        for s, e, n in inside:
            kernels.setdefault(n, []).append((e - s) / 1e6)
            by_name[n[:80]] = by_name.get(n[:80], 0.0) + (e - s) / 1e6
        gaps = label_gaps(idle_gaps(busy, lo, hi), host)
        return {"busy_s": union_length(busy) / 1e6,
                "window_s": (hi - lo) / 1e6,
                "kernels": kernels,
                "breakdown": {"device_ops": top(by_name),
                              "idle_gaps": top(gaps)}}
