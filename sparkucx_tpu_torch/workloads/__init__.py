"""Analytics workloads on the port — the queries the shuffle serves.

Each runner drives one Spark-style job through a
:class:`~sparkucx_tpu_torch.shuffle.manager.ShuffleManager` (``svc.manager``
of :func:`~sparkucx_tpu_torch.connect`) with the calls an engine makes
(``register_shuffle``, ``get_writer``, ``read``, ``partition(s)``,
``unregister_shuffle``) and checks its own answer against a host oracle:
TeraSort (:mod:`.terasort`), GroupBy (:mod:`.groupby`), WordCount over
ids and over text (:mod:`.wordcount`), PageRank (:mod:`.pagerank`), ALS
(:mod:`.als`), transitive closure (:mod:`.tc`), TPC-DS q23's semi-join
(:mod:`.q23`) and the skewed and varchar repartition joins
(:mod:`.join`). Keyword arguments, defaults, returned dicts and the
messages of the ``AssertionError`` a runner raises are the JAX package's,
so the same call gives the same dict in both packages. Where the JAX
runner's oracle is a Python loop or a dense matrix that cannot run at a
deployment's size, the runner here computes the same oracle with
vectorised numpy.

This module holds the pieces the external-memory pipelines report with
(:data:`PHASES`, :class:`WorkloadReport`, :class:`PhaseWalls`) and the
order-free key digest :func:`sampled_key_digest`. The pipelines
themselves and what only they use — ``MemoryBudget``,
``workload_conf_overrides``, the ``WORKLOADS`` registry and
``run_workload`` — wait for the port of spill, the pool statistics and
the waved pipelines.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["PHASES", "WorkloadReport", "PhaseWalls", "sampled_key_digest"]

# the canonical phase vocabulary — the WorkloadReport walls and the
# workload.phase.ms labels speak it (ingest = generation + staging,
# spill = disk moves, exchange = the reads, merge = cross-run merging,
# emit = verification + egress)
PHASES = ("ingest", "spill", "exchange", "merge", "emit")


@dataclass
class WorkloadReport:
    """The rows/s contract of one analytics pipeline run.

    ``phases`` holds wall ms per phase (the spill wall is the part of
    ingest spent moving staged bytes to disk, not counted again inside
    ``ingest``); ``rows_per_s`` divides the dominant row count by each
    phase wall and by the total. ``oracle`` names the verification that
    ran (``exact``, or ``digest``: the order-invariant sampled key
    digest plus structural invariants). ``backend`` names the torch
    device type the run used (``cuda`` or ``cpu``). ``programs`` and
    ``warm_programs`` stay 0: eager PyTorch compiles no step programs."""

    workload: str
    rows_in: int = 0
    rows_out: int = 0
    bytes_in: int = 0
    budget_bytes: int = 0
    scale_ratio: float = 0.0          # bytes_in / budget_bytes
    spill_bytes: int = 0
    spill_count: int = 0
    pool_peak_bytes: int = 0
    phases: Dict[str, float] = field(default_factory=dict)    # ms
    rows_per_s: Dict[str, float] = field(default_factory=dict)
    wall_ms: float = 0.0
    programs: int = 0
    warm_programs: int = 0
    exchanges: int = 0
    waves: int = 0
    replays: int = 0
    oracle: str = "exact"
    oracle_ok: bool = False
    backend: str = ""
    extra: Dict = field(default_factory=dict)

    def finalize(self, rows: int) -> None:
        """Fill the derived rate fields from the accumulated walls."""
        self.wall_ms = sum(self.phases.values())
        self.rows_per_s = {
            ph: round(rows / (ms / 1e3), 1) if ms > 0 else 0.0
            for ph, ms in self.phases.items()}
        if self.wall_ms > 0:
            self.rows_per_s["total"] = round(
                rows / (self.wall_ms / 1e3), 1)
        if self.budget_bytes:
            self.scale_ratio = round(self.bytes_in / self.budget_bytes, 2)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)


class PhaseWalls:
    """Accumulates per-phase walls and publishes them as the labeled
    ``workload.phase.ms`` counters. One instance per pipeline run;
    ``phase(name)`` is a re-enterable context manager."""

    def __init__(self, workload: str, metrics=None):
        self.workload = workload
        self.ms: Dict[str, float] = {ph: 0.0 for ph in PHASES}
        self._metrics = metrics

    class _Span:
        def __init__(self, walls: "PhaseWalls", name: str):
            self._w, self._name = walls, name

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._w.ms[self._name] = self._w.ms.get(self._name, 0.0) \
                + (time.perf_counter() - self._t0) * 1e3
            return False

    def phase(self, name: str) -> "PhaseWalls._Span":
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; want one of "
                             f"{PHASES}")
        return self._Span(self, name)

    def add(self, name: str, ms: float) -> None:
        """Fold an externally timed wall in (e.g. a report's
        ``merge_ms``)."""
        self.ms[name] = self.ms.get(name, 0.0) + float(ms)

    def publish(self, rows: int) -> None:
        """Counters: workload.rows{workload=} + workload.phase.ms
        {workload=,phase=} (plus the unlabeled totals). Cumulative, so
        repeat runs in one process accumulate like every other
        counter."""
        if self._metrics is None:
            return
        from sparkucx_tpu_torch.utils.metrics import (C_WORKLOAD_PHASE_MS,
                                                      C_WORKLOAD_ROWS,
                                                      labeled)
        self._metrics.inc(C_WORKLOAD_ROWS, float(rows))
        self._metrics.inc(labeled(C_WORKLOAD_ROWS,
                                  workload=self.workload), float(rows))
        for ph, ms in self.ms.items():
            if ms <= 0.0:
                continue
            self._metrics.inc(C_WORKLOAD_PHASE_MS, ms)
            self._metrics.inc(labeled(C_WORKLOAD_PHASE_MS,
                                      workload=self.workload, phase=ph),
                              ms)


def sampled_key_digest(keys: np.ndarray, stride: int = 1) -> tuple:
    """(digest, count) of the value-sampled key multiset. Sampling is BY
    VALUE (rows whose splitmix64 mix lands in the 1/stride residue
    class), never by position, so the digest is invariant under every
    reorder the shuffle performs and the emit side samples exactly the
    rows the ingest side did. ``stride=1`` digests every row. Sums are
    mod 2**64 — order-free, split-free."""
    from sparkucx_tpu_torch.shuffle.integrity import _mix64, digest_sum
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if stride > 1:
        mixed = _mix64(keys.view(np.uint64))
        keys = keys[mixed % np.uint64(stride) == 0]
    return digest_sum(keys, None), int(keys.shape[0])
