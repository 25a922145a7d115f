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

The external-memory pipelines (``terasort_pipeline``,
``groupby_pipeline``, ``join_pipeline``) stream a dataset of ten times a
memory budget through spill, the staging pool's byte accounting and
waved reads; they report a :class:`WorkloadReport` (per-:data:`PHASES`
walls, :class:`PhaseWalls`). This module holds what they share: the
budget valve :class:`MemoryBudget`, the budget-derived conf
:func:`workload_conf_overrides`, the ``WORKLOADS`` registry with
:func:`run_workload`, and the order-free key digest
:func:`sampled_key_digest`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["PHASES", "WorkloadReport", "PhaseWalls", "MemoryBudget",
           "workload_conf_overrides", "WORKLOADS", "run_workload",
           "sampled_key_digest"]

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
    ``warm_programs`` stay 0: eager PyTorch compiles no step programs;
    ``replays`` stays 0: the port has no fault replay yet."""

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


class MemoryBudget:
    """The force-spill valve of chunked ingest.

    ``spill.threshold`` bounds ONE writer's staging; many writers can
    still sum past the budget before any crosses it. After every ingest
    chunk the pipelines call :meth:`maybe_spill`: when the staging
    pool's bytes in use reach ``watermark × budget``, every writer's
    staged batches move to its spill files now
    (``MapOutputWriter.spill()``, the same sealed ``SpillFiles`` path),
    returning their pool buffers."""

    def __init__(self, pool, budget_bytes: int, watermark: float = 0.5):
        if budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be positive, got {budget_bytes}")
        self.pool = pool
        self.budget_bytes = int(budget_bytes)
        self.watermark = float(watermark)
        self.forced_spills = 0
        self.forced_bytes = 0

    def over_watermark(self) -> bool:
        in_use = self.pool.stats()["in_use_bytes"]
        return in_use >= self.watermark * self.budget_bytes

    def maybe_spill(self, writers) -> int:
        """Force-spill every writer's staged batches when the pool's
        bytes in use crossed the line; returns the bytes moved."""
        if not self.over_watermark():
            return 0
        moved = 0
        for w in writers:
            moved += w.spill()
        if moved:
            self.forced_spills += 1
            self.forced_bytes += moved
        return moved


def workload_conf_overrides(budget_bytes: int, *, num_mappers: int = 8,
                            width_words: int = 6, wave_depth: int = 2,
                            num_shards: int = 8) -> Dict[str, str]:
    """Budget-derived conf for an external-memory pipeline: a per-writer
    spill threshold of ``budget / (4 × mappers)`` (all writers staged at
    once stay under a quarter of the budget before the valve engages)
    and ``a2a.waveRows`` sized so the waved read's pinned pack blocks
    (``depth × shards × waveRows × width × 4 B``) stay under a quarter
    too. ``num_shards`` is the node's (the JAX package fixes it at its
    8-device mesh)."""
    per_writer = max(64 << 10, budget_bytes // (4 * num_mappers))
    wave_rows = max(1024, budget_bytes
                    // (4 * wave_depth * num_shards * width_words * 4))
    return {
        "spark.shuffle.tpu.spill.threshold": str(per_writer),
        "spark.shuffle.tpu.a2a.waveRows": str(wave_rows),
        "spark.shuffle.tpu.a2a.waveDepth": str(wave_depth),
    }


def run_workload(name: str, *, budget_mb: float = 16.0,
                 scale: float = 1.0, seed: int = 0,
                 conf_overrides: Optional[Dict[str, str]] = None,
                 device=None, num_shards: int = 8,
                 **kwargs) -> WorkloadReport:
    """Run one registered pipeline end to end on a node of its own
    (``device``: the CUDA device unless ``"cpu"``; the port's node is
    not a process singleton, so each call builds and closes one).
    ``scale`` multiplies the ten-times-budget default dataset; the conf
    comes from the budget (:func:`workload_conf_overrides`) with
    ``conf_overrides`` on top."""
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.runtime.node import Node
    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager

    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(WORKLOADS.keys())}")
    budget_bytes = int(budget_mb * (1 << 20))
    conf_map = workload_conf_overrides(budget_bytes, num_shards=num_shards)
    conf_map.update(conf_overrides or {})
    conf = ShuffleConf(conf_map, use_env=False)
    node = Node.start(conf, device=device, num_shards=num_shards)
    manager = ShuffleManager(node, conf)
    try:
        return WORKLOADS[name](manager, budget_bytes=budget_bytes,
                               scale=scale, seed=seed, **kwargs)
    finally:
        manager.stop()
        node.close()


def _program_count() -> int:
    """Step programs compiled so far: always 0. Eager PyTorch compiles
    nothing per shape, so the pipelines' ``programs`` and
    ``warm_programs`` (the JAX package's zero-warm-recompile gates) are
    0 by construction, not by measurement."""
    return 0


def _spill_counters(metrics) -> tuple:
    """(``shuffle.spill.bytes``, ``shuffle.spill.count``) of a node's
    metrics."""
    from sparkucx_tpu_torch.utils.metrics import C_SPILL_BYTES, C_SPILL_COUNT
    return int(metrics.get(C_SPILL_BYTES)), int(metrics.get(C_SPILL_COUNT))


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


# the pipelines import this module's names, so they load after them
from sparkucx_tpu_torch.workloads.groupby import groupby_pipeline  # noqa: E402
from sparkucx_tpu_torch.workloads.join import join_pipeline  # noqa: E402
from sparkucx_tpu_torch.workloads.terasort import (  # noqa: E402
    terasort_pipeline)

WORKLOADS = {"terasort": terasort_pipeline, "groupby": groupby_pipeline,
             "join": join_pipeline}
