"""Shuffle doctor: a rule engine that turns telemetry into graded
findings (the JAX package's ``utils/doctor.py``, with the same rules,
thresholds and finding texts, so both packages' doctors give equal
findings on one document).

Rules read local or gathered snapshot documents and emit
:class:`Finding`\\ s, graded info/warn/critical, with the evidence values
and the conf key to turn.

Inputs are the canonical snapshot documents everything else already
produces (``export.collect_snapshot``, periodic dumps, flight postmortems,
``manager.gather_reports``) — one doc for a process-local diagnosis, a
list of docs for a cluster-wide one. Histograms aggregate exactly across
processes (``Histogram.from_snapshot`` + ``merge`` — same fixed bucket
ladder everywhere), counters sum, and exchange reports concatenate with
process attribution, so a rule never has to care whether it is looking at
one process or thirty-two.

Rules (each names its remediation conf key):

================  =======================================  =====================================
rule              fires on                                 conf key
================  =======================================  =====================================
straggler_peer    per-peer bytes / per-process group_ms    spark.shuffle.tpu.network.timeoutMs
                  outlier vs cluster median; warmup
                  (compile-bearing) reads are excluded
                  via the first_wait split
partition_skew    ExchangeReport skew_ratio                spark.shuffle.tpu.a2a.capacityFactor
retry_storm       failure.retry.ms observation count       spark.shuffle.tpu.failure.maxAttempts
compile_churn     step-cache miss ratio                    spark.shuffle.tpu.a2a.capBucketGrowth
pool_pressure     arena in_use vs allocated watermark      spark.shuffle.tpu.memory.preAllocateBuffers
overflow_loop     overflow retries despite the cap hint    spark.shuffle.tpu.a2a.capacityFactor
cold_start        first_wait p50 ≫ steady-state wait p50   spark.shuffle.tpu.compile.cacheEnabled
pipeline_stall    waved reads where the per-wave pack      spark.shuffle.tpu.a2a.waveRows
                  outruns the collective it should hide
                  behind (wait-gap ≈ 0 while packs cost)
hbm_pressure      devmon HBM in-use sampled near the       spark.shuffle.tpu.a2a.waveRows
                  device limit (per-device gauges from
                  runtime/devmon.py)
bw_underutil...   steady-state achieved collective bw      spark.shuffle.tpu.a2a.waveDepth
                  p50 ≪ the best bw the SAME link
                  demonstrated, while the collective
                  dominates the exchange wall
padding_waste     ExchangeReport pad_ratio (wire bytes /   spark.shuffle.tpu.a2a.impl
                  real payload bytes, plan.RaggedLayout)
                  over threshold with a min-wire-bytes
                  floor — the transport ships padded
                  caps, not real bytes
wire_dequant...   int8-wire exchanges whose sampled        spark.shuffle.tpu.a2a.wire
                  dequantization-error estimate (relative
                  RMS vs the payload, shuffle/wire.py)
                  sits over threshold with a min-payload
                  floor — the lossy tier is rounding away
                  signal (outlier-dominated rows)
block_corrupt...  checksum verification caught corrupt     spark.shuffle.tpu.integrity.verify
                  blocks (pack-time staged verify, full-
                  level digest mismatch, or ledger-scan
                  quarantine) — warn at one block,
                  critical past the corrupt-counter floor
                  or on any quarantine
host_roundtrip    a device-sink-capable consumer ran a     spark.shuffle.tpu.read.sink
                  compiled step over RE-UPLOADED bytes:
                  host-sink reads drained payload D2H
                  (report d2h_bytes, min-bytes floor)
                  while the consumer pushed bytes back
                  H2D (shuffle.consume.h2d.bytes) — the
                  round-trip read.sink=device deletes
sink_fallback     reads that ASKED for the device sink     spark.shuffle.tpu.read.sink
                  landed on host (shuffle.sink.fallback.
                  count, labeled {mode, reason}) — the
                  finding names WHICH read modes
                  (plain/ordered/combine) fell back and
                  why (distributed/hierarchical/conf-
                  pinned); the device sink is legal for
                  all four modes single-process
kernel_fallback   reads that ASKED for the blocked        spark.shuffle.tpu.read.mergeImpl
                  pallas kernels ran jnp/XLA instead
                  (shuffle.kernel.fallback.count,
                  labeled {reason}) — the capability
                  gate refused (backend_unsupported /
                  subword_dtype); 'auto' resolving to
                  jnp off-TPU is clean and never fires
slo_burn          a declared objective (utils/slo.py)      spark.shuffle.tpu.slo.read.p99Ms
                  is burning its error budget over the
                  retained history windows — critical on
                  a fast burn (page-now), warn on a slow
                  one; names the tenant, the objective
                  key and the burn multiple, and uses
                  per-tenant admit/cross-grant evidence
                  so client self-backpressure is not
                  blamed on the engine (the tenant-labeled
                  discriminator discipline)
latency_trend     windowed read-wait p99 is drifting up    spark.shuffle.tpu.trace.enabled
                  vs the retained baseline windows,
                  payload-NORMALIZED (bytes/read ratio
                  divides the drift) so a load shift is
                  not misread as a regression — the "is
                  it getting worse right now" rule
dark_time         the anatomy conservation audit            spark.shuffle.tpu.trace.capacity
                  (utils/anatomy.py) left a material        (ring drops) /
                  share of the settled exchange walls       spark.shuffle.tpu.trace.enabled
                  attributed to no phase; evidence is
                  the worst exchange's uncovered
                  intervals, and a non-zero
                  trace.spans.dropped counter redirects
                  blame from instrumentation to ring
                  capacity
phase_regression  ONE canonical phase's windowed           per phase (anatomy._PHASE_CONF —
                  ms-per-read is drifting vs baseline,     e.g. merge -> read.mergeImpl,
                  payload-normalized like latency_trend    admission_wait -> a2a.maxBytesInFlight)
                  — names WHICH phase is eating the
                  wall and the knob that moves it
decision_split    the decision-ledger auditor              per topic (_DESYNC_CONF — e.g.
                  (shuffle/decisions.py) aligned peers'    hier.* -> a2a.capacityFactor);
                  ledgers by (epoch, seq) and found a      decisions.enabled when the audit
                  round that closed with different         is partial (missing ledgers)
                  topics/winners/proposals across peers
                  — catches the SILENT split a named
                  reduce (min/max/sum) settles without
                  raising; no floor, always critical
slow_proposer     one process is consistently the last     spark.shuffle.tpu.failure.
                  header to arrive across agreement        collectiveTimeoutMs
                  rounds (per-peer send-stamp lag in
                  every ledger record) — floors: min
                  audited rounds, min ms lag, dominance
                  share
================  =======================================  =====================================

Three rules read telemetry the port does not produce, and stay quiet on
its documents: ``compile_churn`` (``compile.step.*``: the port compiles
nothing per shape, so the names live here and not in ``utils/metrics``),
``kernel_fallback`` (``shuffle.kernel.fallback.count``: a kernel asked for
on the card runs or raises) and ``peer_unresponsive`` (the fleet scrape's
metadata, which no port document carries yet). All three fire on the
JAX package's documents as they do there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Union

from sparkucx_tpu_torch.utils.metrics import (C_ADMIT_BYTES,
                                              C_AGREE_DIVERGENCE,
                                              C_AGREE_ROUNDS,
                                              C_D2H, C_H2D,
                                              C_KERNEL_FALLBACK,
                                              C_PHASE_MS,
                                              C_SINK_FALLBACK,
                                              C_INTEGRITY_CORRUPT,
                                              C_INTEGRITY_CORRUPT_BLOCKS,
                                              C_INTEGRITY_QUARANTINED,
                                              C_INTEGRITY_VERIFIED,
                                              C_PEER_TIMEOUT, C_PROBE_DEAD,
                                              C_REPLAYS, C_TRACE_DROPPED,
                                              G_HBM_IN_USE, G_HBM_LIMIT,
                                              H_ADMIT_CROSS, H_ADMIT_WAIT,
                                              H_BW, H_FETCH_FIRST,
                                              H_FETCH_WAIT, H_RETRY_MS,
                                              H_WAVE_GAP, Histogram,
                                              labeled, parse_labeled)

# the JAX package's step-cache counters (compile_churn reads them); the
# port compiles nothing per shape and never counts them
COMPILE_PROGRAMS = "compile.step.programs"
COMPILE_HITS = "compile.step.hits"
COMPILE_SECONDS = "compile.step.seconds"

GRADES = ("info", "warn", "critical")
_GRADE_ORDER = {g: i for i, g in enumerate(GRADES)}


@dataclass
class Finding:
    """One graded diagnosis: what fired, the evidence values that made it
    fire, and the remediation knob. ``trace_ids`` link back to the
    exchanges involved — the same ids on the timeline tracks and in
    flight-ring events."""

    rule: str
    grade: str                     # info | warn | critical
    summary: str
    evidence: Dict[str, Any] = field(default_factory=dict)
    conf_key: Optional[str] = None
    remediation: str = ""
    trace_ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        if self.grade not in GRADES:
            raise ValueError(f"grade {self.grade!r} not in {GRADES}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class Thresholds:
    """Rule trip points. Deliberately conservative defaults: a healthy
    cluster must diagnose CLEAN (the zero-findings golden test), so every
    rule pairs its ratio with a minimum-signal floor."""

    straggler_ratio: float = 3.0       # outlier vs cluster median
    straggler_min_ms: float = 50.0     # ignore sub-noise group_ms spreads
    straggler_min_reads: int = 4       # wait-histogram signal floor
    skew_warn: float = 4.0             # ExchangeReport.skew_ratio
    skew_critical: float = 16.0
    retry_warn: int = 3                # failure.retry.ms observations
    retry_critical: int = 10
    churn_min_programs: int = 4        # below this, compiles are startup
    churn_miss_ratio: float = 0.5      # programs / (programs + hits)
    pool_pressure_ratio: float = 0.9   # in_use / allocated
    pool_min_allocated: int = 8        # tiny pools are never "pressure"
    overflow_warn_exchanges: int = 2   # hint should have absorbed by then
    cold_start_ratio: float = 10.0     # first_wait p50 / wait p50
    stall_min_waves: int = 3           # pipeline verdicts need a few waves
    stall_min_pack_ms: float = 2.0     # sub-noise packs are never a stall
    stall_wait_frac: float = 0.25      # wait p50 below this x pack p50
    #                                    = the collective finished early
    hbm_warn_ratio: float = 0.90       # sampled in_use / limit
    hbm_critical_ratio: float = 0.97
    hbm_min_limit_bytes: float = 64e6  # toy/virtual devices never "press"
    bw_min_exchanges: int = 6          # bw verdicts need a distribution
    bw_ratio: float = 4.0              # best observed bw / p50
    bw_min_gbps: float = 0.05          # below this the link never showed
    #                                    real throughput — timing noise on
    #                                    tiny exchanges, not utilization
    # peer_timeout: the watchdog (failure.collectiveTimeoutMs) declared a
    # collective dead. ONE expiry is already a finding — a hang the fence
    # converted into a typed error is never noise — critical once
    # expiries repeat or the probe confirmed dead devices.
    peer_timeout_critical: int = 3
    # replay_storm: exchanges burning their replay budget. A single
    # replay is the policy doing its job (quiet); repeated replays mean
    # the fault is persistent and failfast + operator attention beats
    # silently re-running (half the default failure.replayBudget=2 per
    # the report-window rule, summed across the retained reports).
    replay_warn: int = 2
    replay_critical: int = 4
    # padding_waste: wire bytes / real payload bytes (plan.RaggedLayout).
    # A P=8 dense exchange at the default capacityFactor pays ~16x even
    # perfectly balanced — warn territory (the ragged-capable transport
    # is the fix); critical is reserved for skew-amplified waste (regrown
    # caps multiplying the padded wire). The min-wire floor keeps tiny
    # test exchanges out (ratios need a signal floor).
    pad_warn_ratio: float = 4.0
    pad_critical_ratio: float = 32.0
    pad_min_wire_bytes: float = 1e6
    # wire_dequant_error: sampled relative-RMS loss of the int8 wire
    # tier (ExchangeReport.wire_dequant_error, shuffle/wire.py). A
    # well-conditioned payload estimates ~0.005 regardless of magnitude
    # (the per-row scale absorbs it) — warn starts at 10x that, critical
    # where a quarter of the signal energy is rounding noise. The
    # min-payload floor keeps tiny test exchanges out (the ratio+
    # floor discipline).
    dequant_warn_rel: float = 0.05
    dequant_critical_rel: float = 0.25
    dequant_min_payload_bytes: float = 1e6
    # host_roundtrip: a device-sink-capable consumer (something pushed
    # bytes BACK to device after a host drain — the h2d counter only
    # moves when a consumer re-uploads) ran over host-sink reads that
    # paid real payload D2H. The min-bytes floor keeps tiny test reads
    # out (the ratio+floor discipline); critical when the
    # round-trip volume says the job is paying a PCIe/DMA tax on every
    # exchange, or it repeats across several reads.
    roundtrip_min_bytes: float = 1e6
    roundtrip_critical_bytes: float = 64e6
    roundtrip_critical_reads: int = 3
    # sink_fallback: reads that ASKED for the device sink resolved to
    # host (manager._resolve_sink: distributed / hierarchical / conf-
    # pinned). One fallback is already a finding — an explicit intent
    # mismatch is never noise, and the warn-once log line used to
    # be the only evidence — but it stays a WARN (the read still ran,
    # correctly, on host); critical once the mismatch repeats enough to
    # say a steady consumer path is paying the round-trip every read.
    sink_fallback_critical: int = 8
    # kernel_fallback: reads that ASKED for the blocked pallas kernels
    # (read.mergeImpl=pallas) resolved to the jnp/XLA path instead
    # (segmented.resolve_kernel_impl: backend_unsupported /
    # subword_dtype). Same posture as sink_fallback: one explicit
    # intent mismatch is already a finding (the warn-once log line used
    # to be the only evidence) but it stays a WARN — the read still ran
    # bit-identically on the oracle path; critical once the mismatch
    # repeats enough to say a steady consumer is paying the slower
    # kernel every read. 'auto' resolving to jnp off-TPU never counts.
    kernel_fallback_critical: int = 8
    # block_corruption: checksum verification (integrity.verify) caught
    # blocks whose bytes no longer match their commit records, or the
    # restart ledger quarantined blocks. ONE detected corruption is
    # already a warning — the verifier filtered the noise by
    # construction (the peer_timeout posture); the corrupt-counter
    # floor below is the CRITICAL line: repeated corruptions (or any
    # quarantine) mean rotting storage/memory, not a one-off flip.
    corruption_critical_blocks: int = 3
    # quota_starvation: one tenant's admission wait dwarfs its own
    # exchange wall while another tenant holds more than its fair share
    # of granted admission bytes. Signal floors per the ratio+floor discipline:
    # a starved verdict needs real waits (min ms + min admissions) and
    # the hog needs real volume (min granted bytes) before a ratio can
    # fire; ``quota_share`` is the granted-byte share past which a
    # tenant counts as hogging (with >= 2 tenants active).
    # cross-grants: how many admission grants OTHER tenants received
    # while a ticket of this tenant waited (shuffle.admit.cross_grants
    # histogram). THE starvation discriminator: a tenant queueing behind
    # its own serialized reads observes ~0 regardless of how long it
    # waits; a tenant parked behind a neighbor's flood observes the
    # flood's length. Fair-share admission bounds it near the
    # interleave ratio (a handful); strict-FIFO behind a whale queue
    # sends it to the queue depth.
    quota_cross_grants: float = 8.0
    quota_cross_critical: float = 24.0
    # the wait floor is deliberately high (~a third of a second):
    # exchanges are ms-scale, and admission waits below this are
    # ordinary backpressure, whoever caused them
    quota_min_wait_ms: float = 300.0
    quota_min_admits: int = 3          # labeled admit histogram floor
    quota_share: float = 0.6           # hog's share of granted bytes
    quota_min_bytes: float = 1e6       # total granted-byte floor
    # slow_tier: one fabric tier of the hierarchical exchange straggles
    # beyond its byte share (ExchangeReport.tiers phase spans). The
    # imbalance is byte-share-NORMALIZED — DCN legitimately carrying
    # more padded bytes than ICI is structure, not a straggler — and
    # floored (steady reads only, min wall, min agreeing reads) per
    # the ratio+floor discipline. Critical when the imbalance is extreme or
    # the same tier keeps straggling.
    tier_ratio: float = 4.0
    tier_critical_ratio: float = 12.0
    tier_min_ms: float = 25.0
    tier_min_reads: int = 2
    # latency_trend: the retained-history drift rule. Recent windows'
    # merged read-wait p99 vs the BASELINE windows before them,
    # payload-normalized (recent bytes/read over baseline bytes/read
    # divides the drift — bigger reads are slower by structure, not by
    # regression). Floors per the ratio+floor discipline: both windows need
    # real read counts and the recent p99 must clear the noise floor;
    # the warn ratio is 3x because the log-bucket ladder resolves ~9%
    # and CPU scheduling jitter alone can double a small p99.
    trend_recent_frames: int = 3
    trend_min_frames: int = 6          # recent + a real baseline
    trend_min_reads: int = 8           # per window side
    trend_min_ms: float = 5.0
    trend_ratio: float = 3.0
    trend_critical_ratio: float = 10.0
    # spill_bound: an analytics workload's wall is dominated by spill
    # I/O instead of the exchange/merge planes it exists to exercise
    # (workload.phase.ms{workload,phase} counters from workloads/
    # PhaseWalls). Shares are over the spill+exchange+merge triple —
    # ingest/emit are generation/verification and say nothing about
    # the engine. Floors per the ratio+floor discipline: a real wall and real
    # rows before any share can fire; exchange-dominant is the healthy
    # shape and stays quiet.
    spill_share_warn: float = 0.4
    spill_share_critical: float = 0.7
    spill_min_wall_ms: float = 500.0
    spill_min_rows: float = 1000.0
    # dark_time: the anatomy plane's conservation audit residual
    # (utils/anatomy.py — exchange wall minus every swept phase
    # interval) as a share of the settled walls. A healthy instrumented
    # exchange attributes >= 95%; warn when the unattributed share says
    # the phase story is incomplete, critical when most of the wall is
    # dark (the operator is flying blind on where time goes). Floors
    # per the ratio+floor discipline: real wall and more than one settled
    # read before any share can fire.
    dark_share_warn: float = 0.15
    dark_share_critical: float = 0.40
    dark_min_wall_ms: float = 25.0
    dark_min_reads: int = 2
    # phase_regression: one canonical phase's windowed ms-per-read is
    # drifting up vs the retained baseline windows, payload-normalized
    # like latency_trend (shuffle.phase.ms{phase=} counters from
    # anatomy settlement). Reuses the trend frame/read floors; the ms
    # floor is per recent-window phase wall per read.
    phase_trend_min_ms: float = 5.0
    phase_trend_ratio: float = 3.0
    phase_trend_critical: float = 10.0
    # clock_drift: a peer's scrape-time re-anchor drifted off its boot
    # anchor (utils/collector.py ``skew_s`` — the wall↔perf pair moved,
    # i.e. the wall clock stepped / NTP slewed hard / perf drifted).
    # Timelines stay exact (they re-anchor per scrape, the satellite);
    # the finding is about TRUST in cross-process ordering: past the
    # warn floor, "peer A finished before B" claims from boot anchors
    # are wrong by more than scheduling noise. Floors per the ratio+floor
    # discipline: a real skew estimate must exist, and sub-quarter-
    # second drift is ordinary NTP housekeeping.
    clock_drift_warn_s: float = 0.25
    clock_drift_critical_s: float = 5.0
    # desync: cross-process agreement divergence (shuffle/agreement.py
    # — the epoch-scoped agree() primitive every distributed control
    # decision rides). NO noise floor, the peer_timeout posture: ONE
    # divergence is already a finding — processes proposed different
    # values for the same deterministic decision, which is a conf split
    # or broken SPMD discipline, never load noise. Critical once it
    # repeats: the disagreement is systematic, not a one-off race.
    desync_critical: int = 2
    # decision_split: the decision-ledger auditor (shuffle/decisions.py
    # audit_round over per-peer ledgers aligned by (epoch, seq)) found
    # peers that closed the SAME round with different topics, winners,
    # or — the silent case agree()'s reducers never surface — different
    # proposals under a named reduce (min/max/sum settle without a
    # unanimity check, so a conf split just silently loses). NO noise
    # floor, the desync posture: one split round is already broken SPMD
    # discipline. Always critical — by the time the auditor sees it the
    # fleet has already acted on divergent inputs.
    # slow_proposer: per-peer header-round arrival lag (the send stamps
    # every agree() header carries) says ONE peer is consistently the
    # last to arrive across many rounds — the agreement plane's
    # straggler attribution. Floors per the ratio+floor discipline: enough
    # audited rounds to call it a pattern, a real ms lag (sub-ms is
    # scheduler noise), and a dominance share so a peer that is merely
    # sometimes-last stays unnamed.
    slow_proposer_min_rounds: int = 8
    slow_proposer_min_lag_ms: float = 5.0
    slow_proposer_share: float = 0.7


# -- snapshot normalization ------------------------------------------------
@dataclass
class ClusterView:
    """N per-process snapshot docs folded into one diagnosable view."""

    counters: Dict[str, float]
    histograms: Dict[str, Histogram]
    reports: List[Dict]            # each with "process_id" attribution
    pools: List[Dict]              # per-process arena stats, if present
    gauges: List[Dict] = field(default_factory=list)
    #                              # per-process {"process_id", "values"}
    #                              # — gauges are point-in-time, so they
    #                              # attribute, never sum
    # windowed history frames (utils/history.py), folded from every
    # process's ``history_frames`` — deltas within a time window SUM
    # across processes, so the trend/SLO rules just concatenate and
    # bucket by t_end. ``slo_objectives``/``slo_policy`` ride the docs
    # (the node stamps them), unioned by (key, tenant) / first-seen.
    frames: List[Dict] = field(default_factory=list)
    slo_objectives: List[Dict] = field(default_factory=list)
    slo_policy: Optional[Dict] = None
    processes: int = 1
    # fleet scrape metadata (utils/collector.fleet_meta): reachability,
    # staleness and clock skew per expected peer, present only when the
    # docs came from a ClusterCollector scrape — the fleet-aware rules
    # (peer_unresponsive, clock_drift) read it and stay quiet without.
    fleet: Optional[Dict] = None
    # decision-ledger records (shuffle/decisions.py) keyed by
    # process_id — per-peer separation is the POINT (the auditor aligns
    # peers' records by (epoch, seq) to catch split decisions), so
    # unlike counters these never fold together.
    decisions: Dict[int, List[Dict]] = field(default_factory=dict)


def _reports_of(doc: Dict) -> List[Dict]:
    """Exchange reports from any producer's schema: live snapshots carry
    ``exchange_reports``; flight postmortems nest them under
    ``contexts.exchange_reports`` (the provider key)."""
    reps = doc.get("exchange_reports")
    if reps is None:
        reps = (doc.get("contexts") or {}).get("exchange_reports")
    return [r for r in (reps or []) if isinstance(r, dict)]


def build_view(snapshots: Union[Dict, Iterable[Dict]],
               fleet: Optional[Dict] = None) -> ClusterView:
    """Normalize one doc or a list of per-process docs into a
    :class:`ClusterView`. Exact aggregation: histogram buckets add
    (same fixed ladder), counters sum, reports concatenate. Multiple
    captures of the SAME process (a dump dir holding its metrics
    snapshot AND its flight postmortem, each embedding the same
    cumulative registries) collapse to one first — summing them would
    silently halve every rule's threshold."""
    if isinstance(snapshots, dict):
        snapshots = [snapshots]
    from sparkucx_tpu_torch.utils.export import dedupe_process_docs
    docs = dedupe_process_docs(snapshots)
    counters: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    reports: List[Dict] = []
    pools: List[Dict] = []
    gauges: List[Dict] = []
    frames: List[Dict] = []
    objectives: List[Dict] = []
    decisions: Dict[int, List[Dict]] = {}
    seen_obj = set()
    policy = None
    for i, doc in enumerate(docs):
        pid = doc.get("process_id", doc.get("pid", i))
        for name, v in (doc.get("counters") or {}).items():
            counters[name] = counters.get(name, 0.0) + float(v)
        for name, snap in (doc.get("histograms") or {}).items():
            h = Histogram.from_snapshot(snap, name)
            if name in hists:
                hists[name].merge(h)
            else:
                hists[name] = h
        for r in _reports_of(doc):
            r = dict(r)
            r.setdefault("process_id", pid)
            reports.append(r)
        if isinstance(doc.get("pool"), dict):
            pools.append({"process_id": pid, **doc["pool"]})
        if isinstance(doc.get("gauges"), dict) and doc["gauges"]:
            gauges.append({"process_id": pid,
                           "values": dict(doc["gauges"])})
        # decision-ledger records keep per-process separation (the
        # auditor compares peers — folding would erase the split);
        # same-process duplicates union by the record's monotonic n
        recs = doc.get("decisions")
        if isinstance(recs, list) and recs:
            slot = decisions.setdefault(int(pid) if isinstance(
                pid, (int, float)) else i, [])
            seen_n = {r.get("n") for r in slot}
            slot.extend(r for r in recs if isinstance(r, dict)
                        and r.get("n") not in seen_n)
            slot.sort(key=lambda r: r.get("n", 0))
        for f in (doc.get("history_frames") or []):
            if isinstance(f, dict):
                f = dict(f)
                f.setdefault("process_id", pid)
                frames.append(f)
                if policy is None and isinstance(f.get("slo_policy"),
                                                 dict):
                    policy = f["slo_policy"]
        if policy is None and isinstance(doc.get("slo_policy"), dict):
            policy = doc["slo_policy"]
        for src in (doc.get("slo_objectives"),
                    *[f.get("slo_objectives")
                      for f in (doc.get("history_frames") or [])
                      if isinstance(f, dict)]):
            for o in (src or []):
                if not isinstance(o, dict):
                    continue
                k = (o.get("key"), o.get("tenant", ""))
                if k not in seen_obj:
                    seen_obj.add(k)
                    objectives.append(o)
    frames.sort(key=lambda f: f.get("t_end", 0.0))
    return ClusterView(counters, hists, reports, pools, gauges,
                       frames=frames, slo_objectives=objectives,
                       slo_policy=policy,
                       processes=max(1, len(docs)), fleet=fleet,
                       decisions=decisions)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _completed(view: ClusterView) -> List[Dict]:
    return [r for r in view.reports if r.get("completed")]


def _steady(reports: List[Dict]) -> List[Dict]:
    """Warmup-free reports: a read whose step-cache delta shows fresh
    programs paid XLA compile in-band (the H_FETCH_FIRST population) —
    its timings say nothing about peers and are excluded from every
    outlier rule."""
    return [r for r in reports if not r.get("stepcache_programs")]


# -- rules -----------------------------------------------------------------
def _rule_straggler(view: ClusterView, th: Thresholds) -> List[Finding]:
    out: List[Finding] = []
    steady = _steady(_completed(view))
    # (a) per-peer byte imbalance within an exchange: the overloaded peer
    # is the one every other process ends up waiting on
    worst = None
    for r in steady:
        pb = [float(x) for x in (r.get("peer_bytes") or []) if x >= 0]
        med = _median(pb)
        if len(pb) >= 2 and med > 0:
            ratio = max(pb) / med
            if worst is None or ratio > worst[0]:
                worst = (ratio, pb.index(max(pb)), r)
    if worst is not None and worst[0] >= th.straggler_ratio:
        ratio, peer, r = worst
        out.append(Finding(
            rule="straggler_peer",
            grade="critical" if ratio >= 2 * th.straggler_ratio
            else "warn",
            summary=(f"peer {peer} carries {ratio:.1f}x the median "
                     f"per-peer bytes in shuffle {r.get('shuffle_id')} "
                     f"— every other peer waits on it"),
            evidence={"peer": peer, "ratio": round(ratio, 2),
                      "peer_bytes": r.get("peer_bytes"),
                      "shuffle_id": r.get("shuffle_id")},
            conf_key="spark.shuffle.tpu.network.timeoutMs",
            remediation=("rebalance map placement so no peer stages a "
                         "multiple of the median; if the imbalance is "
                         "inherent, raise "
                         "spark.shuffle.tpu.network.timeoutMs so slow "
                         "exchanges fail soft, and consider "
                         "a2a.maxBytesInFlight backpressure"),
            trace_ids=[r.get("trace_id", "")]))
    # (b) cluster mode: one process's group (collective + regroup) phase
    # an outlier vs the cluster median for the SAME exchange
    by_trace: Dict[str, List[Dict]] = {}
    for r in steady:
        if r.get("trace_id"):
            by_trace.setdefault(r["trace_id"], []).append(r)
    for trace, rs in sorted(by_trace.items()):
        if len(rs) < 2:
            continue
        gms = [float(r.get("group_ms", 0.0)) for r in rs]
        med = _median(gms)
        mx = max(gms)
        if med > 0 and mx >= th.straggler_min_ms \
                and mx / med >= th.straggler_ratio:
            slow = rs[gms.index(mx)]
            out.append(Finding(
                rule="straggler_peer",
                grade="critical" if mx / med >= 2 * th.straggler_ratio
                else "warn",
                summary=(f"process {slow.get('process_id')} spent "
                         f"{mx:.0f} ms in exchange {trace} vs cluster "
                         f"median {med:.0f} ms — straggler host"),
                evidence={"process_id": slow.get("process_id"),
                          "group_ms": round(mx, 1),
                          "cluster_median_ms": round(med, 1),
                          "ratio": round(mx / med, 2)},
                conf_key="spark.shuffle.tpu.network.timeoutMs",
                remediation=("inspect that host (thermal/preemption/"
                             "network); remesh without it if persistent "
                             "— its timeline track shows where the "
                             "time went"),
                trace_ids=[trace]))
    # (c) wait-distribution spread as supporting evidence (warmup-free by
    # construction: compile-bearing reads observe into first_wait_ms)
    hw = view.histograms.get(H_FETCH_WAIT)
    if hw is not None and hw.count >= th.straggler_min_reads:
        p50, p99 = hw.quantile(0.5), hw.quantile(0.99)
        if p50 > 0 and p99 / p50 >= th.straggler_ratio \
                and p99 >= th.straggler_min_ms:
            out.append(Finding(
                rule="straggler_peer", grade="info",
                summary=(f"fetch-wait p99 {p99:.0f} ms is "
                         f"{p99 / p50:.1f}x p50 {p50:.1f} ms over "
                         f"{hw.count} steady-state reads — intermittent "
                         f"slow exchanges"),
                evidence={"p50_ms": round(p50, 2), "p99_ms": round(p99, 2),
                          "reads": hw.count},
                conf_key="spark.shuffle.tpu.trace.enabled",
                remediation=("enable tracing and pull the merged "
                             "timeline (python -m sparkucx_tpu "
                             "timeline) to see which peer the slow "
                             "reads wait on")))
    return out


def _rule_skew(view: ClusterView, th: Thresholds) -> List[Finding]:
    worst = None
    for r in _completed(view):
        s = float(r.get("skew_ratio", 0.0))
        if worst is None or s > worst[0]:
            worst = (s, r)
    if worst is None or worst[0] < th.skew_warn:
        return []
    s, r = worst
    return [Finding(
        rule="partition_skew",
        grade="critical" if s >= th.skew_critical else "warn",
        summary=(f"shuffle {r.get('shuffle_id')}: hottest partition "
                 f"holds {s:.1f}x the mean rows "
                 f"({r.get('num_partitions')} partitions) — one shard "
                 f"serializes the exchange"),
        evidence={"skew_ratio": round(s, 2),
                  "shuffle_id": r.get("shuffle_id"),
                  "num_partitions": r.get("num_partitions"),
                  "partitioner": r.get("partitioner")},
        conf_key="spark.shuffle.tpu.a2a.capacityFactor",
        remediation=("repartition or salt the hot key; raising "
                     "spark.shuffle.tpu.a2a.capacityFactor buys headroom "
                     "(HBM for overflow retries) but does not fix the "
                     "imbalance"),
        trace_ids=[r.get("trace_id", "")])]


def _rule_retry_storm(view: ClusterView, th: Thresholds) -> List[Finding]:
    h = view.histograms.get(H_RETRY_MS)
    n = h.count if h is not None else 0
    if n < th.retry_warn:
        return []
    return [Finding(
        rule="retry_storm",
        grade="critical" if n >= th.retry_critical else "warn",
        summary=(f"{n} failed attempts burned "
                 f"{h.sum:.0f} ms in retry latency (p99 "
                 f"{h.quantile(0.99):.0f} ms) — the control plane is "
                 f"retrying its way through a persistent fault"),
        evidence={"retries": n, "total_ms": round(h.sum, 1),
                  "p50_ms": round(h.quantile(0.5), 2),
                  "p99_ms": round(h.quantile(0.99), 2)},
        conf_key="spark.shuffle.tpu.failure.maxAttempts",
        remediation=("find the faulting site in the flight ring (retry "
                     "events carry the trace id); if the fault is "
                     "genuinely transient, raise failure.backoffMs so "
                     "retries stop stampeding; lowering "
                     "failure.maxAttempts fails faster instead"))]


def _rule_compile_churn(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    programs = view.counters.get(COMPILE_PROGRAMS, 0.0)
    hits = view.counters.get(COMPILE_HITS, 0.0)
    total = programs + hits
    if programs < th.churn_min_programs or total <= 0:
        return []
    miss = programs / total
    if miss < th.churn_miss_ratio:
        return []
    secs = view.counters.get(COMPILE_SECONDS, 0.0)
    return [Finding(
        rule="compile_churn",
        grade="critical" if miss >= 0.8 else "warn",
        summary=(f"{programs:.0f} distinct exchange programs compiled "
                 f"vs {hits:.0f} cache hits ({miss:.0%} miss, "
                 f"{secs:.1f} s of compile) — plan shapes are churning "
                 f"the step cache"),
        evidence={"programs": int(programs), "hits": int(hits),
                  "miss_ratio": round(miss, 3),
                  "compile_seconds": round(secs, 2)},
        conf_key="spark.shuffle.tpu.a2a.capBucketGrowth",
        remediation=("raise spark.shuffle.tpu.a2a.capBucketGrowth (wider "
                     "capacity buckets, fewer distinct shapes) and keep "
                     "a2a.capBuckets on; the persistent compile cache "
                     "(compile.cacheEnabled) amortizes what remains "
                     "across processes"))]


def _rule_pool_pressure(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    out: List[Finding] = []
    for p in view.pools:
        allocated = float(p.get("allocated", 0))
        in_use = float(p.get("in_use", 0))
        prealloc = float(p.get("preallocated", 0))
        if allocated < th.pool_min_allocated:
            continue
        ratio = in_use / allocated if allocated else 0.0
        if ratio < th.pool_pressure_ratio:
            continue
        out.append(Finding(
            rule="pool_pressure",
            grade="warn",
            summary=(f"process {p.get('process_id')}: {in_use:.0f} of "
                     f"{allocated:.0f} arena blocks in use "
                     f"({ratio:.0%} high-watermark, {prealloc:.0f} "
                     f"preallocated) — the pinned pool is running at "
                     f"its ceiling"),
            evidence={"process_id": p.get("process_id"),
                      "in_use": int(in_use), "allocated": int(allocated),
                      "preallocated": int(prealloc),
                      "ratio": round(ratio, 3)},
            conf_key="spark.shuffle.tpu.memory.preAllocateBuffers",
            remediation=("preallocate the hot size classes "
                         "(memory.preAllocateBuffers=size:count,...) and "
                         "raise memory.minAllocationSize; if growth is "
                         "unbounded, cap concurrent exchanges with "
                         "a2a.maxBytesInFlight")))
    return out


def _rule_overflow_loop(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    over = [r for r in view.reports if int(r.get("retries", 0)) > 0]
    if len(over) < th.overflow_warn_exchanges:
        return []
    total = sum(int(r.get("retries", 0)) for r in over)
    return [Finding(
        rule="overflow_loop",
        grade="warn",
        summary=(f"{len(over)} exchanges paid {total} overflow retries "
                 f"(capacity growth + recompile) — the learned cap hint "
                 f"is not absorbing the skew"),
        evidence={"exchanges": len(over), "total_retries": total,
                  "shuffle_ids": sorted({r.get("shuffle_id")
                                         for r in over}),
                  "plan_buckets": [r.get("plan_bucket") for r in over]},
        conf_key="spark.shuffle.tpu.a2a.capacityFactor",
        remediation=("raise spark.shuffle.tpu.a2a.capacityFactor so the "
                     "first plan provisions the skewed shape; "
                     "a2a.capBucketGrowth > 1.25 also widens each "
                     "retry's jump"),
        trace_ids=sorted({r.get("trace_id", "") for r in over}))]


def _rule_cold_start(view: ClusterView, th: Thresholds) -> List[Finding]:
    hf = view.histograms.get(H_FETCH_FIRST)
    hw = view.histograms.get(H_FETCH_WAIT)
    if hf is None or hw is None or not hf.count or not hw.count:
        return []
    f50, w50 = hf.quantile(0.5), hw.quantile(0.5)
    if w50 <= 0 or f50 / w50 < th.cold_start_ratio:
        return []
    return [Finding(
        rule="cold_start",
        grade="info",
        summary=(f"compile-bearing reads cost {f50:.0f} ms p50 vs "
                 f"{w50:.1f} ms steady-state ({f50 / w50:.0f}x) across "
                 f"{hf.count} first reads — in-band XLA compile"),
        evidence={"first_wait_p50_ms": round(f50, 1),
                  "steady_p50_ms": round(w50, 2),
                  "first_reads": hf.count},
        conf_key="spark.shuffle.tpu.compile.cacheEnabled",
        remediation=("keep compile.cacheEnabled on (persistent cache "
                     "amortizes across restarts) and warmup() handles "
                     "while map tasks run so compile overlaps the map "
                     "phase"))]


def _rule_pipeline_stall(view: ClusterView,
                         th: Thresholds) -> List[Finding]:
    """Wave-pipelined reads (a2a.waveRows) where the host pack is the
    bottleneck: a drained wave's wait is ~zero (the collective finished
    long before it was forced — the device idled) while the steady-state
    packs cost real milliseconds. The wave wait-gap histogram
    (shuffle.wave.gap_ms) carries the same signal as a distribution."""
    worst = None
    for r in _completed(view):
        tl = r.get("wave_timeline") or []
        if int(r.get("waves", 0)) < th.stall_min_waves \
                or len(tl) < th.stall_min_waves:
            continue
        # wave 0's pack is never hidden by construction; judge the
        # steady-state tail only
        steady = tl[1:]
        p_pack = _median([float(t.get("pack_ms", 0.0)) for t in steady])
        p_wait = _median([float(t.get("wait_ms", 0.0)) for t in steady])
        if p_pack < th.stall_min_pack_ms:
            continue
        if p_wait > th.stall_wait_frac * p_pack:
            continue            # collective still outlives the pack
        ratio = p_pack / max(p_wait, 1e-6)
        if worst is None or ratio > worst[0]:
            worst = (ratio, p_pack, p_wait, r)
    if worst is None:
        return []
    ratio, p_pack, p_wait, r = worst
    ev = {"shuffle_id": r.get("shuffle_id"),
          "waves": int(r.get("waves", 0)),
          "wave_rows": int(r.get("wave_rows", 0)),
          "pack_p50_ms": round(p_pack, 2),
          "wait_p50_ms": round(p_wait, 2)}
    hg = view.histograms.get(H_WAVE_GAP)
    if hg is not None and hg.count:
        ev["gap_p50_ms"] = round(hg.quantile(0.5), 2)
        ev["gap_count"] = hg.count
    return [Finding(
        rule="pipeline_stall",
        grade="warn",
        summary=(f"shuffle {r.get('shuffle_id')}: wave packs "
                 f"(p50 {p_pack:.1f} ms) outrun the collective "
                 f"(drain wait p50 {p_wait:.2f} ms over "
                 f"{int(r.get('waves', 0))} waves) — the device idles "
                 f"between waves waiting on the host pack"),
        evidence=ev,
        conf_key="spark.shuffle.tpu.a2a.waveRows",
        remediation=("raise spark.shuffle.tpu.a2a.waveRows (bigger waves "
                     "amortize per-wave pack overhead) or raise "
                     "a2a.packThreads so the persistent pack executor "
                     "keeps up; if packs stay dominant, the shape is "
                     "host-bound — a2a.waveDepth > 2 buys nothing"),
        trace_ids=[r.get("trace_id", "")])]


def _rule_hbm_pressure(view: ClusterView,
                       th: Thresholds) -> List[Finding]:
    """Device-plane memory pressure: the devmon sampler saw a device's
    HBM in-use near its limit. The remediation is to stream — waves
    bound device buffers at depth x one wave instead of the whole
    shuffle — and to keep cap bucketing from over-provisioning. Quiet
    without devmon gauges (off by default) and on toy limits."""
    out: List[Finding] = []
    for g in view.gauges:
        vals = g["values"]
        per_dev: Dict[str, Dict[str, float]] = {}
        for key, v in vals.items():
            base, labels = parse_labeled(key)
            if labels is None or "device" not in labels:
                continue
            if base in (G_HBM_IN_USE, G_HBM_LIMIT):
                per_dev.setdefault(labels["device"], {})[base] = float(v)
        worst = None
        for dev, dv in sorted(per_dev.items()):
            in_use = dv.get(G_HBM_IN_USE)
            limit = dv.get(G_HBM_LIMIT)
            if not in_use or not limit \
                    or limit < th.hbm_min_limit_bytes:
                continue
            ratio = in_use / limit
            if ratio < th.hbm_warn_ratio:
                continue
            if worst is None or ratio > worst[0]:
                worst = (ratio, dev, in_use, limit)
        if worst is None:
            continue
        ratio, dev, in_use, limit = worst
        out.append(Finding(
            rule="hbm_pressure",
            grade="critical" if ratio >= th.hbm_critical_ratio
            else "warn",
            summary=(f"process {g.get('process_id')}: device {dev} HBM "
                     f"{in_use / 1e9:.2f} of {limit / 1e9:.2f} GB in "
                     f"use ({ratio:.0%}) — the next exchange's receive "
                     f"buffers may not fit"),
            evidence={"process_id": g.get("process_id"), "device": dev,
                      "in_use_bytes": int(in_use),
                      "limit_bytes": int(limit),
                      "ratio": round(ratio, 4)},
            conf_key="spark.shuffle.tpu.a2a.waveRows",
            remediation=("stream the read: set a2a.waveRows so device "
                         "buffers are bounded at waveDepth x one wave "
                         "instead of the whole shuffle; keep "
                         "a2a.capBuckets on with a modest "
                         "capBucketGrowth so capacities aren't "
                         "over-provisioned, and lower "
                         "a2a.capacityFactor if headroom is the "
                         "culprit")))
    return out


def _rule_bw_underutilization(view: ClusterView,
                              th: Thresholds) -> List[Finding]:
    """Achieved collective bandwidth (steady-state exchanges only — the
    manager keeps compile-bearing reads out of the histogram) sits far
    below what the SAME link already demonstrated: the self-referential
    roofline, usable without knowing the fabric's spec sheet. Fires only
    when the best observation shows real throughput (bw_min_gbps floor —
    tiny exchanges measure timing noise, not links) and carries the
    worst collective-dominated exchange as evidence when one is still in
    the report ring."""
    h = view.histograms.get(H_BW)
    if h is None or h.count < th.bw_min_exchanges:
        return []
    p50 = h.quantile(0.5)
    best = h.max
    if p50 <= 0 or best < th.bw_min_gbps or best / p50 < th.bw_ratio:
        return []
    ev = {"bw_p50_gbps": round(p50, 4), "bw_best_gbps": round(best, 4),
          "ratio": round(best / p50, 2), "exchanges": h.count}
    trace_ids: List[str] = []
    # supporting evidence: the slowest steady exchange where the
    # collective (group phase) dominated the wall — wait-bound, exactly
    # the shape deeper pipelining (waveDepth) or faster packs fix
    worst = None
    for r in _steady(_completed(view)):
        bw = float(r.get("bw_gbps", 0.0) or 0.0)
        gms = float(r.get("group_ms", 0.0))
        host = float(r.get("pack_ms", 0.0)) + float(
            r.get("dispatch_ms", 0.0))
        if bw <= 0 or gms <= 0 or gms < 2 * host:
            continue
        if worst is None or bw < worst[0]:
            worst = (bw, r)
    if worst is not None:
        bw, r = worst
        ev.update(worst_shuffle_id=r.get("shuffle_id"),
                  worst_bw_gbps=round(bw, 4),
                  worst_group_ms=round(float(r.get("group_ms", 0.0)), 1))
        if r.get("device_cost") and \
                r["device_cost"].get("model_bytes_gbps"):
            # the compile-time byte-movement model's rate for the same
            # dispatch (arxiv 2112.01075's roofline, where available)
            ev["worst_model_bytes_gbps"] = \
                r["device_cost"]["model_bytes_gbps"]
        if r.get("trace_id"):
            trace_ids.append(r["trace_id"])
    return [Finding(
        rule="bw_underutilization",
        grade="warn",
        summary=(f"steady-state collective bandwidth p50 "
                 f"{p50:.2f} GB/s is {best / p50:.1f}x below the "
                 f"{best:.2f} GB/s this link already demonstrated "
                 f"(over {h.count} exchanges) — the fabric is idling "
                 f"while exchanges wait"),
        evidence=ev,
        conf_key="spark.shuffle.tpu.a2a.waveDepth",
        remediation=("deepen the wave pipeline (a2a.waveDepth) so a "
                     "collective is always in flight, and raise "
                     "a2a.packThreads so host packs keep feeding it; "
                     "if slow exchanges correlate with one peer, see "
                     "straggler_peer first"),
        trace_ids=trace_ids)]


def _rule_padding_waste(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    """The wire carries padding, not bytes: a completed exchange's
    ``pad_ratio`` (wire bytes over real payload bytes, from the plan's
    RaggedLayout descriptor) sits over threshold while the wire moved
    enough bytes to matter. The padded dense fallback at any realistic
    skew is exactly this shape — the remediation is the ragged-capable
    transport where the backend has it, capacity tuning where it
    doesn't. Fires once, on the worst offender."""
    worst = None
    for r in _completed(view):
        ratio = float(r.get("pad_ratio") or 0.0)
        wire = float(r.get("wire_bytes") or 0.0)
        if wire < th.pad_min_wire_bytes or ratio < th.pad_warn_ratio:
            continue
        if worst is None or ratio > worst[0]:
            worst = (ratio, r)
    if worst is None:
        return []
    ratio, r = worst
    payload = float(r.get("payload_bytes") or 0.0)
    waves = int(r.get("waves") or 0)
    return [Finding(
        rule="padding_waste",
        grade="critical" if ratio >= th.pad_critical_ratio else "warn",
        summary=(f"shuffle {r.get('shuffle_id')} ({r.get('impl')}"
                 f"{', waved' if waves else ''}) moved "
                 f"{float(r.get('wire_bytes', 0)) / 1e6:.1f} MB on the "
                 f"wire for {payload / 1e6:.1f} MB of real payload "
                 f"({ratio:.1f}x padding) — the transport ships padded "
                 f"caps, not real bytes"),
        evidence={"shuffle_id": r.get("shuffle_id"),
                  "impl": r.get("impl"),
                  "pad_ratio": round(ratio, 2),
                  "payload_bytes": int(payload),
                  "wire_bytes": int(r.get("wire_bytes") or 0),
                  "skew_ratio": round(float(r.get("skew_ratio", 0.0)), 2),
                  "plan_bucket": r.get("plan_bucket"),
                  "waves": waves},
        conf_key="spark.shuffle.tpu.a2a.impl",
        remediation=("run a ragged-capable transport: a2a.impl=auto "
                     "resolves to the native ragged collective wherever "
                     "the backend carries jax.lax.ragged_all_to_all "
                     "(pad_ratio ~= 1.0), and a2a.impl=pallas is the "
                     "first-party chunk-aligned alternative; on "
                     "dense-only backends, lower a2a.capacityFactor and "
                     "keep a2a.capBucketGrowth modest so padded caps "
                     "track real occupancy"),
        trace_ids=[r.get("trace_id", "")])]


def _rule_wire_dequant(view: ClusterView,
                       th: Thresholds) -> List[Finding]:
    """The int8 wire tier is rounding away signal: a completed
    ``wire=int8`` exchange's sampled dequantization-error estimate
    (relative RMS of a round-to-nearest int8 pass over staged float
    values — shuffle/wire.py, stamped by the manager per exchange) sits
    over threshold while the exchange moved enough payload to matter.
    Outlier-dominated rows are the classic cause: one huge element
    stretches the per-row scale so the int8 grid quantizes everything
    else to junk. Fires once, on the worst offender — the remediation
    is an exact tier (raw device lanes, or the lossless host codec)."""
    worst = None
    for r in _completed(view):
        if r.get("wire") != "int8":
            continue
        err = float(r.get("wire_dequant_error") or 0.0)
        if float(r.get("payload_bytes") or 0.0) \
                < th.dequant_min_payload_bytes:
            continue
        if err < th.dequant_warn_rel:
            continue
        if worst is None or err > worst[0]:
            worst = (err, r)
    if worst is None:
        return []
    err, r = worst
    return [Finding(
        rule="wire_dequant_error",
        grade="critical" if err >= th.dequant_critical_rel else "warn",
        summary=(f"shuffle {r.get('shuffle_id')} ({r.get('impl')}, "
                 f"wire=int8) sampled dequantization error is "
                 f"{err:.3f} relative RMS "
                 f"({err / 0.005:.0f}x the well-conditioned ~0.005) — "
                 f"the lossy wire tier is rounding away signal this "
                 f"payload cannot absorb"),
        evidence={"shuffle_id": r.get("shuffle_id"),
                  "impl": r.get("impl"),
                  "wire_dequant_error": round(err, 4),
                  "payload_bytes": int(r.get("payload_bytes") or 0),
                  "wire_bytes": int(r.get("wire_bytes") or 0),
                  "pad_ratio": round(float(r.get("pad_ratio", 0.0)), 2)},
        conf_key="spark.shuffle.tpu.a2a.wire",
        remediation=("move this workload to an exact tier: a2a.wire=raw "
                     "(exact int32 lanes) or a2a.wire=lossless (host-"
                     "side byte-plane compression, bit-exact round-"
                     "trip); if the error is driven by rare outlier "
                     "rows, normalize or clip values before staging so "
                     "the per-row amax stops stretching the int8 grid"),
        trace_ids=[r.get("trace_id", "")])]


def _rule_peer_timeout(view: ClusterView,
                       th: Thresholds) -> List[Finding]:
    """The collective watchdog fired: a distributed rendezvous or an
    in-flight collective outlived ``failure.collectiveTimeoutMs`` and
    was converted into PeerLostError instead of hanging the survivors.
    Evidence is the probe verdict the expiry path gathered
    (``failure.probe.dead`` — devices the liveness probe found dead) and
    the stuck exchanges' trace ids (their reports carry the typed error).
    Never gated by a noise floor: a deadline expiry is a real event by
    construction — the fence already filtered the noise."""
    n = int(view.counters.get(C_PEER_TIMEOUT, 0.0))
    if n < 1:
        return []
    dead = int(view.counters.get(C_PROBE_DEAD, 0.0))
    stuck = [r for r in view.reports
             if "PeerLostError" in str(r.get("error") or "")]
    trace_ids = sorted({r.get("trace_id", "") for r in stuck
                        if r.get("trace_id")})
    return [Finding(
        rule="peer_timeout",
        grade="critical" if n >= th.peer_timeout_critical or dead > 0
        else "warn",
        summary=(f"{n} collective deadline expir{'ies' if n != 1 else 'y'}"
                 f" — a peer stopped answering mid-exchange"
                 + (f"; the liveness probe found {dead} dead device(s)"
                    if dead else
                    " (probe found no dead local device: suspect a "
                    "remote process or the fabric)")),
        evidence={"timeouts": n, "probe_dead_devices": dead,
                  "stuck_exchanges": [r.get("shuffle_id") for r in stuck]},
        conf_key="spark.shuffle.tpu.failure.collectiveTimeoutMs",
        remediation=("remesh over the survivors (node.remesh / the "
                     "recovery controller) and replay — "
                     "failure.policy=replay automates both; if the peer "
                     "is alive but slow, raise "
                     "failure.collectiveTimeoutMs above its worst "
                     "honest exchange"),
        trace_ids=trace_ids)]


def _rule_replay_storm(view: ClusterView,
                       th: Thresholds) -> List[Finding]:
    """Exchanges are living on the replay policy: the retained report
    window shows replays at or past half the default budget — each one a
    full re-plan + re-pack + re-dispatch of the whole exchange. One
    replay is the policy absorbing a blip (quiet); a storm means the
    underlying fault is persistent and the job is paying exchange-sized
    retries to hide it."""
    replayed = [r for r in view.reports if int(r.get("replays", 0)) > 0]
    window = sum(int(r.get("replays", 0)) for r in replayed)
    # the cumulative counter floors the window: replays whose reports
    # were evicted from the retained ring still count
    total = max(window, int(view.counters.get(C_REPLAYS, 0.0)))
    if total < th.replay_warn:
        return []
    burned = sum(float(r.get("replay_ms", 0.0)) for r in replayed)
    evicted = total - window
    if replayed:
        where = (f"across {len(replayed)} shuffle(s) "
                 f"({burned:.0f} ms burned in failed attempts)"
                 + (f", {evicted} more outside the retained report "
                    f"window" if evicted else ""))
    else:
        # counter-only evidence: the replayed reports themselves were
        # evicted — say so instead of claiming "0 shuffles, 0 ms"
        where = ("all outside the retained report window "
                 "(cumulative shuffle.replay.count)")
    return [Finding(
        rule="replay_storm",
        grade="critical" if total >= th.replay_critical else "warn",
        summary=(f"{total} exchange replays {where} — the "
                 f"replay policy is absorbing a persistent fault"),
        evidence={"replays": total, "window_replays": window,
                  "shuffle_ids": sorted({r.get("shuffle_id")
                                         for r in replayed}),
                  "replay_ms": round(burned, 1)},
        conf_key="spark.shuffle.tpu.failure.policy",
        remediation=("find the recurring fault (peer_timeout / flight "
                     "ring 'replay' events name it); if it cannot be "
                     "fixed, failure.policy=failfast surfaces it to the "
                     "host framework instead of silently re-running, "
                     "and failure.replayBudget bounds what each shuffle "
                     "may spend"),
        trace_ids=sorted({r.get("trace_id", "") for r in replayed
                          if r.get("trace_id")}))]


def _rule_block_corruption(view: ClusterView,
                           th: Thresholds) -> List[Finding]:
    """Checksum verification detected corruption: staged/spill bytes no
    longer matched their commit records at pack time, a post-collective
    digest mismatched at the full level, or the restart ledger
    quarantined blocks whose files failed their manifest checksums.
    Evidence pairs the cumulative counters with the retained reports
    whose errors carry the typed BlockCorruptionError (the corrupt
    block is named in the flight ring's ``block_corruption`` events).
    Detection itself is never noise — the verifier compared real
    checksums — so one block is a warning; the corrupt-counter floor
    (``corruption_critical_blocks``) and ANY quarantine grade
    critical: repeated corruption is rotting storage or memory, and
    silently replaying over it forever hides a hardware problem."""
    blocks = int(view.counters.get(C_INTEGRITY_CORRUPT_BLOCKS, 0.0))
    quarantined = int(view.counters.get(C_INTEGRITY_QUARANTINED, 0.0))
    corrupt_reports = [
        r for r in view.reports
        if "BlockCorruption" in str(r.get("error") or "")
        or "TruncatedBlock" in str(r.get("error") or "")]
    total = max(blocks, len(corrupt_reports)) + quarantined
    if total < 1:
        return []          # verified.bytes alone is health, not a finding
    corrupt_bytes = int(view.counters.get(C_INTEGRITY_CORRUPT, 0.0))
    verified = int(view.counters.get(C_INTEGRITY_VERIFIED, 0.0))
    what = []
    if blocks:
        what.append(f"{blocks} block(s) failed checksum verification "
                    f"({corrupt_bytes} corrupt bytes)")
    if quarantined:
        what.append(f"{quarantined} block(s) quarantined by the restart "
                    f"ledger scan")
    return [Finding(
        rule="block_corruption",
        grade="critical"
        if blocks >= th.corruption_critical_blocks or quarantined
        else "warn",
        summary=(" and ".join(what) + " — corruption was DETECTED, not "
                 "served; find out where the bytes rotted"),
        evidence={"corrupt_blocks": blocks,
                  "corrupt_bytes": corrupt_bytes,
                  "quarantined_blocks": quarantined,
                  "verified_bytes": verified,
                  "shuffle_ids": sorted({r.get("shuffle_id")
                                         for r in corrupt_reports})},
        conf_key="spark.shuffle.tpu.integrity.verify",
        remediation=("integrity.verify=full pins down WHERE (staged vs "
                     "post-collective); failure.ledgerDir + "
                     "failure.policy=replay make single corruptions "
                     "survivable (one replay budget unit each) while "
                     "quarantining rotten blocks; recurring corruption "
                     "on one host is failing RAM/disk — drain it"),
        trace_ids=sorted({r.get("trace_id", "") for r in corrupt_reports
                          if r.get("trace_id")}))]


def _rule_host_roundtrip(view: ClusterView,
                         th: Thresholds) -> List[Finding]:
    """The consumer is on-device but the read path went through the
    host: completed HOST-sink reads drained real payload bytes D2H
    (``ExchangeReport.d2h_bytes``) while a consumer pushed bytes back up
    (``shuffle.consume.h2d.bytes`` — the counter only moves when
    something re-uploads after a drain, i.e. a device-sink-capable
    consumer exists). That is the round-trip ``read.sink=device``
    deletes: the engine downloaded what the consumer immediately
    re-uploaded. Quiet without the h2d signal — a host-only pipeline
    (arrow egress, numpy analytics) drains by design and gets no
    finding for it."""
    h2d = float(view.counters.get(C_H2D, 0.0))
    if h2d <= 0:
        return []
    hosts = [r for r in _completed(view)
             if r.get("sink", "host") != "device"
             and float(r.get("d2h_bytes") or 0.0)
             >= th.roundtrip_min_bytes]
    if not hosts:
        return []
    d2h_total = sum(float(r.get("d2h_bytes") or 0.0) for r in hosts)
    # the round-trip volume is what BOTH legs moved: bounded by the
    # smaller side (a consumer may re-upload less than was drained)
    roundtrip = min(d2h_total, h2d)
    worst = max(hosts, key=lambda r: float(r.get("d2h_bytes") or 0.0))
    grade = "critical" if (roundtrip >= th.roundtrip_critical_bytes
                           or len(hosts) >= th.roundtrip_critical_reads) \
        else "warn"
    return [Finding(
        rule="host_roundtrip",
        grade=grade,
        summary=(f"{len(hosts)} host-sink read(s) drained "
                 f"{d2h_total / 1e6:.1f} MB device-to-host while the "
                 f"consumer re-uploaded {h2d / 1e6:.1f} MB — the bytes "
                 f"round-tripped through host memory between two "
                 f"device residents"),
        evidence={"host_sink_reads": len(hosts),
                  "d2h_bytes": int(d2h_total),
                  "h2d_bytes": int(h2d),
                  "roundtrip_bytes": int(roundtrip),
                  "worst_shuffle_id": worst.get("shuffle_id"),
                  "worst_d2h_bytes": int(worst.get("d2h_bytes") or 0),
                  "cumulative_d2h_bytes": int(
                      view.counters.get(C_D2H, 0.0))},
        conf_key="spark.shuffle.tpu.read.sink",
        remediation=("read with a device sink so partitions stay "
                     "sharded jax Arrays handed straight to the "
                     "consumer step: spark.shuffle.tpu.read.sink=device "
                     "(or per read, manager.read(sink='device') / "
                     "DeviceShuffleReaderResult.consume) — d2h_bytes "
                     "drops to 0 and the re-upload disappears; host "
                     "sinks remain right for arrow/varlen egress and "
                     "numpy consumers"),
        trace_ids=[r.get("trace_id", "") for r in hosts[:4]])]


def _rule_sink_fallback(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    """Reads that ASKED for the device sink landed on the host drain —
    the manager's ``_resolve_sink`` fallback, graded instead of a
    warn-once log line. The labeled counter twins name the read MODE
    (plain/ordered/combine — the ordered/combine modes are exactly the
    aggregation-shaped reads the device merge made legal, so a fallback
    there is the old round-trip tax resurfacing) and the REASON
    (distributed / hierarchical / conf_pins_host). Quiet when no read
    ever asked for a device sink it didn't get."""
    total = float(view.counters.get(C_SINK_FALLBACK, 0.0))
    if total <= 0:
        return []
    by_mode: Dict[str, float] = {}
    by_reason: Dict[str, float] = {}
    for name, v in view.counters.items():
        base, labels = parse_labeled(name)
        if base != C_SINK_FALLBACK or not labels:
            continue
        if "mode" in labels:
            by_mode[labels["mode"]] = by_mode.get(
                labels["mode"], 0.0) + float(v)
        if "reason" in labels:
            by_reason[labels["reason"]] = by_reason.get(
                labels["reason"], 0.0) + float(v)
    modes = ", ".join(f"{m}×{int(n)}"
                      for m, n in sorted(by_mode.items())) or "unknown"
    reasons = ", ".join(sorted(by_reason)) or "unknown"
    return [Finding(
        rule="sink_fallback",
        grade="critical" if total >= th.sink_fallback_critical
        else "warn",
        summary=(f"{int(total)} read(s) requested read.sink=device but "
                 f"resolved to the host drain (modes: {modes}; "
                 f"reasons: {reasons}) — the consumer asked for "
                 f"device-resident results and paid the host "
                 f"round-trip instead"),
        evidence={"fallbacks": int(total),
                  "by_mode": {m: int(n) for m, n in by_mode.items()},
                  "by_reason": {r: int(n)
                                for r, n in by_reason.items()}},
        conf_key="spark.shuffle.tpu.read.sink",
        remediation=("the device sink is legal for ALL four read modes "
                     "on the flat exchange — single-process AND "
                     "distributed (the split-tier path lands device-"
                     "resident with zero payload D2H) — and the "
                     "single-shot hierarchical one; if the reason is "
                     "conf_pins_host, set spark.shuffle.tpu.read.sink="
                     "auto (or device); only WAVED hierarchical reads "
                     "(reason hierarchical_waved — drop a2a.waveRows "
                     "for the device consumer) still drain host-side "
                     "by design, so either reshape the read or accept "
                     "the drain and read(sink='host') to silence the "
                     "intent mismatch"))]


def _rule_kernel_fallback(view: ClusterView,
                          th: Thresholds) -> List[Finding]:
    """Reads that ASKED for the blocked pallas kernels landed on the
    jnp/XLA path — ``segmented.resolve_kernel_impl`` refused the
    request, graded instead of the manager's warn-once log line. The
    labeled counter twins name the REASON: ``backend_unsupported``
    (the backend compiles neither natively — TPU — nor under the CPU
    interpreter) or ``subword_dtype`` (the combine dtype is not the
    4-byte lane width the blocked kernels assume). ``auto`` resolving
    to jnp off-TPU is a clean resolution, not a fallback, and never
    increments the counter — quiet unless somebody pinned
    read.mergeImpl=pallas and did not get it."""
    total = float(view.counters.get(C_KERNEL_FALLBACK, 0.0))
    if total <= 0:
        return []
    by_reason: Dict[str, float] = {}
    for name, v in view.counters.items():
        base, labels = parse_labeled(name)
        if base != C_KERNEL_FALLBACK or not labels:
            continue
        if "reason" in labels:
            by_reason[labels["reason"]] = by_reason.get(
                labels["reason"], 0.0) + float(v)
    reasons = ", ".join(f"{r}×{int(n)}"
                        for r, n in sorted(by_reason.items())) \
        or "unknown"
    return [Finding(
        rule="kernel_fallback",
        grade="critical" if total >= th.kernel_fallback_critical
        else "warn",
        summary=(f"{int(total)} read(s) requested read.mergeImpl="
                 f"pallas but ran the jnp/XLA kernels instead "
                 f"(reasons: {reasons}) — the consumer asked for the "
                 f"blocked device kernels and the capability gate "
                 f"refused (the ExchangeReport 'kernel' field names "
                 f"what actually ran)"),
        evidence={"fallbacks": int(total),
                  "by_reason": {r: int(n)
                                for r, n in by_reason.items()}},
        conf_key="spark.shuffle.tpu.read.mergeImpl",
        remediation=("the blocked kernels are legal on TPU natively "
                     "and on CPU under the pallas interpreter "
                     "(segmented.kernel_gate_reason) with 4-byte "
                     "combine dtypes (int32/float32/uint32) — if the "
                     "reason is backend_unsupported, run on TPU or "
                     "accept the oracle path with read.mergeImpl=auto "
                     "(picks pallas exactly where it compiles "
                     "natively, jnp elsewhere, no fallback counted); "
                     "if subword_dtype, widen the combine values to a "
                     "4-byte lane dtype or keep jnp — results are "
                     "identical either way, only the kernel differs"))]


def _labeled_series(mapping, base: str, label: str) -> Dict[str, Any]:
    """{label value: entry} for every identity in ``mapping`` whose base
    name is ``base`` and whose label block carries ``label`` — the
    per-tenant join used by the quota rule (and any future labeled
    rule)."""
    out: Dict[str, Any] = {}
    for name, v in mapping.items():
        b, labels = parse_labeled(name)
        if b == base and labels and label in labels:
            out[labels[label]] = v
    return out


def _rule_quota_starvation(view: ClusterView,
                           th: Thresholds) -> List[Finding]:
    """One tenant is starving in admission while another hogs the
    in-flight budget. Three signals, all required:

    * cross-grants: while this tenant's tickets waited, OTHER tenants
      were granted ``quota_cross_grants``+ exchanges past them
      (``shuffle.admit.cross_grants{tenant=...}`` p99). This is the
      discriminator — a tenant serialized behind its OWN reads observes
      ~0 cross-grants no matter how long it waits, so self-backpressure
      can never masquerade as starvation.
    * real waits: admit-wait p99 over the ``quota_min_wait_ms`` floor —
      being passed by a flood of sub-ms grants is rude, not harmful.
    * a hog exists: some other tenant holds more than ``quota_share``
      of every granted admission byte.

    Names BOTH tenants and the hog's quota key: capping the hog (or
    raising the starved tenant's priority class) is the fix — raising
    the global cap merely moves the queue. Quiet under fair-share
    health: DRR interleaves grants, so a minnow is passed by at most a
    handful of whale exchanges, never the whale's whole queue."""
    waits = _labeled_series(view.histograms, H_ADMIT_WAIT, "tenant")
    cross = _labeled_series(view.histograms, H_ADMIT_CROSS, "tenant")
    granted = _labeled_series(view.counters, C_ADMIT_BYTES, "tenant")
    total_granted = sum(granted.values())
    if len(waits) < 2 or total_granted < th.quota_min_bytes:
        return []
    # per-tenant exchange wall (evidence only): median completed-read
    # wall, admission wait subtracted — group_ms includes the wait when
    # dispatch was deferred
    walls: Dict[str, List[float]] = {}
    for r in _completed(view):
        t = r.get("tenant") or ""
        if t:
            walls.setdefault(t, []).append(max(0.0, (
                float(r.get("pack_ms", 0.0))
                + float(r.get("group_ms", 0.0))
                - float(r.get("admit_wait_ms", 0.0)))))
    out: List[Finding] = []
    for tid, h in sorted(waits.items()):
        if h.count < th.quota_min_admits:
            continue
        p99 = h.quantile(0.99)
        if p99 < th.quota_min_wait_ms:
            continue
        xh = cross.get(tid)
        x99 = xh.quantile(0.99) if xh is not None and xh.count else 0.0
        if x99 < th.quota_cross_grants:
            continue
        hogs = [(u, b) for u, b in granted.items() if u != tid]
        if not hogs:
            continue
        hog, hog_bytes = max(hogs, key=lambda kv: kv[1])
        share = hog_bytes / total_granted
        if share <= th.quota_share:
            continue
        wall = _median(walls.get(tid, []))
        out.append(Finding(
            rule="quota_starvation",
            grade="critical" if x99 >= th.quota_cross_critical
            else "warn",
            summary=(f"tenant {tid!r} is starved of admission: "
                     f"{x99:.0f} grants to other tenants passed its "
                     f"waiting reads (admit-wait p99 {p99:.0f} ms) "
                     f"while tenant {hog!r} holds {share:.0%} of all "
                     f"granted admission bytes"),
            evidence={"starved_tenant": tid, "hog_tenant": hog,
                      "cross_grants_p99": round(x99, 1),
                      "admit_wait_p99_ms": round(p99, 1),
                      "tenant_wall_ms": round(wall, 1),
                      "hog_granted_bytes": int(hog_bytes),
                      "hog_share": round(share, 3),
                      "admits": int(h.count)},
            conf_key=f"spark.shuffle.tpu.tenant.{hog}.maxBytesInFlight",
            remediation=(f"cap tenant {hog!r} "
                         f"(tenant.{hog}.maxBytesInFlight) or raise "
                         f"tenant {tid!r}'s priority class "
                         f"(tenant.{tid}.priority=high — a fair-share "
                         f"weight multiplier); check tenant.fairShare "
                         f"is on — FIFO admission starves by "
                         f"arrival order")))
    return out


def _rule_slow_tier(view: ClusterView, th: Thresholds) -> List[Finding]:
    """One fabric tier of the hierarchical exchange is the straggler —
    attributed from the per-tier phase spans (``ExchangeReport.tiers``
    ``ms``, the tiered pending's measured ICI vs DCN joins), normalized
    by each tier's wire-byte share so a tier that legitimately moves
    more bytes is not blamed for taking longer. Three signals, all
    required (the ratio+floor discipline):

    * steady reads only — a compile-bearing read's tier walls time XLA,
      not the fabric;
    * the slow tier's wall over the ``tier_min_ms`` floor — sub-noise
      spans attribute nothing;
    * normalized imbalance ``(ms_slow/ms_fast) / max(wire_slow/
      wire_fast, 1)`` at ``tier_ratio``+ on a majority of the steady
      hierarchical reads, all agreeing on WHICH tier.

    Names the tier and its deadline knob: a straggling DCN that
    eventually hangs should surface as a typed per-tier PeerLostError,
    and ``a2a.wire=int8`` halves what the slow fabric must carry."""
    cand: List[tuple] = []
    for r in _steady(_completed(view)):
        tiers = {t.get("tier"): t for t in (r.get("tiers") or [])}
        ici, dcn = tiers.get("ici"), tiers.get("dcn")
        if not ici or not dcn:
            continue
        ms = {"ici": float(ici.get("ms", 0.0)),
              "dcn": float(dcn.get("ms", 0.0))}
        slow = "dcn" if ms["dcn"] >= ms["ici"] else "ici"
        fast = "ici" if slow == "dcn" else "dcn"
        if ms[slow] < th.tier_min_ms:
            continue
        wire = {"ici": float(ici.get("wire_bytes", 0.0)),
                "dcn": float(dcn.get("wire_bytes", 0.0))}
        byte_ratio = max(wire[slow] / max(wire[fast], 1.0), 1.0)
        imbalance = (ms[slow] / max(ms[fast], 1e-3)) / byte_ratio
        cand.append((slow, imbalance, ms[slow], ms[fast],
                     r.get("trace_id", "")))
    if not cand:
        return []
    hits = [c for c in cand if c[1] >= th.tier_ratio]
    if len(hits) < th.tier_min_reads or len(hits) * 2 < len(cand):
        return []
    by_tier: Dict[str, int] = {}
    for slow, *_rest in hits:
        by_tier[slow] = by_tier.get(slow, 0) + 1
    tier = max(by_tier, key=by_tier.get)
    t_hits = [c for c in hits if c[0] == tier]
    if len(t_hits) * 2 < len(hits):
        return []                   # no single tier owns the verdict
    med_imb = _median([c[1] for c in t_hits])
    fabric = "inter-slice DCN" if tier == "dcn" else "intra-slice ICI"
    return [Finding(
        rule="slow_tier",
        grade="critical" if (med_imb >= th.tier_critical_ratio
                             or len(t_hits) >= 4) else "warn",
        summary=(f"the {fabric} tier is the hierarchical exchange's "
                 f"straggler: its phase wall is {med_imb:.1f}x the "
                 f"other tier's (byte-share-normalized) on "
                 f"{len(t_hits)} steady read(s) — median "
                 f"{_median([c[2] for c in t_hits]):.0f} ms vs "
                 f"{_median([c[3] for c in t_hits]):.0f} ms"),
        evidence={"tier": tier,
                  "normalized_imbalance_median": round(med_imb, 2),
                  "slow_ms_median": round(
                      _median([c[2] for c in t_hits]), 1),
                  "fast_ms_median": round(
                      _median([c[3] for c in t_hits]), 1),
                  "reads": len(t_hits),
                  "hier_reads_seen": len(cand)},
        conf_key=f"spark.shuffle.tpu.failure.{tier}.timeoutMs",
        remediation=(f"the {tier} phase is slow beyond its byte share: "
                     f"check the {fabric} fabric (a flaky link shows "
                     f"here first); set failure.{tier}.timeoutMs so an "
                     f"eventual hang surfaces as a typed per-tier "
                     f"PeerLostError instead of a stall; a2a.wire=int8 "
                     f"narrows what the slow fabric carries, and "
                     f"combine-style reads shrink the DCN hop at the "
                     f"relay"),
        trace_ids=[c[4] for c in t_hits if c[4]][:8])]


def _frame_window_hist(frames: List[Dict], name: str) -> Histogram:
    """Merge one named histogram's window deltas across frames into one
    distribution (exact — same fixed ladder per frame delta)."""
    out: Optional[Histogram] = None
    for f in frames:
        snap = (f.get("histograms") or {}).get(name)
        if not snap or not snap.get("count"):
            continue
        h = Histogram.from_snapshot(snap, name)
        out = h if out is None else out.merge(h)
    return out if out is not None else Histogram(name)


def _frame_window_counter(frames: List[Dict], name: str) -> float:
    return sum(float((f.get("counters") or {}).get(name, 0.0))
               for f in frames)


def _rule_slo_burn(view: ClusterView, th: Thresholds) -> List[Finding]:
    """A declared service-level objective is burning its error budget
    over the retained windows (utils/slo.py evaluated over the folded
    history frames). A fast burn is critical — at the default 14.4x a
    30-day budget dies in two days — a slow burn is a warning ticket.
    Names the tenant, the objective key and the burn multiple.

    Discriminator discipline (the cross-grants lesson): before
    blaming the engine, the rule reads the burning tenant's admission
    evidence from the SAME fast window. A tenant whose reads spent
    their wall parked in admission while cross-grants stayed ~0 was
    serialized behind its OWN submissions — client self-backpressure —
    and the finding says so instead of pointing at the exchange path."""
    from sparkucx_tpu_torch.utils import slo as _slo
    if not view.slo_objectives or not view.frames:
        return []
    objectives = _slo.objectives_from_dicts(view.slo_objectives)
    if not objectives:
        return []
    policy = _slo.BurnPolicy.from_dict(view.slo_policy)
    verdict = _slo.evaluate(view.frames, objectives, policy=policy)
    now = verdict["ts"]
    out: List[Finding] = []
    for o in verdict["objectives"]:
        if not (o["fast_burn"] or o["slow_burn"]):
            continue
        tid = o["tenant"]
        fast_frames = [f for f in view.frames
                       if now - float(f.get("t_end", 0.0))
                       <= policy.fast_window_s]
        ev = {"objective": o["objective"], "tenant": tid or "(global)",
              "burn_fast": o["burn_fast"], "burn_slow": o["burn_slow"],
              "target": o["target"],
              "fast_window": o["windows"]["fast"],
              "budget_remaining": o["budget"]["remaining"]}
        self_throttled = False
        if tid:
            wait_h = _frame_window_hist(
                fast_frames, labeled(H_ADMIT_WAIT, tenant=tid))
            cross_h = _frame_window_hist(
                fast_frames, labeled(H_ADMIT_CROSS, tenant=tid))
            payload = _frame_window_counter(
                fast_frames, labeled("shuffle.payload.bytes",
                                     tenant=tid))
            ev["payload_bytes_fast_window"] = int(payload)
            if wait_h.count:
                wait99 = wait_h.quantile(0.99)
                cross99 = cross_h.quantile(0.99) if cross_h.count else 0.0
                ev["admit_wait_p99_ms"] = round(wait99, 1)
                ev["cross_grants_p99"] = round(cross99, 1)
                # real admission stalls with ~no foreign grants passing
                # the ticket = the tenant queues behind itself
                self_throttled = (wait99 >= th.quota_min_wait_ms
                                  and cross99 < 2.0)
                ev["self_throttled"] = self_throttled
        who = f"tenant {tid!r}" if tid else "the service"
        conf_key = ("spark.shuffle.tpu."
                    + (f"tenant.{tid}." if tid else "") + o["objective"])
        if self_throttled:
            remediation = (
                f"the burning reads spent their wall waiting on {who}'s "
                f"OWN admission queue (cross-grants ~0 — no neighbor "
                f"passed them): raise the client's concurrency budget "
                f"(tenant.{tid}.maxBytesInFlight / maxInflightReads) or "
                f"submit less, the exchange path is not the bottleneck")
        else:
            remediation = (
                "find WHERE the bad windows spend their wall: "
                "latency_trend / straggler_peer / slow_tier narrow it; "
                "if the objective is simply mis-provisioned for this "
                f"workload, raise {conf_key} rather than paging on it")
        grade = "critical" if o["fast_burn"] else "warn"
        if self_throttled and grade == "critical":
            # a self-inflicted burn still burns the budget, but it is
            # not an engine page — the discriminator caps the grade
            grade = "warn"
        rate = o["windows"]["fast" if o["fast_burn"] else "slow"]
        out.append(Finding(
            rule="slo_burn",
            grade=grade,
            summary=(f"{who} is burning its "
                     f"{o['objective']} budget at "
                     f"{o['burn_fast'] if o['fast_burn'] else o['burn_slow']}x "
                     f"({'fast' if o['fast_burn'] else 'slow'} window: "
                     f"{rate['errors']}/{rate['events']} bad events, "
                     f"{o['budget']['remaining']:.0%} of the error "
                     f"budget left over retention)"
                     + (" — evidence says client self-backpressure, "
                        "not the engine" if self_throttled else "")),
            evidence=ev,
            conf_key=conf_key,
            remediation=remediation))
    return out


def _rule_latency_trend(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    """Is it getting worse RIGHT NOW: the last ``trend_recent_frames``
    windows' merged read-wait p99 vs the retained baseline windows
    before them. Payload-normalized — recent bytes/read over baseline
    bytes/read divides the drift, so a consumer that started issuing
    4x bigger reads is a load shift, not a regression. Steady-state
    only by construction (window histograms carry H_FETCH_WAIT; the
    compile-bearing reads observed into first_wait_ms)."""
    frames = view.frames
    if len(frames) < th.trend_min_frames:
        return []
    recent = frames[-th.trend_recent_frames:]
    baseline = frames[:-th.trend_recent_frames]
    h_rec = _frame_window_hist(recent, H_FETCH_WAIT)
    h_base = _frame_window_hist(baseline, H_FETCH_WAIT)
    if h_rec.count < th.trend_min_reads \
            or h_base.count < th.trend_min_reads:
        return []
    p99_rec, p99_base = h_rec.quantile(0.99), h_base.quantile(0.99)
    if p99_rec < th.trend_min_ms or p99_base <= 0:
        return []
    bpr_rec = _frame_window_counter(recent, "shuffle.payload.bytes") \
        / max(1.0, _frame_window_counter(recent, "shuffle.read.count"))
    bpr_base = _frame_window_counter(baseline, "shuffle.payload.bytes") \
        / max(1.0, _frame_window_counter(baseline, "shuffle.read.count"))
    norm = max(bpr_rec / bpr_base, 1.0) if bpr_base > 0 else 1.0
    drift = (p99_rec / p99_base) / norm
    if drift < th.trend_ratio:
        return []
    span_s = (float(recent[-1].get("t_end", 0.0))
              - float(recent[0].get("t_start", 0.0)))
    return [Finding(
        rule="latency_trend",
        grade="critical" if drift >= th.trend_critical_ratio
        else "warn",
        summary=(f"read-wait p99 drifted to {p99_rec:.1f} ms over the "
                 f"last {len(recent)} window(s) (~{span_s:.0f} s) vs "
                 f"{p99_base:.1f} ms baseline — {drift:.1f}x worse "
                 f"payload-normalized ({h_rec.count} recent reads vs "
                 f"{h_base.count} baseline)"),
        evidence={"recent_p99_ms": round(p99_rec, 2),
                  "baseline_p99_ms": round(p99_base, 2),
                  "drift_normalized": round(drift, 2),
                  "payload_norm": round(norm, 3),
                  "recent_reads": h_rec.count,
                  "baseline_reads": h_base.count,
                  "recent_frames": len(recent),
                  "baseline_frames": len(baseline)},
        conf_key="spark.shuffle.tpu.trace.enabled",
        remediation=("something recent made steady reads slower at the "
                     "same bytes/read: diff the recent windows' frames "
                     "(slo CLI --input history dir) against the "
                     "baseline, then pull the merged timeline for a "
                     "slow recent exchange; straggler_peer / slow_tier "
                     "/ hbm_pressure findings in the same pass usually "
                     "name the culprit"))]


def _rule_spill_bound(view: ClusterView,
                      th: Thresholds) -> List[Finding]:
    """An analytics workload (workloads/ pipelines) spent the dominant
    share of its engine wall in SPILL I/O — sealing staged bytes to
    disk and reading them back — rather than in the exchange or merge
    planes. Attribution comes from the per-phase walls the pipelines
    publish (``workload.phase.ms{workload=,phase=}``): shares are
    computed over the spill/exchange/merge triple (ingest/emit are
    workload-side generation/verification), per workload label.
    Exchange-dominant is the healthy posture for a shuffle engine and
    stays quiet; a spill-bound workload means the configured memory
    budget (or the disk under ``spill.dir``) is the bottleneck — raise
    the budget (bigger ``spill.threshold``, fewer forced spills), point
    ``spill.dir`` at faster storage, or accept the external-memory
    price. Floors: real wall + real rows before any share fires."""
    from sparkucx_tpu_torch.utils.metrics import (
        C_WORKLOAD_PHASE_MS, C_WORKLOAD_ROWS)
    # {workload: {phase: ms}} from the labeled counter family
    by_wl: Dict[str, Dict[str, float]] = {}
    for name, v in view.counters.items():
        base, labels = parse_labeled(name)
        if base != C_WORKLOAD_PHASE_MS or not labels:
            continue
        wl, ph = labels.get("workload"), labels.get("phase")
        if not wl or not ph:
            continue
        by_wl.setdefault(wl, {})[ph] = \
            by_wl.get(wl, {}).get(ph, 0.0) + float(v)
    rows_by_wl = _labeled_series(view.counters, C_WORKLOAD_ROWS,
                                 "workload")
    out: List[Finding] = []
    for wl, phases in sorted(by_wl.items()):
        engine = {ph: phases.get(ph, 0.0)
                  for ph in ("spill", "exchange", "merge")}
        engine_ms = sum(engine.values())
        rows = float(rows_by_wl.get(wl, 0.0))
        if engine_ms < th.spill_min_wall_ms \
                or rows < th.spill_min_rows:
            continue                       # sub-noise workload
        share = engine[("spill")] / engine_ms
        if share < th.spill_share_warn:
            continue                       # exchange/merge-bound: healthy
        spill_bytes = float(view.counters.get(
            "shuffle.spill.bytes", 0.0))
        out.append(Finding(
            rule="spill_bound",
            grade="critical" if share >= th.spill_share_critical
            else "warn",
            summary=(f"workload {wl!r} is spill-bound: {share:.0%} of "
                     f"its engine wall ({engine_ms:.0f} ms across "
                     f"spill/exchange/merge) went to spill I/O — the "
                     f"memory budget, not the exchange, is the "
                     f"bottleneck"),
            evidence={"workload": wl,
                      "spill_share": round(share, 3),
                      "phase_ms": {ph: round(ms, 1)
                                   for ph, ms in phases.items()},
                      "rows": int(rows),
                      "spill_bytes": int(spill_bytes)},
            conf_key="spark.shuffle.tpu.spill.threshold",
            remediation=("raise the workload memory budget (the "
                         "pipelines derive spill.threshold and "
                         "a2a.waveRows from it — fewer forced spills "
                         "per ingest), point spill.dir at faster "
                         "storage, or shrink the dataset per round; "
                         "if exchange_ms is also near zero the run "
                         "never exercised the engine at all")))
    return out


# phase -> the knob that most directly moves it. The autotuner arc's
# hook (ROADMAP #4): a phase_regression finding names the dominant
# growing phase AND the key to turn, so a closed loop can act on it.
_PHASE_CONF = {
    "plan": "spark.shuffle.tpu.a2a.impl",
    "compile": "spark.shuffle.tpu.a2a.capBucketGrowth",
    "pack": "spark.shuffle.tpu.a2a.waveRows",
    "admission_wait": "spark.shuffle.tpu.a2a.maxBytesInFlight",
    "agree": "spark.shuffle.tpu.failure.collectiveTimeoutMs",
    "barrier_wait": "spark.shuffle.tpu.failure.collectiveTimeoutMs",
    "transfer.ici": "spark.shuffle.tpu.a2a.wire",
    "transfer.dcn": "spark.shuffle.tpu.a2a.wire",
    "merge": "spark.shuffle.tpu.read.mergeImpl",
    "sink": "spark.shuffle.tpu.io.fetchGranularity",
    "spill": "spark.shuffle.tpu.spill.threshold",
    "verify": "spark.shuffle.tpu.integrity.verify",
}


def _rule_dark_time(view: ClusterView, th: Thresholds) -> List[Finding]:
    """The anatomy plane's conservation audit failed: a material share
    of the settled exchange walls is attributed to NO phase
    (utils/anatomy.py dark_time — the residual after sweeping every
    matched span interval over the wall). Evidence is the worst
    exchange's uncovered intervals, which localize WHERE in the wall
    the instrumentation hole sits; when the tracer ring dropped spans
    (trace.spans.dropped) the ledger is dark because evidence fell off
    the ring, and the remediation is capacity, not instrumentation."""
    reps = [r for r in view.reports
            if r.get("completed") and float(r.get("anatomy_wall_ms",
                                                  0.0)) > 0]
    if len(reps) < th.dark_min_reads:
        return []
    wall = sum(float(r["anatomy_wall_ms"]) for r in reps)
    dark = sum(float(r.get("dark_ms", 0.0)) for r in reps)
    if wall < th.dark_min_wall_ms:
        return []
    share = dark / wall
    if share < th.dark_share_warn:
        return []
    worst = max(reps, key=lambda r: float(r.get("dark_ms", 0.0)))
    dropped = float(view.counters.get(C_TRACE_DROPPED, 0.0))
    ev = {"dark_share": round(share, 3),
          "dark_ms": round(dark, 2),
          "wall_ms": round(wall, 2),
          "reads": len(reps),
          "worst_trace": worst.get("trace_id", ""),
          "worst_dark_ms": round(float(worst.get("dark_ms", 0.0)), 2),
          "worst_dark_intervals_ms":
              [[round(a, 2), round(b, 2)]
               for a, b in (worst.get("dark_intervals") or [])][:8],
          "trace_spans_dropped": int(dropped)}
    if dropped > 0:
        conf_key = "spark.shuffle.tpu.trace.capacity"
        remediation = (f"the span ring dropped {int(dropped)} span(s) — "
                       "the dark wall is likely evidence that fell off "
                       "the ring, not missing instrumentation; raise "
                       "trace.capacity (or fold closer to the exchange) "
                       "and re-measure before chasing the intervals")
    else:
        conf_key = "spark.shuffle.tpu.trace.enabled"
        remediation = ("un-instrumented wall time: pull the worst "
                       "exchange's uncovered intervals (anatomy CLI "
                       "--trace) and overlay them on the merged "
                       "timeline — whatever runs in those windows "
                       "carries no span; zero drops means this is an "
                       "instrumentation hole, not ring pressure")
    return [Finding(
        rule="dark_time",
        grade="critical" if share >= th.dark_share_critical else "warn",
        summary=(f"{share:.0%} of {wall:.0f} ms of settled exchange "
                 f"wall across {len(reps)} read(s) is attributed to no "
                 f"phase (dark time); worst exchange "
                 f"{worst.get('trace_id', '?')} carries "
                 f"{float(worst.get('dark_ms', 0.0)):.1f} ms dark"),
        evidence=ev,
        conf_key=conf_key,
        remediation=remediation,
        trace_ids=[worst.get("trace_id", "")])]


def _rule_phase_regression(view: ClusterView,
                           th: Thresholds) -> List[Finding]:
    """WHICH phase is getting worse: latency_trend's recent-vs-baseline
    split applied per canonical phase (shuffle.phase.ms{phase=} window
    deltas from anatomy settlement, normalized per read and
    payload-normalized like the parent rule). Where latency_trend says
    \"reads are 4x slower\", this rule says \"merge is what grew\" and
    names the knob that moves merge. One finding per drifting phase,
    worst first; dark_time drift is reported via _rule_dark_time, not
    here (it has no knob of its own)."""
    frames = view.frames
    if len(frames) < th.trend_min_frames:
        return []
    recent = frames[-th.trend_recent_frames:]
    baseline = frames[:-th.trend_recent_frames]
    reads_rec = _frame_window_counter(recent, "shuffle.read.count")
    reads_base = _frame_window_counter(baseline, "shuffle.read.count")
    if reads_rec < th.trend_min_reads or reads_base < th.trend_min_reads:
        return []
    bpr_rec = _frame_window_counter(recent, "shuffle.payload.bytes") \
        / reads_rec
    bpr_base = _frame_window_counter(baseline, "shuffle.payload.bytes") \
        / reads_base
    norm = max(bpr_rec / bpr_base, 1.0) if bpr_base > 0 else 1.0
    out: List[Finding] = []
    for ph in sorted(_PHASE_CONF):
        name = labeled(C_PHASE_MS, phase=ph)
        ms_rec = _frame_window_counter(recent, name) / reads_rec
        ms_base = _frame_window_counter(baseline, name) / reads_base
        if ms_rec < th.phase_trend_min_ms or ms_base <= 0:
            continue
        drift = (ms_rec / ms_base) / norm
        if drift < th.phase_trend_ratio:
            continue
        out.append(Finding(
            rule="phase_regression",
            grade="critical" if drift >= th.phase_trend_critical
            else "warn",
            summary=(f"phase {ph!r} grew to {ms_rec:.1f} ms/read over "
                     f"the last {len(recent)} window(s) vs "
                     f"{ms_base:.1f} ms/read baseline — {drift:.1f}x "
                     f"worse payload-normalized; the exchange wall is "
                     f"being eaten by {ph}, not spread evenly"),
            evidence={"phase": ph,
                      "recent_ms_per_read": round(ms_rec, 2),
                      "baseline_ms_per_read": round(ms_base, 2),
                      "drift_normalized": round(drift, 2),
                      "payload_norm": round(norm, 3),
                      "recent_reads": int(reads_rec),
                      "baseline_reads": int(reads_base)},
            conf_key=_PHASE_CONF[ph],
            remediation=(f"one phase regressed while the others held: "
                         f"turn {_PHASE_CONF[ph]} or diff what changed "
                         f"around the {ph} path; the anatomy CLI on a "
                         f"recent exchange shows the swept {ph} "
                         f"segments against the wall")))
    out.sort(key=lambda f: -f.evidence["drift_normalized"])
    return out


def _rule_peer_unresponsive(view: ClusterView,
                            th: Thresholds) -> List[Finding]:
    """Fleet-scrape reachability (utils/collector.py): an expected peer
    did not answer its telemetry port, or every peer answers yet the
    collective watchdog fired. The discriminator is the whole point —
    the same bare symptom ("the exchange hung") has three distinct
    causes an operator handles differently:

    * ``dead`` — scrape failed AND the watchdog's deadline fired: the
      process is gone from both planes. Critical; remesh over the
      survivors.
    * ``telemetry_unreachable`` — scrape failed but no collective
      deadline has fired: the data plane may be perfectly healthy and
      only the observability port is down/blocked. Warn; fix the scrape
      path before trusting any fleet view.
    * ``wedged_reachable`` — every peer still answers HTTP but the
      watchdog fired: a process is alive-but-parked in the data plane.
      Critical; the evidence names the straggler via the anatomy
      critical path joined over the answered docs (cross-process
      attribution — WHICH peer, in WHICH phase).

    No noise floor on the missing-peer arms (an expected peer that
    stops answering is a real event by construction — the registry was
    agreed at boot when everyone was alive); the wedged arm inherits
    peer_timeout's no-floor posture."""
    fleet = view.fleet
    if not fleet:
        return []
    out: List[Finding] = []
    watchdog_fired = int(view.counters.get(C_PEER_TIMEOUT, 0.0)) > 0
    peers = fleet.get("peers") or {}
    missing = list(fleet.get("missing_peers") or [])
    for pid in missing:
        cell = peers.get(str(pid), {})
        disc = "dead" if watchdog_fired else "telemetry_unreachable"
        out.append(Finding(
            rule="peer_unresponsive",
            grade="critical" if disc == "dead" else "warn",
            summary=(f"peer {pid} did not answer its telemetry scrape "
                     + (f"({cell.get('error')}) " if cell.get("error")
                        else "")
                     + ("and the collective watchdog fired — the "
                        "process is gone from both planes"
                        if disc == "dead" else
                        "but no collective deadline has fired — "
                        "telemetry-plane outage only; the data plane "
                        "may be healthy")),
            evidence={"peer": pid, "discriminator": disc,
                      "url": cell.get("url"),
                      "error": cell.get("error"),
                      "answered": fleet.get("processes_answered"),
                      "expected": len(fleet.get("expected") or [])},
            conf_key="spark.shuffle.tpu.metrics.httpAdvertiseHost",
            remediation=("remesh over the survivors and replay"
                         if disc == "dead" else
                         "check the peer's metrics.httpPort server and "
                         "that metrics.httpAdvertiseHost publishes an "
                         "address this host can reach (a loopback "
                         "advertise in a multi-host world is the "
                         "classic cause)")))
    if watchdog_fired and not missing and len(fleet.get("expected")
                                             or []) > 1:
        cp = fleet.get("critical_path") or {}
        who = cp.get("process")
        out.append(Finding(
            rule="peer_unresponsive",
            grade="critical",
            summary=("collective deadline fired but every peer still "
                     "answers its telemetry port — a process is alive "
                     "but wedged in the data plane"
                     + (f"; the critical path names process {who} "
                        f"(last phase {cp.get('phase')!r}"
                        + (f", tier {cp['tier']}" if cp.get("tier")
                           else "") + ")" if who is not None else "")),
            evidence={"discriminator": "wedged_reachable",
                      "straggler": who,
                      "straggler_phase": cp.get("phase"),
                      "straggler_lag_ms": cp.get("straggler_lag_ms"),
                      "trace_id": cp.get("trace_id")},
            conf_key="spark.shuffle.tpu.failure.collectiveTimeoutMs",
            remediation=("read the flight postmortem's peer_postmortem "
                         "(the survivor scraped the fleet out-of-band "
                         "at expiry — each peer's last-known phase "
                         "ledger is embedded); a wedged-not-dead peer "
                         "usually means a stuck device program or a "
                         "desynced collective, not a crash"),
            trace_ids=[t for t in [cp.get("trace_id")] if t]))
    return out


def _rule_clock_drift(view: ClusterView, th: Thresholds) -> List[Finding]:
    """Scrape-time re-anchor deltas (utils/collector.py ``skew_s``):
    a peer's wall↔perf anchor moved since boot — its wall clock stepped
    or slewed hard. Merged timelines stay exact (they re-anchor per
    scrape), but boot-anchor-based cross-process ordering claims are
    now wrong by the skew; warn past ordinary-NTP territory, critical
    when seconds of drift mean a genuinely broken clock."""
    fleet = view.fleet
    if not fleet:
        return []
    drifted = []
    for pid, cell in sorted((fleet.get("peers") or {}).items()):
        s = cell.get("skew_s")
        if s is not None and abs(float(s)) >= th.clock_drift_warn_s:
            drifted.append((pid, float(s)))
    if not drifted:
        return []
    worst = max(abs(s) for _, s in drifted)
    return [Finding(
        rule="clock_drift",
        grade="critical" if worst >= th.clock_drift_critical_s
        else "warn",
        summary=(f"{len(drifted)} peer clock(s) drifted off their boot "
                 f"anchors (worst {worst:.3f} s) — cross-process "
                 f"ordering from boot anchors is stale; scrape-time "
                 f"re-anchors are already preferred for timelines"),
        evidence={"skews_s": {pid: round(s, 4) for pid, s in drifted},
                  "worst_s": round(worst, 4)},
        remediation=("check NTP/chrony on the drifted hosts; restart "
                     "the drifted process to re-publish a fresh boot "
                     "anchor once its clock is disciplined"))]


# topic (or topic prefix, dot-terminated) -> the conf key whose
# cross-process split most plausibly produced the divergence. Derived
# from the agree() call sites: a2a.waveRows/waveSizes (distributed
# split-tier wave programs), hier.<tier>.overflow/regrow (capacity
# ladder), replay.enter (collective replay budget), async.batch (the
# reduce-min batch bound) and async.order (the K-worker agreed
# submission order whose turnstile tickets serialize collective
# sections — a split here means peers queued different work or
# resolved different tenant weights), turnstile.* (rounds the
# CollectiveTurnstile itself closes under its ticket), tier.crossRows
# (exact distributed tier accounting). Exact topics list before their
# covering prefix so first-match wins stays correct.
_DESYNC_CONF = (
    ("a2a.", "spark.shuffle.tpu.a2a.waveRows"),
    ("hier.", "spark.shuffle.tpu.a2a.capacityFactor"),
    ("replay.", "spark.shuffle.tpu.failure.replayBudget"),
    ("async.order", "spark.shuffle.tpu.tenant.asyncAgreedOrder"),
    ("async.", "spark.shuffle.tpu.tenant.asyncAgreedOrder"),
    ("turnstile.", "spark.shuffle.tpu.tenant.asyncAgreedOrder"),
    ("tier.", "spark.shuffle.tpu.a2a.topology"),
)


def _rule_desync(view: ClusterView, th: Thresholds) -> List[Finding]:
    """Agreement divergence (shuffle/agreement.py ``agree()``): peers
    proposed DIFFERENT values for a decision the SPMD discipline says
    must be identical everywhere — wave programs, capacity regrows,
    replay entry, async submission order, tier cross-rows. The labeled
    counter twins name the TOPIC, and each topic maps to the conf key
    whose per-process split is the usual cause (the divergence error
    itself names the same key at raise time; this rule is the
    after-the-fact flight-recorder face). No noise floor — the
    peer_timeout posture: one divergence is a conf split or broken
    determinism, never load noise. Quiet when every agreement round
    closed unanimous."""
    total = float(view.counters.get(C_AGREE_DIVERGENCE, 0.0))
    if total <= 0:
        return []
    by_topic = {t: float(v) for t, v in _labeled_series(
        view.counters, C_AGREE_DIVERGENCE, "topic").items()}
    # charge the finding to the dominant topic's conf key; every
    # implicated key rides in the evidence
    keys: Dict[str, float] = {}
    for topic, n in by_topic.items():
        for prefix, key in _DESYNC_CONF:
            if topic.startswith(prefix):
                keys[key] = keys.get(key, 0.0) + n
                break
        else:
            keys["spark.shuffle.tpu.*"] = keys.get(
                "spark.shuffle.tpu.*", 0.0) + n
    conf_key = max(keys.items(), key=lambda kv: kv[1])[0] if keys \
        else "spark.shuffle.tpu.*"
    topics = ", ".join(f"{t}×{int(n)}"
                       for t, n in sorted(by_topic.items())) \
        or "unknown"
    rounds = float(view.counters.get(C_AGREE_ROUNDS, 0.0))
    # link the newest divergent decision-ledger record: the
    # (epoch, seq) coordinate an operator feeds straight to the
    # ``decisions`` CLI to see every peer's side of the round
    ledger_rec = None
    for recs in view.decisions.values():
        for r in recs:
            if r.get("ok", True):
                continue
            if ledger_rec is None or r.get("ts", 0.0) > \
                    ledger_rec.get("ts", 0.0):
                ledger_rec = r
    evidence = {"divergences": int(total),
                "by_topic": {t: int(n)
                             for t, n in sorted(by_topic.items())},
                "implicated_conf_keys": {
                    k: int(n) for k, n in sorted(keys.items())},
                "agreement_rounds": int(rounds)}
    if ledger_rec is not None:
        evidence["ledger_record"] = {
            k: ledger_rec.get(k)
            for k in ("epoch", "seq", "topic", "error", "process_id")}
    return [Finding(
        rule="desync",
        grade="critical" if total >= th.desync_critical else "warn",
        summary=(f"{int(total)} agreement divergence(s) (topics: "
                 f"{topics}) — processes proposed different values for "
                 f"a decision that must be identical cluster-wide; the "
                 f"exchange fails typed instead of deadlocking, but "
                 f"the cluster is running a split configuration"),
        evidence=evidence,
        conf_key=conf_key,
        remediation=("diff the named conf key (and the full "
                     "spark.shuffle.tpu.* block) across processes — "
                     "every process must launch with identical shuffle "
                     "conf; if confs match, the divergence payload in "
                     "the AgreementDivergenceError names the dissenting "
                     "processes and their proposals — look for "
                     "non-deterministic inputs (unsorted dict/set "
                     "iteration, locale, per-host seeds) feeding the "
                     "agreed decision on those hosts"))]


def _rule_decision_split(view: ClusterView,
                         th: Thresholds) -> List[Finding]:
    """Decision-ledger audit (shuffle/decisions.py): align every peer's
    ledger by (epoch, seq) and require each round to have closed with
    the same topic, the same winner digest, and — under a named reduce
    — the same proposal multiset. This is the rule that catches the
    SILENT split ``agree()`` cannot: a min/max/sum-reduced round
    settles without a unanimity check, so peers feeding divergent
    values (a conf split under a reduced topic) just quietly lose the
    reduction and keep running on an answer they never proposed. No
    noise floor, always critical — by audit time the fleet already
    acted on the divergent inputs. A peer whose ledger is missing
    (plane disabled, dump lost) degrades the audit to a warn naming
    the blind spot — never a crash, and never silence."""
    if not view.decisions:
        return []
    from sparkucx_tpu_torch.shuffle.decisions import (align_rounds,
                                                      audit_round)
    findings: List[Finding] = []
    expected = set(view.decisions)
    if view.processes > len(expected):
        findings.append(Finding(
            rule="decision_split",
            grade="warn",
            summary=(f"decision-ledger audit is PARTIAL: "
                     f"{len(expected)} of {view.processes} processes "
                     f"contributed a ledger — split decisions on the "
                     f"missing peers are invisible to this audit"),
            evidence={"ledgers": sorted(expected),
                      "processes": view.processes},
            conf_key="spark.shuffle.tpu.decisions.enabled",
            remediation=("enable the decision ledger on every process "
                         "(decisions.enabled, on by default) and set "
                         "history.dir so the JSONL survives restarts; "
                         "re-run the audit over a complete dump set")))
    aligned = align_rounds(view.decisions)
    splits = []
    for row in aligned:
        verdict = audit_round(row)
        if verdict is not None:
            splits.append((row, verdict))
    if not splits:
        return findings
    # charge the dominant split topic's conf key, desync-table mapping
    keys: Dict[str, float] = {}
    rows_ev = []
    for row, verdict in splits:
        recs = row["records"]
        any_rec = next(iter(recs.values()))
        topic = str(any_rec.get("topic", ""))
        ck = verdict.get("conf_key") or ""
        if not ck:
            for prefix, key in _DESYNC_CONF:
                if topic.startswith(prefix):
                    ck = key
                    break
            else:
                ck = "spark.shuffle.tpu.*"
        keys[ck] = keys.get(ck, 0.0) + 1.0
        rows_ev.append({"epoch": row["epoch"], "seq": row["seq"],
                        "topic": topic, "split": verdict["split"],
                        "dissenters": verdict["dissenters"],
                        "conf_key": ck})
    conf_key = max(keys.items(), key=lambda kv: kv[1])[0]
    worst = rows_ev[-1]
    findings.append(Finding(
        rule="decision_split",
        grade="critical",
        summary=(f"{len(splits)} agreement round(s) closed SPLIT "
                 f"across peers (newest: topic {worst['topic']!r} at "
                 f"epoch {worst['epoch']} seq {worst['seq']}, "
                 f"{worst['split']} split, dissenting process(es) "
                 f"{worst['dissenters']}) — the fleet is running on "
                 f"divergent decisions it believes were agreed"),
        evidence={"split_rounds": rows_ev[-8:],
                  "splits": len(splits),
                  "rounds_audited": len(aligned),
                  "implicated_conf_keys": {
                      k: int(n) for k, n in sorted(keys.items())}},
        conf_key=conf_key,
        remediation=("diff the named conf key across the dissenting "
                     "processes' launch confs — a reduced topic "
                     "(min/max/sum) settles silently, so this audit is "
                     "the ONLY detector; replay the round with "
                     "`python -m sparkucx_tpu decisions --input <dump>`"
                     " to see every peer's proposal digest")))
    return findings


def _rule_slow_proposer(view: ClusterView,
                        th: Thresholds) -> List[Finding]:
    """Agreement-plane straggler attribution: every ``agree()`` header
    carries its sender's wall-clock send stamp, so each ledger record
    holds the per-peer arrival lag of its header round — zero for the
    last arrival's own stamp baseline, positive for everyone it kept
    waiting. When ONE process is the slowest proposer across most
    audited rounds (share floor) with a real lag (ms floor, NTP-skew
    noise stays under it), the fleet's agreement latency is that
    peer's scheduling/network problem, not the primitive's. Floors per
    the ratio+floor discipline; names the peer and the timeout knob that
    bounds the damage."""
    if not view.decisions or len(view.decisions) < 2:
        # lag columns are identical on every peer (same gathered
        # stamps) but attribution needs a real multi-process fleet
        return []
    # dedupe rounds across peers: every peer logs the same lag row
    rounds: Dict[tuple, List[float]] = {}
    for recs in view.decisions.values():
        for r in recs:
            lag = r.get("lag_ms")
            if not isinstance(lag, list) or len(lag) < 2 \
                    or not r.get("ok", True):
                continue
            rounds.setdefault((r.get("epoch"), r.get("seq")),
                              [float(v) for v in lag])
    if len(rounds) < th.slow_proposer_min_rounds:
        return []
    nprocs = max(len(v) for v in rounds.values())
    last_count = [0] * nprocs
    lag_sum = [0.0] * nprocs
    for lag in rounds.values():
        worst = max(range(len(lag)), key=lambda i: lag[i])
        if lag[worst] >= th.slow_proposer_min_lag_ms:
            last_count[worst] += 1
        for i, v in enumerate(lag):
            lag_sum[i] += v
    total_slow = sum(last_count)
    if total_slow < th.slow_proposer_min_rounds:
        return []
    culprit = max(range(nprocs), key=lambda i: last_count[i])
    share = last_count[culprit] / float(total_slow)
    if share < th.slow_proposer_share:
        return []
    mean_lag = lag_sum[culprit] / max(1, len(rounds))
    return [Finding(
        rule="slow_proposer",
        grade="warn",
        summary=(f"process {culprit} arrived last in "
                 f"{last_count[culprit]} of {total_slow} lagged "
                 f"agreement round(s) ({share:.0%}; mean lag "
                 f"{mean_lag:.1f} ms over {len(rounds)} audited "
                 f"rounds) — every peer's control decisions wait on "
                 f"this one proposer"),
        evidence={"process": culprit,
                  "slow_rounds": last_count[culprit],
                  "lagged_rounds": total_slow,
                  "rounds_audited": len(rounds),
                  "share": round(share, 3),
                  "mean_lag_ms": round(mean_lag, 3),
                  "per_process_slow_counts": last_count},
        conf_key="spark.shuffle.tpu.failure.collectiveTimeoutMs",
        remediation=(f"inspect process {culprit}'s host (CPU "
                     "contention, NUMA/NIC placement, GC or page-cache "
                     "pressure stall its header sends); the lag rides "
                     "wall-clock stamps, so first rule out NTP skew "
                     "via the clock_drift finding — and keep "
                     "collectiveTimeoutMs above the observed lag so "
                     "slow never escalates to timed-out"))]


_RULES = (_rule_straggler, _rule_skew, _rule_retry_storm,
          _rule_compile_churn, _rule_pool_pressure, _rule_overflow_loop,
          _rule_cold_start, _rule_pipeline_stall, _rule_hbm_pressure,
          _rule_bw_underutilization, _rule_padding_waste,
          _rule_wire_dequant, _rule_peer_timeout, _rule_replay_storm,
          _rule_block_corruption, _rule_host_roundtrip,
          _rule_sink_fallback, _rule_kernel_fallback,
          _rule_quota_starvation, _rule_slow_tier,
          _rule_slo_burn, _rule_latency_trend, _rule_spill_bound,
          _rule_dark_time, _rule_phase_regression,
          _rule_peer_unresponsive, _rule_clock_drift, _rule_desync,
          _rule_decision_split, _rule_slow_proposer)


def diagnose(snapshots: Union[Dict, Iterable[Dict]],
             thresholds: Optional[Thresholds] = None,
             fleet: Optional[Dict] = None) -> List[Finding]:
    """Run every rule over one snapshot doc (process-local diagnosis) or
    a list of per-process docs (cluster-wide), most severe first. The
    zero-findings result IS the healthy verdict — rules carry
    minimum-signal floors so an idle or balanced cluster diagnoses
    clean. ``fleet`` attaches a ClusterCollector scrape's reachability/
    skew metadata (utils/collector.fleet_meta) so the fleet-aware rules
    can grade peers that did NOT contribute a doc."""
    th = thresholds or Thresholds()
    view = build_view(snapshots, fleet=fleet)
    findings: List[Finding] = []
    for rule in _RULES:
        findings.extend(rule(view, th))
    findings.sort(key=lambda f: (-_GRADE_ORDER[f.grade], f.rule))
    return findings


def render_findings(findings: List[Finding]) -> str:
    """Human-readable findings report (the CLI's default output)."""
    if not findings:
        return "doctor: no findings — telemetry looks healthy\n"
    lines = [f"doctor: {len(findings)} finding(s)"]
    for f in findings:
        lines.append(f"[{f.grade.upper():>8}] {f.rule}: {f.summary}")
        if f.evidence:
            ev = ", ".join(f"{k}={v}" for k, v in f.evidence.items())
            lines.append(f"           evidence: {ev}")
        if f.conf_key:
            lines.append(f"           turn: {f.conf_key}")
        if f.remediation:
            lines.append(f"           fix: {f.remediation}")
        ts = [t for t in f.trace_ids if t]
        if ts:
            lines.append(f"           traces: {', '.join(ts)}")
    return "\n".join(lines) + "\n"
