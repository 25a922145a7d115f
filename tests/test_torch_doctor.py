"""Port parity for the shuffle doctor (``sparkucx_tpu_torch/utils/
doctor.py``) and its faces on the service, the node and the postmortem.

* The reference's cases: every case of ``tests/test_doctor.py`` (its
  three CLI cases on each package's CLI) but the v2 facade and the two
  ``regress`` cases, plus the
  doctor cases of ``tests/test_decisions.py`` (``decision_split``,
  ``slow_proposer``, the desync link) and ``tests/test_fleet.py``
  (``peer_unresponsive``, ``clock_drift``), each run unchanged on both
  packages (``torch_ref_cases.port_view``: the port's copy of a case
  module imports the port's doctor, metrics and export).
* Equal findings: every document a reference case hands the JAX
  package's ``diagnose`` goes through the port's too, with equal
  ``[f.to_dict() for f in findings]``; together they fire every rule.
* The facade: ``ShuffleService.doctor`` on a skewed read (the reference's
  service case, through ``connect``), its formats, and the provider seam
  the node's watcher reads.
* The smoke's three drills (``chip_smoke.DIAGNOSIS_DRILLS``) at a small
  size, where the port's own telemetry fires the rule and grade the JAX
  package's does: corrupted staged blocks (``block_corruption``), a
  persistent exchange fault under the replay policy (``replay_storm``)
  and a latency objective below every read's wall (``slo_burn``, with
  ``health_status`` naming the burn); a clean node has no critical
  finding.
"""

import copy
import dataclasses
import importlib
import json

import numpy as np
import pytest

import chip_smoke
import sparkucx_tpu.utils.doctor as jdoc
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.utils import doctor as tdoc
from torch_ref_cases import case_ids, port_view, run_case

PFX = "spark.shuffle.tpu."

# reference cases not run here: the v2 facade and bench's regress stage
# (later items), and the service case, which builds the JAX facade by
# hand (test_service_doctor_on_skewed_workload below runs it on both
# packages)
EXCLUDED = {"test_v2_facade_doctor",
            "test_regress_compare_goldens",
            "test_regress_stage_writes_findings_doc",
            "test_service_doctor_on_skewed_workload"}
# the doctor cases of the decision-plane and fleet suites
DECISIONS_CASES = ("test_doctor_decision_split_golden",
                   "test_doctor_decision_split_quiet_on_clean_fleet",
                   "test_doctor_decision_split_partial_audit_warns",
                   "test_doctor_slow_proposer_golden_and_floors",
                   "test_doctor_desync_links_ledger_record")
FLEET_CASES = ("test_peer_unresponsive_telemetry_unreachable_is_warn",
               "test_peer_unresponsive_dead_is_critical",
               "test_peer_unresponsive_wedged_reachable_names_straggler",
               "test_peer_unresponsive_quiet_when_fleet_healthy",
               "test_clock_drift_grades_and_floor")
# the rule ids, one per rule function
RULE_IDS = ("straggler_peer", "partition_skew", "retry_storm",
            "compile_churn", "pool_pressure", "overflow_loop", "cold_start",
            "pipeline_stall", "hbm_pressure", "bw_underutilization",
            "padding_waste", "wire_dequant_error", "peer_timeout",
            "replay_storm", "block_corruption", "host_roundtrip",
            "sink_fallback", "kernel_fallback", "quota_starvation",
            "slow_tier", "slo_burn", "latency_trend", "spill_bound",
            "dark_time", "phase_regression", "peer_unresponsive",
            "clock_drift", "desync", "decision_split", "slow_proposer")
# cases that read through a manager (not a document)
MANAGER_CASES = {"test_exchange_reports_carry_trace_ids",
                 "test_flight_ring_and_postmortem_carry_trace_ids"}


def _names(mod, only=None):
    return [n for n in dir(mod) if n.startswith("test_")
            and callable(getattr(mod, n)) and n not in EXCLUDED
            and (only is None or n in only)]


MODULES = {"test_doctor": None, "test_decisions": DECISIONS_CASES,
           "test_fleet": FLEET_CASES}


def _cases():
    out = []
    for modname, only in MODULES.items():
        ref = importlib.import_module(modname)
        for name, params in case_ids(ref, _names(ref, only)):
            tag = "-".join(str(v) for v in params.values())
            out.append(pytest.param(modname, name, params,
                                    id=f"{name}[{tag}]" if tag else name))
    return out


CASES = _cases()


@pytest.fixture()
def port_manager_factory():
    """The port's counterpart of the JAX package's ``manager_factory``:
    ``make(overrides)`` -> a manager on the CPU (dense, 8 shards); a new
    one stops the previous one first."""
    made = []

    def make(overrides=None):
        while made:
            made.pop().stop()
        conf = {PFX + "a2a.impl": "dense"}
        conf.update(overrides or {})
        svc = connect(conf, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    while made:
        made.pop().stop()


PORT_FIXTURES = {"manager_factory": "port_manager_factory"}


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("modname,name,params", CASES)
def test_reference_case(side, modname, name, params, request):
    """One reference case, unchanged, on one package."""
    if side == "jax":
        run_case(importlib.import_module(modname), name, params, request)
    else:
        run_case(port_view(modname), name, params, request, PORT_FIXTURES)


def _recorded_diagnoses(modname, name, params, request, monkeypatch):
    """Run a reference case on the JAX package, recording every
    ``diagnose`` call's (args, kwargs, findings)."""
    calls = []
    real = jdoc.diagnose

    def recorder(*args, **kw):
        snap = copy.deepcopy((args, kw))
        out = real(*args, **kw)
        calls.append((snap[0], snap[1], out))
        return out

    ref = importlib.import_module(modname)
    monkeypatch.setattr(jdoc, "diagnose", recorder)
    if getattr(ref, "diagnose", None) is real:
        monkeypatch.setattr(ref, "diagnose", recorder)
    run_case(ref, name, params, request)
    monkeypatch.undo()
    return calls


def _port_findings(args, kw):
    kw = dict(kw)
    th = kw.get("thresholds")
    if th is not None:
        kw["thresholds"] = tdoc.Thresholds(**dataclasses.asdict(th))
    return [f.to_dict() for f in tdoc.diagnose(*args, **kw)]


DOCUMENT_CASES = [c for c in CASES if c.values[1] not in MANAGER_CASES]


@pytest.mark.parametrize("modname,name,params", DOCUMENT_CASES)
def test_equal_findings_on_reference_documents(modname, name, params,
                                               request, monkeypatch):
    """Every document the case hands the JAX package's doctor gives
    equal findings on the port's."""
    for args, kw, out in _recorded_diagnoses(modname, name, params,
                                             request, monkeypatch):
        assert _port_findings(args, kw) == [f.to_dict() for f in out]


def test_reference_documents_fire_every_rule(request, monkeypatch):
    """The reference's documents (the doctor, decision-plane, fleet and
    anatomy suites) fire all the port's rules, each with equal
    findings on both packages."""
    fired = set()
    cases = [(c.values[0], c.values[1], c.values[2])
             for c in DOCUMENT_CASES]
    cases += [("test_anatomy", n, {}) for n in (
        "test_dark_time_rule_fires_and_cites_intervals",
        "test_phase_regression_names_phase_and_knob")]
    for modname, name, params in cases:
        for args, kw, out in _recorded_diagnoses(modname, name, params,
                                                 request, monkeypatch):
            got = _port_findings(args, kw)
            assert got == [f.to_dict() for f in out], name
            fired |= {f["rule"] for f in got}
    assert fired == set(RULE_IDS)
    assert len(RULE_IDS) == len(tdoc._RULES)


def test_thresholds_and_rules_are_the_reference_s():
    assert dataclasses.asdict(tdoc.Thresholds()) == \
        dataclasses.asdict(jdoc.Thresholds())
    assert [r.__name__ for r in tdoc._RULES] == \
        [r.__name__ for r in jdoc._RULES]
    assert tdoc.GRADES == jdoc.GRADES
    assert tdoc._PHASE_CONF == jdoc._PHASE_CONF
    assert tdoc._DESYNC_CONF == jdoc._DESYNC_CONF


def test_render_findings_equal():
    f = dict(rule="partition_skew", grade="warn", summary="s",
             evidence={"skew_ratio": 8.0}, conf_key=PFX + "a2a.x",
             remediation="r", trace_ids=["s1.e0.x1"])
    assert tdoc.render_findings([tdoc.Finding(**f)]) == \
        jdoc.render_findings([jdoc.Finding(**f)])
    assert tdoc.render_findings([]) == jdoc.render_findings([])
    with pytest.raises(ValueError):
        tdoc.Finding(rule="x", grade="fatal", summary="")


# -- the facade --------------------------------------------------------------
def _jax_service(conf):
    from sparkucx_tpu.service import connect as jconnect
    from sparkucx_tpu.utils.export import collect_snapshot
    from sparkucx_tpu.utils.metrics import GLOBAL_METRICS
    svc = jconnect({PFX + "a2a.impl": "dense", PFX + "io.format": "raw",
                    **conf}, use_env=False)
    svc.global_base = collect_snapshot(GLOBAL_METRICS)
    return svc


def _doctor(svc):
    """The service's findings on its own telemetry. The JAX package's
    snapshot also holds its process-global registry, which earlier tests
    of this process fed (retries, watchdog expiries, agreement rounds):
    its doctor reads the snapshot less that registry's state when the
    service started."""
    base = getattr(svc, "global_base", None)
    if base is None:
        return svc.doctor()
    from sparkucx_tpu.utils.metrics import Histogram
    doc = svc.stats("json")
    # a counter name has one owning registry (the node's wins a clash);
    # histograms of both registries add up
    own = svc.node.metrics.snapshot()
    doc["counters"] = {
        k: v - (0.0 if k in own else base["counters"].get(k, 0.0))
        for k, v in doc["counters"].items()}
    doc["counters"] = {k: v for k, v in doc["counters"].items() if v}
    doc["histograms"] = {
        k: Histogram.snapshot_delta(v, base["histograms"].get(k))
        for k, v in doc["histograms"].items()}
    return jdoc.diagnose(doc)


def _port_service(conf):
    return connect({PFX + "a2a.impl": "dense", **conf}, device="cpu",
                   use_env=False)


SERVICES = [pytest.param(_jax_service, id="jax"),
            pytest.param(_port_service, id="port")]


@pytest.mark.parametrize("make", SERVICES)
def test_service_doctor_on_skewed_workload(make, mesh8):
    """The reference's service case: all rows in one of 8 partitions is a
    ``partition_skew`` warning naming the read's trace id, in every
    format."""
    with make({}) as svc:
        h = svc.register_shuffle(71, 4, 8, partitioner="direct")
        for m in range(4):
            svc.write(h, m, np.zeros(512, dtype=np.int64))
        svc.read(h)
        fs = _doctor(svc)
        skew = next(f for f in fs if f.rule == "partition_skew")
        assert skew.grade == "warn"
        assert svc.manager.report(71).trace_id in skew.trace_ids
        assert svc.doctor("text").startswith("doctor:")
        json.dumps(svc.doctor("json"))
        with pytest.raises(ValueError):
            svc.doctor("yaml")


def test_service_doctor_equal_across_packages(mesh8):
    """The same skewed read on both facades: equal findings (rule, grade,
    summary, knob, trace ids), but for the JAX package's compile_churn,
    which reads its step cache's compiles (the port compiles nothing)."""
    got = []
    for make in (_jax_service, _port_service):
        with make({}) as svc:
            h = svc.register_shuffle(72, 4, 8, partitioner="direct")
            for m in range(4):
                svc.write(h, m, np.arange(512, dtype=np.int64) % 2)
            svc.read(h)
            got.append([(f.rule, f.grade, f.summary, f.conf_key,
                         f.trace_ids) for f in _doctor(svc)
                        if f.rule != "compile_churn"])
    assert got[0] == got[1] and got[1]


def test_providers_follow_the_service(mesh8):
    """The node's providers serve the service's stats and doctor while it
    runs, and the node's own after stop."""
    svc = _port_service({})
    node = svc.node
    h = svc.register_shuffle(73, 4, 8, partitioner="direct")
    for m in range(4):
        svc.write(h, m, np.zeros(512, dtype=np.int64))
    svc.read(h)
    assert node.telemetry_provider()["exchange_reports"]
    assert "partition_skew" in {f.rule for f in node.doctor_provider()}
    svc.stop()
    assert node.telemetry_provider == node.telemetry_snapshot
    assert node.doctor_provider == node._default_doctor


# -- drills: the port's own telemetry fires the reference's rules -----------
def _stage(svc, sid, seed=0, maps=2, rows=512, parts=4):
    rng = np.random.default_rng(seed)
    h = svc.register_shuffle(sid, maps, parts)
    for m in range(maps):
        svc.write(h, m, rng.integers(0, 1 << 30, size=rows,
                                     dtype=np.int64))
    return h


def _corruption_drill(make):
    """Three reads of one shuffle under an armed ``corrupt.staged`` site,
    each failing typed: three corrupt blocks."""
    n = chip_smoke.DIAGNOSIS_CORRUPT_READS
    conf = {PFX + "fault.corrupt.staged.failCount": str(n),
            PFX + "fault.corrupt.staged.offset": "97"}
    with make(conf) as svc:
        h = _stage(svc, 80)
        for _ in range(n):
            with pytest.raises(Exception) as e:
                svc.read(h)
            assert type(e.value).__name__ == "BlockCorruptionError"
        return [f for f in _doctor(svc) if f.rule == "block_corruption"]


def _replay_drill(make):
    """One read whose exchange fails twice under the replay policy (two
    replays: the default budget)."""
    n = chip_smoke.DIAGNOSIS_REPLAYS
    conf = {PFX + "failure.policy": "replay",
            PFX + "fault.exchange.failCount": str(n)}
    with make(conf) as svc:
        h = _stage(svc, 90)
        svc.read(h)
        assert svc.manager.report(90).replays == n
        return [f for f in _doctor(svc) if f.rule == "replay_storm"]


def _slo_drill(make):
    """Reads slower than a 1 us latency objective: a fast burn of its
    budget over one window."""
    conf = {PFX + "slo.read.p99Ms": "0.001",
            PFX + "history.windowSecs": "86400"}
    with make(conf) as svc:
        node = svc.node
        h = _stage(svc, 95)
        svc.read(h)           # the JAX package's compiling read
        node.history.roll()
        for _ in range(5):
            svc.read(h)
        node.history.roll()
        verdict = svc.slo()
        status = node.health_status()
        return ([f for f in _doctor(svc) if f.rule == "slo_burn"],
                verdict, status)


def _summary(findings):
    return [(f.rule, f.grade, f.conf_key) for f in findings]


def _drill(name, knob):
    rule, grade = chip_smoke.DIAGNOSIS_DRILLS[name]
    return [(rule, grade, PFX + knob)]


def test_drill_block_corruption(mesh8):
    got = [_summary(_corruption_drill(m)) for m in (_jax_service,
                                                     _port_service)]
    assert got[0] == got[1] == _drill("corruption", "integrity.verify")


def test_drill_replay_storm(mesh8):
    got = [_summary(_replay_drill(m)) for m in (_jax_service,
                                                 _port_service)]
    assert got[0] == got[1] == _drill("replay", "failure.policy")


def test_drill_slo_burn(mesh8):
    got = [_slo_drill(m) for m in (_jax_service, _port_service)]
    for findings, verdict, status in got:
        assert verdict["burning"] == ["slo.read.p99Ms"]
        assert status["cause"] == "slo_fast_burn" and not status["ok"]
    assert _summary(got[0][0]) == _summary(got[1][0]) == \
        _drill("slo", "slo.read.p99Ms")


@pytest.mark.parametrize("make", SERVICES)
def test_clean_node_has_no_critical_finding(make, mesh8):
    with make({}) as svc:
        for i in range(3):
            svc.read(_stage(svc, 60 + i, seed=i))
        assert [f for f in _doctor(svc) if f.grade == "critical"] == []
