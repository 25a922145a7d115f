"""Port parity for the exchange anatomy (``sparkucx_tpu_torch/utils/
anatomy.py``), the manager's settlement that stamps it on every report,
and the Perfetto phase tracks of ``export.merge_timeline(anatomy=True)``.

* The reference's cases: every case of ``tests/test_anatomy.py``, the
  three CLI cases and the live ``/anatomy`` route among them, each run
  unchanged on both packages (``torch_ref_cases.port_view``); the
  end-to-end cases read through the port's manager on the CPU (dense,
  8 shards) and hold it to the reference's 95% attribution bar (their
  JAX side is the reference suite's own run).
* ``fold_events`` on seeded random span lists (names from the whole
  taxonomy, tagged, untagged and foreign spans, overlaps, replayed
  walls): equal ledgers on both packages, exactly.
* A live read of each mode on each package with the tracer on: the same
  phase keys (the JAX package's ``compile`` aside: the port compiles
  nothing), each ledger conserving; the waved, two-tier and replayed
  reads' ledgers too; a failed read's ledger and counters as the
  reference keeps them; a fold that fails leaves the report
  unannotated.
* ``merge_timeline(anatomy=True)``: equal child tracks on both packages.
"""

import importlib

import numpy as np
import pytest

from sparkucx_tpu.utils import anatomy as janat
from sparkucx_tpu.utils import export as jexp
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.utils import anatomy as tanat
from sparkucx_tpu_torch.utils import export as texp
from torch_ref_cases import case_ids, port_view, run_case

PFX = "spark.shuffle.tpu."
EXCLUDED = set()
REF = importlib.import_module("test_anatomy")
# (side, case, params): the JAX side of the end-to-end cases is the
# reference suite itself (tests/test_anatomy.py), not run twice
CASES = [pytest.param(side, n, p, id=f"{n}{list(p.values()) or ''}-{side}")
         for n, p in case_ids(REF, [n for n in dir(REF)
                                    if n.startswith("test_")
                                    and n not in EXCLUDED])
         for side in ("jax", "port")
         if side == "port" or not n.startswith("test_e2e_")]


@pytest.fixture()
def port_manager_factory():
    """``make(overrides)`` -> a port manager on the CPU (dense, 8
    shards); a new one stops the previous one first."""
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


@pytest.mark.parametrize("side,name,params", CASES)
def test_reference_case(side, name, params, request):
    """One reference case, unchanged, on one package."""
    if side == "jax":
        run_case(REF, name, params, request)
    else:
        run_case(port_view("test_anatomy"), name, params, request,
                 {"manager_factory": "port_manager_factory"})


def test_taxonomy_is_the_reference_s():
    assert tanat.PHASES == janat.PHASES and tanat.DARK == janat.DARK
    assert tanat.SPAN_PHASE == janat.SPAN_PHASE
    assert tanat._PRIORITY == janat._PRIORITY
    assert tanat._CONTAINMENT_OK == janat._CONTAINMENT_OK
    assert tanat.WALL_SPAN == janat.WALL_SPAN


# -- fold_events on seeded random spans --------------------------------------
NAMES = sorted(set(janat.SPAN_PHASE) | {"shuffle.tier",
                                        "shuffle.exchange.wait",
                                        "shuffle.publish", "devmon.sample"})


def random_events(seed: int, n: int = 60):
    """Walls of three exchanges (one replayed) and ``n`` spans around
    them: tagged with one of the traces, untagged or foreign, inside,
    across and outside the walls, with tier attrs."""
    rng = np.random.default_rng(seed)
    traces = [f"s{i}.e0.x{i}" for i in (1, 2, 3)]
    evs = []
    for i, tr in enumerate(traces):
        evs.append({"name": "shuffle.exchange", "ph": "X",
                    "ts": float(i * 20_000), "dur": 15_000.0, "pid": 0,
                    "tid": 1, "args": {"trace": tr, "completed": True}})
    evs.append({"name": "shuffle.exchange", "ph": "X", "ts": 70_000.0,
                "dur": 9_000.0, "pid": 0, "tid": 1,
                "args": {"trace": traces[0], "completed": True}})
    for _ in range(n):
        name = NAMES[rng.integers(len(NAMES))]
        ts = float(rng.uniform(-5_000, 85_000))
        dur = float(rng.exponential(3_000))
        args = {}
        r = rng.random()
        if r < 0.6:
            args["trace"] = traces[rng.integers(3)]
        elif r < 0.7:
            args["trace"] = "s9.e9.x9"
        if name in ("shuffle.tier", "shuffle.exchange.wait"):
            args["tier"] = ("ici", "dcn")[rng.integers(2)]
        ev = {"name": name, "ph": "X" if rng.random() < 0.95 else "i",
              "ts": ts, "dur": dur, "pid": 0, "tid": int(rng.integers(4)),
              "args": args}
        evs.append(ev)
    return evs, traces


def _ledger(led):
    return None if led is None else (led.to_dict(), led.segments,
                                     led.dark_intervals, led.wall_start_us,
                                     led.wall_end_us)


@pytest.mark.parametrize("seed", range(12))
def test_fold_events_equal_on_random_spans(seed):
    evs, traces = random_events(seed)
    assert tanat.trace_ids(evs) == janat.trace_ids(evs)
    for tr in traces + ["s7.e0.x7"]:
        t, j = tanat.fold_events(evs, tr), janat.fold_events(evs, tr)
        assert _ledger(t) == _ledger(j)
        if t is not None:
            # conservation by construction
            assert sum(t.phases_ms.values()) + t.dark_ms == \
                pytest.approx(t.wall_ms, abs=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_report_and_renderers_equal_on_random_spans(seed):
    evs, _ = random_events(seed)
    doc = {"process_id": 0, "trace_events": evs,
           "anchor": {"wall": 1000.0, "perf": 0.0, "perf_epoch": 0.0,
                      "wall_epoch": 1000.0, "pid": 1.0}}
    t = tanat.report_from_docs([doc], max_ledgers=2)
    assert t == janat.report_from_docs([doc], max_ledgers=2)
    assert [tanat.render_ledger(x) for x in t["ledgers"]] == \
        [janat.render_ledger(x) for x in t["ledgers"]]
    assert tanat.render_critical_path(t["critical_path"]) == \
        janat.render_critical_path(t["critical_path"])
    assert tanat.phase_track_events(evs, pid=5) == \
        janat.phase_track_events(evs, pid=5)


@pytest.mark.parametrize("seed", range(3))
def test_merge_timeline_anatomy_tracks_equal(seed):
    """Two processes' captures (clocks 1.5 s apart): the same merged
    timeline, phase child tracks included, on both packages; the tracks
    tile each settled wall."""
    docs = []
    for pid in (0, 1):
        evs, _ = random_events(seed * 2 + pid, n=30)
        docs.append({"process_id": pid, "trace_events": evs,
                     "anchor": {"wall": 1000.0 + 1.5 * pid, "perf": 0.0,
                                "perf_epoch": 0.0,
                                "wall_epoch": 1000.0 + 1.5 * pid,
                                "pid": float(100 + pid)}})
    t = texp.merge_timeline(docs, anatomy=True)
    assert t == jexp.merge_timeline(docs, anatomy=True)
    tracks = [e for e in t["traceEvents"]
              if (e.get("args") or {}).get("anatomy")]
    assert tracks
    for doc in docs:
        pid = doc["process_id"]
        for tr in tanat.trace_ids(doc["trace_events"]):
            wall = tanat.fold_events(doc["trace_events"], tr).wall_ms
            tiled = sum(e["dur"] for e in tracks if e["pid"] == pid
                        and e["args"]["trace"] == tr)
            assert tiled == pytest.approx(wall * 1e3)
    plain = texp.merge_timeline(docs)
    assert len(t["traceEvents"]) > len(plain["traceEvents"])
    assert not [e for e in plain["traceEvents"]
                if (e.get("args") or {}).get("anatomy")]


# -- live reads on both packages --------------------------------------------
MODES = {"plain": {}, "ordered": {"ordered": True},
         "combine": {"combine": "sum"}, "device_sink": {"sink": "device"}}


def _read_once(mgr, sid, mode):
    return REF._run_exchange(mgr, sid, mode)


def _check_conserves(rep):
    assert rep.completed and rep.anatomy_wall_ms > 0.0 and rep.phases
    assert sum(rep.phases.values()) + rep.dark_ms == \
        pytest.approx(rep.anatomy_wall_ms, abs=0.05)
    assert len(rep.dark_intervals) <= 16


@pytest.mark.parametrize("mode", list(MODES))
def test_live_read_phase_keys_and_conservation(mode, manager_factory,
                                               port_manager_factory):
    """The same read on both packages: each ledger conserves, and the
    phase keys agree but for the JAX package's ``compile`` and the port's
    ``verify`` (its staged verify has a span of its own; the reference's
    lands in ``plan``)."""
    keys = []
    for make, own in ((manager_factory, set()),
                      (port_manager_factory, {"verify"})):
        mgr = make({PFX + "trace.enabled": "true"})
        _read_once(mgr, 800, mode)           # warm (the JAX compile)
        rep = _read_once(mgr, 801, mode)
        _check_conserves(rep)
        assert all(rep.phases.get(ph, 0.0) > 0.0 for ph in own)
        keys.append(set(rep.phases) - {"compile"} - own)
    assert keys[0] == keys[1]


def test_staged_read_ledger_has_a_verify_phase(port_manager_factory):
    """A read at the default ``integrity.verify=staged``: its
    ``shuffle.verify`` span (``level="staged"``, the verified bytes, the
    read's trace id) is the ledger's ``verify`` phase, above 0, and the
    ledger still conserves."""
    mgr = port_manager_factory({PFX + "trace.enabled": "true"})
    rep = _read_once(mgr, 840, "plain")
    _check_conserves(rep)
    assert rep.integrity == "staged" and rep.phases["verify"] > 0.0
    (sp,) = [s for s in mgr.node.tracer.spans("shuffle.verify")
             if s.attrs["trace"] == rep.trace_id]
    assert sp.attrs["level"] == "staged"
    assert sp.attrs["bytes"] == rep.integrity_bytes > 0


@pytest.mark.parametrize("conf", [
    pytest.param({PFX + "a2a.waveRows": "512"}, id="waved"),
    pytest.param({PFX + "mesh.numSlices": "2"}, id="two_tier"),
    pytest.param({PFX + "failure.policy": "replay",
                  PFX + "fault.exchange.failCount": "1"}, id="replayed")])
def test_live_read_ledgers_of_other_settlements(conf, manager_factory,
                                                port_manager_factory):
    """Waved, two-tier and replayed reads settle their ledgers too, with
    the same phase keys on both packages (``compile`` and the port's
    ``verify`` aside)."""
    keys = []
    for make, own in ((manager_factory, set()),
                      (port_manager_factory, {"verify"})):
        mgr = make({PFX + "trace.enabled": "true", **conf})
        _read_once(mgr, 810, "plain")
        rep = _read_once(mgr, 811, "plain")
        _check_conserves(rep)
        assert all(rep.phases.get(ph, 0.0) > 0.0 for ph in own)
        keys.append(set(rep.phases) - {"compile"} - own)
    assert keys[0] == keys[1]


def test_failed_read_ledger_and_counters_match(manager_factory,
                                               port_manager_factory):
    """A read whose exchange fails: whether its report keeps a ledger
    matches the reference, and neither package adds
    ``shuffle.phase.ms`` for it."""
    from sparkucx_tpu_torch.utils.metrics import C_PHASE_MS
    got = []
    for make in (manager_factory, port_manager_factory):
        mgr = make({PFX + "trace.enabled": "true",
                    PFX + "failure.maxAttempts": "1"})
        h = mgr.register_shuffle(820, 2, 4)
        for m in range(2):
            w = mgr.get_writer(h, m)
            w.write(np.arange(64, dtype=np.int64))
            w.commit(4)
        mgr.node.faults.arm("exchange", fail_count=1)
        with pytest.raises(Exception):
            mgr.read(h)
        rep = mgr.report(820)
        got.append((rep.completed, rep.anatomy_wall_ms > 0.0,
                    bool(rep.phases),
                    [k for k in mgr.node.metrics.snapshot()
                     if k.startswith(C_PHASE_MS)]))
    assert got[0] == got[1]
    assert got[1][0] is False and got[1][3] == []


def test_fold_failure_leaves_report_unannotated(port_manager_factory,
                                                monkeypatch):
    """A fold that raises never fails the read: the report is simply
    unannotated."""
    from sparkucx_tpu_torch.shuffle import manager as tman

    def broken(tracer, trace_id):
        raise RuntimeError("fold failed")

    monkeypatch.setattr(tman, "fold_tracer", broken)
    mgr = port_manager_factory({PFX + "trace.enabled": "true"})
    rep = _read_once(mgr, 830, "plain")
    assert rep.completed and rep.phases == {} and rep.anatomy_wall_ms == 0
