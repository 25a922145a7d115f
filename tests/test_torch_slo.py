"""Port parity for the SLO plane (``sparkucx_tpu_torch/utils/slo.py``)
and its faces on the node and the service.

* The reference's cases: the objective, burn and per-tenant cases of
  ``tests/test_slo.py`` (conf parsing and its validation, burn firing,
  clearing and budget re-accrual, the bucket boundary, availability over
  replays, ``test_whale_burn_does_not_move_minnow_budget`` through the
  port's manager and node) and its dumper cases, each run unchanged on
  both packages (``torch_ref_cases.port_view``), with its facade-and-live
  ``/slo`` case and its three CLI cases. Its history cases are
  ``tests/test_torch_history.py``'s; the v2-facade case waits for its
  module.
* ``evaluate`` on the same seeded frames (global, per-tenant, latency and
  availability objectives, several policies): equal verdicts on both
  packages, exactly; ``render_verdict`` equal text; the objectives the
  two packages parse from one conf equal.
* The facade: ``ShuffleService.slo`` in both formats and the snapshot
  carrying the frames and objectives (the reference's facade case without
  its live route); the key table's defaults are ``BurnPolicy``'s.
"""

import importlib

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu.utils import slo as jslo
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import TELEMETRY_KEYS, ShuffleConf
from sparkucx_tpu_torch.utils import slo as tslo
from torch_ref_cases import case_ids, port_view, run_case

PFX = "spark.shuffle.tpu."
REF_CASES = ("test_objectives_from_conf_parse_and_overrides",
             "test_objectives_validation_fails_fast",
             "test_evaluate_burn_fires_clears_and_budget_reaccrues",
             "test_good_count_bucket_boundary",
             "test_availability_objective_counts_replays",
             "test_whale_burn_does_not_move_minnow_budget",
             "test_tick_only_dumper_without_dump_dir",
             "test_dumper_off_without_history_or_dump_dir",
             "test_facade_slo_and_live_endpoint",
             "test_cli_slo_replays_history_dir",
             "test_cli_slo_rejects_anchorless_history",
             "test_cli_slo_live_node_requires_node")
REF = importlib.import_module("test_slo")
CASES = [pytest.param(n, p, id=n) for n, p in case_ids(REF, REF_CASES)]


@pytest.fixture()
def port_manager_factory():
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


def _service_factory(connect_fn):
    made = []

    def make(overrides=None):
        while made:
            made.pop().stop()
        conf = dict(REF.BASE_CONF)
        conf.update(overrides or {})
        svc = connect_fn(conf)
        made.append(svc)
        return svc

    return make, made


@pytest.fixture()
def jax_service_factory(mesh8):
    from sparkucx_tpu.service import connect as jconnect
    make, made = _service_factory(lambda c: jconnect(c, use_env=False))
    yield make
    while made:
        made.pop().stop()


@pytest.fixture()
def port_service_factory():
    make, made = _service_factory(
        lambda c: connect(c, device="cpu", use_env=False))
    yield make
    while made:
        made.pop().stop()


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("name,params", CASES)
def test_reference_case(side, name, params, request):
    """One reference case, unchanged, on one package."""
    if side == "jax":
        run_case(REF, name, params, request,
                 {"service_factory": "jax_service_factory"})
    else:
        run_case(port_view("test_slo"), name, params, request,
                 {"manager_factory": "port_manager_factory",
                  "service_factory": "port_service_factory"})


# -- evaluate() on the same frames ------------------------------------------
def random_frames(seed: int, n: int = 12):
    """``n`` one-minute frames of read waits (global and two tenants'
    labeled series, lognormal around a per-frame level that sometimes
    jumps) with read, replay and deadline counts."""
    rng = np.random.default_rng(seed)
    t0 = 1_000_000.0 + seed * 10_000.0
    frames = []
    for i in range(n):
        hists, counters = {}, {}
        level = rng.choice([5.0, 20.0, 400.0], p=[0.6, 0.25, 0.15])
        for tenant in ("", "whale", "minnow"):
            k = int(rng.integers(0, 12))
            name = jmet.labeled(jmet.H_FETCH_WAIT, tenant=tenant) \
                if tenant else jmet.H_FETCH_WAIT
            cname = jmet.labeled("shuffle.read.count", tenant=tenant) \
                if tenant else "shuffle.read.count"
            if k:
                h = jmet.Histogram(name)
                for v in rng.lognormal(np.log(level), 0.5, size=k):
                    h.observe(float(v))
                hists[name] = h.snapshot()
            counters[cname] = float(k)
            if rng.random() < 0.3:
                rname = jmet.labeled(jmet.C_REPLAYS, tenant=tenant) \
                    if tenant else jmet.C_REPLAYS
                counters[rname] = float(rng.integers(1, 4))
        if rng.random() < 0.2:
            counters[jmet.C_PEER_TIMEOUT] = 1.0
        frames.append({"kind": "history_frame", "seq": i + 1,
                       "t_start": t0 + 60.0 * i, "t_end": t0 + 60.0 * (i + 1),
                       "window_s": 60.0, "pid": 1, "process_id": 0,
                       "counters": counters, "histograms": hists,
                       "gauges": {}})
    rng.shuffle(frames)                      # evaluate sorts by t_end
    return frames


def _objectives(slo):
    O = slo.Objective
    return [O("slo.read.p99Ms", "latency", threshold_ms=50.0),
            O("slo.read.p99Ms", "latency", tenant="whale",
              threshold_ms=100.0, target=0.95),
            O("slo.read.p99Ms", "latency", tenant="minnow",
              threshold_ms=10.0, target=0.9),
            O("slo.availability", "availability", target=0.999),
            O("slo.availability", "availability", tenant="whale",
              target=0.8)]


POLICIES = [dict(), dict(fast_window_s=120.0, slow_window_s=480.0,
                         min_events=2),
            dict(fast_burn=2.0, slow_burn=1.0, min_events=10)]


@pytest.mark.parametrize("policy", range(len(POLICIES)))
@pytest.mark.parametrize("seed", range(6))
def test_evaluate_equal_on_random_frames(seed, policy):
    frames = random_frames(seed)
    got = [slo.evaluate(frames, _objectives(slo),
                        policy=slo.BurnPolicy(**POLICIES[policy]))
           for slo in (jslo, tslo)]
    assert got[0] == got[1]
    assert tslo.render_verdict(got[1]) == jslo.render_verdict(got[0])
    # replayed history grades as of its newest frame
    assert got[1]["ts"] == max(f["t_end"] for f in frames)


def test_evaluate_empty_and_objectiveless_equal():
    for frames, objs in (([], []), ([], _objectives), (
            random_frames(0), [])):
        got = [slo.evaluate(frames, objs(slo) if callable(objs) else objs,
                            now=5.0) for slo in (jslo, tslo)]
        assert got[0] == got[1]
    assert tslo.render_verdict({"objectives": []}) == \
        jslo.render_verdict({"objectives": []})


def test_objectives_and_policy_from_one_conf_equal():
    conf = {PFX + "slo.read.p99Ms": "250", PFX + "slo.read.target": "0.95",
            PFX + "slo.availability": "0.995",
            PFX + "slo.fastWindowSecs": "60", PFX + "slo.slowBurn": "3",
            PFX + "slo.minEvents": "7",
            PFX + "tenant.whale.slo.read.p99Ms": "1000",
            PFX + "tenant.minnow.slo.availability": "0.9"}
    j = TpuShuffleConf(conf, use_env=False)
    t = ShuffleConf(conf, use_env=False)
    assert [o.to_dict() for o in tslo.objectives_from_conf(t)] == \
        [o.to_dict() for o in jslo.objectives_from_conf(j)]
    assert tslo.BurnPolicy.from_conf(t).to_dict() == \
        jslo.BurnPolicy.from_conf(j).to_dict()
    raw = [o.to_dict() for o in jslo.objectives_from_conf(j)]
    assert [o.to_dict() for o in tslo.objectives_from_dicts(
        raw + raw[:1] + [{"kind": "latency"}])] == raw
    pol = tslo.BurnPolicy.from_dict({"fast_burn": 3.0, "unknown": 1})
    assert pol.fast_burn == 3.0
    assert tslo.BurnPolicy.from_dict(None) == tslo.BurnPolicy()


def test_key_table_defaults_are_the_policy_s():
    """The key table documents the defaults ``BurnPolicy`` and the
    objectives use."""
    pol = tslo.BurnPolicy()
    assert float(TELEMETRY_KEYS["slo.fastWindowSecs"][0]) == \
        pol.fast_window_s
    assert float(TELEMETRY_KEYS["slo.slowWindowSecs"][0]) == \
        pol.slow_window_s
    assert float(TELEMETRY_KEYS["slo.fastBurn"][0]) == pol.fast_burn
    assert float(TELEMETRY_KEYS["slo.slowBurn"][0]) == pol.slow_burn
    assert int(TELEMETRY_KEYS["slo.minEvents"][0]) == pol.min_events
    assert TELEMETRY_KEYS["slo.read.target"][0] == "0.99"
    assert TELEMETRY_KEYS["slo.read.p99Ms"][0] == ""
    assert TELEMETRY_KEYS["slo.availability"][0] == ""
    assert tslo.BurnPolicy.from_conf(ShuffleConf({}, use_env=False)) == pol
    assert tslo.objectives_from_conf(ShuffleConf({}, use_env=False)) == []


def test_bad_objective_fails_the_node_start():
    with pytest.raises(ValueError, match="slo.read.p99Ms"):
        connect({PFX + "slo.read.p99Ms": "-1"}, device="cpu",
                use_env=False)


# -- the facade --------------------------------------------------------------
def test_facade_slo_formats_and_snapshot():
    """The reference's facade case on the port, without its live route:
    a healthy verdict over two windows, its text, a refused format, and
    the snapshot carrying the frames and objectives."""
    with connect({**REF.BASE_CONF,
                  PFX + "history.windowSecs": "86400",
                  PFX + "slo.read.p99Ms": "500"}, device="cpu",
                 use_env=False) as svc:
        rng = np.random.default_rng(1)
        h = svc.register_shuffle(720, 2, 4)
        for m in range(2):
            svc.write(h, m, rng.integers(0, 1 << 30, size=512))
        for _ in range(2):
            svc.read(h)
            svc.node.history.roll()
        verdict = svc.slo()
        assert verdict["healthy"] and len(verdict["objectives"]) == 1
        assert verdict is svc.node.slo_verdict()        # cached per frame
        assert "slo.read.p99Ms" in svc.slo("text")
        with pytest.raises(ValueError):
            svc.slo("prometheus")
        doc = svc.stats("json")
        assert doc["history_frames"] and doc["slo_objectives"]
        assert doc["slo_policy"] == tslo.BurnPolicy().to_dict()
        # the frames carry them too, so a history dir describes itself
        assert doc["history_frames"][-1]["slo_objectives"] == \
            doc["slo_objectives"]
        assert svc.node.health_status()["ok"]


def test_objectiveless_node_is_healthy_and_empty():
    with connect({}, device="cpu", use_env=False) as svc:
        v = svc.slo()
        assert v["objectives"] == [] and v["healthy"]
        assert svc.node.slo_fast_burn() == []
        assert "no objectives declared" in svc.slo("text")
        assert "slo_objectives" not in svc.stats("json")
