"""Port parity for the doctor watcher (``sparkucx_tpu_torch/runtime/
devmon.DoctorWatcher``) and the node's health verdict.

* One scripted ``doctor_provider`` sequence (critical and warn findings
  on changing exchanges, quiet streaks, a rule minting a new finding every
  pass) through both packages' watchers with no profiler window
  (``captureMs=0``): the same captures pass by pass, the same re-arms and
  the same ``RULE_CAPTURE_CAP`` refunds.
* The node: ``doctor.*`` keys start the watcher (and ``close`` stops it),
  a capture's profiler window holds a Chrome trace, a capture while
  another profiler of the process runs records why it has no trace, and
  the flight postmortem carries the finding and the doctor's findings.
* ``health_status`` on both packages' nodes through the same events:
  ``operator``, ``epoch_bump``, ``device_unhealthy``, ``closed`` (the
  ``slo_fast_burn`` cause is the SLO drill of ``tests/
  test_torch_doctor.py``), each cleared by ``mark_healthy``.
"""

import json
import os
import time

import pytest

from sparkucx_tpu.runtime import devmon as jdevmon
from sparkucx_tpu.utils import doctor as jdoc
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.runtime import devmon as tdevmon
from sparkucx_tpu_torch.utils import doctor as tdoc

PFX = "spark.shuffle.tpu."


class _Flight:
    """A flight recorder stand-in: numbered dump paths, the extras kept."""

    def __init__(self):
        self.dumps = []

    def dump(self, reason, extra=None):
        self.dumps.append((reason, extra))
        return f"dump-{len(self.dumps)}"


class _Node:
    """What the watcher reads of a node: ``doctor_provider``, ``flight``
    and ``flight_capture_dir``; the provider plays ``script`` pass by
    pass."""

    def __init__(self, script, finding):
        self._script = iter(script)
        self._finding = finding
        self.flight = _Flight()

    def doctor_provider(self):
        return [self._finding(rule=r, grade=g, summary="s",
                              trace_ids=list(t))
                for r, g, t in next(self._script)]

    def flight_capture_dir(self):
        return "/nonexistent"


A = ("block_corruption", "critical")
B = ("replay_storm", "critical")
W = ("padding_waste", "warn")
# one list of (rule, grade, trace_ids) per pass
SCRIPT = (
    [(*A, ["s1.e0.x1"])],                          # capture A/x1
    [(*A, ["s1.e0.x1"])],                          # seen
    [(*A, ["s1.e0.x1", "s2.e0.x2"]), (*W, [])],     # new key; x1 quiet 1
    [(*W, [])],                                    # x1 quiet 2
    [],                                            # x1 quiet 3: re-armed
    [(*A, ["s1.e0.x1"])],                          # captures again
    [], [], [],                                    # 3 quiet: re-armed
    [(*A, ["s1.e0.x1"])],                          # and again
) + tuple([(*B, [f"s{9 + i}.e0.x{9 + i}"])] for i in range(7)) + (
    [], [], [],                                    # B quiet: refund
    [(*B, ["s30.e0.x30"])],                        # captures past the cap
    [(*A, ["s40.e0.x40"]), (*B, ["s41.e0.x41"])],  # both capture
)


def _run_script(devmon, doctor, rearm=3):
    node = _Node(SCRIPT, doctor.Finding)
    w = devmon.DoctorWatcher(node, 60.0, profile_ms=0.0,
                             rearm_passes=rearm)
    per_pass = []
    for _ in SCRIPT:
        caps = w.check_once()
        per_pass.append([(c["rule"], c["grade"], c["profile_dir"],
                          c["flight_dump"]) for c in caps])
    return per_pass, node.flight.dumps, w


@pytest.mark.parametrize("rearm", [1, 3])
def test_scripted_watcher_equal_across_packages(rearm):
    j = _run_script(jdevmon, jdoc, rearm)
    t = _run_script(tdevmon, tdoc, rearm)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert tdevmon.DoctorWatcher.RULE_CAPTURE_CAP == \
        jdevmon.DoctorWatcher.RULE_CAPTURE_CAP


def test_scripted_watcher_captures():
    """The script's captures, pass by pass: the dedup, the re-arm after
    three quiet passes, the per-rule cap of five and its refund."""
    per_pass, dumps, w = _run_script(tdevmon, tdoc)
    n = [len(p) for p in per_pass]
    assert n[:10] == [1, 0, 1, 0, 0, 1, 0, 0, 0, 1]
    assert n[10:17] == [1, 1, 1, 1, 1, 0, 0]           # B capped at 5
    assert n[17:] == [0, 0, 0, 1, 2]
    assert all(c[2] is None for p in per_pass for c in p)
    assert dumps[0] == ("doctor finding: block_corruption", {
        "finding": tdoc.Finding(rule="block_corruption", grade="critical",
                                summary="s",
                                trace_ids=["s1.e0.x1"]).to_dict()})
    assert len(w.captures) == sum(n)


def test_watcher_never_raises_on_a_failing_provider():
    class Bad:
        def doctor_provider(self):
            raise RuntimeError("provider down")

    w = tdevmon.DoctorWatcher(Bad(), 0.1).start()
    time.sleep(0.35)
    w.stop()
    assert w.captures == []


# -- the node's watcher ------------------------------------------------------
def _corrupt_reads(svc, n, sid0=50):
    import numpy as np
    for i in range(n):
        h = svc.register_shuffle(sid0 + i, 2, 4)
        for m in range(2):
            svc.write(h, m, np.arange(256, dtype=np.int64) + m)
        with pytest.raises(Exception):
            svc.read(h)


def test_node_watcher_captures_profile_and_postmortem(tmp_path):
    """``doctor.*`` keys start the node's watcher over the service's
    doctor: three corrupt staged blocks are critical, the watcher takes
    one capture (a Chrome trace of its window and a postmortem naming the
    finding and carrying the doctor's findings), and ``close`` stops
    it."""
    conf = {PFX + "a2a.impl": "dense",
            PFX + "fault.corrupt.staged.failCount": "3",
            PFX + "doctor.watchIntervalSecs": "0.1",
            PFX + "doctor.captureMs": "20",
            PFX + "doctor.captureDir": str(tmp_path / "cap"),
            PFX + "flightRecorder.enabled": "true",
            PFX + "flightRecorder.dir": str(tmp_path / "flight")}
    svc = connect(conf, device="cpu", use_env=False)
    node = svc.node
    w = node.watcher
    assert w is not None and w._thread.is_alive()
    _corrupt_reads(svc, 3)
    deadline = time.time() + 20.0
    while not w.captures and time.time() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)                   # later passes see the same finding
    assert len(w.captures) == 1
    cap = w.captures[0]
    assert (cap["rule"], cap["grade"]) == ("block_corruption", "critical")
    assert cap["profile_dir"].startswith(str(tmp_path / "cap"))
    with open(os.path.join(cap["profile_dir"], "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    with open(cap["flight_dump"]) as f:
        doc = json.load(f)
    assert doc["finding"]["rule"] == "block_corruption"
    assert "block_corruption" in {x["rule"] for x in doc["findings"]}
    svc.stop()
    assert not w._thread.is_alive()


def test_capture_refuses_a_second_profiler(tmp_path):
    """A capture while another torch.profiler session of the process
    runs records no trace and says why (a second session would end the
    first one's)."""
    from torch.profiler import ProfilerActivity, profile
    with connect({PFX + "doctor.captureMs": "10"}, device="cpu",
                 use_env=False) as svc:
        w = tdevmon.DoctorWatcher(svc.node, 60.0, profile_ms=10.0,
                                  capture_dir=str(tmp_path))
        f = tdoc.Finding(rule="replay_storm", grade="critical", summary="s")
        with profile(activities=[ProfilerActivity.CPU]):
            cap = w._capture(f)
        assert cap["profile_dir"] is None
        assert "another torch.profiler session" in cap["profile_error"]
        cap = w._capture(f)
        assert cap["profile_dir"] and cap["profile_error"] is None


def test_watcher_off_by_default_and_capture_dir():
    with connect({}, device="cpu", use_env=False) as svc:
        node = svc.node
        assert node.watcher is None
        assert node.flight_capture_dir().endswith(
            f"sparkucx_tpu_capture_{os.getpid()}")
        assert node._default_doctor() == []


# -- health_status -----------------------------------------------------------
def _health_sequence(node, fail_probe):
    out = []

    def status():
        s = node.health_status()
        out.append((s["ok"], s["cause"], s["epoch"], s["devices"],
                    s["process_id"]))
        return s

    status()
    node.mark_unhealthy("drained for maintenance")
    assert status()["reason"] == "drained for maintenance"
    node.mark_healthy()
    status()
    node.remesh()
    assert "re-register" in status()["reason"]
    node.mark_healthy()
    status()
    fail_probe()
    with pytest.raises(Exception) as e:
        node.health.assert_healthy()
    assert type(e.value).__name__ == "DeviceUnhealthy"
    status()
    node.mark_healthy()
    status()
    return out


def test_health_status_causes_equal_across_packages(manager_factory,
                                                    monkeypatch):
    """The same events on both packages' nodes give the same verdicts:
    ok, operator, epoch_bump, device_unhealthy, each cleared; closed
    after close."""
    from sparkucx_tpu.runtime import failures as jf
    from sparkucx_tpu_torch.runtime import failures as tf
    got = []
    jnode = manager_factory().node

    def jfail():
        monkeypatch.setattr(jf.HealthMonitor, "_run_one",
                            lambda self, d, out, i: None)

    got.append(_health_sequence(jnode, jfail))
    svc = connect({}, device="cpu", use_env=False)

    def tfail():
        monkeypatch.setattr(tf.HealthMonitor, "_run_one",
                            lambda self, out: None)

    got.append(_health_sequence(svc.node, tfail))
    assert got[0] == got[1]
    assert [g[1] for g in got[1]] == [None, "operator", None, "epoch_bump",
                                      None, "device_unhealthy", None]
    svc.stop()
    jnode.close()
    assert svc.node.health_status()["cause"] == "closed"
    assert jnode.health_status()["cause"] == "closed"
