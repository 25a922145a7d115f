"""Port parity for the windowed telemetry history (``sparkucx_tpu_torch/
utils/history.py``) and the dumper cadence that rolls it: the history
cases of ``tests/test_slo.py`` (its window deltas, ring and on-disk
retention, rank-keyed path, restart adoption, tick cadence, replay doc,
the tick-only dumper and the dedupe of frames), each run on both
packages, and ``history_p<rank>.jsonl`` adopted across the two.

The reference's SLO objectives, burn rates and their live / CLI faces
wait for ``utils/slo`` (ROADMAP item 6b); here a node turns history on
with ``history.dir``. Window quantiles are estimates within half a
bucket; they are held to numpy's within 12%, the reference's own
tolerance. Counter deltas and frame contents are compared exactly."""

import math
import os
import time

import numpy as np
import pytest

from sparkucx_tpu.utils import export as jexp
from sparkucx_tpu.utils import history as jhist
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.utils import export as texp
from sparkucx_tpu_torch.utils import history as thist
from sparkucx_tpu_torch.utils import metrics as tmet

JAX = {"hist": jhist, "met": jmet, "exp": jexp}
PORT = {"hist": thist, "met": tmet, "exp": texp}
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]
H_FETCH_WAIT = "shuffle.read.wait_ms"


def _anchor():
    perf = time.perf_counter()
    wall = time.time()
    return {"wall": wall, "perf": perf, "perf_epoch": perf,
            "wall_epoch": wall, "pid": 1.0}


def _frame(met, t_end, waits=(), seq=1, window_s=60.0):
    h = met.Histogram(H_FETCH_WAIT)
    for v in waits:
        h.observe(float(v))
    return {"kind": "history_frame", "seq": seq,
            "t_start": t_end - window_s, "t_end": t_end,
            "window_s": window_s, "pid": 1, "process_id": 0,
            "anchor": _anchor(),
            "counters": {"shuffle.read.count": float(len(waits))},
            "histograms": {H_FETCH_WAIT: h.snapshot()} if waits else {},
            "gauges": {}}


def _mk_history(mods, metrics, tmp_path=None, retain=5, **kw):
    return mods["hist"].TelemetryHistory(
        lambda: mods["exp"].collect_snapshot(metrics),
        window_secs=3600.0, retain_windows=retain,
        out_dir=str(tmp_path) if tmp_path is not None else None, **kw)


# -- Histogram.snapshot_delta ------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
def test_snapshot_delta_is_the_window(mods, rng):
    H = mods["met"].Histogram
    h = H("w")
    for v in rng.uniform(1.0, 5.0, size=200):
        h.observe(v)
    s0 = h.snapshot()
    w2 = rng.uniform(50.0, 500.0, size=300)
    for v in w2:
        h.observe(v)
    d = H.snapshot_delta(h.snapshot(), s0)
    assert int(d["count"]) == len(w2)
    assert d["sum"] == pytest.approx(w2.sum(), rel=1e-9)
    for q, key in ((50, "p50"), (99, "p99")):
        assert d[key] == pytest.approx(np.percentile(w2, q), rel=0.12)
    assert d["min"] <= np.min(w2) * H.GROWTH
    assert d["max"] >= np.max(w2) / H.GROWTH


@pytest.mark.parametrize("mods", BOTH)
def test_snapshot_delta_reset_and_empty(mods):
    H = mods["met"].Histogram
    h = H("x")
    for v in (1.0, 2.0):
        h.observe(v)
    s = h.snapshot()
    assert H.snapshot_delta(s, None) == s
    assert H.snapshot_delta(s, {"count": 0}) == s
    d = H.snapshot_delta(s, s)
    assert d["count"] == 0 and d["buckets"][-1] == [math.inf, 0]
    bigger = H("x")
    for v in (1.0, 2.0, 3.0):
        bigger.observe(v)
    assert H.snapshot_delta(s, bigger.snapshot()) == s


@pytest.mark.parametrize("mods", BOTH)
def test_counters_delta_drops_zero_and_detects_reset(mods):
    d = mods["hist"].counters_delta({"a": 10.0, "b": 5.0, "c": 3.0},
                                    {"a": 4.0, "b": 5.0, "c": 7.0})
    assert d == {"a": 6.0, "c": 3.0}


def test_histograms_delta_equal_across_packages(rng):
    vals = rng.lognormal(2.0, 1.0, size=400)
    out = []
    for mods in (JAX, PORT):
        h = mods["met"].Histogram(H_FETCH_WAIT)
        for v in vals[:150]:
            h.observe(v)
        prev = {H_FETCH_WAIT: h.snapshot(), "idle": h.snapshot()}
        for v in vals[150:]:
            h.observe(v)
        cur = {H_FETCH_WAIT: h.snapshot(), "idle": prev["idle"]}
        out.append(mods["hist"].histograms_delta(cur, prev))
    assert out[0] == out[1] and list(out[1]) == [H_FETCH_WAIT]


# -- TelemetryHistory --------------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
def test_history_ring_and_disk_retention(tmp_path, mods):
    m = mods["met"].Metrics()
    hist = _mk_history(mods, m, tmp_path, retain=5)
    assert hist.roll() is None
    for _ in range(9):
        m.inc("shuffle.read.count", 2)
        m.observe(H_FETCH_WAIT, 5.0)
        f = hist.roll()
        assert f["counters"]["shuffle.read.count"] == 2.0
        assert f["histograms"][H_FETCH_WAIT]["count"] == 1
    frames = hist.frames()
    assert len(frames) == 5
    assert [f["seq"] for f in frames] == list(range(5, 10))
    assert all(f["anchor"] for f in frames)
    lines = mods["hist"].load_history_file(hist.path)
    assert [f["seq"] for f in lines] == [f["seq"] for f in frames]


@pytest.mark.parametrize("mods", BOTH)
def test_history_path_is_rank_keyed_not_pid(tmp_path, mods):
    hist = _mk_history(mods, mods["met"].Metrics(), tmp_path, retain=4,
                       process_id=7)
    assert os.path.basename(hist.path) == "history_p7.jsonl"
    assert str(os.getpid()) not in os.path.basename(hist.path)
    assert _mk_history(mods, mods["met"].Metrics()).path is None


@pytest.mark.parametrize("mods", BOTH)
def test_history_disk_adoption_across_instances(tmp_path, mods):
    m = mods["met"].Metrics()
    h1 = _mk_history(mods, m, tmp_path, retain=4)
    h1.roll()
    for _ in range(3):
        m.inc("x", 1)
        h1.roll()
    h2 = _mk_history(mods, m, tmp_path, retain=4)
    h2.roll()
    for _ in range(3):
        m.inc("x", 1)
        h2.roll()
    assert len(mods["hist"].load_history_file(h1.path)) <= 4


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_history_log_adopted_across_packages(tmp_path, writer, reader):
    """One package's ``history_p<rank>.jsonl`` is adopted by the other's
    restarted rank: the retention bound spans the restart and every
    frame stays readable by both."""
    m = writer["met"].Metrics()
    h1 = _mk_history(writer, m, tmp_path, retain=4, process_id=3)
    h1.roll()
    for i in range(3):
        m.inc("x", i + 1)
        h1.roll()
    m2 = reader["met"].Metrics()
    h2 = _mk_history(reader, m2, tmp_path, retain=4, process_id=3)
    assert h2.path == h1.path
    h2.roll()
    for _ in range(3):
        m2.inc("y", 1)
        h2.roll()
    frames = reader["hist"].load_history_file(h2.path)
    assert frames == writer["hist"].load_history_file(h2.path)
    assert len(frames) == 4
    assert frames[0]["counters"] == {"x": 3.0}
    assert [f["counters"] for f in frames[1:]] == [{"y": 1.0}] * 3


@pytest.mark.parametrize("mods", BOTH)
def test_history_tick_rolls_on_cadence_only(mods):
    m = mods["met"].Metrics()
    hist = mods["hist"].TelemetryHistory(
        lambda: mods["exp"].collect_snapshot(m), window_secs=3600.0,
        retain_windows=4)
    assert hist.tick() is None and hist.tick() is None
    assert hist.frames() == []
    hist.window_secs = 0.0001
    time.sleep(0.001)
    hist.tick()
    m.inc("x", 1)
    time.sleep(0.001)
    assert hist.tick() is not None


@pytest.mark.parametrize("mods", BOTH)
def test_frames_to_doc_and_empty_raises(mods):
    with pytest.raises(ValueError):
        mods["hist"].frames_to_doc([], source="empty")
    f = _frame(mods["met"], time.time(), waits=[5.0, 6.0])
    doc = mods["hist"].frames_to_doc([f])
    assert doc["history_frames"] == [f]
    assert doc["anchor"] == f["anchor"]
    assert doc["counters"] == {} and doc["histograms"] == {}


# -- the dumper drives the roll ----------------------------------------------
def _port(conf=None):
    c = {"spark.shuffle.tpu.a2a.impl": "dense"}
    c.update(conf or {})
    return connect(c, device="cpu", use_env=False)


def test_tick_only_dumper_without_dump_dir(tmp_path):
    """``history.dir`` without ``metrics.dumpDir`` still gets a rolling
    cadence: the service starts a tick-only dumper (no snapshot file)
    beating at the history window."""
    svc = _port({"spark.shuffle.tpu.history.dir": str(tmp_path),
                 "spark.shuffle.tpu.history.windowSecs": "0.05"})
    try:
        assert svc._dumper is not None and svc._dumper.path is None
        deadline = time.time() + 5.0
        while not svc.node.history.frames() and time.time() < deadline:
            time.sleep(0.05)
        assert svc.node.history.frames(), \
            "dumper cadence never rolled a history window"
        assert "history_frames" in svc.stats()
    finally:
        svc.stop()
    assert thist.load_history_file(str(tmp_path / "history_p0.jsonl"))


def test_dumper_off_without_history_or_dump_dir():
    svc = _port()
    try:
        assert svc._dumper is None
        assert svc.node.history.out_dir is None
    finally:
        svc.stop()


def test_history_frames_sum_to_the_counters(tmp_path):
    """The frames a node's history writes hold counter deltas that add
    up to its registry's counters."""
    svc = _port({"spark.shuffle.tpu.history.dir": str(tmp_path),
                 "spark.shuffle.tpu.history.windowSecs": "3600"})
    try:
        hist = svc.node.history
        hist.roll()
        rng = np.random.default_rng(1)
        for sid in (1, 2, 3):
            h = svc.register_shuffle(sid, 2, 4)
            for m in range(2):
                svc.write(h, m, rng.integers(0, 1 << 30, size=100))
            svc.read(h)
            hist.roll()
        counters = svc.node.metrics.snapshot()
    finally:
        svc.stop()
    frames = thist.load_history_file(str(tmp_path / "history_p0.jsonl"))
    assert len(frames) == 3
    total = {}
    for f in frames:
        for k, v in f["counters"].items():
            total[k] = total.get(k, 0.0) + v
    for k in ("shuffle.read.count", "shuffle.rows", "shuffle.bytes"):
        assert total[k] == counters[k]
    assert sum(f["histograms"][H_FETCH_WAIT]["count"] for f in frames) == 3


@pytest.mark.parametrize("mods", BOTH)
def test_dedupe_keeps_frames_when_postmortem_wins(mods):
    fr = _frame(mods["met"], 6_000_000.0, waits=[5.0] * 4)
    snap = {"process_id": 0, "pid": 1, "ts": 100.0,
            "history_frames": [fr]}
    post = {"process_id": 0, "pid": 1, "ts": 200.0}
    out = mods["exp"].dedupe_process_docs([snap, post])
    assert len(out) == 1 and out[0]["ts"] == 200.0
    assert out[0]["history_frames"] == [fr]


@pytest.mark.parametrize("mods", BOTH)
def test_dedupe_history_replay_never_wipes_registries(mods):
    fr = _frame(mods["met"], 160.0, waits=[5.0] * 4)
    fr["process_id"], fr["pid"] = 0, 1
    snap = {"process_id": 0, "pid": 1, "ts": 100.0,
            "counters": {"shuffle.read.count": 9.0}, "histograms": {}}
    hist = mods["hist"].frames_to_doc([fr], source="history_p0.jsonl")
    assert hist["ts"] > snap["ts"]
    out = mods["exp"].dedupe_process_docs([snap, hist])
    assert len(out) == 1
    assert out[0]["counters"] == {"shuffle.read.count": 9.0}
    assert out[0]["history_frames"] == [fr]
