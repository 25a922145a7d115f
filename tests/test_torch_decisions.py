"""Port parity for the decision ledger (``sparkucx_tpu_torch/shuffle/
decisions.py``) and the agreement plane's settlement into it
(``shuffle/agreement.agree``): the portable cases of
``tests/test_decisions.py``, each run on both packages, plus
cross-package cases.

* the ledger: its ring and monotonic index, the live JSONL with its 2x
  retention bound, restart adoption, a torn line, the null ledger, and
  ``record`` never raising;
* ``agree``: the round's metrics and record on success, a divergent
  round still counted and recorded, the audit contract's defaults and
  validation, the per-peer lag from the header stamps;
* the audit: ``align_rounds`` and the three ``audit_round`` cases;
* ``utils/export.dedupe_process_docs`` unioning the records;
* the node: the snapshot's ledger tail and the postmortem's position,
  the disabled plane.

Cross-package: ``digest_row`` and a whole record are equal for the same
round (times apart), each package's ``load_decisions_file`` reads the
other's ledger, and ``audit_round`` gives one verdict on ledgers either
package wrote. The report's ``agreement`` summary is the ``-k
decisions`` case of ``tests/test_torch_distributed.py`` (a real
two-process world). The reference's doctor rules (``decision_split``,
``slow_proposer``, the desync link), its live ``/decisions`` route, its
anatomy phase, its collector and its ``decisions`` CLI wait for the
modules they run on (ROADMAP item 6b).

Every comparison here is exact: digests and records are pure functions
of the round's inputs."""

import json

import numpy as np
import pytest

from sparkucx_tpu.shuffle import agreement as jagr
from sparkucx_tpu.shuffle import decisions as jdec
from sparkucx_tpu.shuffle import distributed as jdist
from sparkucx_tpu.utils import export as jexp
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.shuffle import agreement as tagr
from sparkucx_tpu_torch.shuffle import decisions as tdec
from sparkucx_tpu_torch.shuffle import distributed as tdist
from sparkucx_tpu_torch.utils import export as texp
from sparkucx_tpu_torch.utils import metrics as tmet

JAX = {"dec": jdec, "agr": jagr, "dist": jdist, "exp": jexp, "met": jmet}
PORT = {"dec": tdec, "agr": tagr, "dist": tdist, "exp": texp, "met": tmet}
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]
# record fields that are times or the writing process, not the round
TIMES = ("ts", "round_ms", "pid")


@pytest.fixture(params=BOTH)
def side(request):
    """One package's modules, with a fresh ring-only ledger installed
    through its seam (the previous one restored after)."""
    mods = dict(request.param)
    dec = mods["dec"]
    prev = dec.current_ledger()
    mods["ledger"] = dec.DecisionLedger(retain=64)
    dec.set_ledger(mods["ledger"])
    yield mods
    dec.set_ledger(prev)


def _rec(epoch=0, seq=0, topic="hier.dcn.capms", reduce="min",
         winner=250, proposals=(250, 250), audit="strict", ok=True,
         lag_ms=(0.0, 0.0), process_id=0, n=1, **kw):
    out = {"kind": "decision", "n": n, "ts": 1000.0 + seq, "pid": 1,
           "process_id": process_id, "epoch": epoch, "seq": seq,
           "topic": topic, "reduce": reduce, "nprocs": len(proposals),
           "winner": winner, "proposals": list(proposals),
           "round_ms": 0.4, "lag_ms": list(lag_ms),
           "conf_key": "spark.shuffle.tpu.a2a.capacityFactor",
           "ok": ok, "audit": audit}
    out.update(kw)
    return out


class _FakeGather:
    """A 3-process gather: every peer proposes this process's row; with
    ``mutate`` peer 2's payload (never its header) is changed."""

    def __init__(self, mutate=None):
        self.mutate = mutate

    def __call__(self, payload, what="", timeout_ms=None, **kw):
        mine = np.asarray(payload)
        rows = [mine, mine, mine.copy()]
        if self.mutate is not None and not what.startswith(
                "agreement header"):
            rows[2] = self.mutate(mine.copy())
        return np.stack(rows)


# -- the ledger --------------------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
def test_ledger_ring_retention_and_monotonic_index(mods):
    led = mods["dec"].DecisionLedger(retain=4)
    for i in range(10):
        led.record(epoch=0, seq=i, topic="t", winner=i)
    assert led.total == 10
    tail = led.tail()
    assert len(tail) == 4
    assert [r["n"] for r in tail] == [7, 8, 9, 10]
    assert [r["seq"] for r in tail] == [6, 7, 8, 9]
    assert led.tail(2)[0]["seq"] == 8
    assert [r["n"] for r in led.since(8)] == [9, 10]
    pos = led.position()
    assert pos["seq"] == 9 and pos["topic"] == "t" and pos["ok"]


@pytest.mark.parametrize("mods", BOTH)
def test_ledger_jsonl_live_append_and_retention_bound(tmp_path, mods):
    dec = mods["dec"]
    led = dec.DecisionLedger(retain=3, out_dir=str(tmp_path), process_id=5)
    path = tmp_path / "decisions_p5.jsonl"
    led.record(epoch=0, seq=0, topic="t")
    assert path.exists()                       # live, not buffered
    assert len(dec.load_decisions_file(str(path))) == 1
    for i in range(1, 20):
        led.record(epoch=0, seq=i, topic="t")
        assert len(path.read_text().splitlines()) <= 6   # 2x retain
    led.close()
    recs = dec.load_decisions_file(str(path))
    assert [r["seq"] for r in recs][-3:] == [17, 18, 19]
    assert dec.decisions_files(str(tmp_path)) == [str(path)]


@pytest.mark.parametrize("mods", BOTH)
def test_ledger_restart_adoption_spans_retention(tmp_path, mods):
    dec = mods["dec"]
    a = dec.DecisionLedger(retain=4, out_dir=str(tmp_path), process_id=0)
    for i in range(6):
        a.record(epoch=0, seq=i, topic="before")
    a.close()
    b = dec.DecisionLedger(retain=4, out_dir=str(tmp_path), process_id=0)
    for i in range(2):
        b.record(epoch=1, seq=i, topic="after")
    b.close()
    recs = dec.load_decisions_file(str(tmp_path / "decisions_p0.jsonl"))
    assert [r["topic"] for r in recs[-2:]] == ["after", "after"]
    assert any(r["topic"] == "before" for r in recs)
    assert len(recs) <= 8


@pytest.mark.parametrize("mods", BOTH)
def test_ledger_torn_line_skipped(tmp_path, mods):
    dec = mods["dec"]
    led = dec.DecisionLedger(retain=8, out_dir=str(tmp_path), process_id=1)
    led.record(epoch=0, seq=0, topic="t")
    led.close()
    path = tmp_path / "decisions_p1.jsonl"
    with open(path, "a") as f:
        f.write('{"kind": "decision", "n": 2, "epo')   # torn write
    assert len(dec.load_decisions_file(str(path))) == 1


@pytest.mark.parametrize("mods", BOTH)
def test_null_ledger_stateless_and_never_raises(mods):
    null = mods["dec"].NULL_DECISION_LEDGER
    assert null.record(epoch=0, seq=0, topic="t") is None
    assert null.tail() == [] and null.since(0) == []
    assert null.position() is None and null.close() is None
    assert not null.enabled


def test_record_never_raises(side):
    led = side["ledger"]
    assert led.record(epoch=0, seq=0, topic="t", proposals=[1, 2]) \
        is not None
    assert led.record(epoch="bogus", seq=0, topic="t") is None


# -- agree() settlement ------------------------------------------------------
def test_agree_round_metrics_and_ledger_on_success(side):
    agr, met, dec = side["agr"], side["met"], side["dec"]
    agr.reset_epoch(0)
    m = met.Metrics()
    agr.agree("a2a.waveRows", [4096], metrics=m,
              conf_key="spark.shuffle.tpu.a2a.waveRows")
    assert m.get(met.C_AGREE_ROUNDS) == 1.0
    assert m.get(met.labeled(met.C_AGREE_ROUNDS, topic="a2a.waveRows")) \
        == 1.0
    assert m.histogram(met.H_AGREE_ROUND).snapshot()["count"] == 1
    assert m.histogram(met.labeled(
        met.H_AGREE_ROUND, topic="a2a.waveRows")).snapshot()["count"] == 1
    rec = side["ledger"].tail(1)[0]
    assert rec["topic"] == "a2a.waveRows" and rec["ok"]
    assert rec["audit"] == "strict"
    assert rec["winner"] == dec.digest_row(np.array([4096]))
    assert rec["conf_key"] == "spark.shuffle.tpu.a2a.waveRows"
    assert rec["round_ms"] >= 0.0 and len(rec["lag_ms"]) == 1


def test_agree_divergent_round_still_counts(side, monkeypatch):
    agr, met = side["agr"], side["met"]
    agr.reset_epoch(0)
    m = met.Metrics()

    def bump(row):
        row[0] += 9
        return row

    monkeypatch.setattr(side["dist"], "allgather_blob",
                        _FakeGather(mutate=bump))
    with pytest.raises(agr.AgreementDivergenceError):
        agr.agree("async.order", [1, 2], metrics=m,
                  conf_key="spark.shuffle.tpu.tenant.asyncAgreedOrder")
    assert m.get(met.C_AGREE_ROUNDS) == 1.0
    assert m.get(met.labeled(met.C_AGREE_ROUNDS, topic="async.order")) \
        == 1.0
    assert m.histogram(met.H_AGREE_ROUND).snapshot()["count"] == 1
    assert m.histogram(met.labeled(
        met.H_AGREE_ROUND, topic="async.order")).snapshot()["count"] == 1
    rec = side["ledger"].tail(1)[0]
    assert rec["ok"] is False and rec["error"] == "value"
    assert rec["nprocs"] == 3 and len(rec["proposals"]) == 3
    assert rec["proposals"][0] != rec["proposals"][2]


def test_agree_audit_contract_defaults_and_validation(side):
    agr = side["agr"]
    agr.reset_epoch(0)
    agr.agree("x.unanimous", [1])
    agr.agree("x.reduced", [2], reduce="min")
    agr.agree("x.optin", [3], reduce="min", audit="strict")
    a, b, c = side["ledger"].tail(3)
    assert a["audit"] == "strict"
    assert b["audit"] == "aggregate"
    assert c["audit"] == "strict"
    with pytest.raises(ValueError, match="audit contract"):
        agr.agree("x.bad", [1], audit="paranoid")


def test_agree_lag_recovered_from_header_stamps(side, monkeypatch):
    agr = side["agr"]
    agr.reset_epoch(0)

    def gather(payload, what="", timeout_ms=None, **kw):
        mine = np.asarray(payload)
        rows = np.stack([mine, mine, mine])
        if what.startswith("agreement header"):
            rows = rows.copy()
            rows[1, 5] -= 7                    # peer 1 sent earliest
            rows[2, 5] += 5
        return rows

    monkeypatch.setattr(side["dist"], "allgather_blob", gather)
    agr.agree("x.lag", [1])
    assert side["ledger"].tail(1)[0]["lag_ms"] == [7.0, 0.0, 12.0]


def test_agree_sequencing_split_recorded(side, monkeypatch):
    """A header split records the round ok=False, error "sequencing",
    with the header digests as its proposals."""
    agr = side["agr"]
    agr.reset_epoch(0)

    def gather(payload, what="", timeout_ms=None, **kw):
        rows = np.stack([np.asarray(payload)] * 2).copy()
        if what.startswith("agreement header"):
            rows[1, 1] += 1                    # peer 1 at another seq
        return rows

    monkeypatch.setattr(side["dist"], "allgather_blob", gather)
    with pytest.raises(agr.AgreementDivergenceError, match="sequencing"):
        agr.agree("x.seq", [1])
    rec = side["ledger"].tail(1)[0]
    assert (rec["ok"], rec["error"], rec["nprocs"]) == (False,
                                                        "sequencing", 2)
    assert len(rec["proposals"]) == 2 and \
        rec["proposals"][0] != rec["proposals"][1]


# -- the joined-ledger audit -------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
def test_align_rounds_joins_by_epoch_seq(mods):
    dec = mods["dec"]
    rows = dec.align_rounds({0: [_rec(seq=0, n=1), _rec(seq=1, n=2)],
                             1: [_rec(seq=1, n=1, process_id=1)]})
    assert [(r["epoch"], r["seq"]) for r in rows] == [(0, 0), (0, 1)]
    assert set(rows[1]["records"]) == {0, 1}
    assert set(rows[0]["records"]) == {0}


@pytest.mark.parametrize("mods", BOTH)
def test_audit_clean_fleet_quiet(mods):
    dec = mods["dec"]
    for row in dec.align_rounds({
            0: [_rec(seq=0, topic="u", reduce="unanimous",
                     proposals=(9, 9)),
                _rec(seq=1, proposals=(250, 250), audit="strict"),
                _rec(seq=2, topic="async.batch", reduce="min",
                     proposals=(3, 5), audit="aggregate")],
            1: [_rec(seq=0, topic="u", reduce="unanimous",
                     proposals=(9, 9), process_id=1),
                _rec(seq=1, proposals=(250, 250), audit="strict",
                     process_id=1),
                _rec(seq=2, topic="async.batch", reduce="min",
                     proposals=(3, 5), audit="aggregate",
                     process_id=1)]}):
        assert dec.audit_round(row) is None, row


@pytest.mark.parametrize("mods", BOTH)
def test_audit_detects_silent_strict_split(mods):
    dec = mods["dec"]
    rows = dec.align_rounds({
        0: [_rec(seq=0, proposals=(250, 256), audit="strict")],
        1: [_rec(seq=0, proposals=(250, 256), audit="strict",
                 process_id=1)]})
    v = dec.audit_round(rows[0])
    assert v is not None and v["split"] == "proposal"
    assert v["dissenters"] == [1]
    rows = dec.align_rounds({
        0: [_rec(seq=0, proposals=(250, 256), audit="aggregate")],
        1: [_rec(seq=0, proposals=(250, 256), audit="aggregate",
                 process_id=1)]})
    assert dec.audit_round(rows[0]) is None


@pytest.mark.parametrize("mods", BOTH)
def test_audit_topic_winner_and_fenced_rounds(mods):
    dec = mods["dec"]
    rows = dec.align_rounds({0: [_rec(seq=0, topic="a")],
                             1: [_rec(seq=0, topic="b", process_id=1)]})
    assert dec.audit_round(rows[0])["split"] == "topic"
    rows = dec.align_rounds({0: [_rec(seq=0, winner=111)],
                             1: [_rec(seq=0, winner=222, process_id=1)]})
    assert dec.audit_round(rows[0])["split"] == "winner"
    rows = dec.align_rounds({
        0: [_rec(seq=0, ok=False, error="value", winner=111)],
        1: [_rec(seq=0, winner=222, process_id=1)]})
    assert dec.audit_round(rows[0]) is None
    assert dec.audit_round(dec.align_rounds({0: [_rec(seq=0)]})[0]) is None


@pytest.mark.parametrize("mods", BOTH)
def test_dedupe_process_docs_unions_decisions(mods):
    snap = {"process_id": 0, "pid": 100, "ts": 2000.0,
            "counters": {"x": 1.0},
            "decisions": [_rec(seq=0, n=1), _rec(seq=1, n=2)]}
    side_doc = {"process_id": 0, "pid": 100, "ts": 1000.0, "counters": {},
                "decisions": [_rec(seq=1, n=2), _rec(seq=2, n=3)]}
    out = mods["exp"].dedupe_process_docs([snap, side_doc])
    assert len(out) == 1
    assert [r["n"] for r in out[0]["decisions"]] == [1, 2, 3]
    assert out[0]["counters"]["x"] == 1.0


@pytest.mark.parametrize("mods", BOTH)
def test_decisions_to_doc_wraps_and_empty_raises(mods):
    dec = mods["dec"]
    with pytest.raises(ValueError):
        dec.decisions_to_doc([])
    recs = [_rec(seq=0, n=1), _rec(seq=1, n=2, process_id=0)]
    doc = dec.decisions_to_doc(recs)
    assert doc["decisions"] == recs and doc["process_id"] == 0
    assert doc["counters"] == {} and doc["histograms"] == {}


# -- cross-package -----------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 3, 17])
def test_digest_row_equal_across_packages(n):
    rng = np.random.default_rng(n)
    row = rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
    assert tdec.digest_row(row) == jdec.digest_row(row)
    assert tdec.digest_row(row.tolist()) == jdec.digest_row(row)


@pytest.mark.parametrize("kind", ["unanimous", "reduced", "divergent"])
def test_record_equal_across_packages(kind, monkeypatch):
    """The same round through both packages' ``agree`` (one fake
    3-process gather, one epoch and seq) lands the same record, times
    apart."""
    recs = []
    for mods in (JAX, PORT):
        led = mods["dec"].DecisionLedger(retain=8)
        prev = mods["dec"].set_ledger(led)
        try:
            mods["agr"].reset_epoch(4)
            gather = _FakeGather(
                mutate=(lambda r: r + 5) if kind != "unanimous" else None)
            monkeypatch.setattr(mods["dist"], "allgather_blob", gather)
            kw = {"reduce": "max"} if kind == "reduced" else {}
            try:
                mods["agr"].agree("hier.dcn.regrow", [7, 9],
                                  conf_key="spark.shuffle.tpu.a2a."
                                           "capacityFactor", **kw)
            except mods["agr"].AgreementDivergenceError:
                assert kind == "divergent"
        finally:
            mods["dec"].set_ledger(prev)
        (rec,) = led.tail()
        recs.append({k: v for k, v in rec.items() if k not in TIMES})
    assert recs[0] == recs[1]
    assert recs[1]["ok"] is (kind != "divergent")


@pytest.mark.parametrize("writer,reader", [(jdec, tdec), (tdec, jdec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_ledger(tmp_path, writer, reader):
    led = writer.DecisionLedger(retain=4, out_dir=str(tmp_path),
                                process_id=2)
    for i in range(7):
        led.record(epoch=1, seq=i, topic=f"t{i % 2}", reduce="min",
                   nprocs=2, winner=i, proposals=[i, i + 1],
                   audit="aggregate")
    led.close()
    path = str(tmp_path / "decisions_p2.jsonl")
    assert reader.decisions_files(str(tmp_path)) == [path]
    assert reader.load_decisions_file(path) == \
        writer.load_decisions_file(path)
    assert [r["seq"] for r in reader.load_decisions_file(path)][-4:] == \
        [3, 4, 5, 6]
    # the reader's restarted rank adopts the writer's log
    b = reader.DecisionLedger(retain=4, out_dir=str(tmp_path),
                              process_id=2)
    b.record(epoch=2, seq=0, topic="after")
    b.close()
    recs = reader.load_decisions_file(path)
    assert recs[-1]["topic"] == "after" and len(recs) <= 8
    assert any(r["topic"] == "t0" for r in recs)


@pytest.mark.parametrize("split", ["clean", "proposal", "winner", "topic"])
def test_audit_same_verdict_on_either_packages_ledgers(tmp_path, split):
    """Two peers' ledgers written by each package, loaded and audited by
    each package: one verdict."""
    verdicts = []
    for writer in (jdec, tdec):
        d = tmp_path / writer.__name__.split(".")[0]
        for peer in (0, 1):
            led = writer.DecisionLedger(retain=16, out_dir=str(d),
                                        process_id=peer)
            led.record(epoch=0, seq=0, topic="a2a.waveRows", nprocs=2,
                       winner=5, proposals=[5, 5])
            props = [250, 256] if split == "proposal" else [250, 250]
            topic = "hier.b" if split == "topic" and peer else "hier.a"
            winner = 999 if split == "winner" and peer else 250
            led.record(epoch=0, seq=1, topic=topic, reduce="min",
                       nprocs=2, winner=winner, proposals=props,
                       audit="strict")
            led.close()
        for reader in (jdec, tdec):
            ledgers = {int(p[-7]): reader.load_decisions_file(p)
                       for p in reader.decisions_files(str(d))}
            verdicts.append([reader.audit_round(r)
                             for r in reader.align_rounds(ledgers)])
    assert all(v == verdicts[0] for v in verdicts)
    assert verdicts[0][0] is None
    assert (verdicts[0][1] is None) == (split == "clean")
    if split != "clean":
        assert verdicts[0][1]["split"] == split


# -- the node ----------------------------------------------------------------
def _port(conf=None):
    c = {"spark.shuffle.tpu.a2a.impl": "dense"}
    c.update(conf or {})
    return connect(c, device="cpu", use_env=False)


def test_snapshot_embeds_decisions_and_postmortem_position(tmp_path):
    """The node installs its ledger: a round lands in the snapshot's
    tail, and a flight postmortem carries the last-decision position."""
    svc = _port({"spark.shuffle.tpu.flightRecorder.enabled": "true",
                 "spark.shuffle.tpu.flightRecorder.dir": str(tmp_path)})
    try:
        assert tdec.current_ledger() is svc.node.decisions
        tagr.reset_epoch(0)
        tagr.agree("a2a.waveRows", [3], metrics=svc.node.metrics)
        doc = svc.node.telemetry_snapshot()
        assert doc["decisions"][-1]["topic"] == "a2a.waveRows"
        post = json.loads(open(svc.node.flight.dump("test")).read())
        led = post["contexts"]["decision_ledger"]
        assert led["enabled"] and led["total"] == 1
        assert led["position"]["topic"] == "a2a.waveRows"
    finally:
        svc.stop()
    # a closed node leaves the null ledger installed
    assert tdec.current_ledger() is tdec.NULL_DECISION_LEDGER


def test_decisions_on_disk_beside_history(tmp_path):
    svc = _port({"spark.shuffle.tpu.history.dir": str(tmp_path)})
    try:
        tagr.reset_epoch(0)
        tagr.agree("x.disk", [1])
        assert svc.node.decisions.path == \
            str(tmp_path / "decisions_p0.jsonl")
    finally:
        svc.stop()
    (rec,) = tdec.load_decisions_file(str(tmp_path / "decisions_p0.jsonl"))
    assert rec["topic"] == "x.disk"


def test_decisions_disabled_null_object():
    svc = _port({"spark.shuffle.tpu.decisions.enabled": "false"})
    try:
        assert svc.node.decisions is tdec.NULL_DECISION_LEDGER
        tagr.reset_epoch(0)
        tagr.agree("x.off", [1])
        assert svc.node.decisions.tail() == []
        assert "decisions" not in svc.node.telemetry_snapshot()
        assert svc.node.decision_ledger()["enabled"] is False
    finally:
        svc.stop()


def test_single_process_read_records_no_round():
    """A one-process read closes no agreement round: the report's
    summary stays empty and the ledger records nothing."""
    svc = _port()
    try:
        rng = np.random.default_rng(3)
        h = svc.register_shuffle(5, 2, 4)
        for m in range(2):
            svc.write(h, m, rng.integers(0, 1 << 30, size=64))
        svc.read(h)
        assert svc.report(5).agreement == {}
        assert svc.node.decisions.total == 0
    finally:
        svc.stop()
