"""Port parity for the integrity and durability plane
(``sparkucx_tpu_torch/shuffle/integrity.py``, ``shuffle/durable.py`` and
their sites in the writer, the registry and the manager): the
counterparts of ``tests/test_integrity.py``, the default verify level,
and each package adopting the other's ledger directory.

A primitive case feeds both packages' functions the same seeded arrays
and compares the results bit for bit (``fold64``, ``crc32_of``, the
digest rows, ``IntegrityRecord.to_dict()``, the key-routing verdicts). A
manager case runs one call sequence on the JAX package's
``manager_factory`` (8 virtual CPU devices, ``a2a.impl=dense``) and on
the port's ``connect(device="cpu")`` (8 logical shards, ``dense``) and
compares what the sequence observed: the raised type and the block it
names, the report's ``integrity`` / ``integrity_bytes`` / ``replays``,
the integrity counters, ``recovered_shuffles()``, the parsed
``commit.manifest`` (its crc32 included), the files on disk and every
partition's sorted rows (exact). A "restart" is a new manager on the
same ledger directory after the previous one stopped, on both sides."""

import glob
import json
import os

import numpy as np
import pytest

from sparkucx_tpu.ops.partition import \
    blocked_partition_map as jax_blocked_partition_map
from sparkucx_tpu.runtime import failures as jf
from sparkucx_tpu.shuffle import durable as jdurable
from sparkucx_tpu.shuffle import integrity as jinteg
from sparkucx_tpu.utils import metrics as jmetrics
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.ops import ragged_a2a as ra
from sparkucx_tpu_torch.runtime import failures as tf
from sparkucx_tpu_torch.shuffle import durable as tdurable
from sparkucx_tpu_torch.shuffle import integrity as tinteg
from sparkucx_tpu_torch.utils import metrics as tmetrics

MAPS, R, ROWS, W = 2, 8, 512, 2
LEDGER = "spark.shuffle.tpu.failure.ledgerDir"
VERIFY = "spark.shuffle.tpu.integrity.verify"

INTEG = [pytest.param(jinteg, id="jax"), pytest.param(tinteg, id="port")]


class Side:
    """One package's handles for a manager case."""

    def __init__(self, name, make, metrics, durable):
        self.name = name
        self.make = make
        self.m = metrics
        self.durable = durable


@pytest.fixture()
def port_factory():
    """``make(overrides)`` -> a port manager on the CPU (dense, 8
    shards). Like the JAX package's ``manager_factory``, a new manager
    first stops the ones made before it (a stop keeps the ledger)."""
    made = []

    def make(overrides=None):
        while made:
            made.pop().stop()
        svc = connect({"spark.shuffle.tpu.a2a.impl": "dense",
                       **(overrides or {})}, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


@pytest.fixture()
def sides(manager_factory, port_factory):
    return [Side("jax", manager_factory, jmetrics, jdurable),
            Side("port", port_factory, tmetrics, tdurable)]


def both(sides, scenario, *args):
    """Run ``scenario(side, *args)`` on the JAX package, then on the port;
    the port must observe exactly what the reference did."""
    got = [scenario(side, *args) for side in sides]
    assert got[1] == got[0]
    return got[1]


@pytest.fixture()
def data(rng):
    keys = [rng.integers(-(1 << 62), 1 << 62, size=ROWS)
            for _ in range(MAPS)]
    vals = [rng.integers(-(1 << 30), 1 << 30,
                         size=(ROWS, W)).astype(np.int32)
            for _ in range(MAPS)]
    return keys, vals


def _stage(mgr, sid, keys, vals, num_partitions=R):
    h = mgr.register_shuffle(sid, MAPS, num_partitions)
    for m in range(MAPS):
        w = mgr.get_writer(h, m)
        w.write(keys[m], vals[m])
        w.commit(num_partitions)
    return h


def _canonical(res):
    out = []
    for r in range(R):
        k, v = res.partition(r)
        order = np.lexsort(tuple(v.T[::-1]) + (k,)) if k.size \
            else np.array([], dtype=np.int64)
        out.append((k[order].tolist(), v[order].tolist()))
    return out


def _error(fn):
    """(type name, message) of what ``fn()`` raised, or ("ok", "")."""
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return "ok", ""


def _flip_file(path, offset, mask=0xFF):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _manifest(ledger, sid):
    with open(os.path.join(ledger, f"shuffle_{sid}",
                           "commit.manifest")) as f:
        return json.load(f)


def _files(ledger, sid):
    d = os.path.join(ledger, f"shuffle_{sid}")
    return sorted(os.path.relpath(p, d) for p in glob.glob(
        os.path.join(d, "**", "*"), recursive=True) if os.path.isfile(p))


def _ledger(tmp_path, side):
    return str(tmp_path / side.name / "ledger")


# -- primitives ------------------------------------------------------------
def test_fold64_detects_any_bit_flip(rng):
    a = rng.integers(-(1 << 62), 1 << 62, size=257)

    def folds(integ):
        b = a.copy().view(np.uint8)
        out = [integ.fold64(a)]
        for off in (0, 1000, b.nbytes - 1):
            b[off] ^= 0x01
            out.append(integ.fold64(b.view(np.int64)))
            b[off] ^= 0x01
        out += [integ.fold64(np.zeros(8, np.int64)),
                integ.fold64(np.zeros(9, np.int64)),
                integ.fold64(a.view(np.uint8)[:2051]),   # a ragged tail
                integ.fold64(None)]
        return out

    want = folds(jinteg)
    got = folds(tinteg)
    assert got == want
    assert all(f != got[0] for f in got[1:4])
    assert got[4] != got[5]


def test_partition_digests_order_and_split_invariant(rng):
    keys = rng.integers(0, 1 << 40, size=400)
    vals = rng.standard_normal((400, 3)).astype(np.float32)
    parts = rng.integers(0, R, size=400)
    full, keyd = tinteg.partition_digests(keys, vals, parts, R)
    jfull, jkeyd = jinteg.partition_digests(keys, vals, parts, R)
    assert full.tolist() == jfull.tolist()
    assert keyd.tolist() == jkeyd.tolist()
    perm = rng.permutation(400)
    full2, keyd2 = tinteg.partition_digests(keys[perm], vals[perm],
                                            parts[perm], R)
    assert full.tolist() == full2.tolist()
    assert keyd.tolist() == keyd2.tolist()
    fa, _ = tinteg.partition_digests(keys[:150], vals[:150], parts[:150], R)
    fb, _ = tinteg.partition_digests(keys[150:], vals[150:], parts[150:], R)
    assert ((fa + fb) == full).all()
    r0 = parts == 3
    assert tinteg.digest_sum(keys[r0], vals[r0]) == int(full[3]) \
        == jinteg.digest_sum(keys[r0], vals[r0])
    vals2 = vals.copy()
    vals2[7, 1] += 1.0
    full3, keyd3 = tinteg.partition_digests(keys, vals2, parts, R)
    assert full3.tolist() != full.tolist()
    assert keyd3.tolist() == keyd.tolist()


def test_integrity_record_roundtrip(rng):
    keys = rng.integers(0, 1 << 40, size=64)
    vals = rng.standard_normal((64, 2)).astype(np.float32)
    parts = rng.integers(0, R, size=64)
    for with_crc in (False, True):
        rec = tinteg.compute_record(keys, vals, parts, R, with_digests=True,
                                    with_crc=with_crc)
        jrec = jinteg.compute_record(keys, vals, parts, R,
                                     with_digests=True, with_crc=with_crc)
        assert rec.to_dict() == jrec.to_dict()
        assert tinteg.IntegrityRecord.from_dict(rec.to_dict()) == rec
        assert tinteg.crc32_of(vals) == jinteg.crc32_of(vals)
    assert rec.val_dtype == "<f4" and rec.val_tail == (2,)
    empty = tinteg.compute_record(None, None, None, R, with_digests=True)
    assert empty.rows == 0 and empty.digests == [0] * R
    assert empty.to_dict() == jinteg.compute_record(
        None, None, None, R, with_digests=True).to_dict()


# -- the default level ------------------------------------------------------
def test_default_conf_reports_staged_like_reference(sides, data):
    """With nothing set, a read runs the staged verify and reports the
    reference's figures."""
    keys, vals = data

    def run(side):
        m = side.make()
        h = _stage(m, 1, keys, vals)
        res = m.read(h)
        rep = m.report(1)
        return {"integrity": rep.integrity,
                "integrity_bytes": rep.integrity_bytes,
                "verified": m.node.metrics.get(side.m.C_INTEGRITY_VERIFIED),
                "rows": _canonical(res)}

    got = both(sides, run)
    assert got["integrity"] == "staged"
    assert got["integrity_bytes"] == sum(k.nbytes + v.nbytes
                                         for k, v in zip(keys, vals))


def test_verify_level_validation_matches(sides):
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu_torch.config import ShuffleConf
    for level in ("off", "staged", "full"):
        assert ShuffleConf({VERIFY: level}, use_env=False) \
            .integrity_verify == level
    with pytest.raises(ValueError) as want:
        TpuShuffleConf({VERIFY: "paranoid"}, use_env=False).integrity_verify
    with pytest.raises(ValueError) as got:
        ShuffleConf({VERIFY: "paranoid"}, use_env=False)
    assert str(want.value) in str(got.value)
    assert ShuffleConf(use_env=False).ledger_dir == \
        TpuShuffleConf({}, use_env=False).ledger_dir == ""


def test_corrupt_fire_offset_matches():
    """``FaultInjector.fire``: the same firings, offsets and stats for the
    same conf and hits; ``disarm`` drops the offset."""
    conf = {"spark.shuffle.tpu.fault.corrupt.staged.failCount": "2",
            "spark.shuffle.tpu.fault.corrupt.staged.offset": "77",
            "spark.shuffle.tpu.fault.corrupt.spill.failRate": "0.5",
            "spark.shuffle.tpu.fault.seed": "3"}
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu_torch.config import ShuffleConf
    out = []
    for mod, cls in ((jf, TpuShuffleConf), (tf, ShuffleConf)):
        fi = mod.FaultInjector(cls(conf, use_env=False))
        seq = [fi.fire(s) for s in ["corrupt.staged", "corrupt.spill"] * 6]
        fi.arm("x", fail_count=1, offset=5)
        seq.append(fi.fire("x"))
        fi.arm("y", fail_count=1, offset=9)
        fi.disarm("y")
        fi.arm("y", fail_count=1)
        seq.append(fi.fire("y"))
        out.append((seq, fi.stats()))
    assert out[1] == out[0]
    assert out[1][0][:4] == [77, out[1][0][1], 77, out[1][0][3]]
    assert out[1][0][-2:] == [5, 0]


# -- commit publication + staged verify --------------------------------------
def test_commit_publishes_record_and_read_verifies(sides, data):
    keys, vals = data

    def run(side):
        m = side.make()
        h = _stage(m, 1, keys, vals)
        rec = h.entry.fetch_integrity(0)
        res = m.read(h)
        rep = m.report(1)
        verified = m.node.metrics.get(side.m.C_INTEGRITY_VERIFIED)
        return {"rec": rec.to_dict(), "integrity": rep.integrity,
                "integrity_bytes": rep.integrity_bytes,
                "verified_ok": verified >= rep.integrity_bytes,
                "rows": _canonical(res)}

    got = both(sides, run)
    assert got["rec"]["keys_fold"] == tinteg.fold64(keys[0])
    assert got["rec"]["keys_crc"] == 0 and "digests" not in got["rec"]
    assert got["integrity_bytes"] == sum(k.nbytes for k in keys) \
        + sum(v.nbytes for v in vals)


def test_verify_off_is_inert(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({VERIFY: "off"})
        h = _stage(m, 2, keys, vals)
        rec = h.entry.fetch_integrity(0)
        m.node.faults.arm("corrupt.staged", fail_count=1)
        m.read(h)                          # the armed site is never read
        rep = m.report(2)
        return {"rec": rec, "integrity": rep.integrity,
                "integrity_bytes": rep.integrity_bytes,
                "verified": m.node.metrics.get(side.m.C_INTEGRITY_VERIFIED),
                "stats": m.node.faults.stats()}

    got = both(sides, run)
    assert got["rec"] is None and got["integrity"] == ""
    assert got["verified"] == 0 and "corrupt.staged" not in got["stats"]


def test_corrupt_staged_failfast_typed_then_clean_reread(sides, data):
    keys, vals = data

    def run(side):
        m = side.make()
        want = _canonical(m.read(_stage(m, 3, keys, vals)))
        m.unregister_shuffle(3)
        m.node.faults.arm("corrupt.staged", fail_count=1, offset=123)
        h = _stage(m, 4, keys, vals)
        kind, msg = _error(lambda: m.read(h))
        return {"kind": kind, "names_map0": "map 0" in msg,
                "block": msg.split(": ")[1] if ": " in msg else "",
                "blocks": m.node.metrics.get(
                    side.m.C_INTEGRITY_CORRUPT_BLOCKS),
                "corrupt_bytes": m.node.metrics.get(
                    side.m.C_INTEGRITY_CORRUPT),
                "reread_ok": _canonical(m.read(h)) == want}

    got = both(sides, run)
    assert got["kind"] == "BlockCorruptionError" and got["names_map0"]
    assert got["blocks"] == 1 and got["reread_ok"]


def test_corrupt_staged_ring_event(sides, data, tmp_path):
    """The detection lands a ``fault`` event with the offset and a
    ``block_corruption`` event naming the block in the flight recorder's
    ring. (The factories close both nodes, which unhooks the recorder.)"""
    keys, vals = data

    def run(side):
        m = side.make({"spark.shuffle.tpu.flightRecorder.enabled": "true",
                       "spark.shuffle.tpu.flightRecorder.dir":
                       str(tmp_path / side.name)})
        m.node.faults.arm("corrupt.staged", fail_count=1, offset=9)
        h = _stage(m, 5, keys, vals)
        kind, _ = _error(lambda: m.read(h))
        ev = [e for e in m.node.flight.events()
              if e.get("kind") in ("block_corruption", "fault")]
        return {"kind": kind,
                "events": [(e["kind"], e.get("site"), e.get("block"),
                            e.get("offset"), e.get("bytes")) for e in ev]}

    got = both(sides, run)
    assert got["events"] == [
        ("fault", "corrupt.staged", None, 9, None),
        ("block_corruption", None, "map 0 (map 0 staged arena)", None,
         ROWS * 8 + ROWS * W * 4)]


def test_corrupt_staged_replay_spends_one_unit(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({"spark.shuffle.tpu.failure.policy": "replay"})
        want = _canonical(m.read(_stage(m, 5, keys, vals)))
        m.unregister_shuffle(5)
        m.node.faults.arm("corrupt.staged", fail_count=1, offset=123)
        h = _stage(m, 6, keys, vals)
        same = _canonical(m.read(h)) == want
        return {"same": same, "replays": m.report(6).replays,
                "blocks": m.node.metrics.get(
                    side.m.C_INTEGRITY_CORRUPT_BLOCKS)}

    assert both(sides, run) == {"same": True, "replays": 1, "blocks": 1}


def test_corrupt_spill_detected_through_mmap_views(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        d = tmp_path / side.name
        m = side.make({"spark.shuffle.tpu.failure.policy": "replay",
                       "spark.shuffle.tpu.spill.threshold": "1k",
                       "spark.shuffle.tpu.spill.dir": str(d)})
        m.node.faults.arm("corrupt.spill", fail_count=1, offset=777)
        h = _stage(m, 7, keys, vals)
        path = os.path.join(str(d), "shuffle_7_map_0.keys")
        crc0 = tinteg.crc32_file(path)
        res = m.read(h)
        return {"replays": m.report(7).replays,
                "fired": m.node.faults.stats()["corrupt.spill"][1],
                "rows": sum(res.partition(r)[0].shape[0] for r in range(R)),
                "undone": tinteg.crc32_file(path) == crc0}

    assert both(sides, run) == {"replays": 1, "fired": 1,
                                "rows": MAPS * ROWS, "undone": True}


# -- full level --------------------------------------------------------------
def test_full_verify_clean_and_tamper(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({VERIFY: "full"})
        h = _stage(m, 8, keys, vals)
        rec = h.entry.fetch_integrity(0)
        m.read(h)
        rep = m.report(8)
        out = {"rec": rec.to_dict(), "integrity": rep.integrity,
               "integrity_bytes": rep.integrity_bytes}
        h2 = _stage(m, 9, keys, vals)
        r2 = h2.entry.fetch_integrity(1)
        r2.digests[5] = (r2.digests[5] + 1) & 0xFFFFFFFFFFFFFFFF
        kind, msg = _error(lambda: m.read(h2))
        out.update(kind=kind, names="partition 5" in msg,
                   blocks=m.node.metrics.get(
                       side.m.C_INTEGRITY_CORRUPT_BLOCKS))
        return out

    got = both(sides, run)
    assert len(got["rec"]["digests"]) == R and got["integrity"] == "full"
    assert got["kind"] == "BlockCorruptionError" and got["names"]


def test_full_verify_waved_and_int8(sides, rng):
    fkeys = [rng.integers(-(1 << 62), 1 << 62, size=ROWS)
             for _ in range(MAPS)]
    fvals = [(rng.standard_normal((ROWS, W)) * 8).astype(np.float32)
             for _ in range(MAPS)]

    def run(side):
        m = side.make({VERIFY: "full", "spark.shuffle.tpu.a2a.waveRows":
                       "64"})
        m.read(_stage(m, 10, fkeys, fvals))
        rep = m.report(10)
        out = {"waves": rep.waves, "waved": rep.integrity,
               "waved_bytes": rep.integrity_bytes}
        m = side.make({VERIFY: "full", "spark.shuffle.tpu.a2a.wire": "int8"})
        m.read(_stage(m, 11, fkeys, fvals))
        rep = m.report(11)
        out.update(wire=rep.wire, int8=rep.integrity,
                   int8_bytes=rep.integrity_bytes)
        return out

    got = both(sides, run)
    assert got["waves"] >= 2 and got["waved"] == "full"
    assert got["wire"] == "int8" and got["int8"] == "full"


def test_full_verify_combine_host_verifies_staged_bytes_only(sides, data):
    """A combined host read at the full level runs the staged verify
    alone (the combine rewrites rows): its report names the configured
    level, as the reference's does, and counts the staged bytes only."""
    keys, vals = data

    def run(side):
        m = side.make({VERIFY: "full"})
        m.read(_stage(m, 12, keys, vals), combine="sum")
        rep = m.report(12)
        return rep.integrity, rep.integrity_bytes

    assert both(sides, run) == (
        "full", sum(k.nbytes + v.nbytes for k, v in zip(keys, vals)))


def test_no_records_keeps_report_unclaimed(sides, data):
    keys, vals = data

    def run(side):
        m = side.make()
        h = _stage(m, 17, keys, vals)
        with h.entry._cv:
            h.entry._integrity.clear()
        m.read(h)
        rep = m.report(17)
        return rep.integrity, rep.integrity_bytes

    assert both(sides, run) == ("", 0)


def test_full_verify_covers_async_submit(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({VERIFY: "full"})
        h = _stage(m, 15, keys, vals)
        res = m.submit(h).result()
        out = {"integrity": m.report(15).integrity,
               "rows": sum(res.partition(r)[0].shape[0] for r in range(R))}
        h2 = _stage(m, 16, keys, vals)
        r2 = h2.entry.fetch_integrity(0)
        r2.digests[2] = (r2.digests[2] ^ 0x1)
        pending = m.submit(h2)
        kind, msg = _error(pending.result)
        out.update(kind=kind, names="partition 2" in msg)
        return out

    assert both(sides, run) == {"integrity": "full", "rows": MAPS * ROWS,
                                "kind": "BlockCorruptionError",
                                "names": True}


def test_full_verify_programs_invariant(port_factory, data, monkeypatch):
    """The port's counterpart of the reference's compiled-program
    invariant: every verify level launches the same kernels. The CPU runs
    the segment move's plain version, counted here as the card counts the
    kernel."""
    keys, vals = data
    plain = ra.ragged_a2a_plain

    def counted(*a, **kw):
        backend.count_launch(ra.KERNEL_NAME)
        return plain(*a, **kw)

    monkeypatch.setattr(ra, "ragged_a2a_plain", counted)
    seen = {}
    for level, sid in (("off", 12), ("staged", 13), ("full", 14)):
        m = port_factory({VERIFY: level,
                          "spark.shuffle.tpu.a2a.impl": "pallas"})
        h = _stage(m, sid, keys, vals)
        backend.reset_launch_counts()
        m.read(h)
        seen[level] = backend.launch_counts()
    assert seen["off"] == seen["staged"] == seen["full"] \
        == {ra.KERNEL_NAME: 1}


# -- restart recovery (failure.ledgerDir) -------------------------------------
def test_restart_recovery_zero_recompute(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        m = side.make(conf)
        h = _stage(m, 20, keys, vals)
        want = _canonical(m.read(h))
        sdir = os.path.join(ledger, "shuffle_20")
        out = {"files": _files(ledger, 20),
               "manifest": _manifest(ledger, 20),
               "tmp": glob.glob(os.path.join(sdir, "*.tmp"))}
        m2 = side.make(conf)
        out["recovered"] = m2.recovered_shuffles()
        h2 = m2.register_shuffle(20, MAPS, R)
        out["present"] = [h2.entry.present(mm) for mm in range(MAPS)]
        out["rewrite"] = _error(lambda: m2.get_writer(h2, 0))[0]
        out["same"] = _canonical(m2.read(h2)) == want
        out["recovered_count"] = m2.node.metrics.get(
            side.m.C_INTEGRITY_RECOVERED)
        out["integrity"] = m2.report(20).integrity
        m2.unregister_shuffle(20)
        out["gone"] = not os.path.exists(sdir)
        return out

    got = both(sides, run)
    assert got["recovered"] == {20: {"intact": [0, 1], "quarantined": []}}
    assert got["present"] == [True, True] and got["rewrite"] == \
        "RuntimeError"
    assert got["same"] and got["recovered_count"] == MAPS
    assert got["integrity"] == "staged" and got["gone"]
    assert got["tmp"] == [] and len([f for f in got["files"]
                                     if f.endswith(".keys")]) == MAPS


def test_restart_recovery_quarantines_corrupt_block(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        m = side.make(conf)
        want = _canonical(m.read(_stage(m, 21, keys, vals)))
        vpath = os.path.join(ledger, "shuffle_21", "shuffle_21_map_1.vals")
        _flip_file(vpath, 40)
        m2 = side.make(conf)
        out = {"recovered": m2.recovered_shuffles(),
               "quarantined": m2.node.metrics.get(
                   side.m.C_INTEGRITY_QUARANTINED)}
        h2 = m2.register_shuffle(21, MAPS, R)
        out["present"] = [h2.entry.present(0), h2.entry.present(1)]
        out["moved"] = not os.path.exists(vpath) and bool(glob.glob(
            os.path.join(ledger, "shuffle_21", "quarantine",
                         "shuffle_21_map_1.vals.*")))
        with open(os.path.join(ledger, "quarantine_report.json")) as f:
            out["report"] = [(b["shuffle_id"], b["map_id"])
                             for b in json.load(f)["blocks"]]
        w = m2.get_writer(h2, 1)
        w.write(keys[1], vals[1])
        w.commit(R)
        out["same"] = _canonical(m2.read(h2)) == want
        return out

    got = both(sides, run)
    assert got["recovered"][21] == {"intact": [0], "quarantined": [1]}
    assert got["quarantined"] == 1 and got["present"] == [True, False]
    assert got["moved"] and got["report"] == [(21, 1)] and got["same"]


def test_quarantine_not_double_counted_across_restarts(sides, data,
                                                       tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        m = side.make(conf)
        _stage(m, 25, keys, vals)
        _flip_file(os.path.join(ledger, "shuffle_25",
                                "shuffle_25_map_0.vals"), 8)
        m2 = side.make(conf)
        out = {"first": m2.recovered_shuffles()[25],
               "q1": m2.node.metrics.get(side.m.C_INTEGRITY_QUARANTINED)}
        m3 = side.make(conf)
        out.update(second=m3.recovered_shuffles()[25],
                   q2=m3.node.metrics.get(side.m.C_INTEGRITY_QUARANTINED),
                   manifest=sorted(_manifest(ledger, 25)["maps"]))
        with open(os.path.join(ledger, "quarantine_report.json")) as f:
            out["blocks"] = len(json.load(f)["blocks"])
        return out

    assert both(sides, run) == {
        "first": {"intact": [1], "quarantined": [0]}, "q1": 1,
        "second": {"intact": [1], "quarantined": []}, "q2": 0,
        "manifest": ["1"], "blocks": 1}


def test_restart_recovery_shape_mismatch_registers_fresh(sides, data,
                                                         tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        _stage(side.make(conf), 22, keys, vals)
        m2 = side.make(conf)
        seen = 22 in m2.recovered_shuffles()
        h = m2.register_shuffle(22, MAPS, 2 * R)
        return {"seen": seen, "parts": h.num_partitions,
                "present": h.entry.present(0),
                "manifest": os.path.exists(os.path.join(
                    ledger, "shuffle_22", "commit.manifest")),
                "left": m2.recovered_shuffles()}

    assert both(sides, run) == {"seen": True, "parts": 2 * R,
                                "present": False, "manifest": False,
                                "left": {}}


def test_manifest_crc_tamper_ignores_shuffle(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        _stage(side.make(conf), 23, keys, vals)
        mpath = os.path.join(ledger, "shuffle_23", "commit.manifest")
        body = open(mpath).read().replace('"rows": %d' % ROWS,
                                          '"rows": %d' % (ROWS - 1), 1)
        open(mpath, "w").write(body)
        m2 = side.make(conf)
        seen = 23 in m2.recovered_shuffles()
        h = m2.register_shuffle(23, MAPS, R)
        return seen, h.entry.present(0)

    assert both(sides, run) == (False, False)


def test_recovered_survive_remesh_before_adoption(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        m = side.make(conf)
        want = _canonical(m.read(_stage(m, 28, keys, vals)))
        m2 = side.make(conf)
        seen = 28 in m2.recovered_shuffles()
        m2.node.remesh(reason="pre-adoption remesh")
        h2 = m2.register_shuffle(28, MAPS, R)
        return {"seen": seen,
                "present": all(h2.entry.present(mm) for mm in range(MAPS)),
                "same": _canonical(m2.read(h2)) == want,
                "epoch": h2.epoch == m2.node.epochs.current}

    assert both(sides, run) == {"seen": True, "present": True,
                                "same": True, "epoch": True}


def test_corrupt_index_sidecar_quarantines(sides, data, tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        _stage(side.make(conf), 27, keys, vals)
        ipath = os.path.join(ledger, "shuffle_27", "shuffle_27_map_0.index")
        open(ipath, "w").write('{"rows": 7, "val_dtype": null, '
                               '"val_tail": null}')
        return side.make(conf).recovered_shuffles()[27]

    assert both(sides, run) == {"quarantined": [0], "intact": [1]}


def test_manifest_version_mismatch_degrades_to_recompute(sides, data,
                                                         tmp_path):
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        conf = {LEDGER: ledger}
        _stage(side.make(conf), 26, keys, vals)
        mpath = os.path.join(ledger, "shuffle_26", "commit.manifest")
        doc = json.load(open(mpath))
        doc["version"] = 99
        doc["crc32"] = side.durable._manifest_crc(doc)
        open(mpath, "w").write(json.dumps(doc, sort_keys=True))
        m2 = side.make(conf)
        seen = 26 in m2.recovered_shuffles()
        h = m2.register_shuffle(26, MAPS, R)
        return seen, h.entry.present(0)

    assert both(sides, run) == (False, False)


def test_epoch_bump_replay_carries_integrity_records(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({"spark.shuffle.tpu.failure.policy": "replay"})
        h = _stage(m, 24, keys, vals)
        want = _canonical(m.read(h))
        m.node.epochs.bump("test remesh")
        same = _canonical(m.read(h)) == want
        rep = m.report(24)
        return {"same": same, "rec": h.entry.fetch_integrity(0).to_dict(),
                "integrity": rep.integrity, "replays": rep.replays}

    got = both(sides, run)
    assert got["same"] and got["integrity"] == "staged"
    assert got["replays"] == 1


# -- the parsed manifest, and each package adopting the other's ledger ------
def test_manifest_and_sealed_files_match_reference(sides, data, tmp_path):
    """The same writes give the same manifest (crc32 included), the same
    sealed file set and byte-equal files."""
    keys, vals = data

    def run(side):
        ledger = _ledger(tmp_path, side)
        m = side.make({LEDGER: ledger, VERIFY: "full"})
        h = _stage(m, 30, keys, vals)
        files = _files(ledger, 30)
        blobs = {f: open(os.path.join(ledger, "shuffle_30", f), "rb").read()
                 for f in files if not f.endswith(".manifest")}
        return {"manifest": _manifest(ledger, 30), "files": files,
                "blobs": blobs,
                "recs": [h.entry.fetch_integrity(mm).to_dict()
                         for mm in range(MAPS)]}

    got = both(sides, run)
    assert got["manifest"]["maps"]["0"]["keys_crc"] \
        == tinteg.crc32_of(keys[0])
    assert got["manifest"]["crc32"] == tdurable._manifest_crc(
        got["manifest"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_ledger_adopted_across_packages(sides, data, tmp_path, writer,
                                        reader):
    """A ledger directory one package wrote is adopted by the other with
    zero recompute and the same partitions: the on-disk format is one."""
    keys, vals = data
    by = {s.name: s for s in sides}
    ledger = str(tmp_path / "ledger")
    conf = {LEDGER: ledger}
    w = by[writer].make(conf)
    want = _canonical(w.read(_stage(w, 40, keys, vals)))
    w.stop()
    w.node.close()
    r = by[reader].make(conf)
    assert r.recovered_shuffles() == {40: {"intact": [0, 1],
                                           "quarantined": []}}
    h = r.register_shuffle(40, MAPS, R)
    assert all(h.entry.present(mm) for mm in range(MAPS))
    with pytest.raises(RuntimeError, match="already committed"):
        r.get_writer(h, 1)
    assert _canonical(r.read(h)) == want
    assert r.report(40).integrity == "staged"
    assert r.node.metrics.get(by[reader].m.C_INTEGRITY_RECOVERED) == MAPS


# -- integrity.verify=full + device sink ---------------------------------------
def test_full_device_sink_samples_key_lanes_and_counts_d2h(sides, data):
    """A device-sink read at the full level samples the receive buffer's
    key lanes (a copy: the device buffers stay consumable), routes them
    again on the host and charges the pull to the read's D2H."""
    keys, vals = data

    def d2h(side, m):
        if side.name == "jax":
            return jmetrics.GLOBAL_METRICS.get(jmetrics.C_D2H)
        return m.node.metrics.get(tmetrics.C_D2H)

    def run(side):
        m = side.make({VERIFY: "full"})
        h = _stage(m, 30, keys, vals)
        d0 = d2h(side, m)
        res = m.read(h, sink="device")
        sampled = d2h(side, m) - d0
        rep = m.report(30)
        d1 = d2h(side, m)
        outs = res.consume(lambda c, rows, nv: (c or []) + [rows])
        if side.name == "jax":
            import jax
            jax.block_until_ready(outs)
        return {"sink": rep.sink, "integrity": rep.integrity,
                "integrity_bytes": rep.integrity_bytes,
                "sampled_ok": sampled > 0 and rep.d2h_bytes == sampled,
                "consume_d2h": d2h(side, m) - d1}

    got = both(sides, run)
    assert got["integrity"] == "full" and got["sink"] == "device"
    assert got["sampled_ok"] and got["consume_d2h"] == 0


def test_full_device_sink_covers_combine(sides, data):
    keys, vals = data

    def run(side):
        m = side.make({VERIFY: "full"})
        res = m.read(_stage(m, 31, keys, vals), combine="sum",
                     sink="device")
        rep = m.report(31)
        res.consume(lambda c, rows, nv: c)
        return rep.sink, rep.integrity, rep.integrity_bytes

    assert both(sides, run)[:2] == ("device", "full")


def test_full_device_sink_pallas_plain_verifies_staged_only(port_factory,
                                                           data):
    """A plain device-sink read under the segment move keeps the
    reference's verdict: no key-lane sample (the reference's receive
    layout there is chunk-aligned; the port compacts the rows it hands
    over, but samples nothing either), so only the staged bytes count
    and nothing moves to the host."""
    keys, vals = data
    m = port_factory({VERIFY: "full", "spark.shuffle.tpu.a2a.impl":
                      "pallas"})
    res = m.read(_stage(m, 32, keys, vals), sink="device")
    rep = m.report(32)
    assert (rep.sink, rep.impl, rep.integrity) == ("device", "pallas",
                                                   "full")
    assert rep.integrity_bytes == sum(k.nbytes + v.nbytes
                                      for k, v in zip(keys, vals))
    assert rep.d2h_bytes == 0
    res.close()


def _routed_rows(rng, integ, p2d, shards, cap):
    rows = np.zeros((shards * cap, 4), np.int32)
    totals = np.zeros(shards, np.int64)
    keys = rng.integers(-(1 << 62), 1 << 62, size=200)
    part = integ.host_partition_ids(keys, R)
    for s in range(shards):
        mine = keys[np.asarray(p2d[part]) == s][:cap]
        n = mine.shape[0]
        rows[s * cap:s * cap + n, :2] = \
            mine.astype(np.int64).view(np.int32).reshape(n, 2)
        totals[s] = n
    return rows, totals


def test_verify_key_routing_detects_misrouted_key():
    shards, cap = 4, 64
    p2d = np.asarray(jax_blocked_partition_map(R, shards))
    out = []
    for integ in (jinteg, tinteg):
        rows, totals = _routed_rows(np.random.default_rng(0), integ, p2d,
                                    shards, cap)
        ok = integ.verify_key_routing(rows, totals, R, shards)
        bad = rows.copy()
        bad[cap, 0] ^= 1 << 7
        with pytest.raises(integ._StagedMismatch) as e:
            integ.verify_key_routing(bad, totals, R, shards)
        out.append((ok, str(e.value), rows.tolist()))
    assert out[1] == out[0]
    assert out[1][0] == int(totals.sum()) * 8 and "shard 1" in out[1][1]
    # a distributed partial view (shards 1 and 3 only) verifies alike
    rows, totals = _routed_rows(np.random.default_rng(0), tinteg, p2d,
                                shards, cap)
    part = np.concatenate([rows[cap:2 * cap], rows[3 * cap:]])
    assert tinteg.verify_key_routing(part, totals[[1, 3]], R, shards,
                                     shard_ids=[1, 3]) \
        == int(totals[[1, 3]].sum()) * 8


@pytest.mark.parametrize("integ", INTEG)
def test_verify_key_routing_partitioners(integ):
    k = np.array([-5, 0, 3, 99, 0xFFFFFFFF], np.int64)
    assert integ.host_partition_ids(k, R, "direct").tolist() \
        == [0, 0, 3, R - 1, 0]
    bounds = np.array([10, 20, 30], np.int64)
    k = np.array([5, 10, 25, 100], np.int64)
    assert integ.host_partition_ids(k, 4, "range", bounds).tolist() \
        == [0, 1, 2, 3]
    hk = np.random.default_rng(1).integers(-(1 << 62), 1 << 62, size=500)
    assert integ.host_partition_ids(hk, R).tolist() == \
        jinteg.host_partition_ids(hk, R).tolist()


def test_staged_verify_names_lowest_failing_map(sides, rng):
    """``corrupt.staged`` armed for two firings, on outputs large enough
    for the port to fold them on its pack executor: each read consumes
    one firing (the sites are consulted in map order until one fires, as
    the reference's serial loop consults them until its raise), the
    error names map 0 and one corrupt block is counted a read."""
    rows = 1 << 16
    keys = [rng.integers(-(1 << 62), 1 << 62, size=rows)
            for _ in range(MAPS)]
    vals = [rng.integers(-(1 << 30), 1 << 30, size=(rows, W))
            .astype(np.int32) for _ in range(MAPS)]

    def run(side):
        m = side.make()
        m.node.faults.arm("corrupt.staged", fail_count=2, offset=11)
        h = _stage(m, 50, keys, vals)
        first = _error(lambda: m.read(h))
        out = {"first": first[0], "block": first[1].split(": ")[1],
               "fired": m.node.faults.stats()["corrupt.staged"]}
        second = _error(lambda: m.read(h))
        out.update(second=second[0],
                   blocks=m.node.metrics.get(
                       side.m.C_INTEGRITY_CORRUPT_BLOCKS),
                   fired2=m.node.faults.stats()["corrupt.staged"],
                   clean=sum(len(k) for k, _ in _canonical(m.read(h))))
        return out

    got = both(sides, run)
    assert got["first"] == got["second"] == "BlockCorruptionError"
    assert got["block"].startswith("block corruption detected in map 0 ")
    assert (got["fired"], got["fired2"], got["blocks"]) == \
        ((1, 1), (2, 2), 2)
    assert got["clean"] == MAPS * (1 << 16)
