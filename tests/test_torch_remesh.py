"""Port parity for elastic recovery: remesh, the recovery ledger under
``failure.policy=replay`` and the in-flight-read guard with its
graveyard — the counterparts of ``tests/test_remesh.py``.

Each case runs one sequence of calls on the JAX package's manager
(``manager_factory``: 8 virtual CPU devices, ``a2a.impl=dense``) and on
the port's (``connect(device="cpu")``: 8 logical shards, ``dense``) with
the same seeded keys, and holds the port to the reference's outcome: the
raised types, the replays and the re-pinned epoch, the delivered key
multisets (exact), and the pool's buffers and the spill files released
or held at the same steps. The JAX side remeshes over a device list; the
port over a shard count."""

import os

import numpy as np
import pytest

from sparkucx_tpu.workloads.groupby import run_groupby as jax_groupby
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.shuffle import manager as tmanager
from sparkucx_tpu_torch.workloads.groupby import run_groupby


@pytest.fixture()
def port_factory():
    made = []

    def make(overrides=None):
        svc = connect({"spark.shuffle.tpu.a2a.impl": "dense",
                       **(overrides or {})}, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


@pytest.fixture()
def managers(manager_factory, port_factory):
    return lambda overrides=None: (("jax", manager_factory(overrides)),
                                   ("port", port_factory(overrides)))


def _remesh(side: str, mgr, n: int, reason: str) -> int:
    node = mgr.node
    if side == "jax":
        import jax
        return node.remesh(devices=jax.devices()[:n], reason=reason)
    return node.remesh(n, reason=reason)


def _keys(res) -> list:
    return np.sort(np.concatenate([k for _, (k, _) in
                                   res.partitions()])).tolist()


def _kind(fn) -> str:
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return "ok"


def test_remesh_shrink_and_rerun(managers):
    """Two shards lost: the grid shrinks to 6, the stale handle fails
    typed, and re-registered work completes on the smaller grid."""
    got = []
    for side, mgr in managers():
        h_old = mgr.register_shuffle(50, num_maps=4, num_partitions=16)
        w = mgr.get_writer(h_old, 0)
        w.write(np.arange(10, dtype=np.int64))
        w.commit(16)
        epoch = _remesh(side, mgr, 6, "2 devices lost")
        size = mgr.node.num_devices if side == "jax" \
            else mgr.node.num_shards
        stale = _kind(lambda: mgr.read(h_old))
        run = jax_groupby if side == "jax" else run_groupby
        out = run(mgr, num_mappers=4, pairs_per_mapper=200,
                  num_partitions=12, key_space=100, shuffle_id=51)
        got.append((epoch, size, stale, out["rows"],
                    out["distinct_keys"]))
    assert got[0] == got[1]
    assert got[1][:4] == (1, 6, "StaleEpochError", 800)


def test_remesh_rejects_empty():
    with connect(device="cpu", use_env=False) as svc:
        with pytest.raises(RuntimeError, match="zero surviving"):
            svc.node.remesh(0)


def test_ledger_replays_staged_state_across_remesh(managers):
    """Under replay a fully staged shuffle survives the bump: the stale
    handle re-pins, the exchange runs on the new grid, the report counts
    the replay, and the handle is current afterwards."""
    got = []
    for side, mgr in managers({"spark.shuffle.tpu.failure.policy":
                               "replay"}):
        rng = np.random.default_rng(60)
        h = mgr.register_shuffle(60, num_maps=3, num_partitions=8)
        keys = []
        for m in range(3):
            k = rng.integers(0, 1 << 20, size=100).astype(np.int64)
            w = mgr.get_writer(h, m)
            w.write(k)
            w.commit(8)
            keys.append(k)
        _remesh(side, mgr, 6, "2 devices lost")
        res = mgr.read(h)
        first = (_keys(res) == np.sort(np.concatenate(keys)).tolist(),
                 mgr.report(60).replays, h.epoch == mgr.node.epochs.current)
        again = len(_keys(mgr.read(h)))
        got.append((first, again, mgr.report(60).replays,
                    mgr._replay_counts.get(60)))
        mgr.unregister_shuffle(60)
    assert got[0] == got[1] == ((True, 1, True), 300, 0, 1)


def test_ledger_budget_exhausted_across_repeat_remesh(managers):
    got = []
    for side, mgr in managers({"spark.shuffle.tpu.failure.policy": "replay",
                               "spark.shuffle.tpu.failure.replayBudget":
                                   "1"}):
        rng = np.random.default_rng(61)
        h = mgr.register_shuffle(61, num_maps=1, num_partitions=4)
        w = mgr.get_writer(h, 0)
        w.write(rng.integers(0, 1 << 20, size=32).astype(np.int64))
        w.commit(4)
        mgr.node.epochs.bump("first loss")
        total = len(_keys(mgr.read(h)))
        mgr.node.epochs.bump("second loss")
        with pytest.raises(Exception, match="replay budget") as e:
            mgr.read(h)
        got.append((total, type(e.value).__name__))
        mgr.unregister_shuffle(61)
    assert got[0] == got[1] == (32, "StaleEpochError")


def test_failfast_remesh_still_fences_stale_handles(managers):
    got = []
    for side, mgr in managers():
        rng = np.random.default_rng(62)
        h = mgr.register_shuffle(62, num_maps=2, num_partitions=4)
        for m in range(2):
            w = mgr.get_writer(h, m)
            w.write(rng.integers(0, 1 << 20, size=16).astype(np.int64))
            w.commit(4)
        mgr.node.epochs.bump("device loss")
        got.append((_kind(lambda: mgr.read(h)),
                    mgr.report(62) is None or mgr.report(62).replays))
    assert got[0] == got[1] == ("StaleEpochError", True)


def test_partially_staged_shuffle_drops_from_ledger(managers):
    got = []
    for side, mgr in managers({"spark.shuffle.tpu.failure.policy":
                               "replay"}):
        rng = np.random.default_rng(63)
        h = mgr.register_shuffle(63, num_maps=2, num_partitions=4)
        w = mgr.get_writer(h, 0)
        w.write(rng.integers(0, 1 << 20, size=16).astype(np.int64))
        w.commit(4)
        mgr.get_writer(h, 1)                 # staged, never committed
        mgr.node.epochs.bump("loss mid-stage")
        got.append(_kind(lambda: mgr.read(h)))
    assert got == ["StaleEpochError", "StaleEpochError"]


def _spill_fixture(mgr, sid: int, seed: int):
    """Writer 0 spills (3000 rows over a 4k threshold), writer 1 stays in
    pinned pool buffers below it."""
    rng = np.random.default_rng(seed)
    h = mgr.register_shuffle(sid, 2, 4)
    w = mgr.get_writer(h, 0)
    w.write(rng.integers(0, 1 << 30, size=3000).astype(np.int64))
    w.commit(4)
    w2 = mgr.get_writer(h, 1)
    w2.write(rng.integers(0, 1 << 30, size=64).astype(np.int64))
    w2.commit(4)
    return h


def test_epoch_bump_releases_writer_buffers(managers, tmp_path):
    """A bump drops the shuffle: the pool buffers go back and the spill
    files are deleted, in both packages at the same step."""
    got = []
    for side, mgr in managers({"spark.shuffle.tpu.spill.threshold": "4k",
                               "spark.shuffle.tpu.spill.dir":
                                   str(tmp_path / "x")}):
        d = str(tmp_path / "x")
        _spill_fixture(mgr, 88, 88)
        before = mgr.node.pool.stats()["in_use"]
        spilled = bool([f for f in os.listdir(d) if "88" in f])
        mgr.node.epochs.bump("test remesh")
        after_one = (mgr.node.pool.stats()["in_use"] < before,
                     not [f for f in os.listdir(d) if "88" in f])
        mgr.node.epochs.bump("second remesh")
        got.append((before > 0, spilled, after_one,
                    mgr.node.pool.stats()["in_use"] < before))
    assert got[0] == got[1] == (True, True, (True, True), True)


def test_graveyard_held_while_read_in_flight(managers, tmp_path):
    """Two bumps while a read is inside its materialize-to-pack window:
    the dropped writers' buffers and spill files stay until that read's
    window closes, then go."""
    got = []
    for side, mgr in managers({"spark.shuffle.tpu.spill.threshold": "4k",
                               "spark.shuffle.tpu.spill.dir":
                                   str(tmp_path / "y")}):
        d = str(tmp_path / "y")
        _spill_fixture(mgr, 90, 90)
        before = mgr.node.pool.stats()["in_use"]
        g = mgr._read_started()
        mgr.node.epochs.bump("first remesh")
        mgr.node.epochs.bump("second remesh")
        held = (mgr.node.pool.stats()["in_use"] == before,
                bool([f for f in os.listdir(d) if "90" in f]))
        mgr._read_finished(g)
        freed = (mgr.node.pool.stats()["in_use"] < before,
                 not [f for f in os.listdir(d) if "90" in f])
        got.append((held, freed))
    assert got[0] == got[1] == ((True, True), (True, True))


def test_graveyard_freed_immediately_when_idle(managers):
    got = []
    for side, mgr in managers():
        rng = np.random.default_rng(91)
        h = mgr.register_shuffle(91, 1, 4)
        w = mgr.get_writer(h, 0)
        w.write(rng.integers(0, 1 << 30, size=64).astype(np.int64))
        w.commit(4)
        before = mgr.node.pool.stats()["in_use"]
        mgr.node.epochs.bump("remesh")
        got.append((before > 0, mgr.node.pool.stats()["in_use"] < before))
    assert got[0] == got[1] == (True, True)


def test_remesh_during_pack_defers_release(port_factory, monkeypatch):
    """A remesh that lands while a read packs from the writers' staged
    buffers (here: from inside the pack) must not hand those buffers back
    to the pool under it: they stay checked out until the pack is done,
    the read delivers what was written, and the buffers go back after."""
    mgr = port_factory()
    pool = mgr.node.pool
    rng = np.random.default_rng(92)
    h = mgr.register_shuffle(92, 2, 4)
    keys = []
    for m in range(2):
        k = rng.integers(0, 1 << 30, size=512).astype(np.int64)
        w = mgr.get_writer(h, m)
        w.write(k, np.stack([k, k], 1).astype(np.int32))
        w.commit(4)
        keys.append(k)
    staged = pool.stats()["in_use"]
    seen = {}
    real = tmanager.pack_rows

    def pack_during_remesh(*a, **kw):
        if not seen:
            mgr.node.remesh(mgr.node.num_shards, reason="mid-pack loss")
            seen["in_use"] = pool.stats()["in_use"]
        return real(*a, **kw)

    monkeypatch.setattr(tmanager, "pack_rows", pack_during_remesh)
    res = mgr.read(h)
    monkeypatch.setattr(tmanager, "pack_rows", real)
    # the staged buffers plus the pack buffer the read holds
    assert seen["in_use"] == staged + 1
    assert _keys(res) == np.sort(np.concatenate(keys)).tolist()
    for _, (k, v) in res.partitions():
        assert (v[:, 0] == k.astype(np.int32)).all()
    assert pool.stats()["in_use"] == 0
