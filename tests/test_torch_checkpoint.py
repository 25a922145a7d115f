"""Port parity for checkpoint / resume
(``sparkucx_tpu_torch/runtime/checkpoint.py``): the 12 cases of
``tests/test_checkpoint.py`` and a shuffle snapshot crossing between the
packages in both directions.

The five ``TrainCheckpointer`` cases run the reference's script on the
port's checkpointer (``torch.save`` underneath where the reference has
Orbax) with the same state, plus a tensor state restored onto its
target's device and dtype. The seven snapshot cases run one script on
the JAX package's ``manager_factory`` (8 virtual CPU devices,
``a2a.impl=dense``) and on a port manager (``connect(device="cpu")``, 8
logical shards) from the same seeded numpy inputs, and hold the port's
restored partitions (exact key and value multisets) and raised texts
against the JAX package's. The crossing cases restore a snapshot one
package wrote with the other's ``restore_shuffles``: the ``.npz`` layout
and ``_SNAP_VERSION`` are shared."""

import os

import numpy as np
import pytest
import torch

from sparkucx_tpu.runtime import checkpoint as jck
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.runtime import checkpoint as tck
from sparkucx_tpu_torch.runtime.checkpoint import TrainCheckpointer

SIDES = ["jax", "port"]


# -- TrainCheckpointer -------------------------------------------------------
def make_state(step):
    return {
        "params": {"w": np.full((4, 4), float(step), np.float32),
                   "b": np.arange(4, dtype=np.float32) * step},
        "step": np.int64(step),
    }


def test_save_restore_roundtrip(tmp_path):
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        state = make_state(1)
        assert ck.save(1, state)
        out = ck.restore(1)
        np.testing.assert_array_equal(out["params"]["w"],
                                      state["params"]["w"])
        np.testing.assert_array_equal(out["params"]["b"],
                                      state["params"]["b"])
        assert int(out["step"]) == 1
        assert out["params"]["w"].dtype == np.float32
        assert isinstance(out["step"], np.int64)


def test_latest_and_retention(tmp_path):
    with TrainCheckpointer(str(tmp_path / "ckpt"), keep=2) as ck:
        for s in (1, 2, 3):
            ck.save(s, make_state(s))
        assert ck.latest_step() == 3
        assert ck.all_steps() == [2, 3]
        out = ck.restore()
        assert float(out["params"]["w"][0, 0]) == 3.0


def test_restore_empty_raises(tmp_path):
    with TrainCheckpointer(str(tmp_path / "empty")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_restore_with_target_pytree(tmp_path, kind):
    """With a target, each tensor comes back on its target leaf's device
    and dtype (the counterpart of Orbax's restore shardings)."""
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        state = make_state(5)
        if kind == "tensor":
            state = _tree_map(torch.as_tensor, state)
        ck.save(5, state)
        target = _tree_map(
            np.zeros_like if kind == "numpy"
            else (lambda t: torch.zeros_like(t, dtype=torch.float64)),
            state)
        out = ck.restore(5, target=target)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]),
                                      np.asarray(state["params"]["w"]))
        if kind == "tensor":
            assert out["params"]["w"].dtype == torch.float64
            assert out["params"]["w"].device == target["params"]["w"].device


def test_resume_across_instances(tmp_path):
    d = str(tmp_path / "ckpt")
    with TrainCheckpointer(d) as ck:
        ck.save(7, make_state(7))
    with TrainCheckpointer(d) as ck2:
        assert ck2.latest_step() == 7
        assert float(ck2.restore()["params"]["w"][0, 0]) == 7.0


def test_adam_state_round_trip_resumes_bit_for_bit(tmp_path):
    """A torch module's parameters and Adam state: the step after a
    restore equals the step without one."""
    torch.manual_seed(0)
    x, y = torch.randn(32, 8), torch.randn(32, 4)

    def fresh():
        torch.manual_seed(1)
        lin = torch.nn.Linear(8, 4)
        return lin, torch.optim.Adam(lin.parameters(), lr=1e-2)

    def step(lin, opt):
        opt.zero_grad()
        torch.nn.functional.mse_loss(lin(x), y).backward()
        opt.step()

    lin, opt = fresh()
    for _ in range(2):
        step(lin, opt)
    with TrainCheckpointer(str(tmp_path / "adam")) as ck:
        ck.save(2, {"model": lin.state_dict(), "opt": opt.state_dict()})
        step(lin, opt)
        lin2, opt2 = fresh()
        got = ck.restore(target={"model": lin2.state_dict(),
                                 "opt": opt.state_dict()})
        lin2.load_state_dict(got["model"])
        opt2.load_state_dict(got["opt"])
        step(lin2, opt2)
    for a, b in zip(lin.parameters(), lin2.parameters()):
        assert torch.equal(a, b)


# -- shuffle snapshots -------------------------------------------------------
class Factories:
    """One manager factory per package; each builds a fresh manager."""

    def __init__(self, jax_factory):
        self._jax = jax_factory
        self._svcs = []

    def make(self, side, overrides=None):
        if side == "jax":
            return self._jax(overrides)
        svc = connect({"spark.shuffle.tpu.a2a.impl": "dense",
                       **(overrides or {})}, device="cpu", use_env=False)
        self._svcs.append(svc)
        return svc.manager

    def close(self):
        while self._svcs:
            self._svcs.pop().stop()


@pytest.fixture()
def factories(manager_factory):
    f = Factories(manager_factory)
    yield f
    f.close()


def ck_of(side):
    return jck if side == "jax" else tck


def _rows(result, R, ordered=False):
    """{partition: sorted (key, value bytes) records} of a read."""
    out = {}
    for r in range(R):
        k, v = result.partition(r)
        k = np.asarray(k)
        if v is None:
            out[r] = np.sort(k)
            continue
        v = np.ascontiguousarray(np.asarray(v)).reshape(k.size, -1)
        rec = np.concatenate([k.view(np.uint8).reshape(k.size, 8),
                              v.view(np.uint8).reshape(k.size, -1)], axis=1)
        out[r] = rec[np.lexsort(rec.T[::-1])] if k.size else rec
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for r in a:
        np.testing.assert_array_equal(a[r], b[r])


def test_shuffle_snapshot_roundtrip(factories, tmp_path):
    seen = []
    for side in SIDES:
        rng = np.random.default_rng(0)
        mgr = factories.make(side)
        h = mgr.register_shuffle(920, num_maps=3, num_partitions=8)
        for m in range(3):
            w = mgr.get_writer(h, m)
            keys = rng.integers(0, 1 << 20, size=40 + m)
            vals = rng.standard_normal((40 + m, 2)).astype(np.float32)
            w.write(keys, vals)
            w.commit(h.num_partitions)
        snap = str(tmp_path / side / "snap")
        assert ck_of(side).snapshot_shuffles(mgr, snap) == 1
        mgr.unregister_shuffle(920)
        handles = ck_of(side).restore_shuffles(mgr, snap)
        assert set(handles) == {920}
        assert mgr.node.registry.get(920).num_present == 3
        seen.append(_rows(mgr.read(handles[920]), 8))
        assert sum(x.shape[0] for x in seen[-1].values()) == 40 + 41 + 42
        mgr.unregister_shuffle(920)
    _same(*seen)


def test_snapshot_uncommitted_writer(factories, tmp_path):
    """An uncommitted writer survives as staged-but-unpublished."""
    for side in SIDES:
        rng = np.random.default_rng(0)
        mgr = factories.make(side)
        h = mgr.register_shuffle(921, num_maps=2, num_partitions=4)
        w0 = mgr.get_writer(h, 0)
        w0.write(rng.integers(0, 100, size=10))
        w0.commit(h.num_partitions)
        w1 = mgr.get_writer(h, 1)
        w1.write(rng.integers(0, 100, size=5))
        snap = str(tmp_path / side / "snap2")
        ck_of(side).snapshot_shuffles(mgr, snap)
        mgr.unregister_shuffle(921)
        ck_of(side).restore_shuffles(mgr, snap)
        assert mgr.node.registry.get(921).num_present == 1
        mgr.unregister_shuffle(921)


def test_snapshot_keys_only_shuffle(factories, tmp_path):
    seen = []
    for side in SIDES:
        rng = np.random.default_rng(0)
        mgr = factories.make(side)
        h = mgr.register_shuffle(922, num_maps=2, num_partitions=4)
        for m in range(2):
            w = mgr.get_writer(h, m)
            w.write(rng.integers(0, 1000, size=16))
            w.commit(h.num_partitions)
        snap = str(tmp_path / side / "snap3")
        ck_of(side).snapshot_shuffles(mgr, snap)
        mgr.unregister_shuffle(922)
        handles = ck_of(side).restore_shuffles(mgr, snap)
        got = _rows(mgr.read(handles[922]), 4)
        assert sum(x.shape[0] for x in got.values()) == 32
        seen.append(got)
        mgr.unregister_shuffle(922)
    _same(*seen)


def test_snapshot_preserves_direct_partitioner(factories, tmp_path):
    """A 'direct' shuffle snapshotted before any writer exists comes back
    'direct'."""
    for side in SIDES:
        mgr = factories.make(side)
        mgr.register_shuffle(924, num_maps=2, num_partitions=4,
                             partitioner="direct")
        snap = str(tmp_path / side / "snap5")
        ck_of(side).snapshot_shuffles(mgr, snap)
        mgr.unregister_shuffle(924)
        handles = ck_of(side).restore_shuffles(mgr, snap)
        assert handles[924].partitioner == "direct"
        assert mgr.node.registry.get(924).partitioner == "direct"
        w = mgr.get_writer(handles[924], 0)
        w.write(np.array([0, 1, 3, 3], np.int64))
        w.commit(4)
        mgr.get_writer(handles[924], 1).commit(4)
        assert mgr.read(handles[924]).partition(3)[0].tolist() == [3, 3]
        mgr.unregister_shuffle(924)


def test_restore_version_guard(factories, tmp_path):
    texts = []
    for side in SIDES:
        rng = np.random.default_rng(0)
        mgr = factories.make(side)
        h = mgr.register_shuffle(923, num_maps=1, num_partitions=2)
        w = mgr.get_writer(h, 0)
        w.write(rng.integers(0, 10, size=4))
        w.commit(2)
        snap = str(tmp_path / side / "snap4")
        ck_of(side).snapshot_shuffles(mgr, snap)
        mgr.unregister_shuffle(923)
        path = os.path.join(snap, "shuffle_923.npz")
        data = dict(np.load(path))
        data["version"] = np.int64(99)
        np.savez_compressed(path, **data)
        with pytest.raises(RuntimeError, match="version 99") as ei:
            ck_of(side).restore_shuffles(mgr, snap)
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


def test_snapshot_preserves_range_bounds(factories, tmp_path):
    """A range-partitioned shuffle restores with its split points, on a
    second manager, and reads back globally ordered."""
    seen = []
    bounds = np.array([-100, 0, 100], dtype=np.int64)
    for side in SIDES:
        rng = np.random.default_rng(0)
        m1 = factories.make(side)
        h = m1.register_shuffle(77, 2, 4, partitioner="range",
                                bounds=bounds)
        allk = []
        for mid in range(2):
            w = m1.get_writer(h, mid)
            k = rng.integers(-500, 500, size=300).astype(np.int64)
            w.write(k)
            w.commit(4)
            allk.extend(k.tolist())
        snapdir = str(tmp_path / side / "snap")
        assert ck_of(side).snapshot_shuffles(m1, snapdir) == 1
        m2 = factories.make(side)
        h2 = ck_of(side).restore_shuffles(m2, snapdir)[77]
        assert h2.partitioner == "range"
        assert tuple(h2.bounds) == tuple(bounds.tolist())
        res = m2.read(h2, ordered=True)
        cat = []
        for r, (ks, _) in res.partitions():
            cat.extend(ks.tolist())
        assert cat == sorted(allk)
        seen.append(cat)
    assert seen[0] == seen[1]


def test_restore_failure_unregisters_and_carries_handles(factories,
                                                         tmp_path):
    """A snapshot that fails after registration does not stay registered,
    and the shuffles that did restore ride on the error's ``.handles``."""
    texts = []
    for side in SIDES:
        rng = np.random.default_rng(0)
        mgr = factories.make(side)
        for sid in (930, 931):
            h = mgr.register_shuffle(sid, 1, 2)
            w = mgr.get_writer(h, 0)
            w.write(rng.integers(0, 10, size=4).astype(np.int64))
            w.commit(2)
        snap = str(tmp_path / side / "snap_partial")
        assert ck_of(side).snapshot_shuffles(mgr, snap) == 2
        mgr.unregister_shuffle(930)
        mgr.unregister_shuffle(931)
        path = os.path.join(snap, "shuffle_931.npz")
        data = dict(np.load(path))
        data["keys_0"] = data["keys_0"].reshape(2, 2)
        np.savez_compressed(path, **data)
        with pytest.raises(RuntimeError, match="1 failed") as ei:
            ck_of(side).restore_shuffles(mgr, snap)
        assert sorted(ei.value.handles) == [930]
        assert mgr.read(ei.value.handles[930]).partition(0)[0].shape[0] >= 0
        data["keys_0"] = data["keys_0"].reshape(-1)
        np.savez_compressed(path, **data)
        os.unlink(os.path.join(snap, "shuffle_930.npz"))
        handles = ck_of(side).restore_shuffles(mgr, snap)
        assert sorted(handles) == [931]
        texts.append(str(ei.value).split(" (")[0])
        mgr.unregister_shuffle(930)
        mgr.unregister_shuffle(931)
    assert texts[0] == texts[1]


# -- a snapshot crossing between the packages --------------------------------
def _write_mixed(mgr, rng):
    """Three shuffles: hash with float values (one map uncommitted), range
    keys-only, direct with int values."""
    h = mgr.register_shuffle(950, 3, 8)
    for m in range(3):
        w = mgr.get_writer(h, m)
        w.write(rng.integers(-(1 << 40), 1 << 40, size=50 + m),
                rng.standard_normal((50 + m, 3)).astype(np.float32))
        if m != 2:
            w.commit(8)
    h = mgr.register_shuffle(951, 2, 4, partitioner="range",
                             bounds=np.array([-50, 0, 50], np.int64))
    for m in range(2):
        w = mgr.get_writer(h, m)
        w.write(rng.integers(-99, 99, size=70).astype(np.int64))
        w.commit(4)
    h = mgr.register_shuffle(952, 2, 4, partitioner="direct")
    for m in range(2):
        w = mgr.get_writer(h, m)
        w.write(rng.integers(0, 4, size=30).astype(np.int64),
                rng.integers(0, 9, size=(30, 2)).astype(np.int32))
        w.commit(4)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_crosses_packages(factories, tmp_path, writer, reader):
    """A snapshot written by one package restores in the other: the same
    registrations, the same committed maps, equal partitions."""
    src = factories.make(writer)
    _write_mixed(src, np.random.default_rng(11))
    snap = str(tmp_path / "cross")
    assert ck_of(writer).snapshot_shuffles(src, snap) == 3
    # the writer's own restore is the reference reading
    want = {}
    for sid in (950, 951, 952):
        src.unregister_shuffle(sid)
    hs = ck_of(writer).restore_shuffles(src, snap)
    src.get_writer(hs[950], 2).commit(8)
    for sid, R in ((950, 8), (951, 4), (952, 4)):
        want[sid] = _rows(src.read(hs[sid]), R)
        src.unregister_shuffle(sid)
    dst = factories.make(reader)
    handles = ck_of(reader).restore_shuffles(dst, snap)
    assert sorted(handles) == [950, 951, 952]
    assert handles[951].partitioner == "range"
    assert tuple(handles[951].bounds) == (-50, 0, 50)
    assert handles[952].partitioner == "direct"
    assert dst.node.registry.get(950).num_present == 2
    dst.get_writer(handles[950], 2).commit(8)
    for sid, R in ((950, 8), (951, 4), (952, 4)):
        _same(_rows(dst.read(handles[sid]), R), want[sid])
        dst.unregister_shuffle(sid)
