"""Port parity for the two-tier topology plane (``shuffle/topology.py``,
``shuffle/hierarchical.py``): the PyTorch port on the CPU against the JAX
package on the 8 virtual CPU devices, as a ``(dcn, shuffle)`` mesh of 2 x
4 (``tests/test_hierarchical.py``'s ``mesh2x4``) and of 4 x 2, on the
same seeded packed rows and map outputs.

Tolerances, stated once:

* exact: topology descriptors, the conf seam and its errors, tier cross
  rows and tier layouts, per-partition key multisets, int32 combine sums
  (ring sums), overflow verdicts and retry counts, the per-tier byte
  accounting, and on the int8 wire the delivered bytes when both
  packages round with the same uniforms (``a2a.sortImpl=argsort`` on
  both sides, so rows meet the same uniforms in the same places);
* float32 combine sums: the JAX package takes them as float32 prefix
  differences (``ops/aggregate``), which lose up to ``2 k 2**-24`` times
  the prefix's absolute sum for a prefix of k rows, once per combine (map
  side, relay, receive side); the port rounds float64 sums once per
  combine. Both are held to ``F32_COMBINES * 2 * N * 2**-24 * sum|v|``
  over the N input rows;
* ordered reads: multisets and non-decreasing keys (the sort is
  unstable)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.parallel.mesh import make_shuffle_mesh
from sparkucx_tpu.shuffle import alltoall as jat
from sparkucx_tpu.shuffle import topology as jtopo
from sparkucx_tpu.shuffle.hierarchical import \
    read_shuffle_hierarchical as jread_hier
from sparkucx_tpu.shuffle.plan import ShufflePlan as JPlan
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.parallel.mesh import SliceGrid, make_shuffle_grid
from sparkucx_tpu_torch.runtime.node import Node
from sparkucx_tpu_torch.shuffle import alltoall as tat
from sparkucx_tpu_torch.shuffle import manager as tmanager
from sparkucx_tpu_torch.shuffle import plan as tplan
from sparkucx_tpu_torch.shuffle import topology as ttopo
from sparkucx_tpu_torch.shuffle.hierarchical import read_shuffle_hierarchical
from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
from sparkucx_tpu_torch.shuffle.reader import KEY_WORDS, pack_rows
from sparkucx_tpu_torch.shuffle.writer import hash32_np
from sparkucx_tpu_torch.utils.metrics import (C_SINK_FALLBACK, C_TIER_BYTES,
                                              labeled)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
P = 8
F32_COMBINES = 3
SLICES = "spark.shuffle.tpu.mesh.numSlices"
TOPO = "spark.shuffle.tpu.a2a.topology"


def _jmesh(S: int, D: int) -> Mesh:
    return Mesh(np.array(jax.devices()).reshape(S, D), ("dcn", "shuffle"))


def _topos(S: int, D: int):
    return (jtopo.TopologyDescriptor("hier", "shuffle", "dcn", S, D),
            ttopo.TopologyDescriptor("hier", "shuffle", "dcn", S, D))


def _pid(keys, R):
    return (hash32_np(np.asarray(keys)) % np.uint32(R)).astype(np.int64)


def _parts(res, R):
    return [res.partition(r) for r in range(R)]


def _f32_tol(values, n_rows: int) -> float:
    return F32_COMBINES * 2.0 * n_rows * 2.0 ** -24 \
        * float(np.abs(values.astype(np.float64)).sum())


# -- conf seam, grid, descriptor ---------------------------------------------
def test_topology_conf_seam_matches_reference():
    assert tat.ALLOWED_TOPOLOGIES == jat.ALLOWED_TOPOLOGIES
    assert tat.validate_topology("hier") == "hier"
    with pytest.raises(ValueError) as got:
        tat.validate_topology("nope")
    with pytest.raises(ValueError) as want:
        jat.validate_topology("nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="a2a.topology"):
        ShuffleConf({TOPO: "bogus"}, use_env=False)
    c = ShuffleConf(use_env=False)
    j = TpuShuffleConf({}, use_env=False)
    assert (c.a2a_topology, c.num_slices) == (j.a2a_topology, j.num_slices)


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_grid_lays_shards_out_as_the_mesh(slices):
    """The node's grid has the JAX mesh's shape and axis names, and keeps
    them on the node."""
    conf = {SLICES: str(slices)}
    grid = make_shuffle_grid(P, ShuffleConf(conf, use_env=False))
    mesh = make_shuffle_mesh(jax.devices(), TpuShuffleConf(conf,
                                                           use_env=False))
    assert grid.shape == tuple(mesh.devices.shape)
    assert grid.axis_names == tuple(mesh.axis_names)
    node = Node(ShuffleConf(conf, use_env=False), device="cpu")
    assert node.grid == grid


def test_grid_refuses_slices_that_do_not_divide():
    conf = {SLICES: "3"}
    with pytest.raises(ValueError, match="do not divide into 3 slices"):
        make_shuffle_grid(P, ShuffleConf(conf, use_env=False))
    with pytest.raises(ValueError, match="do not divide into 3 slices"):
        make_shuffle_mesh(jax.devices(), TpuShuffleConf(conf, use_env=False))
    with pytest.raises(ValueError, match="do not divide into 3 slices"):
        connect(conf, device="cpu", use_env=False)


@pytest.mark.parametrize("slices,extra", [
    (2, {}), (4, {}), (8, {}), (1, {}),
    (2, {TOPO: "flat"}), (2, {TOPO: "hier"}), (4, {TOPO: "auto"}),
    (4, {TOPO: "flat"}), (8, {TOPO: "hier"})])
def test_resolve_topology_matches_reference(slices, extra):
    conf = {SLICES: str(slices), **extra}
    tc = ShuffleConf(conf, use_env=False)
    jc = TpuShuffleConf(conf, use_env=False)
    got = ttopo.resolve_topology(make_shuffle_grid(P, tc), tc)
    want = jtopo.resolve_topology(make_shuffle_mesh(jax.devices(), jc), jc)
    assert got.describe() == want.describe()
    assert got.tiers == want.tiers and got.hierarchical == want.hierarchical


def test_explicit_hier_on_one_slice_is_a_conf_error():
    conf = {TOPO: "hier"}
    tc = ShuffleConf(conf, use_env=False)
    jc = TpuShuffleConf(conf, use_env=False)
    with pytest.raises(ValueError, match="a2a.topology=hier") as got:
        ttopo.resolve_topology(make_shuffle_grid(P, tc), tc)
    with pytest.raises(ValueError, match="a2a.topology=hier"):
        jtopo.resolve_topology(make_shuffle_mesh(jax.devices(), jc), jc)
    assert "{'shuffle': 8}" in str(got.value)
    with pytest.raises(ValueError, match="a2a.topology=hier"):
        connect(conf, device="cpu", use_env=False)


# -- per-tier accounting -----------------------------------------------------
@pytest.mark.parametrize("S,D", [(2, 4), (4, 2)])
def test_tier_cross_rows_match_reference(S, D):
    m = np.random.default_rng(S).integers(0, 1000, (P, P))
    jt, tt = _topos(S, D)
    assert ttopo.tier_cross_rows(m, tt) == jtopo.tier_cross_rows(m, jt)


@pytest.mark.parametrize("impl", ["dense", "gather"])
@pytest.mark.parametrize("wire", ["raw", "int8"])
@pytest.mark.parametrize("S,D", [(2, 4), (4, 2)])
def test_tier_layouts_match_reference(impl, wire, S, D):
    rng = np.random.default_rng(hash((impl, wire, S)) % 1000)
    kw = dict(wire=wire, wire_words=8 if wire == "int8" else 0)
    tplan_ = ShufflePlan(P, 16, 64, 128, impl, **kw)
    jplan = JPlan(P, 16, 64, 128, impl, **kw)
    rows = rng.integers(0, 64, P)
    m = rng.integers(0, 50, (P, P))
    jt, tt = _topos(S, D)
    for args in ({}, {"dev_matrix": m}, {"relay_cap": 256},
                 {"dev_matrix": m, "relay_cap": 512}):
        got = ttopo.tier_layouts(tplan_, tt, rows, KEY_WORDS + 8, **args)
        want = jtopo.tier_layouts(jplan, jt, rows, KEY_WORDS + 8, **args)
        if impl == "dense" and "relay_cap" in args:
            # the one difference, on purpose: the JAX package sizes stage
            # 1's dense wire by cap_out, the port by the relay capacity
            # stage 1 pads to
            ici = got[0]
            assert ici["wire_rows"] == S * D * D * args["relay_cap"]
            assert ici["wire_bytes"] == ici["wire_rows"] * (
                want[0]["wire_bytes"] // want[0]["wire_rows"])
            assert ici["pad_ratio"] == round(
                ici["wire_bytes"] / ici["payload_bytes"], 6)
            got[0] = {**ici, **{k: want[0][k] for k in
                                ("wire_rows", "wire_bytes", "pad_ratio")}}
        assert got == want


def test_settle_tier_walls_matches_reference():
    tt, jt = _topos(2, 4)[1], _topos(2, 4)[0]
    plan = dict(wire="int8", wire_words=6)
    got = ttopo.tier_layouts(ShufflePlan(P, 8, 32, 64, "dense", **plan), tt,
                             np.full(P, 30), 8)
    want = jtopo.tier_layouts(JPlan(P, 8, 32, 64, "dense", **plan), jt,
                              np.full(P, 30), 8)
    walls = {"ici": 2.5, "dcn": 7.25}
    ttopo.settle_tier_walls(got, walls)
    jtopo.settle_tier_walls(want, walls, 8)
    assert got == want and got[1]["ms"] == 7.25 and got[0]["bw_gbps"] > 0


# -- the stage-level reads against the reference ------------------------------
def _rows(seed, R, mode, rows=48, vw=2):
    """[P, rows, 2 + vw] packed rows: hash keys (int32 or float32 values),
    or partition ids as keys for the direct partitioner."""
    rng = np.random.default_rng(seed)
    width = KEY_WORDS + vw
    keys, vals = [], []
    out = np.zeros((P, rows, width), np.int32)
    for p in range(P):
        if mode == "direct":
            k = rng.integers(0, R, rows).astype(np.int64)
        else:
            k = rng.integers(0, 40 if mode.startswith("combine") else 1 << 20,
                             rows).astype(np.int64)
        if mode == "combine_i32":
            v = rng.integers(-(1 << 31), 1 << 31, (rows, vw)).astype(np.int32)
        else:
            v = (rng.random((rows, vw), dtype=np.float32) + 0.5)
        out[p] = pack_rows(k, v, width)
        keys.append(k)
        vals.append(v)
    return out, np.concatenate(keys), np.concatenate(vals)


def _plan_kw(mode, vw=2):
    if mode == "ordered":
        return {"ordered": True}
    if mode == "direct":
        return {"partitioner": "direct"}
    if mode.startswith("combine"):
        dt = np.dtype(np.int32 if mode == "combine_i32" else np.float32)
        return {"combine": "sum", "combine_words": vw,
                "combine_dtype": dt.str}
    return {}


def _check_against(got, want, keys, vals, R, mode):
    n = 0
    pid = keys if mode == "direct" else _pid(keys, R)
    for r in range(R):
        (gk, gv), (wk, wv) = got[r], want[r]
        sel = pid == r
        if mode.startswith("combine"):
            np.testing.assert_array_equal(gk, np.unique(keys[sel]))
            np.testing.assert_array_equal(wk, gk)
            if mode == "combine_i32":
                np.testing.assert_array_equal(gv, wv)
                want_sum = np.array([vals[sel][keys[sel] == k].astype(
                    np.int64).sum(axis=0) for k in gk]).reshape(gv.shape)
                np.testing.assert_array_equal(
                    gv, want_sum.astype(np.int64).astype(np.int32))
            else:
                np.testing.assert_allclose(gv, wv, rtol=0,
                                           atol=_f32_tol(vals, len(keys)))
            n += int(sel.sum())
            continue
        np.testing.assert_array_equal(np.sort(gk), np.sort(keys[sel]))
        np.testing.assert_array_equal(np.sort(wk), np.sort(gk))
        if mode == "ordered":
            assert (np.diff(gk) >= 0).all() and (np.diff(wk) >= 0).all()
        if gv is not None:
            # (key, value) pairs as multisets
            g = sorted(zip(gk.tolist(), map(bytes, gv.view(np.uint8))))
            w = sorted(zip(wk.tolist(), map(bytes, wv.view(np.uint8))))
            assert g == w
        n += gk.shape[0]
    assert n == keys.shape[0]


@pytest.mark.parametrize("S,D", [(2, 4), (4, 2)])
@pytest.mark.parametrize("mode", ["plain", "ordered", "combine_i32",
                                  "combine_f32", "direct"])
def test_read_shuffle_tiered_matches_reference(S, D, mode):
    R = 13 if mode != "direct" else 16
    rows, keys, vals = _rows(7 * S + len(mode), R, mode)
    kw = _plan_kw(mode)
    tp = ShufflePlan(P, R, 48, 96, "dense", **kw)
    jp = JPlan(P, R, 48, 96, "dense", **kw)
    jt, tt = _topos(S, D)
    nv = np.full(P, 48)
    vt, vd = (2,), vals.dtype
    pend = ttopo.submit_shuffle_tiered(tt, tp, rows, nv, vt, vd, CPU)
    assert not pend.done()                     # stage 2 not dispatched yet
    got = pend.result()
    assert pend.done() and pend.tier_walls["ici"] > 0 \
        and pend.tier_walls["dcn"] > 0
    want = jtopo.read_shuffle_tiered(_jmesh(S, D), jt, jp, rows, nv, vt, vd)
    _check_against(_parts(got, R), _parts(want, R), keys, vals, R, mode)
    # the fused form: both stages in one step, same partitions
    fused = read_shuffle_hierarchical(SliceGrid((S, D), ("dcn", "shuffle")),
                                      "dcn", "shuffle", tp, rows, nv, vt, vd,
                                      CPU)
    _check_against(_parts(fused, R), _parts(want, R), keys, vals, R, mode)


def test_fused_hierarchical_matches_reference():
    """The fused JAX step against the port's fused step (2 x 4, values)."""
    R = 8
    rows, keys, vals = _rows(31, R, "plain", rows=32, vw=1)
    tp = ShufflePlan(P, R, 32, 128, "dense")
    jp = JPlan(P, R, 32, 128, "dense")
    nv = np.full(P, 32)
    got = read_shuffle_hierarchical(SliceGrid((2, 4), ("dcn", "shuffle")),
                                    "dcn", "shuffle", tp, rows, nv, (1,),
                                    np.float32, CPU)
    want = jread_hier(_jmesh(2, 4), "dcn", "shuffle", jp, rows, nv, (1,),
                      np.float32)
    _check_against(_parts(got, R), _parts(want, R), keys, vals, R, "plain")
    with pytest.raises(ValueError, match="axes"):
        read_shuffle_hierarchical(SliceGrid((2, 4), ("shuffle", "dcn")),
                                  "dcn", "shuffle", tp, rows, nv, (1,),
                                  np.float32, CPU)


def _jax_uniforms(shape, seeds, device):
    """The uniforms the JAX package's int8 quantize draws for each
    shard's seed (``jax.random.uniform(PRNGKey(seed), [rows, w])``)."""
    return torch.stack([torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(int(s)), tuple(shape[1:]), jax.numpy.float32)))
        for s in seeds]).to(device)


@pytest.mark.parametrize("S,D", [(2, 4), (4, 2)])
@pytest.mark.parametrize("mode", ["plain", "ordered"])
def test_int8_tiered_bytes_equal_given_same_uniforms(S, D, mode,
                                                     monkeypatch):
    """Both hops quantize; fed the JAX package's uniforms, the port
    delivers the same bytes for every key (unique keys, stable sorts on
    both sides, so every row meets the same uniforms on both hops)."""
    R, VW, n = 12, 6, 40
    rng = np.random.default_rng(11 + S + len(mode))
    keys = rng.permutation(1 << 20)[:P * n].astype(np.int64)
    vals = (rng.standard_normal((P * n, VW))
            * np.exp(rng.normal(0, 2, (P * n, 1)))).astype(np.float32)
    rows = np.stack([pack_rows(keys[p * n:(p + 1) * n],
                               vals[p * n:(p + 1) * n], KEY_WORDS + VW)
                     for p in range(P)])
    kw = dict(_plan_kw(mode), wire="int8", wire_words=VW,
              sort_impl="argsort")
    tp = ShufflePlan(P, R, n, 96, "dense", **kw)
    jp = JPlan(P, R, n, 96, "dense", **kw)
    jt, tt = _topos(S, D)
    nv = np.full(P, n)
    calls = []

    def spy(shape, seeds, device):
        calls.append(list(seeds))
        return _jax_uniforms(shape, seeds, device)

    monkeypatch.setattr(ttopo, "wire_uniforms", spy)
    got = ttopo.read_shuffle_tiered(tt, tp, rows, nv, (VW,), np.float32, CPU)
    want = jtopo.read_shuffle_tiered(_jmesh(S, D), jt, jp, rows, nv, (VW,),
                                     np.float32)
    # stage 1 seeds from (0 + 0) * 2 + 0, stage 2 from (0 + 0) * 2 + 1
    assert calls == [list(range(P)), [P + p for p in range(P)]]
    for r in range(R):
        (gk, gv), (wk, wv) = got.partition(r), want.partition(r)
        if mode == "plain":
            og, ow = np.argsort(gk), np.argsort(wk)
            gk, gv, wk, wv = gk[og], gv[og], wk[ow], wv[ow]
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    assert sum(got.partition(r)[0].size for r in range(R)) == P * n


# -- per-tier overflow ---------------------------------------------------------
def _one_key_rows(n, key):
    rows = np.zeros((P, n, KEY_WORDS), np.int32)
    for p in range(P):
        rows[p] = pack_rows(np.full(n, key, np.int64), None, KEY_WORDS)
    return rows


@pytest.mark.parametrize("case", ["stage1", "stage2_only"])
def test_tier_overflow_retries_match_reference(case, monkeypatch):
    """A one-hot key overflows the relay (stage 1) and then the receiver;
    keys bound for shard 0 fit every relay but not the receiver, so only
    stage 2 re-runs — stage 1 dispatches once. Retry counts and
    partitions equal the JAX package's."""
    R, n = 8, 16
    if case == "stage1":
        rows, cap_out = _one_key_rows(n, 12345), 48
        keys = np.full(P * n, 12345, np.int64)
    else:
        # keys whose partition is 0 (shard 0): each slice's rows meet at
        # relay (s, 0), 4n = 64 rows; shard 0 then receives 8n = 128
        pool = np.arange(1, 20000, dtype=np.int64)
        k0 = pool[_pid(pool, R) == 0][:P * n]
        rows = np.zeros((P, n, KEY_WORDS), np.int32)
        for p in range(P):
            rows[p] = pack_rows(k0[p * n:(p + 1) * n], None, KEY_WORDS)
        keys, cap_out = k0, 64
    tp = ShufflePlan(P, R, n, cap_out, "dense")
    jp = JPlan(P, R, n, cap_out, "dense")
    jt, tt = _topos(2, 4)
    nv = np.full(P, n)
    stage1 = []
    real = ttopo._stage1_body
    monkeypatch.setattr(ttopo, "_stage1_body",
                        lambda *a: stage1.append(a[2]) or real(*a))
    tpend = ttopo.submit_shuffle_tiered(tt, tp, rows, nv, None, None, CPU)
    got = tpend.result()
    jpend = jtopo.submit_shuffle_tiered(_jmesh(2, 4), jt, jp, rows, nv, None,
                                        None)
    want = jpend.result()
    assert (tpend._retries1, tpend._retries2, tpend._attempt,
            tpend._relay_cap, tpend._plan.cap_out) == \
        (jpend._retries1, jpend._retries2, jpend._attempt,
         jpend._relay_cap, jpend._plan.cap_out)
    if case == "stage1":
        assert tpend._retries1 >= 1 and tpend._retries2 >= 1
        assert len(stage1) == tpend._retries1 + 1
    else:
        assert (tpend._retries1, tpend._retries2) == (0, 1)
        assert stage1 == [cap_out]              # stage 1 dispatched once
    _check_against(_parts(got, R), _parts(want, R), keys, None, R, "plain")
    assert got.cap_out_used == want.cap_out_used


def test_tier_overflow_past_max_retries_names_the_stage():
    rows = _one_key_rows(16, 7)
    tt = _topos(2, 4)[1]
    plan = ShufflePlan(P, 8, 16, 8, "dense", max_retries=1)
    with pytest.raises(RuntimeError, match="stage-1 \\(ICI\\)"):
        ttopo.read_shuffle_tiered(tt, plan, rows, np.full(P, 16), None, None,
                                  CPU)


# -- the manager path ----------------------------------------------------------
def _maps(seed, M=4, rows=120, vw=1, key_space=1 << 18, ints=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(M):
        k = rng.integers(0, key_space, rows).astype(np.int64)
        v = rng.integers(-1000, 1000, (rows, vw)).astype(np.int32) if ints \
            else (rng.random((rows, vw), dtype=np.float32) + 0.5)
        out.append((k, v))
    return out


def _write(mgr, sid, maps, R):
    h = mgr.register_shuffle(sid, len(maps), R)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        w.write(k, v)
        w.commit(R)
    return h


def _port(conf):
    return connect({SLICES: "2", **conf}, device="cpu", use_env=False)


def _spy_tiered(monkeypatch):
    """Record ``(initial cap_out, pending)`` of every tiered read the
    port's manager submits."""
    seen = []
    real = tmanager.submit_shuffle_tiered

    def spy(topo, plan, *a, **kw):
        pend = real(topo, plan, *a, **kw)
        seen.append((plan.cap_out, pend))
        return pend

    monkeypatch.setattr(tmanager, "submit_shuffle_tiered", spy)
    return seen


def _check_wire_vs_reference(rep, jrep, pend):
    """The port's tier wire against the JAX manager's: the DCN hop and
    the payload equal; the ICI hop equal too, except on the dense
    transport after a relay regrow, where the port pads to the relay
    capacity stage 1 used and the JAX package to ``cap_out``; the
    headline the two-hop sum on both."""
    ici, dcn = rep.tiers
    jici, jdcn = jrep.tiers
    assert rep.payload_bytes == jrep.payload_bytes
    assert dcn["wire_bytes"] == jdcn["wire_bytes"]
    scale = pend._relay_cap / pend._plan.cap_out \
        if ici["impl"] == "dense" else 1
    assert ici["wire_bytes"] == jici["wire_bytes"] * scale
    assert rep.wire_bytes == ici["wire_bytes"] + dcn["wire_bytes"]
    assert jrep.wire_bytes == jici["wire_bytes"] + jdcn["wire_bytes"]


def test_manager_hier_read_tiers_and_counters(manager_factory, monkeypatch):
    """The default conf on a 2-slice node runs the tiered path: tier
    entries (ici, then dcn) equal the JAX manager's, except that the ICI
    wire pads to the relay capacity stage 1 used (the JAX package pads
    it to ``cap_out``); the DCN payload is the numpy count of rows that
    change slice, walls above 0, the headline wire the two-hop sum, the
    tier counters, and partitions equal the JAX read's."""
    R, M, rows = 8, 4, 120
    maps = _maps(701)
    seen = _spy_tiered(monkeypatch)
    jm = manager_factory({SLICES: "2"})
    want = _parts(jm.read(_write(jm, 701, maps, R)), R)
    jrep = jm.report(701)
    with _port({}) as svc:
        mgr = svc.manager
        assert mgr.hierarchical and mgr.topology.kind == "hier"
        got = _parts(svc.read(_write(mgr, 701, maps, R)), R)
        rep = svc.report(701)
        counters = {t: mgr.node.metrics.get(labeled(
            C_TIER_BYTES, tier=t, tenant="default")) for t in ("ici", "dcn")}
    keys = np.concatenate([k for k, _ in maps])
    vals = np.concatenate([v for _, v in maps])
    _check_against(got, want, keys, vals, R, "plain")
    assert rep.hierarchical and jrep.hierarchical and rep.completed
    assert rep.impl == jrep.impl == "dense"
    assert [t["tier"] for t in rep.tiers] == ["ici", "dcn"]
    measured = ("ms", "bw_gbps", "effective_bw_gbps")
    ici_wire = ("wire_rows", "wire_bytes", "pad_ratio")
    assert [{k: v for k, v in t.items()
             if k not in measured + (ici_wire if t["tier"] == "ici" else ())}
            for t in rep.tiers] == \
        [{k: v for k, v in t.items()
          if k not in measured + (ici_wire if t["tier"] == "ici" else ())}
         for t in jrep.tiers]
    ici, dcn = rep.tiers
    jici, jdcn = jrep.tiers
    (_, pend), = seen
    assert ici["wire_rows"] == 2 * 4 * 4 * pend._relay_cap
    assert jici["wire_rows"] == 2 * 4 * 4 * pend._plan.cap_out
    pid = _pid(keys, R)
    src = np.concatenate([np.full(rows, m % P) for m in range(M)])
    dst = blocked_partition_map(R, P)[pid]
    assert ici["cross_exact"] and dcn["cross_exact"]
    assert dcn["payload_rows"] == int(((src // 4) != (dst // 4)).sum())
    assert ici["payload_rows"] == int(((src % 4) != (dst % 4)).sum())
    assert ici["ms"] > 0 and dcn["ms"] > 0
    assert rep.wire_bytes == ici["wire_bytes"] + dcn["wire_bytes"]
    assert jrep.wire_bytes == jici["wire_bytes"] + jdcn["wire_bytes"]
    assert rep.payload_bytes == jrep.payload_bytes
    assert counters == {"ici": ici["wire_bytes"], "dcn": dcn["wire_bytes"]}


@pytest.mark.parametrize("mode", ["ordered", "combine"])
def test_manager_hier_modes_match_reference(manager_factory, mode):
    """Ordered and int32 combine reads through both managers on 2
    slices: keys sorted and equal, int32 sums exact."""
    R = 8
    maps = _maps(720 + len(mode), key_space=300, ints=True, vw=2)
    kw = {"combine": "sum"} if mode == "combine" else {"ordered": True}
    jm = manager_factory({SLICES: "2"})
    want = _parts(jm.read(_write(jm, 720, maps, R), **kw), R)
    with _port({}) as svc:
        got = _parts(svc.read(_write(svc.manager, 720, maps, R), **kw), R)
        rep = svc.report(720)
    assert rep.hierarchical and len(rep.tiers) == 2
    assert rep.kernel == "jnp"           # the stages combine in torch ops
    keys = np.concatenate([k for k, _ in maps])
    vals = np.concatenate([v for _, v in maps])
    _check_against(got, want, keys, vals, R,
                   "combine_i32" if mode == "combine" else "ordered")


def test_manager_int8_bytes_equal_given_same_uniforms(manager_factory,
                                                      monkeypatch):
    """The int8 wire on both hops through both managers: with the JAX
    package's uniforms and stable sorts, the same bytes land in every
    partition; the report's int8 accounting is the JAX one."""
    R = 8
    conf = {SLICES: "2", "spark.shuffle.tpu.a2a.wire": "int8",
            "spark.shuffle.tpu.a2a.sortImpl": "argsort"}
    maps = _maps(730, vw=5)
    jm = manager_factory(conf)
    want = _parts(jm.read(_write(jm, 730, maps, R)), R)
    jrep = jm.report(730)
    monkeypatch.setattr(ttopo, "wire_uniforms", _jax_uniforms)
    seen = _spy_tiered(monkeypatch)
    with connect(conf, device="cpu", use_env=False) as svc:
        got = _parts(svc.read(_write(svc.manager, 730, maps, R)), R)
        rep = svc.report(730)
    assert rep._seq == jrep._seq                 # the same noise base
    assert rep.wire == jrep.wire == "int8"
    _check_wire_vs_reference(rep, jrep, seen[0][1])
    for r in range(R):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        np.testing.assert_array_equal(got[r][1].view(np.int32),
                                      want[r][1].view(np.int32))


def test_manager_hier_regrow_restamps_both_hops():
    """A skewed hier read regrows; the report's tiers are re-derived
    under the final capacities and its retries counted."""
    R = 8
    pool = np.arange(1, 40000, dtype=np.int64)
    hot = pool[_pid(pool, R) == 0][:1200]
    maps = [(hot[m * 300:(m + 1) * 300],
             np.ones((300, 1), np.float32)) for m in range(4)]
    with _port({"spark.shuffle.tpu.a2a.capacityFactor": "1.0"}) as svc:
        res = svc.read(_write(svc.manager, 740, maps, R))
        rep = svc.report(740)
    assert rep.retries >= 1 and rep.completed
    k, _ = res.partition(0)
    np.testing.assert_array_equal(np.sort(k), np.sort(hot))
    assert rep.wire_bytes == sum(t["wire_bytes"] for t in rep.tiers)
    assert rep.tiers[0]["wire_rows"] >= 2 * 16 * 300


def test_manager_hier_restamp_after_stage1_regrow(monkeypatch):
    """One hot key overflows the relays: stage 1 regrows the relay
    capacity, and the restamped ICI entry pads to that capacity (stage 1's
    output), the DCN entry to the final ``cap_out``; the headline wire is
    their sum."""
    R, S, D = 8, 2, 4
    maps = [(np.full(300, 12345, np.int64), np.ones((300, 1), np.float32))
            for _ in range(4)]
    seen = _spy_tiered(monkeypatch)
    with _port({"spark.shuffle.tpu.a2a.capacityFactor": "1.0"}) as svc:
        res = svc.read(_write(svc.manager, 745, maps, R))
        rep = svc.report(745)
    (cap0, pend), = seen
    assert pend._retries1 >= 1 and rep.completed
    assert rep.retries == pend._attempt
    assert pend._relay_cap == cap0 * 2 ** pend._retries1
    ici, dcn = rep.tiers
    assert ici["wire_rows"] == S * D * D * pend._relay_cap
    assert dcn["wire_rows"] == D * S * S * pend._plan.cap_out
    assert rep.wire_bytes == ici["wire_bytes"] + dcn["wire_bytes"]
    k, _ = res.partition(int(_pid([12345], R)[0]))
    assert len(k) == 1200 and (k == 12345).all()


def test_manager_hier_device_sink_single_shot():
    """A single-shot hier combine read keeps the device sink: nothing
    pulled to the host before ``host_view()``, whose sums are exact."""
    R, M, rows = 8, 4, 100
    maps = [((np.arange(m * rows, (m + 1) * rows) % 64).astype(np.int64),
             np.ones((rows, 1), np.float32)) for m in range(M)]
    with _port({}) as svc:
        res = svc.read(_write(svc.manager, 750, maps, R), combine="sum",
                       sink="device")
        rep = svc.report(750)
        assert rep.sink == "device" and rep.hierarchical and rep.tiers
        assert rep.d2h_bytes == 0
        assert int(res.device_totals().sum()) == 64
        hv = res.host_view()
        got = {}
        for r in range(R):
            k, v = hv.partition(r)
            got.update({int(a): float(b) for a, b in zip(k, v[:, 0])})
    counts = np.bincount(np.concatenate([k for k, _ in maps]), minlength=64)
    assert got == {k: float(counts[k]) for k in range(64)}


def test_manager_hier_waved_timeline_and_demotion():
    """Waved hier reads ride the tiered path per wave: ``ici_ms`` and
    ``dcn_ms`` on every timeline entry, tier walls summed onto the
    tiers; a device-sink ask demotes to the host and is counted."""
    R = 8
    maps = _maps(760, rows=200)
    with _port({"spark.shuffle.tpu.a2a.waveRows": "64"}) as svc:
        m = svc.manager.node.metrics
        res = svc.read(_write(svc.manager, 760, maps, R), sink="device")
        rep = svc.report(760)
        fallback = (m.get(C_SINK_FALLBACK), m.get(labeled(
            C_SINK_FALLBACK, mode="plain", reason="hierarchical_waved")))
    assert rep.waves > 1 and rep.hierarchical and rep.sink == "host"
    assert fallback == (1.0, 1.0)
    assert all(e["ici_ms"] > 0 and e["dcn_ms"] > 0
               for e in rep.wave_timeline)
    for i, t in enumerate(rep.tiers):
        assert not t["cross_exact"]
        assert t["ms"] == pytest.approx(sum(
            e[("ici_ms", "dcn_ms")[i]] for e in rep.wave_timeline), abs=0.01)
    assert rep.wire_bytes == sum(t["wire_bytes"] for t in rep.tiers)
    keys = np.concatenate([k for k, _ in maps])
    pid = _pid(keys, R)
    for r in range(R):
        k, _ = res.partition(r)
        np.testing.assert_array_equal(np.sort(k), np.sort(keys[pid == r]))


def test_manager_hier_admission_defers_and_completes():
    """Tiered reads ride the global ``a2a.maxBytesInFlight`` cap: the
    second submit defers until the first settles; both complete."""
    R = 8
    with _port({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1"}) as svc:
        mgr = svc.manager
        maps1, maps2 = _maps(770), _maps(771)
        p1 = mgr.submit(_write(mgr, 770, maps1, R))
        p2 = mgr.submit(_write(mgr, 771, maps2, R))
        assert isinstance(p2, ttopo.PendingTieredShuffle)
        assert not p2.done()
        r1, r2 = p1.result(), p2.result()
        assert svc.report(771).completed and svc.report(771).tiers
        for maps, res in ((maps1, r1), (maps2, r2)):
            keys = np.concatenate([k for k, _ in maps])
            pid = _pid(keys, R)
            for r in range(R):
                k, _ = res.partition(r)
                np.testing.assert_array_equal(np.sort(k),
                                              np.sort(keys[pid == r]))


# -- impl resolution under hier ------------------------------------------------
# tests/test_torch_impl_resolution.py's table, each case on a flat
# topology (as it was) and on a hierarchical one: under hier, auto keeps
# the dense exchange on the card too
_TABLE = [
    ("auto", CUDA, 8, False, "host", "pallas", "dense"),
    ("auto", CUDA, 8, True, "host", "dense", "dense"),
    ("auto", CUDA, 8, False, "device", "dense", "dense"),
    ("auto", CUDA, 8, True, "device", "dense", "dense"),
    ("auto", CUDA, 1, False, "host", "local", "local"),
    ("auto", CUDA, 1, True, "device", "local", "local"),
    ("auto", CPU, 8, False, "host", "dense", "dense"),
    ("auto", CPU, 1, False, "host", "local", "local"),
    ("pallas", CUDA, 8, True, "device", "pallas", "pallas"),
    ("pallas", CPU, 1, False, "host", "pallas", "pallas"),
    ("dense", CUDA, 8, False, "host", "dense", "dense"),
    ("gather", CUDA, 8, True, "host", "gather", "gather"),
]


@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("impl,device,shards,waved,sink,flat,tiered",
                         _TABLE)
def test_resolution_table_under_hier(impl, device, shards, waved, sink,
                                     flat, tiered, hier):
    assert backend.resolve_a2a_impl(
        impl, device, shards, waved=waved, sink=sink,
        hierarchical=hier) == (tiered if hier else flat)


@pytest.fixture
def card_view(monkeypatch):
    """The plan's resolver sees a CUDA device; the read runs on the CPU."""
    real = tplan.resolve_a2a_impl

    def on_card(impl, device, num_shards, **kw):
        return real(impl, CUDA, num_shards, **kw)

    monkeypatch.setattr(tplan, "resolve_a2a_impl", on_card)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_card_resolution_keeps_or_drops_the_hierarchy(manager_factory,
                                                      card_view, impl):
    """On the card ``auto`` keeps the two tiers (dense), so no hier read
    reaches the segment move; an explicit ``pallas`` runs flat over all
    shards with ``report.hierarchical`` False, as the JAX package's
    manager does. Partitions equal the JAX read's."""
    R = 8
    conf = {SLICES: "2", "spark.shuffle.tpu.a2a.impl": impl}
    maps = _maps(780)
    jm = manager_factory(conf)
    want = _parts(jm.read(_write(jm, 780, maps, R)), R)
    jrep = jm.report(780)
    with connect(conf, device="cpu", use_env=False) as svc:
        got = _parts(svc.read(_write(svc.manager, 780, maps, R)), R)
        rep = svc.report(780)
    keys = np.concatenate([k for k, _ in maps])
    vals = np.concatenate([v for _, v in maps])
    _check_against(got, want, keys, vals, R, "plain")
    if impl == "auto":
        assert rep.impl == "dense" and rep.hierarchical and rep.tiers
    else:
        assert rep.impl == jrep.impl == "pallas"
        assert not rep.hierarchical and not jrep.hierarchical
        assert not rep.tiers and not jrep.tiers


# -- the reference's sweep cells ----------------------------------------------
# tests/test_hierarchical.py's _SWEEP_CELLS (impl, wire, mode, skew), all of
# them here against the numpy oracle; three also against the JAX manager
_SWEEP_CELLS = [
    ("dense", "raw", "plain", "zipf", True),
    ("dense", "int8", "combine", "onehot", False),
    ("gather", "raw", "ordered", "uniform", False),
    ("dense", "raw", "combine", "uniform", True),
    ("dense", "int8", "plain", "uniform", False),
    ("dense", "raw", "ordered", "onehot", False),
    ("gather", "int8", "ordered", "zipf", False),
    ("gather", "raw", "plain", "onehot", False),
    ("gather", "int8", "combine", "zipf", False),
    ("dense", "int8", "plain", "zipf", False),
]


def _sweep_keys(rng, skew, n):
    if skew == "uniform":
        return rng.permutation(np.arange(4 * n, dtype=np.int64))[:n]
    if skew == "zipf":
        return (rng.zipf(1.6, size=n) % 512).astype(np.int64)
    return np.full(n, 7, dtype=np.int64)


@pytest.mark.parametrize(
    "impl,wire,mode,skew,vs_jax", _SWEEP_CELLS,
    ids=[f"{i}-{w}-{m}-{s}" for i, w, m, s, _ in _SWEEP_CELLS])
def test_hier_sweep_vs_oracle(manager_factory, monkeypatch, impl, wire, mode,
                              skew, vs_jax):
    """The reference's sweep bound: keys exact every tier, values exact
    on raw and on int8 within two rounding steps per row per hop
    (``tests/test_hierarchical.py``), per-tier accounting with the
    headline wire the two-hop sum."""
    conf = {"spark.shuffle.tpu.a2a.impl": impl,
            "spark.shuffle.tpu.a2a.wire": wire, SLICES: "2"}
    R, M, rows, VW = 8, 4, 96, 4
    rng = np.random.default_rng(880 + len(impl + wire + mode + skew))
    maps = [(_sweep_keys(rng, skew, rows),
             rng.random((rows, VW), dtype=np.float32) + 0.5)
            for _ in range(M)]
    kw = {"combine": "sum"} if mode == "combine" else (
        {"ordered": True} if mode == "ordered" else {})
    seen = _spy_tiered(monkeypatch)
    with connect(conf, device="cpu", use_env=False) as svc:
        res = svc.read(_write(svc.manager, 880, maps, R), **kw)
        rep = svc.report(880)
        got = _parts(res, R)
    assert rep.hierarchical and rep.completed
    assert [t["tier"] for t in rep.tiers] == ["ici", "dcn"]
    assert rep.wire_bytes == sum(t["wire_bytes"] for t in rep.tiers)
    assert rep.wire == wire
    ak = np.concatenate([k for k, _ in maps])
    av = np.concatenate([v for _, v in maps])
    parts = _pid(ak, R)
    total = 0
    for r in range(R):
        k, v = got[r]
        sel = parts == r
        total += k.shape[0]
        if mode == "combine":
            np.testing.assert_array_equal(k, np.unique(ak[sel]))
        else:
            np.testing.assert_array_equal(np.sort(k), np.sort(ak[sel]))
            if mode == "ordered":
                assert (np.diff(k) >= 0).all()
        for kk in np.unique(ak[sel]):
            want = av[sel][ak[sel] == kk].sum(axis=0)
            gotv = v[k == kk].sum(axis=0)
            cnt = int((ak[sel] == kk).sum())
            if wire == "int8":
                vmax = float(np.abs(av[sel][ak[sel] == kk]).max())
                smax = max(vmax * cnt, vmax)
                atol = 2 * (cnt + 2) * (smax / 127.0) + 1e-3
            else:
                atol = 1e-3 * max(cnt, 1)
            np.testing.assert_allclose(gotv, want, atol=atol, rtol=1e-4)
    if mode != "combine":
        assert total == ak.shape[0]
    if not vs_jax:
        return
    jm = manager_factory(conf)
    want_parts = _parts(jm.read(_write(jm, 880, maps, R), **kw), R)
    jrep = jm.report(880)
    _check_wire_vs_reference(rep, jrep, seen[0][1])
    _check_against(got, want_parts, ak, av, R,
                   "combine_f32" if mode == "combine" else mode)


def test_connect_passes_num_slices_through_the_conf():
    with connect({SLICES: "4"}, device="cpu", use_env=False) as svc:
        assert svc.manager.node.grid.shape == (4, 2)
        assert svc.manager.topology.describe() == {
            "kind": "hier", "ici_axis": "shuffle", "dcn_axis": "dcn",
            "num_slices": 4, "per_slice": 2}
    with connect({SLICES: "4", TOPO: "flat"}, device="cpu",
                 use_env=False) as svc:
        assert not svc.manager.hierarchical
    plan = dataclasses.replace(ShufflePlan(P, 8, 8, 8, "pallas"))
    with pytest.raises(ValueError, match="dense-contract"):
        ttopo.PendingTieredShuffle(_topos(2, 4)[1], plan,
                                   np.zeros((P, 8, 2), np.int32),
                                   np.zeros(P), None, None, CPU)
