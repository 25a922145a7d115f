"""``a2a.impl`` resolution and the segment move's device-sink layout in the
PyTorch port, against the JAX package on 8 virtual CPU devices.

``auto`` resolves as the reference's ``ragged_shuffle`` does ('local' for
one shard, else the dense exchange), except that on CUDA a single-shot
host-sink read takes the hand kernel ('pallas'). The table is checked
with ``torch.device("cuda")`` objects, which need no card; the manager
checks run on the CPU with the plan's resolver shown a CUDA device, so
the read takes the path it would take on the card (the segment move's
plain version where it resolves 'pallas').

An explicit ``a2a.impl=pallas`` plain device-sink read hands consumers
each shard's delivered rows as a prefix of its buffer
(``reader.compact_received``): checked row by row, through
``host_view()``, and through both attention consumers against the JAX
package's consumers on its dense device-sink read."""

import numpy as np
import pytest
import torch

from sparkucx_tpu.parallel import ring as jring
from sparkucx_tpu.parallel import ulysses as july
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.ops import attention as tatt
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.parallel import ring as tring
from sparkucx_tpu_torch.parallel import ulysses as tuly
from sparkucx_tpu_torch.shuffle import plan as tplan
from sparkucx_tpu_torch.shuffle.reader import DeviceShuffleReaderResult
from sparkucx_tpu_torch.shuffle.writer import hash32_np
from torch_attention_cases import qkv_rows

N_SHARDS = 8
M = 12
R = 16
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.mark.parametrize("impl,device,shards,waved,sink,want", [
    ("auto", CUDA, 8, False, "host", "pallas"),
    ("auto", CUDA, 8, True, "host", "dense"),
    ("auto", CUDA, 8, False, "device", "dense"),
    ("auto", CUDA, 8, True, "device", "dense"),
    ("auto", CUDA, 1, False, "host", "local"),
    ("auto", CUDA, 1, True, "device", "local"),
    ("auto", CPU, 8, False, "host", "dense"),
    ("auto", CPU, 1, False, "host", "local"),
    ("pallas", CUDA, 8, True, "device", "pallas"),
    ("pallas", CPU, 1, False, "host", "pallas"),
    ("dense", CUDA, 8, False, "host", "dense"),
    ("gather", CUDA, 8, True, "host", "gather"),
])
def test_resolution_table(impl, device, shards, waved, sink, want):
    assert backend.resolve_a2a_impl(impl, device, shards, waved=waved,
                                    sink=sink) == want


@pytest.mark.parametrize("wave_rows,sink,want", [
    ("0", "host", "pallas"), ("150", "host", "dense"),
    ("0", "device", "dense"), ("150", "device", "dense")])
def test_make_plan_resolves_per_read(wave_rows, sink, want):
    conf = ShuffleConf({"spark.shuffle.tpu.a2a.waveRows": wave_rows},
                       use_env=False)
    plan = tplan.make_plan(np.full(8, 100), 8, 16, conf, CUDA, sink=sink)
    assert plan.impl == want


def _maps(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(M):
        n = int(rng.integers(300, 600))
        k = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64) * 7919
        v = rng.integers(-(1 << 31), 1 << 31, (n, 3)).astype(np.int32)
        out.append((k, v))
    return out


def _stage(mgr, sid, maps):
    h = mgr.register_shuffle(sid, len(maps), R)
    for m, (k, v) in enumerate(maps):
        w = mgr.get_writer(h, m)
        w.write(k, v)
        w.commit(R)
    return h


def _recs(k, v):
    return sorted(zip(k.tolist(), map(bytes, v)))


@pytest.fixture()
def card_view(monkeypatch):
    """The plan's resolver sees a CUDA device; the read runs on the CPU."""
    real = tplan.resolve_a2a_impl

    def on_card(impl, device, num_shards, **kw):
        return real(impl, CUDA, num_shards, **kw)

    monkeypatch.setattr(tplan, "resolve_a2a_impl", on_card)


@pytest.mark.parametrize("waved,sink,want", [
    (False, "host", "pallas"), (True, "host", "dense"),
    (False, "device", "dense"), (True, "device", "dense")])
def test_auto_on_card_matches_reference(manager_factory, card_view, waved,
                                        sink, want):
    """Under the default ``auto`` a waved read keeps the reference's waves
    and a device-sink read runs the dense exchange; the partitions equal
    the JAX package's."""
    conf = {"spark.shuffle.tpu.a2a.impl": "auto"}
    if waved:
        conf["spark.shuffle.tpu.a2a.waveRows"] = "150"
    maps = _maps(90 + 2 * waved + (sink == "device"))
    jm = manager_factory(conf)
    jres = jm.read(_stage(jm, 990, maps), sink=sink)
    jrep = jm.report(990)
    if sink == "device":
        jres = jres.host_view()
    want_parts = [jres.partition(r) for r in range(R)]
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        res = svc.read(_stage(svc.manager, 990, maps), sink=sink)
        rep = svc.report(990)
        assert rep.impl == want and rep.sink == sink
        assert rep.waves == jrep.waves
        assert (rep.waves >= 3) == waved
        if sink == "device":
            assert isinstance(res, DeviceShuffleReaderResult)
            assert rep.d2h_bytes == 0
            res = res.host_view()
        got = [res.partition(r) for r in range(R)]
    for r in range(R):
        assert _recs(*got[r]) == _recs(*want_parts[r]), f"partition {r}"


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_pallas_device_read_has_valid_prefixes(wire):
    """Each shard's delivered rows are ``rows[p, :totals[p]]``: exactly the
    rows routed to that shard's partitions, and what ``host_view()``
    serves; no D2H before it."""
    maps = _maps(95)
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
            "spark.shuffle.tpu.a2a.wire": wire}
    keys = np.concatenate([k for k, _ in maps])
    vals = np.random.default_rng(96).standard_normal(
        (keys.size, 3)).astype(np.float32)
    with connect(conf, device="cpu", num_shards=N_SHARDS,
                 use_env=False) as svc:
        h = svc.register_shuffle(991, M, R)
        for m in range(M):
            lo = sum(k.size for k, _ in maps[:m])
            n = maps[m][0].size
            svc.write(h, m, keys[lo:lo + n], vals[lo:lo + n])
        res = svc.read(h, sink="device")
        rep = svc.report(991)
        assert rep.impl == "pallas" and rep.wire == wire
        rows = res.device_rows().numpy()
        totals = res.device_totals().numpy()
        assert rep.d2h_bytes == 0
        hv = res.host_view()
        parts = [hv.partition(r) for r in range(R)]
    part_shard = blocked_partition_map(R, N_SHARDS)
    shard_of = part_shard[hash32_np(keys) % R]
    assert int(totals.sum()) == keys.size
    for p in range(N_SHARDS):
        sel = shard_of == p
        got = rows[p, :totals[p]]
        gk = got[:, :2].copy().view(np.int64)[:, 0]
        assert sorted(gk.tolist()) == sorted(keys[sel].tolist()), p
        hk = np.concatenate([parts[r][0] for r in range(R)
                             if part_shard[r] == p])
        np.testing.assert_array_equal(np.sort(hk), np.sort(gk))
        gv = got[:, 2:].view(np.float32)
        o = np.argsort(keys[sel], kind="stable")
        og = np.argsort(gk, kind="stable")
        want = vals[sel][o]
        if wire == "raw":
            np.testing.assert_array_equal(gv[og], want)
        else:
            step = np.abs(want).max(axis=1, keepdims=True) / 127.0
            assert (np.abs(gv[og] - want) <= step * 1.000001).all()


CH, CD, CT, CMAPS = 8, 8, 16, 4


def _stage_qkv(mgr, sid, qkv, pos):
    bounds = tuple(CT * (i + 1) for i in range(N_SHARDS - 1))
    h = mgr.register_shuffle(sid, CMAPS, N_SHARDS, partitioner="range",
                             bounds=bounds)
    per = qkv.shape[0] // CMAPS
    for mid in range(CMAPS):
        sel = pos[mid * per:(mid + 1) * per]
        w = mgr.get_writer(h, mid)
        w.write(sel.astype(np.int64), qkv[sel].reshape(len(sel), -1))
        w.commit(N_SHARDS)
    return h


@pytest.mark.parametrize("which", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_consumers_match_jax_on_pallas_device_sink_read(manager_factory,
                                                        which, causal):
    """A plain device-sink read under the segment move (``a2a.impl=pallas``,
    its plain version on the CPU) feeds both consumers what the JAX
    package's consumers compute on its dense device-sink read."""
    qkv, pos = qkv_rows(100 + causal, CH, CD, N_SHARDS * CT)
    jm = manager_factory({})
    jh = _stage_qkv(jm, 992, qkv, pos)
    if which == "ring":
        jstep = jring.ring_attention_consumer(jm.exchange_mesh, jm.axis, CT,
                                              CH, CD, causal=causal)
        tstep = tring.ring_attention_consumer(N_SHARDS, CT, CH, CD,
                                              causal=causal)
    else:
        jstep = july.ulysses_attention_consumer(jm.exchange_mesh, jm.axis,
                                                CT, CH, CD, causal=causal)
        tstep = tuly.ulysses_attention_consumer(N_SHARDS, CT, CH, CD,
                                                causal=causal)
    jout = np.asarray(jm.read(jh, sink="device").consume(
        lambda c, rows, nv: jstep(rows, nv)))
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"}, device="cpu",
                 num_shards=N_SHARDS, use_env=False) as svc:
        th = _stage_qkv(svc.manager, 992, qkv, pos)
        res = svc.read(th, sink="device")
        tout = res.consume(lambda c, rows, totals: tstep(rows, totals))
        rep = svc.report(992)
    assert rep.impl == "pallas" and rep.d2h_bytes == 0
    assert tuple(tout.shape) == (1, CH, N_SHARDS * CT, CD)
    np.testing.assert_allclose(tout.numpy(), jout, atol=5e-5)
    q, k, v = (torch.from_numpy(qkv[:, i].transpose(1, 0, 2)[None].copy())
               for i in range(3))
    ref = tatt.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(tout.numpy(), ref.numpy(), atol=5e-5)
