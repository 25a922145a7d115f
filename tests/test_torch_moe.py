"""Port parity for the expert-parallel MoE (``sparkucx_tpu_torch/models/
moe.py``) against the JAX package's ``models/moe.py``: the JAX model on
a ``dp=2 x ep=4`` mesh of virtual CPU devices, the port on the same grid
of logical shards, parameters carried across by ``params_from_jax``.

Forward: the same routing and outputs within ``1e-5 max|out| + 1e-6``
(raw wire; int8 wire with the JAX side's uniforms handed over), and the
dense top-1 oracle. Gradients: every leaf within ``1e-4 max|g| + 1e-6``;
three Adam steps against optax's within 1e-4 relative; a NaN loss on an
exchange overflow. Traffic: ``exchange_traffic`` and the counters a
forward and a training step add. Read path: the device-sink consumer on
the same staged tokens as the JAX package's, its loss falling over five
reads with no D2H, and the host-staged arm's loss equal to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkucx_tpu.models import moe as jm
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.models import moe as tm
from sparkucx_tpu_torch.shuffle import alltoall as tat
from sparkucx_tpu_torch.utils.metrics import (C_D2H, C_H2D, C_MOE_EXCHANGES,
                                              C_MOE_ROWS, C_PAYLOAD_BYTES,
                                              C_WIRE_BYTES, Metrics)

DP, EP = 2, 4
SIZES = dict(d_model=16, d_hidden=32, num_experts=8, tokens_per_shard=16,
             impl="dense")
B = DP * EP * SIZES["tokens_per_shard"]
SEED = 3
CPU = torch.device("cpu")


def _cfgs(wire="raw", **kw):
    return (jm.MoEConfig(**{**SIZES, **kw}, wire=wire),
            tm.MoEConfig(**{**SIZES, **kw}, wire=wire))


def _jax_uniforms(seed, shape, device):
    u = jax.random.uniform(jax.random.PRNGKey(seed), tuple(shape))
    return torch.from_numpy(np.array(u)).to(device)


def _close(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float64)
    tol = rel * np.abs(want).max() + 1e-6
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    assert err <= tol, f"{what}: max err {err} > {tol}"


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()).reshape(DP, EP), ("dp", "ep"))


@pytest.fixture(scope="module")
def data():
    jcfg, _ = _cfgs()
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, jcfg.d_model))
    y = jax.random.normal(jax.random.PRNGKey(2), (B, jcfg.d_model)) * 0.1
    return ({k: np.array(v) for k, v in params.items()}, np.array(x),
            np.array(y))


def _port(data):
    params, x, y = data
    return (tm.params_from_jax(params, device="cpu"), torch.from_numpy(x),
            torch.from_numpy(y))


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_forward_matches_jax(mesh, data, wire):
    jcfg, tcfg = _cfgs(wire)
    params, x, _ = data
    want = np.asarray(jm.forward({k: jnp.asarray(v) for k, v in
                                  params.items()}, jnp.asarray(x), mesh,
                                 jcfg, seed=SEED))
    tp, tx, _ = _port(data)
    got = tm.forward(tp, tx, tcfg, DP, EP, seed=SEED,
                     uniforms=_jax_uniforms)
    assert got.shape == (B, jcfg.d_model) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5, wire)
    # the same routing: top-1 expert of every token, and on the raw wire
    # every received row recomputes its sender's expert
    want_e = np.asarray(jnp.argmax(jnp.asarray(x) @ params["router"], -1))
    got_e = torch.argmax(tx @ tp["router"], -1)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    from chip_smoke import routing_disagreements
    chk = routing_disagreements(tp, tx, tcfg, DP, EP)
    assert chk == {"rows": B, "disagree": 0}


@pytest.mark.parametrize("n", [1, 100, tm.ROUTER_BLOCK + 3])
def test_router_logits_do_not_depend_on_the_row_count(n):
    """A row's logits are the same bits whichever other rows share the
    call (the raw wire's receiver recomputes the sender's routing over
    another number of rows), and they are the plain product's."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3 * tm.ROUTER_BLOCK, 24),
                                             dtype=np.float32))
    router = torch.from_numpy(rng.standard_normal((24, 8), dtype=np.float32))
    full = tm.router_logits(x, router)
    part = tm.router_logits(x[-n:], router)
    assert part.shape == (n, 8)
    assert torch.equal(part, full[-n:])
    assert torch.equal(tm.router_logits(x.view(3, -1, 24), router),
                       full.view(3, -1, 8))
    torch.testing.assert_close(full, x @ router, rtol=1e-5, atol=1e-5)


def test_forward_matches_dense_oracle(data):
    """The oracle of tests/test_moe.py in float64: the same top-1 MoE
    computed densely, without any dispatch."""
    _, tcfg = _cfgs()
    tp, tx, _ = _port(data)
    got = tm.forward(tp, tx, tcfg, DP, EP)
    p = {k: v.double() for k, v in tp.items()}
    xd = tx.double()
    logits = xd @ p["router"]
    expert = torch.argmax(logits, -1)
    gate = torch.softmax(logits, -1).gather(1, expert[:, None])[:, 0]
    h = torch.nn.functional.gelu(torch.einsum("td,edh->teh", xd, p["w1"]),
                                 approximate="tanh")
    y = torch.einsum("teh,ehd->ted", h, p["w2"])
    own = y[torch.arange(B), expert]
    want = (own * gate[:, None]) @ p["wout"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_grads_match_jax(mesh, data, wire):
    jcfg, tcfg = _cfgs(wire)
    params, x, y = data
    want = jax.grad(jm.loss_fn)({k: jnp.asarray(v) for k, v in
                                 params.items()}, jnp.asarray(x),
                                jnp.asarray(y), mesh, jcfg, seed=SEED)
    tp, tx, ty = _port(data)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    loss = tm.loss_fn(leaves, tx, ty, tcfg, DP, EP, seed=SEED,
                      uniforms=_jax_uniforms)
    got = torch.autograd.grad(loss, [leaves[k] for k in tm.PARAM_NAMES])
    for name, g in zip(tm.PARAM_NAMES, got):
        w = np.asarray(want[name])
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        _close(g.numpy(), w, 1e-4, f"{wire} d{name}")


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_train_steps_match_optax(mesh, data, wire):
    jcfg, tcfg = _cfgs(wire)
    _, x, y = data
    jinit, jstep = jm.make_train_step(mesh, jcfg, lr=3e-3)
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    start = {k: np.array(v) for k, v in jparams.items()}
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tinit, tstep = tm.make_train_step(tcfg, DP, EP, lr=3e-3, device="cpu",
                                      uniforms=_jax_uniforms)
    tparams, topt = tinit(tm.params_from_jax(start, device="cpu"))
    for i in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jx, jy)
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(x),
                                     torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert tm._adam_count(topt) == i + 1
    for k in tm.PARAM_NAMES:
        w = np.asarray(jparams[k])
        _close(tparams[k].detach().numpy(), w, 1e-4, f"{wire} {k}")
        assert not np.array_equal(w, start[k]), k


def test_overflow_poisons_loss(data):
    """A router biased to expert 0: shard 0 of each dp row receives 4x
    its capacity; the loss must be NaN, as in the JAX package."""
    _, tcfg = _cfgs(capacity_factor=1.0)
    tp, tx, _ = _port(data)
    tp["router"][:, 0] = 100.0
    loss = tm.loss_fn(tp, tx, torch.zeros_like(tx), tcfg, DP, EP)
    assert torch.isnan(loss)


def test_exchange_traffic_matches_jax():
    for d_model in (16, 64, 768):
        for wire in ("raw", "f32", "int8"):
            j = jm.MoEConfig(d_model=d_model, wire=wire)
            t = tm.MoEConfig(d_model=d_model, wire=wire)
            assert t.wire_int8 == j.wire_int8
            assert t.recv_capacity == j.recv_capacity
            for tokens in (1, 100, 32768):
                assert tm.exchange_traffic(t, tokens) == \
                    jm.exchange_traffic(j, tokens)
    with pytest.raises(ValueError, match="raw|int8"):
        _ = tm.MoEConfig(wire="lossless").wire_int8


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_counters_follow_exchange_traffic(data, wire):
    _, tcfg = _cfgs(wire)
    tp, tx, ty = _port(data)
    m = Metrics()
    tm.forward(tp, tx, tcfg, DP, EP, seed=1, metrics=m)
    p, w = tm.exchange_traffic(tcfg, B)
    assert m.get(C_PAYLOAD_BYTES) == p and m.get(C_WIRE_BYTES) == w
    assert m.get(C_MOE_EXCHANGES) == 2.0 and m.get(C_MOE_ROWS) == 2 * B
    # a training step: the forward's exchanges and the transposed ones
    # (no expert-id exchange in the backward)
    m2 = Metrics()
    init, step = tm.make_train_step(tcfg, DP, EP, device="cpu", metrics=m2)
    params, opt = init(tp)
    step(params, opt, tx, ty)
    ids = B * 4 if tcfg.wire_int8 else 0
    assert m2.get(C_PAYLOAD_BYTES) == 2 * p - ids
    assert m2.get(C_WIRE_BYTES) == 2 * w - ids
    assert m2.get(C_MOE_EXCHANGES) == 4.0


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.make_train_step(tcfg, DP, EP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.make_device_dispatch_step(tcfg, 64, 8)
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (16, 8), "w1": (8, 16, 32), "w2": (8, 32, 16),
        "wout": (16, 16)}


def test_device_dispatch_matches_jax(manager_factory):
    """The read-path dispatch on the same staged tokens: the JAX
    manager's device-sink read and consumer against the port's on
    ``device="cpu"``, from the same expert weights."""
    cfg = tm.MoEConfig(d_model=16, d_hidden=32, num_experts=16)
    jcfg = jm.MoEConfig(d_model=16, d_hidden=32, num_experts=16)
    rng = np.random.default_rng(0)
    N, maps = 2000, 4
    tokens = rng.standard_normal((N, cfg.d_model)).astype(np.float32)
    eids = rng.integers(0, cfg.num_experts, size=N)

    jmgr = manager_factory({"spark.shuffle.tpu.a2a.impl": "dense"})
    jh = jmgr.register_shuffle(91_001, maps, cfg.num_experts,
                               partitioner="direct")
    jm.stage_tokens_by_expert(jmgr, jh, tokens, eids)
    jres = jmgr.read(jh, sink="device")
    jcap = jres.device_rows().shape[0] // jmgr.node.num_devices
    jinit, jstep = jm.make_device_dispatch_step(jmgr.exchange_mesh, jcfg,
                                                jcap, axis=jmgr.axis)
    jparams = jinit(jax.random.PRNGKey(0))
    start = {k: np.array(v) for k, v in jparams.items()}
    _, jloss = jres.consume(lambda c, rows, nv: jstep(c[0], rows, nv),
                            (jparams, None))
    jmgr.unregister_shuffle(jh.shuffle_id)

    conf = {"spark.shuffle.tpu.a2a.impl": "dense"}
    with connect(conf, device="cpu", num_shards=8, use_env=False) as svc:
        h = svc.register_shuffle(91_002, maps, cfg.num_experts,
                                 partitioner="direct")
        tm.stage_tokens_by_expert(svc.manager, h, tokens, eids)
        metrics = svc.node.metrics
        d0 = metrics.get(C_D2H)
        res = svc.read(h, sink="device")
        cap = res.device_rows().shape[1]
        init, step = tm.make_device_dispatch_step(cfg, cap, 8, device="cpu")
        params = tm.params_from_jax(start, device="cpu")
        params, loss0 = res.consume(
            lambda c, rows, totals: step(c[0], rows, totals), (params, None))
        assert abs(float(loss0) - float(jloss)) <= 1e-5 * float(jloss)
        losses = [float(loss0)]
        for _ in range(4):
            r = svc.read(h, sink="device")
            params, loss = r.consume(
                lambda c, rows, totals: step(c[0], rows, totals),
                (params, None))
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert metrics.get(C_D2H) - d0 == 0
        # host-staged arm: the same staged shuffle and step from the same
        # weights; it pays the round trip
        h2d0 = metrics.get(C_H2D)
        rh = svc.read(h, sink="host")
        _, hloss = tm.host_staged_consume(
            rh, step, tm.params_from_jax(start, device="cpu"), cap,
            2 + cfg.d_model, 8, metrics)
        assert abs(float(hloss) - float(loss0)) <= 1e-6 * float(loss0)
        assert metrics.get(C_H2D) - h2d0 > 0
        svc.unregister_shuffle(91_002)


def test_device_dispatch_rejects_bad_shapes():
    cfg = tm.MoEConfig(d_model=16, d_hidden=32, num_experts=12)
    with pytest.raises(ValueError, match="divide"):
        tm.make_device_dispatch_step(cfg, 64, 8, device="cpu")
    init, step = tm.make_device_dispatch_step(
        tm.MoEConfig(d_model=16, d_hidden=32, num_experts=8), 64, 8,
        device="cpu")
    params = init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="rows"):
        step(params, torch.zeros((8, 32, 18), dtype=torch.int32),
             torch.zeros(8, dtype=torch.int32))


def test_shared_uniforms_drive_the_int8_forward(data):
    """Without a uniforms hook the int8 wire rounds with the port's own
    draws: deterministic per seed, different across seeds, within one
    rounding step of the raw forward's scale."""
    _, raw = _cfgs("raw")
    _, q = _cfgs("int8")
    tp, tx, _ = _port(data)
    a = tm.forward(tp, tx, q, DP, EP, seed=5)
    assert torch.equal(a, tm.forward(tp, tx, q, DP, EP, seed=5))
    assert not torch.equal(a, tm.forward(tp, tx, q, DP, EP, seed=6))
    exact = tm.forward(tp, tx, raw, DP, EP)
    assert (a - exact).abs().max() < 0.05 * exact.abs().max()
    assert tat.wire_noise_seed(5, 0) != tat.wire_noise_seed(5, 1)


def test_int8_step_quantizes_three_moves(data, monkeypatch):
    """A step's tokens are not differentiated, so the dispatch's backward
    never runs: the dispatch, the combine and the combine's backward
    quantize, each once for every shard of the grid."""
    from sparkucx_tpu_torch.ops import quant as tq
    _, tcfg = _cfgs("int8")
    tp, tx, ty = _port(data)
    rows = []
    plain = tq.quantize

    def counting(x, u):
        rows.append(x.shape[0])
        return plain(x, u)

    monkeypatch.setattr(tq, "quantize", counting)
    init, step = tm.make_train_step(tcfg, DP, EP, device="cpu")
    params, opt = init(tp)
    step(params, opt, tx, ty)
    T, cap = tcfg.tokens_per_shard, tcfg.recv_capacity
    assert rows == [DP * EP * T, DP * EP * cap, DP * EP * T]
