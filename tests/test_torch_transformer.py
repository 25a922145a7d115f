"""Port parity for the five-axis MoE transformer (``sparkucx_tpu_torch/
models/transformer.py``) against the JAX package's ``models/
transformer.py``: the JAX model on the virtual CPU devices, the port on
the same logical grid on the CPU, parameters carried across by
``params_from_jax`` and tokens drawn with numpy from a seed, at
``tests/test_transformer.py``'s sizes.

Forward: within 2e-4 at every mesh of ``tests/test_transformer.py`` and at
the trivial one; Ulysses both as shipped (``auto``: the blockwise scan on
the CPU, on both sides) and through the flash kernels' plain versions
(``interpret``). Gradients: every leaf within ``1e-4 max|g| + 1e-6`` of
``jax.grad``'s. Three Adam steps against optax's within 1e-4 relative. A
bfloat16 forward within ``BF16_TOL`` of the reference's bfloat16 forward.
Then the errors, the grid factorisation, the NaN loss of an exchange
overflow and the device rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkucx_tpu.models import transformer as jt
from sparkucx_tpu_torch.models import transformer as tt
from sparkucx_tpu_torch.ops import flash_attention as tfa

SIZES = dict(vocab=64, d_model=16, num_heads=4, head_dim=4, d_ff=32,
             num_layers=2, num_experts=4, seq_len=16, microbatches=2,
             capacity_factor=2.0)
MESHES = [(1, 1, 1, 1, 1),
          (2, 1, 2, 1, 2),   # dp x sp x ep
          (1, 2, 1, 2, 2),   # pp x tp x ep
          (1, 2, 2, 2, 1),   # pp x sp x tp
          (2, 2, 1, 1, 2)]   # dp x pp x ep
# bfloat16 against the reference's bfloat16: both round every product and
# activation to 8 mantissa bits (2**-9 relative), but at other points
# (XLA's and torch's CPU products accumulate and round differently), and
# the differences grow through two layers' residual sums; measured 0.7%
# of max|logits| at these sizes, so 2% (five bf16 steps of the largest
# logit) holds it with room and still catches a dtype mistake (a float32
# forward is 26% of max|logits| away from the bfloat16 one here)
BF16_TOL = 2e-2


def _cfgs(**kw):
    return (jt.TransformerConfig(**{**SIZES, **kw}),
            tt.TransformerConfig(**{**SIZES, **kw}))


def _mesh(sizes):
    n = int(np.prod(sizes))
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes), jt.AXES)


def _data(seed, batch=8, seq=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SIZES["vocab"], size=(batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _jax_params(seed, cfg):
    return {k: np.asarray(v) for k, v in
            jt.init_params(jax.random.PRNGKey(seed), cfg).items()}


def _jax_forward(params, x, sizes, cfg):
    return np.asarray(jt.forward({k: jnp.asarray(v) for k, v in
                                  params.items()}, jnp.asarray(x),
                                 _mesh(sizes), cfg))


def _port_forward(params, x, sizes, cfg):
    with torch.no_grad():
        return tt.forward(tt.params_from_jax(params, device="cpu"),
                          torch.from_numpy(x), tt.ShardGrid(*sizes),
                          cfg).numpy()


def _close(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float64)
    tol = rel * np.abs(want).max() + 1e-6
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    assert err <= tol, f"{what}: max err {err} > {tol}"


@pytest.fixture(scope="module")
def data():
    jcfg, _ = _cfgs()
    x, y = _data(0)
    return _jax_params(0, jcfg), x, y


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax(data, sizes):
    jcfg, tcfg = _cfgs()
    params, x, _ = data
    want = _jax_forward(params, x, sizes, jcfg)
    got = _port_forward(params, x, sizes, tcfg)
    assert got.shape == (8, 16, SIZES["vocab"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def ulysses_want(data):
    jcfg, _ = _cfgs(attn="ulysses")
    params, x, _ = data
    return _jax_forward(params, x, (2, 1, 2, 1, 2), jcfg)


@pytest.mark.parametrize("impl", ["auto", "interpret"])
def test_ulysses_forward_matches_jax(data, ulysses_want, impl, monkeypatch):
    """sp=2 with 4 heads: ``auto`` runs the blockwise scan on both sides;
    ``interpret`` puts the flash autograd function, with the kernels'
    plain versions, inside the model: one forward launch a layer and
    microbatch."""
    _, tcfg = _cfgs(attn="ulysses")
    params, x, _ = data
    calls = []
    plain = tfa.flash_fwd_plain

    def counted(q, *args):
        calls.append(tuple(q.shape))
        return plain(q, *args)

    monkeypatch.setattr(tt, "ULYSSES_IMPL", impl)
    monkeypatch.setattr(tfa, "flash_fwd_plain", counted)
    got = _port_forward(params, x, (2, 1, 2, 1, 2), tcfg)
    np.testing.assert_allclose(got, ulysses_want, atol=2e-4, rtol=2e-4)
    # [dp*ep*mb*H, T, Dh] = [2*2*1*4, 16, 4], per layer and microbatch
    want_calls = [(16, 16, 4)] * 4 if impl == "interpret" else []
    assert calls == want_calls


@pytest.mark.parametrize("sizes", [(1, 1, 1, 1, 1), (1, 2, 1, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grads_match_jax(sizes):
    """Every leaf against ``jax.grad(loss_fn)``; (1, 2, 1, 2, 2) is
    pp x tp x ep, the reference's NaN-prone combination."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(2, jcfg)
    x, y = _data(2)
    mesh = _mesh(sizes)
    want = jax.jit(lambda p, a, b: jax.grad(jt.loss_fn)(p, a, b, mesh, jcfg))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y))
    leaves = {k: v.requires_grad_() for k, v in
              tt.params_from_jax(params, device="cpu").items()}
    loss = tt.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y),
                      tt.ShardGrid(*sizes), tcfg)
    got = torch.autograd.grad(loss, [leaves[k] for k in tt.PARAM_NAMES])
    for name, g in zip(tt.PARAM_NAMES, got):
        w = np.asarray(want[name])
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        _close(g.numpy(), w, 1e-4, f"d{name}")


def test_ulysses_flash_grads_match_scan(data, monkeypatch):
    """The gradients through the flash autograd function inside the model
    (``interpret``: the kernels' plain backward, as the card runs the
    kernels) equal, within the gradient tolerance, those through the
    blockwise scan at (2, 1, 2, 1, 2)."""
    _, tcfg = _cfgs(attn="ulysses")
    params, x, y = data
    grads = {}
    for impl in ("auto", "interpret"):
        monkeypatch.setattr(tt, "ULYSSES_IMPL", impl)
        leaves = {k: v.requires_grad_() for k, v in
                  tt.params_from_jax(params, device="cpu").items()}
        loss = tt.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y),
                          tt.ShardGrid(2, 1, 2, 1, 2), tcfg)
        grads[impl] = torch.autograd.grad(
            loss, [leaves[k] for k in tt.PARAM_NAMES])
    for name, got, want in zip(tt.PARAM_NAMES, grads["interpret"],
                               grads["auto"]):
        assert want.abs().max() > 0, name
        _close(got.numpy(), want.numpy(), 1e-4, f"d{name}")


def test_train_steps_match_optax():
    jcfg, tcfg = _cfgs()
    x, y = _data(1)
    jinit, jstep = jt.make_train_step(_mesh((1, 1, 1, 1, 1)), jcfg, lr=1e-2)
    jparams, jopt = jinit(jax.random.PRNGKey(1))
    start = {k: np.array(v) for k, v in jparams.items()}
    tinit, tstep = tt.make_train_step(tt.ShardGrid(), tcfg, lr=1e-2,
                                      device="cpu")
    tparams, topt = tinit(tt.params_from_jax(start, device="cpu"))
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(x),
                                     jnp.asarray(y))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(x),
                                     torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k in tt.PARAM_NAMES:
        w = np.asarray(jparams[k])
        _close(tparams[k].detach().numpy(), w, 1e-4, k)
        assert not np.array_equal(w, start[k]), k


@pytest.mark.parametrize("sizes", [(1, 1, 1, 1, 1), (2, 1, 2, 1, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_forward_matches_jax(data, sizes):
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    params, x, _ = data
    want = _jax_forward(params, x, sizes, jcfg)
    got = _port_forward(params, x, sizes, tcfg)
    assert got.dtype == np.float32       # the unembedding runs in float32
    _close(got, want, BF16_TOL, "bf16 logits")
    f32 = _port_forward(params, x, sizes, _cfgs()[1])
    assert np.abs(f32 - want).max() > BF16_TOL * np.abs(want).max()


def test_bf16_step_keeps_master_params_float32(data):
    _, tcfg = _cfgs(compute_dtype="bfloat16")
    params, x, y = data
    init, step = tt.make_train_step(tt.make_mesh(8), tcfg, lr=1e-2,
                                    device="cpu")
    p, opt = init(tt.params_from_jax(params, device="cpu"))
    p, opt, loss = step(p, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert np.isfinite(float(loss))
    for k, v in p.items():
        assert v.dtype == torch.float32 and v.grad.dtype == torch.float32, k


def test_remat_off_matches_remat_on(data):
    _, tcfg = _cfgs()
    params, x, y = data
    grads = []
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=False)):
        leaves = {k: v.requires_grad_() for k, v in
                  tt.params_from_jax(params, device="cpu").items()}
        loss = tt.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y),
                          tt.make_mesh(8), cfg)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_ulysses_rejects_indivisible_heads():
    # one head cannot be split over sp=2: both raise, neither misroutes
    jcfg, tcfg = _cfgs(attn="ulysses", num_heads=1, head_dim=16)
    params = _jax_params(0, jcfg)
    x, _ = _data(0)
    with pytest.raises(ValueError, match="divisible"):
        _jax_forward(params, x, (2, 1, 2, 1, 2), jcfg)
    with pytest.raises(ValueError, match="divisible"):
        _port_forward(params, x, (2, 1, 2, 1, 2), tcfg)
    # 4 heads divide over sp=4 but tp=2 leaves 2 local heads a shard
    _, tcfg = _cfgs(attn="ulysses")
    with pytest.raises(ValueError, match="local heads 2 divisible by sp=4"):
        _port_forward(_jax_params(0, _cfgs()[0]), x, (1, 1, 4, 2, 1),
                      tcfg)


def test_too_many_experts_for_the_dtype():
    """bfloat16 holds integers exactly up to 256: 512 experts would
    corrupt the expert-id column of the exchanged rows."""
    jcfg, tcfg = _cfgs(num_experts=512, compute_dtype="bfloat16")
    params = _jax_params(0, jcfg)
    x, _ = _data(0)
    with pytest.raises(ValueError, match="not exactly representable"):
        _jax_forward(params, x, (1, 1, 1, 1, 1), jcfg)
    with pytest.raises(ValueError, match="not exactly representable"):
        _port_forward(params, x, (1, 1, 1, 1, 1), tcfg)


@pytest.mark.parametrize("kw, sizes, what", [
    (dict(num_layers=3), (1, 2, 1, 1, 1), "num_layers 3"),
    (dict(num_experts=3), (1, 1, 1, 1, 2), "num_experts 3"),
    (dict(num_heads=3, head_dim=4), (1, 1, 1, 2, 1), "num_heads 3"),
    (dict(d_ff=30), (1, 1, 1, 4, 1), "d_ff 30"),
    (dict(seq_len=12), (1, 1, 8, 1, 1), "seq_len 12"),
    (dict(microbatches=3), (1, 1, 1, 1, 1), "the batch 8"),
    (dict(attn="tree"), (1, 1, 1, 1, 1), "ring|ulysses"),
])
def test_indivisible_grid_raises(kw, sizes, what):
    _, tcfg = _cfgs(**kw)
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    x, _ = _data(0)
    with pytest.raises(ValueError, match=what):
        tt.forward(params, torch.from_numpy(x), tt.ShardGrid(*sizes), tcfg)


@pytest.mark.parametrize("n, order", [
    (8, None), (8, ("ep", "tp")), (16, None), (6, None), (1, None),
    (32, ("ep", "sp", "pp", "tp"))])
def test_make_mesh_factorization(n, order):
    kw = {} if order is None else {"order": order}
    want = dict(zip(jt.AXES, jt.make_mesh(
        n, devices=list(range(n)), **kw).devices.shape))
    grid = tt.make_mesh(n, **kw)
    assert tt.mesh_axis_sizes(grid) == want
    assert int(np.prod(list(want.values()))) == n
    if n == 8 and order is None:
        assert want == {"dp": 1, "pp": 2, "sp": 2, "tp": 1, "ep": 2}


def test_param_specs_match_jax():
    want = {k: tuple(v) for k, v in jt.param_specs().items()}
    assert tt.param_specs() == want
    assert set(want) == set(tt.PARAM_NAMES)


def test_init_params_layouts():
    jcfg, tcfg = _cfgs()
    want = {k: np.asarray(v).shape for k, v in
            jt.init_params(jax.random.PRNGKey(0), jcfg).items()}
    got = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())


@pytest.mark.parametrize("sizes", [(1, 1, 1, 1, 1), (2, 1, 2, 1, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_overflow_poisons_loss(sizes):
    """capacity_factor 0.25: a shard's receive capacity is a quarter of
    its rows, every exchange overflows, and the loss is NaN on both
    sides."""
    jcfg, tcfg = _cfgs(capacity_factor=0.25)
    params = _jax_params(0, jcfg)
    x, y = _data(0)
    jloss = jt.loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), jnp.asarray(y), _mesh(sizes), jcfg)
    tloss = tt.loss_fn(tt.params_from_jax(params, device="cpu"),
                       torch.from_numpy(x), torch.from_numpy(y),
                       tt.ShardGrid(*sizes), tcfg)
    assert np.isnan(float(jloss)) and torch.isnan(tloss)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a card, every entry point that places tensors raises
    unless it is given ``"cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    arrays = {k: v.numpy() for k, v in
              tt.init_params(tcfg, gen, device="cpu").items()}
    for call in (lambda: tt.init_params(tcfg, gen),
                 lambda: tt.params_from_jax(arrays),
                 lambda: tt.make_train_step(tt.ShardGrid(), tcfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tt.params_from_jax(arrays, device="cpu")["wo"].device.type == "cpu"


def test_shard_grid_rejects_bad_sizes():
    with pytest.raises(ValueError, match="positive"):
        tt.ShardGrid(dp=0)
