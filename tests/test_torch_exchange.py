"""Port parity for the differentiable exchanges: ``shuffle/alltoall.
exchange`` and ``exchange_quantized`` against the JAX package's on 8
virtual CPU devices, the port over 8 logical shards, on the buffers and
sizes of ``tests/test_quant_exchange.py`` (W = 6: the int8 pad path).

Exact: the raw forward and its gradient (the transposed move), under
``dense`` and ``gather``; NaN poisoning of float outputs on overflow and
no poison in int32 outputs. Byte-equal, with the JAX side's uniforms
handed to the port: the int8 forward and its straight-through backward
(noise stream 3). A bfloat16 input comes back bfloat16, within one step
of ``amax/127`` of the exact exchange."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparkucx_tpu.shuffle import alltoall as jat
from sparkucx_tpu_torch.shuffle import alltoall as tat

PDEV, CAP, W = 8, 32, 6
SEED = 7


def _mk(rng):
    buffers = rng.normal(size=(PDEV, CAP, W)).astype(np.float32)
    sizes = np.zeros((PDEV, PDEV), np.int32)
    for p in range(PDEV):
        left = CAP
        for q in range(PDEV - 1):
            sizes[p, q] = rng.integers(0, left // 2 + 1)
            left -= sizes[p, q]
        sizes[p, -1] = left
    return buffers, sizes


def _case(seed=0):
    buffers, sizes = _mk(np.random.default_rng(seed))
    out_cap = int(sizes.sum(axis=0).max()) + 8
    cot = np.random.default_rng(seed + 100).normal(
        size=(PDEV, out_cap, W)).astype(np.float32)
    return buffers, sizes, out_cap, cot


def _jax_forward(mesh8, fn, buffers, sizes, out_cap):
    w = buffers.shape[-1]
    g = jax.jit(jax.shard_map(
        lambda d, s: fn(d.reshape(CAP, w), s.reshape(-1)),
        mesh=mesh8, in_specs=(P("shuffle"), P("shuffle")),
        out_specs=P("shuffle")))
    out = g(jnp.asarray(buffers.reshape(-1, w)),
            jnp.asarray(sizes.reshape(-1)))
    return np.asarray(out).reshape(PDEV, out_cap, w)


def _jax_grad(mesh8, fn, buffers, sizes, cot):
    """d/d buffers of sum(fn(buffers) * cot), through the shard_map."""
    def f(d, s, c):
        return jnp.sum(fn(d.reshape(CAP, W), s.reshape(-1))
                       * c.reshape(-1, W)).reshape(1)

    def run(flat):
        parts = jax.shard_map(
            f, mesh=mesh8, in_specs=(P("shuffle"),) * 3,
            out_specs=P("shuffle"))(flat, jnp.asarray(sizes.reshape(-1)),
                                    jnp.asarray(cot.reshape(-1, W)))
        return parts.sum()

    g = jax.jit(jax.grad(run))(jnp.asarray(buffers.reshape(-1, W)))
    return np.asarray(g).reshape(PDEV, CAP, W)


def _port_grad(fn, buffers, cot):
    d = torch.from_numpy(buffers.copy()).requires_grad_()
    out = fn(d)
    torch.sum(out * torch.from_numpy(cot)).backward()
    return out.detach(), d.grad


def _jax_uniforms(seed, shape, device):
    """The JAX side's noise for ``seed``: what its jnp quantize draws."""
    u = jax.random.uniform(jax.random.PRNGKey(seed), tuple(shape))
    return torch.from_numpy(np.array(u)).to(device)


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_exchange_forward_and_grad_exact(mesh8, impl):
    buffers, sizes, out_cap, cot = _case(0)
    want = _jax_forward(mesh8, lambda d, s: jat.exchange(
        d, s, "shuffle", out_cap, impl), buffers, sizes, out_cap)
    want_g = _jax_grad(mesh8, lambda d, s: jat.exchange(
        d, s, "shuffle", out_cap, impl), buffers, sizes, cot)
    sz = torch.from_numpy(sizes)
    got, got_g = _port_grad(
        lambda d: tat.exchange(d, sz, out_cap, impl), buffers, cot)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    # the gradient is the transposed move: each sender's valid rows get
    # back exactly the cotangent rows their data landed in, pad rows zero
    for p in range(PDEV):
        assert not got_g[p, sizes[p].sum():].any()


def test_exchange_grouped_equals_each_group():
    """[G, P, cap, w] with [G, P, P] sizes: each group its own exchange,
    forward and backward."""
    (b0, s0, c0, _), (b1, s1, c1, _) = _case(3), _case(4)
    out_cap = max(c0, c1)
    data = torch.from_numpy(np.stack([b0, b1])).requires_grad_()
    sizes = torch.from_numpy(np.stack([s0, s1]))
    out = tat.exchange(data, sizes, out_cap, "dense")
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    torch.sum(out * cot).backward()
    for g, (b, s) in enumerate(((b0, s0), (b1, s1))):
        d = torch.from_numpy(b).requires_grad_()
        o = tat.exchange(d, torch.from_numpy(s), out_cap, "dense")
        torch.sum(o * cot[g]).backward()
        assert torch.equal(o.detach(), out[g].detach())
        assert torch.equal(d.grad, data.grad[g])
    with pytest.raises(ValueError, match="sizes"):
        tat.exchange(data, sizes[:, :4], out_cap)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_exchange_overflow_poisons_float_only(mesh8, dtype):
    buffers, sizes, _, _ = _case(1)
    out_cap = int(sizes.sum(axis=0).max()) - 1        # one row short
    if dtype == "int32":
        buffers = (buffers * 1000).astype(np.int32)
    want = _jax_forward(mesh8, lambda d, s: jat.exchange(
        d, s, "shuffle", out_cap, "dense"), buffers, sizes, out_cap)
    got = tat.exchange(torch.from_numpy(buffers), torch.from_numpy(sizes),
                       out_cap, "dense")
    if dtype == "float32":
        assert torch.isnan(got).all() and np.isnan(want).all()
    else:
        assert got.dtype == torch.int32
        raw = tat.ragged_shuffle(torch.from_numpy(buffers),
                                 torch.from_numpy(sizes),
                                 out_capacity=out_cap, impl="dense")
        assert bool(raw.overflow)
        assert torch.equal(got, raw.data)
        np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_quantized_forward_and_backward_byte_equal(mesh8):
    buffers, sizes, out_cap, cot = _case(2)
    fn = lambda d, s: jat.exchange_quantized(       # noqa: E731
        d, s, SEED, "shuffle", out_cap, "dense")
    want = _jax_forward(mesh8, fn, buffers, sizes, out_cap)
    want_g = _jax_grad(mesh8, fn, buffers, sizes, cot)
    seen = []

    def uniforms(seed, shape, device):
        seen.append((seed, tuple(shape)))
        return _jax_uniforms(seed, shape, device)

    sz = torch.from_numpy(sizes)
    got, got_g = _port_grad(lambda d: tat.exchange_quantized(
        d, sz, SEED, out_cap, "dense", uniforms=uniforms), buffers, cot)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(got_g.numpy().view(np.int32),
                                  want_g.view(np.int32))
    # forward on the seed, the backward on its stream 3, shard-shaped
    assert seen == [(SEED, (CAP, W)),
                    (tat.wire_noise_seed(SEED, 3), (out_cap, W))]
    # the port's own noise: the same draw on every shard
    u = tat.shared_uniforms(SEED, (CAP, W), torch.device("cpu"))
    assert torch.equal(u, tat.wire_uniforms((2, CAP, W), [SEED, SEED],
                                            torch.device("cpu"))[1])


def test_exchange_quantized_bfloat16(mesh8):
    buffers, sizes, out_cap, cot = _case(3)
    bf = torch.from_numpy(buffers).to(torch.bfloat16)
    sz = torch.from_numpy(sizes)
    d = bf.clone().requires_grad_()
    got = tat.exchange_quantized(d, sz, SEED, out_cap, "dense")
    assert got.dtype == torch.bfloat16
    torch.sum(got * torch.from_numpy(cot).to(torch.bfloat16)).backward()
    assert d.grad.dtype == torch.bfloat16 and torch.isfinite(d.grad).all()
    exact = tat.exchange(bf.float(), sz, out_cap, "dense").numpy()
    recv = sizes.sum(axis=0)
    for q in range(PDEV):
        e = exact[q, :recv[q]].astype(np.float64)
        v = got[q, :recv[q]].detach().float().numpy()
        # one rounding step of the row, plus bfloat16's own rounding of
        # the dequantized value (8 bits of mantissa)
        step = np.abs(e).max(axis=1, keepdims=True) / 127.0
        assert (np.abs(v - e) <= step + np.abs(e) * 2 ** -8 + 1e-7).all()
    # the same bytes as the JAX package's bfloat16 exchange on its noise
    want = _jax_forward(mesh8, lambda d_, s_: jat.exchange_quantized(
        d_.astype(jnp.bfloat16), s_, SEED, "shuffle", out_cap, "dense"
    ).astype(jnp.float32), buffers.astype(jnp.bfloat16).astype(np.float32),
        sizes, out_cap)
    port = tat.exchange_quantized(bf, sz, SEED, out_cap, "dense",
                                  uniforms=_jax_uniforms)
    np.testing.assert_array_equal(port.float().numpy().view(np.int32),
                                  want.view(np.int32))


def test_exchange_quantized_rejects_non_float_rows():
    with pytest.raises(ValueError, match="float rows"):
        tat.exchange_quantized(torch.zeros((8, 4, 3), dtype=torch.int32),
                               torch.zeros((8, 8), dtype=torch.int32), 0, 8)
