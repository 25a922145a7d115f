"""Port parity for the int8 wire format: ``ops/quant.quantize_plain``
against the JAX package's Pallas quantize kernel in interpret mode, and
``shuffle/alltoall.wire_pack_rows`` / ``wire_unpack_rows`` against the
JAX package's, fed the same uniforms ``u`` (the TPU kernel takes its
noise from the caller, so equal ``u`` must give equal bytes).

Exact: ``q`` and ``scale`` bytes, packed wire rows, unpacked rows, the
lane formula, the noise-stream and per-shard seed arithmetic. Statistical
(on the port's own ``torch.Generator`` draws): stochastic rounding is
unbiased."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas.quant import _quantize_pallas
from sparkucx_tpu.ops.pallas.quant import dequantize_rows as jax_dequant
from sparkucx_tpu.shuffle import alltoall as jat
from sparkucx_tpu.shuffle.plan import ShufflePlan as JaxPlan
from sparkucx_tpu.shuffle.reader import seeded_nvalid
from sparkucx_tpu_torch.ops import quant as tq
from sparkucx_tpu_torch.shuffle import alltoall as tat
from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
from sparkucx_tpu_torch.shuffle.reader import wire_shard_seeds
from torch_wire_cases import QUANT_KINDS, quant_values


@pytest.mark.parametrize("w", [1, 3, 4, 128])
@pytest.mark.parametrize("kind", QUANT_KINDS)
def test_quantize_plain_bytes_equal_pallas_interpret(w, kind):
    rng = np.random.default_rng(w * 31 + len(kind))
    n, block_n = 389, 64                     # not a multiple of the block
    x = quant_values(rng, n, w, kind)
    u = rng.random((n, w), dtype=np.float32)
    jq, js = _quantize_pallas(jnp.asarray(x), jnp.asarray(u), block_n,
                              interpret=True)
    tq_, ts = tq.quantize_plain(torch.from_numpy(x), torch.from_numpy(u))
    assert tq_.dtype == torch.int8 and tuple(tq_.shape) == (n, w)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (n, 1)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    # all-zero rows: scale exactly 1.0, q zero
    zero = ~x.any(axis=1)
    assert (ts.numpy()[zero] == 1.0).all() and not tq_.numpy()[zero].any()
    # dequantize: one rounded product, as the JAX package computes it
    np.testing.assert_array_equal(
        tq.dequantize_rows(tq_, ts).numpy().view(np.int32),
        np.asarray(jax_dequant(jq, js)).view(np.int32))


def test_quantize_dispatch_and_input_checks():
    x = torch.randn(5, 3)
    u = torch.rand(5, 3)
    q1, s1 = tq.quantize(x, u)            # a CPU tensor: the plain version
    q2, s2 = tq.quantize_plain(x, u)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="float32"):
        tq.quantize_plain(x.double(), u)
    with pytest.raises(ValueError, match="shape"):
        tq.quantize_plain(x, u[:4])
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_kernel(x, u)          # the kernel never takes the CPU


@pytest.mark.parametrize("head,ww", [(2, 1), (2, 3), (2, 4), (2, 7),
                                     (3, 6), (2, 128)])
def test_wire_pack_rows_bytes_equal_jax(head, ww):
    """Port pack of [P, cap, W] rows == the JAX pack of each shard's
    [cap, W] rows with the same seed, its uniforms handed to the port."""
    P, cap, width = 3, 97, head + ww
    rng = np.random.default_rng(head * 100 + ww)
    rows = rng.integers(-(1 << 31), 1 << 31, (P, cap, width)).astype(
        np.int32)
    rows[..., head:] = (rng.standard_normal((P, cap, ww)) * 50).astype(
        np.float32).view(np.int32)
    rows[:, ::9, head:] = 0                       # pad-like zero rows
    seeds = [11, 12345, 0x7FFFFFFF]
    want, u = [], []
    for p in range(P):
        want.append(np.asarray(jat.wire_pack_rows(
            jnp.asarray(rows[p]), ww, seeds[p], quant_impl="interpret")))
        u.append(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seeds[p]), (cap, ww))))
    got = tat.wire_pack_rows(torch.from_numpy(rows), ww,
                             torch.from_numpy(np.stack(u)))
    assert tuple(got.shape) == (P, cap, head + tat.int8_wire_words(ww))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    # an all-zero value row packs to zero bytes and scale 1.0
    assert (got.numpy()[:, ::9, -1] == np.float32(1).view(np.int32)).all()
    # unpack: the same dequantized rows as the JAX package's, head exact
    back = tat.wire_unpack_rows(got, width, ww)
    jback = np.stack([np.asarray(jat.wire_unpack_rows(
        jnp.asarray(want[p]), width, ww)) for p in range(P)])
    np.testing.assert_array_equal(back.numpy(), jback)
    np.testing.assert_array_equal(back.numpy()[..., :head], rows[..., :head])
    # within one quantization step of the input, row by row
    v = rows[..., head:].view(np.float32).astype(np.float64)
    step = np.abs(v).max(axis=-1, keepdims=True) / 127.0
    err = np.abs(back.numpy()[..., head:].view(np.float32) - v)
    assert (err <= step * (1 + 1e-6) + 1e-30).all()


def test_wire_unpack_rejects_wrong_width():
    rows = torch.zeros((2, 5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        tat.wire_unpack_rows(rows, 10, 8)


def test_lane_formula_and_seed_arithmetic_match_jax():
    for vw in (1, 2, 3, 4, 5, 8, 23, 127, 128, 129):
        assert tat.int8_wire_words(vw) == jat.int8_wire_words(vw)
    for seed in (0, 1, 77, 0x7FFFFFFF, 1 << 40, 123456789):
        for stream in range(tat.WIRE_SEED_STREAMS):
            assert tat.wire_noise_seed(seed, stream) == \
                jat.wire_noise_seed(seed, stream)
    assert tat.WIRE_SEED_STREAMS == jat.WIRE_SEED_STREAMS
    nv = np.array([5, 0, 7, 9, 1, 3, 2, 8], np.int32)
    for base in (0, 1, 7, 100_003 * 5 + 3, (1 << 31) - 1, 1 << 33):
        jplan = JaxPlan(8, 16, 64, 64, "dense", wire="int8", wire_words=4)
        want = seeded_nvalid(jplan, nv, base).reshape(8, 2)
        tplan = ShufflePlan(8, 16, 64, 64, "dense", wire="int8",
                            wire_words=4)
        assert wire_shard_seeds(tplan, base) == want[:, 1].tolist()
        np.testing.assert_array_equal(want[:, 0], nv)
    raw = ShufflePlan(8, 16, 64, 64, "dense")
    assert wire_shard_seeds(raw, 3) is None


def test_wire_uniforms_per_shard_streams():
    u = tat.wire_uniforms((3, 50, 4), [5, 6, 5], torch.device("cpu"))
    assert u.dtype == torch.float32 and ((u >= 0) & (u < 1)).all()
    assert torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    with pytest.raises(ValueError, match="seeds"):
        tat.wire_uniforms((3, 50, 4), [5, 6], torch.device("cpu"))


def test_stochastic_rounding_unbiased_on_port_draws():
    """E[dequant(quant(x))] = x: the mean signed error over many draws of
    the port's own noise sits within a few standard errors of zero."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    errs = []
    for seed in range(200):
        u = tat.wire_uniforms((1, 64, 32), [seed], torch.device("cpu"))[0]
        q, s = tq.quantize_plain(x, u)
        errs.append((tq.dequantize_rows(q, s) - x).double().numpy())
    e = np.stack(errs)                               # [draws, 64, 32]
    step = (x.abs().amax(dim=1, keepdim=True) / 127).double().numpy()
    assert (np.abs(e) <= step).all()
    # the mean signed error over every element and draw, over its
    # standard error
    z = e.mean() / (e.std() / np.sqrt(e.size))
    assert abs(z) < 5, z
