"""A CPU rehearsal of the backward kernels' split-TF32 arithmetic.

``csrc/flash_attention.cu`` computes dq and dk/dv on the tensor cores
with every operand split as big = x rounded to TF32 and small = x - big,
which the tensor core reads truncated to TF32, and each product taken as
a_big b_big + (a_small b_big + a_big b_small). Here that arithmetic
(``torch_attention_cases.mm_split_tf32``) runs through the kernels' block
recurrence on the CPU and is held against the JAX package's
flash-attention gradients (its Pallas kernels in interpret mode) under the
card tests' tolerance: 1e-3 of the largest |grad| plus the larger of 1e-5
and four times the plain version's own distance from float64. Where a
gradient vanishes (T = 1: dS = P (dP - delta) cancels) that floor is what
the split products must meet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import flash_attention as jfa
from sparkucx_tpu_torch.ops import flash_attention as tfa
from torch_attention_cases import (FLASH_D, FLASH_T, flash_inputs,
                                   flash_seed, float64_grads,
                                   grad_tolerance, mm_split_tf32,
                                   split_tf32, tf32_round)

TILE = 32                  # the kernels' streamed tile


def _split_values(kind: str) -> torch.Tensor:
    """Float32 values whose small part is a normal number (|x| above
    2^-102), where the split's error bound holds."""
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        x = rng.standard_normal(100_000)
    elif kind == "wide":             # magnitudes 1e-30 .. 1e30, both signs
        x = rng.choice([-1.0, 1.0], 100_000) * 10.0 ** rng.uniform(
            -30, 30, 100_000)
    elif kind == "ties":             # the dropped bits exactly half a unit
        bits = (rng.integers(0x0D00_0000, 0x7F00_0000, 50_000) & ~0x1FFF) \
            | 0x1000
        x = np.concatenate([bits, bits | 0x8000_0000]).astype(
            np.uint32).view(np.float32)
    else:                            # every mantissa pattern near one
        x = (np.arange(1 << 13, dtype=np.uint32) | 0x3F80_0000).view(
            np.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "ties", "low_bits"])
def test_split_tf32_properties(kind):
    """big and small are TF32 (low 13 bits zero); big is x to the nearest
    TF32 (within half a unit, 2^-11 |x|; ties away from zero); big + small
    is within 2^-21 |x| of x (small's truncation), and within 2^-22 |x| if
    small were rounded too (``cvt.rna`` on both, the slower split)."""
    x = _split_values(kind)
    big, small = split_tf32(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    xd = x.double()
    assert bool(((xd - big.double()).abs() <= 2.0 ** -11 * xd.abs()).all())
    err = (xd - big.double() - small.double()).abs()
    assert bool((err <= 2.0 ** -21 * xd.abs()).all())
    rounded = tf32_round(x - big)
    err = (xd - big.double() - rounded.double()).abs()
    assert bool((err <= 2.0 ** -22 * xd.abs()).all())
    if kind == "ties":               # ties go away from zero
        assert bool((big.abs() > x.abs()).all())
        assert torch.equal(tf32_round(-x), -big)


def _split_backward(q, k, v, g, lse, delta, causal: bool, scale: float):
    """(dq, dk, dv) by the kernels' block recurrence, every product in
    split-TF32; masks and the dS arithmetic in float32."""
    BH, T, D = q.shape
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    pos = torch.arange(T)
    for q0 in range(0, T, TILE):
        q1 = min(T, q0 + TILE)
        for k0 in range(0, q1 if causal else T, TILE):
            k1 = min(T, k0 + TILE)
            s = mm_split_tf32(q[:, q0:q1], k[:, k0:k1].transpose(1, 2))
            p = torch.exp(scale * s - lse[:, q0:q1, None])
            if causal:
                p = p.masked_fill(pos[k0:k1][None, :] > pos[q0:q1][:, None],
                                  0.0)
            dp = mm_split_tf32(g[:, q0:q1], v[:, k0:k1].transpose(1, 2))
            ds = p * (dp - delta[:, q0:q1, None]) * scale
            dq[:, q0:q1] += mm_split_tf32(ds, k[:, k0:k1])
            dk[:, k0:k1] += mm_split_tf32(ds.transpose(1, 2), q[:, q0:q1])
            dv[:, k0:k1] += mm_split_tf32(p.transpose(1, 2), g[:, q0:q1])
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", FLASH_D)
@pytest.mark.parametrize("t", FLASH_T)
def test_split_tf32_backward_matches_jax(t, d, causal):
    """The split-TF32 recurrence against the JAX package's gradients
    (interpret-mode Pallas) and the port's plain float32 versions, at BH 1
    on the card tests' grid, under ``grad_tolerance`` with the plain
    version's float64 distance measured on these inputs."""
    q, k, v, g = flash_inputs(flash_seed(1, t, d, causal), 1, t, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x)[None] for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, scale=scale, impl="interpret"), jq, jk, jv)
    jgrads = [np.asarray(x)[0] for x in vjp(jg)]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, scale)
    delta = (tg * o).sum(dim=-1)
    split = _split_backward(tq, tk, tv, tg, lse, delta, causal, scale)
    plain = (tfa.flash_dq_plain(tq, tk, tv, tg, lse, delta, causal, scale),
             *tfa.flash_dkv_plain(tq, tk, tv, tg, lse, delta, causal, scale))
    _, truth = float64_grads(tq, tk, tv, tg, causal, scale)
    for got, want, ref, exact, name in zip(split, plain, jgrads, truth,
                                           ("dq", "dk", "dv")):
        plain_err = float((want.double() - exact).abs().max())
        got = got.numpy()
        for other, what in ((ref, "JAX"), (want.numpy(), "plain")):
            err = float(np.abs(got - other).max())
            tol = grad_tolerance(other, plain_err)
            assert err <= tol, f"{name} vs {what}: {err} > {tol}"
