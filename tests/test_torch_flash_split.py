"""A CPU rehearsal of the flash kernels' split-TF32 arithmetic.

``csrc/flash_attention.cu`` computes the forward, dq and dk/dv on the
tensor cores with every operand split as big = x rounded to TF32 and
small = x - big, which the tensor core reads truncated to TF32, and each
product taken as a_big b_big + (a_small b_big + a_big b_small). Here that
arithmetic (``torch_attention_cases.mm_split_tf32``) runs through the
kernels' block recurrences on the CPU and is held against the JAX
package's flash attention (its Pallas kernels in interpret mode) and the
port's plain versions under the card tests' tolerances. The forward: O
within 1e-4 of the largest |O| plus 1e-6, lse within 1e-5 (1 + |lse|).
The gradients: 1e-3 of the largest |grad| plus the larger of 1e-5 and
four times the plain version's own distance from float64. Where a
gradient vanishes (T = 1: dS = P (dP - delta) cancels) that floor is what
the split products must meet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import flash_attention as jfa
from sparkucx_tpu_torch.ops import flash_attention as tfa
from sparkucx_tpu_torch.ops.attention import NEG_INF
from torch_attention_cases import (FLASH_D, FLASH_T, flash_inputs,
                                   flash_seed, float64_grads,
                                   grad_tolerance, lse_tolerance,
                                   mm_split_tf32, out_tolerance,
                                   split_tf32, tf32_round)

TILE = 32                  # the kernels' streamed tile
RESIDENT = 128             # the kernels' resident tile (forward: Q rows)
FWD_KEYS = 64              # the forward's streamed K and V rows a stage


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


def _split_forward(q, k, v, causal: bool, scale: float):
    """(O, lse) by the forward kernel's recurrence: 128-row Q tiles, each
    multiplied by scale in float32 before the split; per 64-row K and V
    stage, S in split-TF32, the reference's online softmax (m, dead,
    alpha, l) in float32, and P V in split-TF32, each 32-key half summed
    from zero and added to the rescaled O accumulator in float32."""
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T))
    pos = torch.arange(T)
    for q0 in range(0, T, RESIDENT):
        q1 = min(T, q0 + RESIDENT)
        qs = q[:, q0:q1] * scale
        m = torch.full((BH, q1 - q0), NEG_INF)
        l = torch.zeros((BH, q1 - q0))
        acc = torch.zeros((BH, q1 - q0, D))
        for k0 in range(0, q1 if causal else T, FWD_KEYS):
            k1 = min(T, k0 + FWD_KEYS)
            s = mm_split_tf32(qs, k[:, k0:k1].transpose(1, 2))
            if causal:
                s = s.masked_fill(pos[k0:k1][None, :] > pos[q0:q1][:, None],
                                  NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            dead = m_new <= NEG_INF / 2
            m_safe = m_new.masked_fill(dead, 0.0)
            alpha = torch.exp(m - m_safe).masked_fill(dead, 1.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(dead[..., None],
                                                             0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None]
            for h0 in range(k0, k1, TILE):
                h1 = min(k1, h0 + TILE)
                acc = acc + mm_split_tf32(p[..., h0 - k0:h1 - k0],
                                          v[:, h0:h1])
            m = m_new
        denom = torch.where(l <= 0.0, torch.ones_like(l), l)
        o[:, q0:q1] = acc / denom[..., None]
        lse[:, q0:q1] = torch.where(l <= 0.0, torch.zeros_like(l),
                                    m + torch.log(denom))
    return o, lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", FLASH_D)
@pytest.mark.parametrize("t", FLASH_T)
def test_split_tf32_forward_matches_jax(t, d, causal):
    """The forward's split-TF32 recurrence against the JAX package's
    forward (interpret-mode Pallas: O from ``flash_attention``, lse from
    the ``_flash_call`` it runs) and the port's plain forward, at BH 1 on
    the card tests' grid, under ``out_tolerance`` and ``lse_tolerance``."""
    q, k, v, _ = flash_inputs(flash_seed(1, t, d, causal), 1, t, d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x)[None] for x in (q, k, v))
    jo = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal,
                                        scale=scale, impl="interpret"))[0]
    _, jlse, _ = jfa._flash_call(jq, jk, jv, 256, 256, causal, scale, True)
    jlse = np.asarray(jlse)[:, 0, :t]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    so, slse = (x.numpy() for x in _split_forward(tq, tk, tv, causal, scale))
    po, plse = (x.numpy() for x in tfa.flash_fwd_plain(tq, tk, tv, causal,
                                                       scale))
    for want, what in ((jo, "JAX"), (po, "plain")):
        err = float(np.abs(so - want).max())
        assert err <= out_tolerance(want), f"O vs {what}: {err}"
    for want, what in ((jlse, "JAX"), (plse, "plain")):
        err = np.abs(slse - want)
        assert (err <= lse_tolerance(want)).all(), \
            f"lse vs {what}: {float(err.max())}"
