"""Attention cases shared by the CPU parity tests and the card tests: the
flash-kernel grid, seeded inputs and the stated tolerances. Imports
neither JAX nor the JAX package, so the card tests can use it on a
machine that has only PyTorch."""

import numpy as np

# the flash_kernels grid: lengths off and on the 64-row tile, every
# compiled head dim the port's callers use, one and several heads
FLASH_T = (1, 33, 97, 130, 256, 1000)
FLASH_D = (8, 32, 64, 128)
FLASH_BH = (1, 6)


def flash_inputs(seed: int, bh: int, t: int, d: int):
    """q, k, v, g ``[bh, t, d]`` float32, standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, t, d)).astype(np.float32)
                 for _ in range(4))


def flash_seed(bh: int, t: int, d: int, causal: bool) -> int:
    return bh * 1_000_003 + t * 1009 + d * 7 + int(causal)


def out_tolerance(want):
    """O: 1e-4 of the largest |O| plus 1e-6 (float32 sums taken in
    another order over up to T terms)."""
    return 1e-4 * float(np.abs(want).max(initial=0.0)) + 1e-6


def lse_tolerance(want):
    """lse: 1e-5 relative to (1 + |lse|), elementwise."""
    return 1e-5 * (1.0 + np.abs(want))


def grad_tolerance(want, plain_err: float = 0.0):
    """dq, dk, dv: 1e-3 of the largest |grad| plus the larger of 1e-5 and
    four times ``plain_err``, the plain version's own largest distance
    from a float64 reference on the same inputs. Where a gradient
    vanishes (one key: dS = P (dP - delta) cancels) both float32 versions
    hold only the rounding of dP - delta, whose terms are as large as
    |dO| |V| summed over D: measured against float64, the plain version
    sits 2e-6 to 5e-6 away at D = 128, and the kernel, summing in
    another order, as far again; a 1e-6 floor would fail them on
    rounding alone."""
    return 1e-3 * float(np.abs(want).max(initial=0.0)) + max(
        1e-5, 4.0 * plain_err)


def float64_grads(q, k, v, g, causal: bool, scale: float):
    """O and (dq, dk, dv) of ``[BH, T, D]`` attention in float64 by
    autograd through ``reference_attention``: the truth the float32
    plain versions are measured against."""
    import torch

    from sparkucx_tpu_torch.ops.attention import reference_attention
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    o = reference_attention(*(x[None] for x in leaves), causal=causal,
                            scale=scale)[0]
    return o.detach(), torch.autograd.grad(o, leaves, g.double())


def qkv_rows(seed: int, heads: int, head_dim: int, total: int):
    """Fused ``q|k|v`` float32 rows ``[total, 3, heads, head_dim]`` and a
    permutation of the positions (the order the maps write them in)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((total, 3, heads, head_dim)).astype(np.float32)
    return qkv, rng.permutation(total)


def tf32_round(x):
    """``cvt.rna.tf32.f32`` on a float32 tensor: round to nearest, ties away
    from zero, on the low 13 mantissa bits (which come out zero). Adding
    half of the dropped unit to the sign-magnitude bit pattern rounds the
    magnitude up at a tie whatever the sign."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x):
    """What the tensor core reads from a float32 register as a TF32
    operand: the low 13 mantissa bits dropped (toward zero)."""
    import torch
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """The backward kernels' split of a float32 operand, (big, small), both
    TF32: big = x rounded to nearest, small = x - big as the tensor core
    reads it (truncated), as in CUTLASS's fast float32 products."""
    big = tf32_round(x)
    return big, tf32_truncate(x - big)


def mm_split_tf32(a, b):
    """``a @ b`` as the backward kernels take it on the tensor cores:
    a_big b_big + a_small b_big + a_big b_small (3xTF32; the cross terms
    summed apart, as the kernels sum dP's). A TF32 x TF32 product is exact
    in float32, so on the CPU each of the three is a float32 product of
    the split operands, summed in float32."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return ab @ bb + (as_ @ bb + ab @ bs)
