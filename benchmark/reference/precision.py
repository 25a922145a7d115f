"""Float32 products with TF32 off, and the TF32 control.

The control rounds both operands of every matrix product to TF32's 10
explicit mantissa bits (round to nearest) and multiplies them in float32,
forward and backward alike. That is what the card's tensor cores do in
TF32 mode; emulating it keeps the control the same on the card and on
the CPU, where the tests run it."""

from __future__ import annotations

import torch

_ROUND = 0x1000           # half of the lowest kept mantissa bit (bit 13)
_KEEP = -0x2000           # 0xFFFFE000 as an int32: sign, exponent, 10 bits


def strict_float32() -> None:
    """Turn TF32 off for float32 products in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _ROUND) & _KEEP).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, tf32_round(b).transpose(-1, -2))
        gb = torch.matmul(tf32_round(a).transpose(-1, -2), g)
        # broadcast batch dims back to each operand's shape
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def matmul_for(tf32: bool):
    """The product the reference uses: ``torch.matmul`` in float32, or
    its TF32 control."""
    return _Tf32Matmul.apply if tf32 else torch.matmul
