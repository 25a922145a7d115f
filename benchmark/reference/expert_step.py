"""Plain reference of the read-path expert step: each expert trains on the
tokens routed to it against a reconstruction loss, by one SGD step.

For tokens ``x [N, D]`` with expert ids ``e [N]`` and expert weights
``w1 [E, D, H]``, ``w2 [E, H, D]``::

    y_n  = gelu_tanh(x_n @ w1[e_n]) @ w2[e_n]
    loss = sum_n |y_n - x_n|^2 / (N * D)
    w   <- w - lr * dloss/dw

The gradient is written out by hand (two products and the GELU's
derivative), so the control can round every product to TF32."""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import matmul_for

_C = math.sqrt(2.0 / math.pi)
_A = 0.044715


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_C * (x + _A * x * x * x)))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_C * (x + _A * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _C \
        * (1.0 + 3.0 * _A * x * x)


def group_by_expert(x: torch.Tensor, eids: torch.Tensor, experts: int):
    """The tokens of each expert, ``[x[eids == e] for e in experts]``."""
    return [x[eids == e] for e in range(experts)]


def sgd_step(w1: torch.Tensor, w2: torch.Tensor, groups, lr: float,
             tf32: bool = False):
    """One step over one batch, given as :func:`group_by_expert`'s
    groups: ``(w1', w2', loss)``; the inputs are left unchanged."""
    mm = matmul_for(tf32)
    n = sum(int(xe.shape[0]) for xe in groups)
    denom = float(n * w1.shape[1])
    g1 = torch.zeros_like(w1)
    g2 = torch.zeros_like(w2)
    total = torch.zeros((), dtype=torch.float64, device=w1.device)
    for e, xe in enumerate(groups):
        if xe.shape[0] == 0:
            continue
        pre = mm(xe, w1[e])
        h = gelu_tanh(pre)
        err = mm(h, w2[e]) - xe
        total += (err.double() ** 2).sum()
        dy = err * (2.0 / denom)
        g2[e] = mm(h.t(), dy)
        dpre = mm(dy, w2[e].t()) * gelu_tanh_grad(pre)
        g1[e] = mm(xe.t(), dpre)
    return w1 - lr * g1, w2 - lr * g2, float(total / denom)
