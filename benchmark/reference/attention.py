"""Plain reference of causal multi-head attention, in blocks of query rows
so that the scores of one block fit on the card::

    O_h = softmax(Q_h K_h^T * scale + causal mask) V_h
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import matmul_for


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, tf32: bool = False,
                     block: int = 8192) -> torch.Tensor:
    """``q, k, v [H, T, D]`` float32 -> ``O [H, T, D]``."""
    mm = matmul_for(tf32)
    H, T, _ = q.shape
    out = torch.empty_like(q)
    for h in range(H):
        for lo in range(0, T, block):
            hi = min(T, lo + block)
            s = mm(q[h, lo:hi], k[h, :hi].t()) * scale      # [b, hi]
            rows = torch.arange(lo, hi, device=q.device)[:, None]
            cols = torch.arange(hi, device=q.device)[None, :]
            s.masked_fill_(cols > rows, float("-inf"))
            p = torch.softmax(s, dim=-1)
            del s
            out[h, lo:hi] = mm(p, v[h, :hi])
            del p
    return out
