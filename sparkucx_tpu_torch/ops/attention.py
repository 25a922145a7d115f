"""Attention core ops in torch — the port of the JAX package's
``ops/attention.py``: the plain oracle, the online-softmax block update
the ring streams through, and the blockwise (``scan``) attention.

Conventions as in the reference: tensors are ``[batch, heads, seq,
head_dim]`` (B, H, T, D); the softmax scale defaults to ``D ** -0.5``;
masks are additive biases of 0 or :data:`NEG_INF`. These are plain torch
ops, which is what the reference computes here outside any kernel;
autograd differentiates them directly.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite "-inf": keeps exp()/where() NaN-free under masking


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain O(T^2)-memory softmax attention; the test oracle."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(col <= row + (tk - tq), logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _block_update(q, k_blk, v_blk, o, m, l, bias, scale):
    """One online-softmax accumulation step (the flash-attention
    recurrence). ``o`` [B,H,Tq,D] unnormalised accumulator, ``m`` [B,H,Tq]
    running max, ``l`` [B,H,Tq] running denominator, ``bias`` [Tq, Tk]
    additive mask (or None). Fully-masked rows stay NaN-free: m stays
    NEG_INF, the correction factor is 1 and the block adds 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    if bias is not None:
        s = s + bias[None, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    dead = m_new <= NEG_INF / 2
    m_safe = torch.where(dead, torch.zeros_like(m_new), m_new)
    alpha = torch.where(dead, torch.ones_like(m_new), torch.exp(m - m_safe))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(dead[..., None], torch.zeros_like(p), p)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
    return o_new, m_new, l_new


def _finalize(o, m, l):
    """Normalise the accumulator; fully-masked rows yield zeros."""
    denom = torch.where(l <= 0.0, torch.ones_like(l), l)
    return o / denom[..., None]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_k: int = 512, causal: bool = False,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention: stream K/V in blocks with online
    softmax (the reference's ``lax.scan`` as a Python loop).
    ``q_offset`` is the global position of ``q``'s first row."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, H, Tk, D = k.shape
    Tq = q.shape[2]
    block_k = min(block_k, Tk)
    if Tk % block_k != 0:
        raise ValueError(f"seq len {Tk} not divisible by block_k {block_k}")
    row = q_offset + torch.arange(Tq, device=q.device)[:, None]
    col0 = torch.arange(block_k, device=q.device)[None, :]
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for j in range(Tk // block_k):
        sl = slice(j * block_k, (j + 1) * block_k)
        bias = None
        if causal:
            bias = torch.where(j * block_k + col0 <= row, 0.0, NEG_INF).to(
                q.dtype)
        o, m, l = _block_update(q, k[:, :, sl], v[:, :, sl], o, m, l, bias,
                                scale)
    return _finalize(o, m, l)


def make_block_bias(tq: int, tk: int, q_offset: int, k_offset: int,
                    causal: bool, device=None,
                    dtype=torch.float32) -> Optional[torch.Tensor]:
    """[tq, tk] additive bias for a (q-block, kv-block) pair at global
    offsets, or None when not causal."""
    if not causal:
        return None
    row = q_offset + torch.arange(tq, device=device)[:, None]
    col = k_offset + torch.arange(tk, device=device)[None, :]
    return torch.where(col <= row, 0.0, NEG_INF).to(dtype)


__all__ = [
    "NEG_INF", "reference_attention", "blockwise_attention",
    "make_block_bias", "_block_update", "_finalize",
]
