"""Ulysses attention over logical sequence shards — the port of the JAX
package's ``parallel/ulysses.py``.

Each of P logical shards trades its sequence shard of all heads for the
full sequence of its ``H/P`` heads (the reference's first
``jax.lax.all_to_all``), attention runs exactly on those heads, and the
inverse trade restores sequence shards. On one device the two trades are
permutes of the shard-major ``[P, B, H, t, D]`` tensor, and all shards'
head groups go through ONE :func:`flash_attention` call over
``[B, H, T, D]`` (one launch of each kernel) instead of one call per
shard: the heads are independent, so the outputs equal the reference's
per-shard calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparkucx_tpu_torch.ops.flash_attention import flash_attention
from sparkucx_tpu_torch.parallel.ring import (_check_consumer_rows,
                                              decode_qkv_rows, shard_seq,
                                              unshard_seq)


def _to_heads(x: torch.Tensor) -> torch.Tensor:
    """Sequence shards ``[P, B, H, t, D]`` -> head shards
    ``[P, B, H/P, P*t, D]``: shard j gets head group j of every shard's
    sequence block, in shard order (the all-to-all's split axis 1,
    concat axis 2)."""
    P, B, H, t, D = x.shape
    return x.reshape(P, B, P, H // P, t, D).permute(2, 1, 3, 0, 4, 5) \
        .reshape(P, B, H // P, P * t, D)


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    """Head shards ``[P, B, H/P, T, D]`` -> sequence shards
    ``[P, B, H, T/P, D]``, the inverse of :func:`_to_heads`."""
    P, B, Hp, T, D = x.shape
    t = T // P
    return x.reshape(P, B, Hp, P, t, D).permute(3, 1, 0, 2, 4, 5) \
        .reshape(P, B, P * Hp, t, D)


def _ulysses_sharded(q, k, v, causal: bool, scale: Optional[float],
                     block_q: int, block_k: int, impl: str) -> torch.Tensor:
    """q/k/v ``[P, B, H, t, D]`` sequence shards -> O in the same layout."""
    P, B, H, t, D = q.shape
    qh, kh, vh = _to_heads(q), _to_heads(k), _to_heads(v)

    def heads_major(x):       # [P, B, H/P, T, D] -> [B, H, T, D]
        return x.transpose(0, 1).reshape(B, H, P * t, D)

    oh = flash_attention(heads_major(qh), heads_major(kh), heads_major(vh),
                         block_q=block_q, block_k=block_k, causal=causal,
                         scale=scale, impl=impl)
    oh = oh.reshape(B, P, H // P, P * t, D).transpose(0, 1)
    return _to_seq(oh)


def _check_heads(heads: int, num_shards: int) -> None:
    if heads % num_shards != 0:
        raise ValueError(
            f"num_heads {heads} not divisible by {num_shards} shards; use "
            f"ring_attention for head counts below the shard count")


def ulysses_attention_consumer(num_shards: int, tokens_per_shard: int,
                               heads: int, head_dim: int,
                               causal: bool = False,
                               scale: Optional[float] = None,
                               block_q: int = 256, block_k: int = 512,
                               impl: str = "auto"):
    """Device-sink consumer for Ulysses attention: ``step(rows, totals)``
    decodes a device-resident result's ``[P, cap, W]`` sequence shards
    (:func:`~sparkucx_tpu_torch.parallel.ring.decode_qkv_rows`, the decode
    the ring consumer shares) and runs the head/sequence trade and the
    attention on the rows' device. Use as ``result.consume(lambda c, rows,
    totals: step(rows, totals))``; returns ``[1, heads, T, head_dim]``.
    Requires ``heads % num_shards == 0``."""
    _check_heads(heads, num_shards)

    def step(rows, totals):
        _check_consumer_rows(rows, num_shards)
        q, k, v = decode_qkv_rows(rows, totals, tokens_per_shard, heads,
                                  head_dim)
        return unshard_seq(_ulysses_sharded(q, k, v, causal, scale, block_q,
                                            block_k, impl))

    return step


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_shards: int, causal: bool = False,
                      scale: Optional[float] = None, block_q: int = 256,
                      block_k: int = 512, impl: str = "auto") -> torch.Tensor:
    """Global-view Ulysses attention over ``num_shards`` logical sequence
    shards. ``q``/``k``/``v``: ``[B, H, T, D]``; H and T must divide by
    ``num_shards``. Returns ``[B, H, T, D]``. Differentiable."""
    if q.dim() != 4:
        raise ValueError(f"expected [B,H,T,D], got shape {tuple(q.shape)}")
    _check_heads(q.shape[1], num_shards)
    o = _ulysses_sharded(shard_seq(q, num_shards), shard_seq(k, num_shards),
                         shard_seq(v, num_shards), causal, scale, block_q,
                         block_k, impl)
    return unshard_seq(o)


__all__ = ["ulysses_attention", "ulysses_attention_consumer"]
