"""Ring attention over logical sequence shards — the port of the JAX
package's ``parallel/ring.py``.

Q, K and V are cut along the sequence into P logical shards of one
device, stacked shard-major as ``[P, B, H, t, D]``. Each shard keeps its
Q block and sees every shard's K/V block in turn: after ``s`` rotations
shard ``i`` holds the block that started on shard ``i - s``. The
reference's ``jax.lax.ppermute`` around the ring becomes ``torch.roll``
over the shard dim, and the per-block math is the online-softmax update
of :mod:`sparkucx_tpu_torch.ops.attention`, masked causally by global
offsets. There is no kernel on this path: it is torch ops, and autograd
differentiates it.

:func:`decode_qkv_rows` is the device-sink decode both attention
consumers share: packed shuffle rows (key = global position, value lanes
= fused ``q|k|v`` float32) back into sequence-ordered attention shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparkucx_tpu_torch.ops.attention import (NEG_INF, _block_update,
                                              _finalize, make_block_bias)

_POS_SENTINEL = 2 ** 31 - 1


def _ring_attention_sharded(q, k, v, causal: bool,
                            scale: Optional[float]) -> torch.Tensor:
    """q/k/v ``[P, B, H, t, D]`` shard-major; returns O in the same
    layout. P - 1 steps that each end with a rotation, then the last
    resident block without one, as in the reference."""
    p, t = q.shape[0], q.shape[3]
    scale_ = q.shape[-1] ** -0.5 if scale is None else scale
    o = [torch.zeros_like(q[i]) for i in range(p)]
    m = [torch.full(q.shape[1:-1], NEG_INF, dtype=q.dtype, device=q.device)
         for _ in range(p)]
    l = [torch.zeros(q.shape[1:-1], dtype=q.dtype, device=q.device)
         for _ in range(p)]
    k_blk, v_blk = k, v
    for s in range(p):
        for i in range(p):
            src = (i - s) % p         # where shard i's resident block began
            bias = make_block_bias(t, t, i * t, src * t, causal,
                                   device=q.device, dtype=q.dtype)
            o[i], m[i], l[i] = _block_update(q[i], k_blk[i], v_blk[i], o[i],
                                             m[i], l[i], bias, scale_)
        if s < p - 1:
            k_blk = torch.roll(k_blk, 1, dims=0)
            v_blk = torch.roll(v_blk, 1, dims=0)
    return torch.stack([_finalize(o[i], m[i], l[i]) for i in range(p)])


def shard_seq(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``[B, H, T, D]`` -> ``[P, B, H, T/P, D]`` (sequence shards)."""
    B, H, T, D = x.shape
    if T % num_shards:
        raise ValueError(f"seq len {T} not divisible by {num_shards} shards")
    return x.reshape(B, H, num_shards, T // num_shards, D).permute(
        2, 0, 1, 3, 4)


def unshard_seq(x: torch.Tensor) -> torch.Tensor:
    """``[P, B, H, t, D]`` -> ``[B, H, P*t, D]``."""
    P, B, H, t, D = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(B, H, P * t, D)


def decode_qkv_rows(rows: torch.Tensor, nvalid: torch.Tensor, t: int,
                    heads: int, head_dim: int):
    """Packed shuffle receive rows -> ``(q, k, v)`` on the rows' device.

    One shard: ``rows`` ``[cap, W]`` int32 and ``nvalid`` its valid row
    count (``[1]`` or a scalar) give each of q, k, v as
    ``[1, heads, t, head_dim]``. Batched: ``rows`` ``[P, cap, W]`` and
    ``nvalid`` ``[P]`` give ``[P, 1, heads, t, head_dim]``. Rows arrive
    partition-grouped but position-unordered: one argsort over the key's
    low word (the global position) restores sequence order, rows past
    ``nvalid`` sort to the tail and the ``[:t]`` slice drops them."""
    one = rows.dim() == 2
    if one:
        rows = rows[None]
        nvalid = nvalid.reshape(1)
    P, cap, _ = rows.shape
    j = torch.arange(cap, device=rows.device)
    valid = j[None, :] < nvalid.reshape(P, 1).to(rows.device)
    pos = torch.where(valid, rows[..., 0],
                      torch.full_like(rows[..., 0], _POS_SENTINEL))
    order = torch.argsort(pos, dim=1, stable=True)[:, :t]
    lanes = 3 * heads * head_dim
    shard = torch.arange(P, device=rows.device)[:, None]
    picked = rows[shard, order, 2:2 + lanes]          # [P, t, lanes]
    fused = picked.view(torch.float32).reshape(P, t, 3, heads, head_dim)
    qkv = fused.permute(2, 0, 3, 1, 4)[:, :, None]    # [3, P, 1, H, t, D]
    if one:
        qkv = qkv[:, 0]
    return qkv[0], qkv[1], qkv[2]


def _check_consumer_rows(rows: torch.Tensor, num_shards: int) -> None:
    if rows.dim() != 3 or rows.shape[0] != num_shards:
        raise ValueError(f"expected [{num_shards}, cap, W] receive rows, got "
                         f"{tuple(rows.shape)}")


def ring_attention_consumer(num_shards: int, tokens_per_shard: int,
                            heads: int, head_dim: int, causal: bool = False,
                            scale: Optional[float] = None):
    """Device-sink consumer for ring attention: ``step(rows, totals)``
    decodes a device-resident result's ``[P, cap, W]`` receive rows
    (sequence shards routed by the range partitioner) and runs the ring
    over them on the rows' device. Use as ``result.consume(lambda c, rows,
    totals: step(rows, totals))``; returns ``[1, heads, T, head_dim]``."""

    def step(rows, totals):
        _check_consumer_rows(rows, num_shards)
        q, k, v = decode_qkv_rows(rows, totals, tokens_per_shard, heads,
                                  head_dim)
        return unshard_seq(_ring_attention_sharded(q, k, v, causal, scale))

    return step


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_shards: int, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Global-view ring attention over ``num_shards`` logical sequence
    shards. ``q``/``k``/``v``: ``[B, H, T, D]`` with T divisible by
    ``num_shards``; returns ``[B, H, T, D]``. Differentiable."""
    if q.dim() != 4:
        raise ValueError(f"expected [B,H,T,D], got shape {tuple(q.shape)}")
    o = _ring_attention_sharded(shard_seq(q, num_shards),
                                shard_seq(k, num_shards),
                                shard_seq(v, num_shards), causal, scale)
    return unshard_seq(o)


__all__ = ["ring_attention", "ring_attention_consumer", "decode_qkv_rows"]
