"""The dense-contract exchange impls — torch ops over the P logical
shards of one device.

Each shard's send buffer ``data[p]`` is grouped by destination shard; the
``[P, P]`` size matrix says how many rows go where. The result holds, for
every receiver, the segments of all senders concatenated in sender order
from row 0, zero past the valid total — the JAX package's
``ragged_shuffle`` contract (``sparkucx_tpu/shuffle/alltoall.py``).

``local``  — one shard: the identity move.
``dense``  — pad every segment to ``peer_capacity``, transpose
             [sender, receiver], recompact.
``gather`` — every receiver gathers its rows straight out of every
             sender's buffer.

The chunk-aligned hand-kernel transport ('pallas') does not ride this
contract; the reader dispatches it (``reader._pallas_step_body``).
:func:`resolved_wire_impl` names the transport an exchange rides, for
the reports; the exchange-topology set (``ALLOWED_TOPOLOGIES``,
``validate_topology``: flat, hier, auto) is the config's, re-exported
here as the JAX package keeps it beside the impl set.

The int8 wire format (``a2a.wire=int8``) is defined here too:
:func:`wire_pack_rows` narrows the float32 value lanes of ``[P, cap, W]``
rows to int8 plus one float32 scale lane per row, and
:func:`wire_unpack_rows` expands them back; the key lanes stay exact.

The differentiable exchanges (the MoE dispatch and combine,
``models/moe.py``) ride the same contract: :func:`exchange` moves float
rows and its backward moves the cotangent under the transposed plan;
:func:`exchange_quantized` moves them on the int8 wire (the quantize
kernel through :func:`wire_pack_rows`), straight-through in the
backward, which is itself an int8 move. Both also take a leading group
axis, ``[G, P, cap, ...]`` with ``[G, P, P]`` sizes: G independent
exchanges among P shards each (the data-parallel rows of an
expert-parallel grid), whose int8 rows quantize in one launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from sparkucx_tpu_torch.config import (ALLOWED_IMPLS, ALLOWED_TOPOLOGIES,
                                       validate_impl, validate_topology)
from sparkucx_tpu_torch.meta.segments import exchange_plan
from sparkucx_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

# the impls ragged_shuffle dispatches itself
IMPLS = ("local", "dense", "gather")

# distinct noise streams one step may draw from one base seed (forward
# dispatch, forward combine, spare, backward), as in the JAX package
WIRE_SEED_STREAMS = 4

__all__ = ["ALLOWED_IMPLS", "ALLOWED_TOPOLOGIES", "IMPLS", "ShuffleResult",
           "WIRE_SEED_STREAMS", "exchange", "exchange_quantized",
           "group_shuffle", "int8_wire_words", "ragged_shuffle",
           "resolved_wire_impl", "select_impl", "shared_uniforms",
           "validate_impl", "validate_topology", "wire_noise_seed",
           "wire_pack_rows", "wire_uniforms", "wire_unpack_rows"]


def wire_noise_seed(seed: int, stream: int) -> int:
    """Noise stream ``stream`` (< WIRE_SEED_STREAMS) of a base step seed,
    in the int32 ring: no two int8 moves of one step share a rounding
    noise realization."""
    return int((int(seed) * WIRE_SEED_STREAMS + int(stream)) & 0x7FFFFFFF)


def int8_wire_words(value_words: int) -> int:
    """int32 lanes ``value_words`` float32 lanes cost on the int8 wire:
    the int8 values packed four to a word, plus one float32 scale."""
    return -(-int(value_words) // 4) + 1


def wire_uniforms(shape, seeds: Sequence[int],
                  device: torch.device) -> torch.Tensor:
    """The rounding noise of one int8 exchange: ``[P, cap, wire_words]``
    float32 uniforms in [0, 1), shard ``p`` drawn from its own
    ``torch.Generator`` seeded with ``seeds[p]``."""
    P = int(shape[0])
    if len(seeds) != P:
        raise ValueError(f"{len(seeds)} seeds for {P} shards")
    u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    for p in range(P):
        g = torch.Generator(device=device)
        g.manual_seed(int(seeds[p]))
        torch.rand(tuple(shape[1:]), generator=g, out=u[p])
    return u


def wire_pack_rows(rows: torch.Tensor, wire_words: int,
                   u: torch.Tensor) -> torch.Tensor:
    """Narrow the trailing ``wire_words`` float32-bit-pattern lanes of
    ``[..., W]`` int32 rows to the int8 wire format:
    ``[..., W - wire_words + int8_wire_words(wire_words)]`` = the head
    lanes copied exactly, the int8 values padded to a multiple of 4 with
    zero bytes and viewed as int32 (byte ``j % 4`` of word ``j // 4``,
    little-endian: the bytes of the JAX package's bitcast), then the
    row's float32 scale bits. ``u`` is ``[..., wire_words]`` (see
    :func:`wire_uniforms`)."""
    lead, width = tuple(rows.shape[:-1]), rows.shape[-1]
    head = width - wire_words
    if wire_words <= 0 or head < 0:
        raise ValueError(f"wire_words={wire_words} out of (0, {width}]")
    n = 1
    for d in lead:
        n *= int(d)
    vals = rows[..., head:].reshape(n, wire_words).contiguous() \
        .view(torch.float32)
    q, scale = quantize_rows(vals, u.reshape(n, wire_words))
    pad = (-wire_words) % 4
    if pad:
        q = torch.cat([q, q.new_zeros((n, pad))], dim=1)
    qi = q.view(torch.int32)
    si = scale.view(torch.int32)
    out = torch.cat([rows[..., :head].reshape(n, head), qi, si], dim=1)
    return out.reshape(lead + (out.shape[1],))


def wire_unpack_rows(rows: torch.Tensor, width: int,
                     wire_words: int) -> torch.Tensor:
    """Inverse of :func:`wire_pack_rows` up to the rounding noise:
    ``[..., W']`` wire rows -> ``[..., width]`` rows whose value lanes
    hold ``int8 * scale`` as float32 bits. Zero wire rows (transport pad)
    decode to zero rows."""
    lead = tuple(rows.shape[:-1])
    head = width - wire_words
    qw = -(-wire_words // 4)
    if rows.shape[-1] != head + qw + 1:
        raise ValueError(f"wire rows are {rows.shape[-1]} lanes; width "
                         f"{width} with wire_words={wire_words} packs to "
                         f"{head + qw + 1}")
    n = 1
    for d in lead:
        n *= int(d)
    flat = rows.reshape(n, rows.shape[-1])
    q = flat[:, head:head + qw].contiguous().view(torch.int8)[:, :wire_words]
    scale = flat[:, head + qw:].contiguous().view(torch.float32)
    vals = dequantize_rows(q, scale).view(torch.int32)
    out = torch.cat([flat[:, :head], vals], dim=1)
    return out.reshape(lead + (width,))


@dataclass
class ShuffleResult:
    """Outcome of one exchange over all shards.

    ``data``       [P, out_capacity, ...] received rows, packed from 0.
    ``recv_sizes`` [P, P] rows receiver p got from each sender.
    ``total``      [P] valid prefix of each receiver's ``data``.
    ``overflow``   0-d bool: a capacity was exceeded on some shard; the
                   data is garbage and the caller retries bigger."""

    data: torch.Tensor
    recv_sizes: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor


def select_impl(impl: str, num_shards: int) -> str:
    """Resolve what ``ragged_shuffle`` runs: 'auto' takes the local move
    for one shard and dense otherwise; an explicit dense-contract impl is
    honoured."""
    if impl == "auto":
        return "local" if num_shards == 1 else "dense"
    if impl not in IMPLS:
        validate_impl(impl)
        raise ValueError(f"impl {impl!r} has no dense-contract exchange; "
                         f"the reader dispatches it")
    return impl


def resolved_wire_impl(impl: str, num_shards: int) -> str:
    """The transport an exchange with this (impl, shard count) rides, for
    reports and the real-bytes accounting: the segment move for
    'pallas', the one-shard local move under 'auto', else
    :func:`select_impl`'s."""
    if impl == "pallas":
        return "pallas"
    return select_impl(impl, num_shards)


def _global_overflow(sizes: torch.Tensor, total: torch.Tensor,
                     data_rows: int, out_capacity: int) -> torch.Tensor:
    """True if ANY shard would overrun its output capacity (receive side)
    or claims more rows than its send buffer holds (send side)."""
    return (total > out_capacity).any() \
        | (sizes.sum(dim=1) > data_rows).any()


def _compact_from_segments(recv_sizes: torch.Tensor, out_capacity: int):
    """[Q, out_capacity] (sender, within-segment row, valid) indices that
    concatenate each of the Q receivers' ragged segments (``recv_sizes``
    ``[Q, S]``: rows receiver q gets from each of S senders)."""
    Q, S = recv_sizes.shape
    recv_cum = torch.cumsum(recv_sizes, dim=1, dtype=torch.int32)
    j = torch.arange(out_capacity, dtype=torch.int32,
                     device=recv_sizes.device).expand(Q, -1).contiguous()
    sender = torch.searchsorted(recv_cum, j, right=True)
    sender_c = torch.clamp(sender, max=S - 1)
    excl = recv_cum - recv_sizes
    within = j - torch.gather(excl, 1, sender_c)
    valid = j < recv_cum[:, -1:]
    return sender_c, within, valid


def _masked(out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    shape = valid.shape + (1,) * (out.dim() - valid.dim())
    return torch.where(valid.reshape(shape), out, torch.zeros_like(out))


def _a2a_local(data, sizes, out_capacity):
    total = sizes.sum(dim=1, dtype=torch.int32)
    overflow = ((total > out_capacity) | (total > data.shape[1])).any()
    cap_in = data.shape[1]
    if out_capacity <= cap_in:
        out = data[:, :out_capacity]
    else:
        pad = torch.zeros((data.shape[0], out_capacity - cap_in)
                          + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        out = torch.cat([data, pad], dim=1)
    j = torch.arange(out_capacity, device=data.device)
    return ShuffleResult(_masked(out, j[None, :] < total[:, None]),
                         sizes.to(torch.int32), total, overflow)


def _a2a_gather(data, sizes, out_capacity):
    in_off, _, _, recv, total = exchange_plan(sizes)
    cap_in = data.shape[1]
    sender, within, valid = _compact_from_segments(recv, out_capacity)
    # receiver p's row k comes from sender s at in_off[s, p] + within
    recv_idx = torch.arange(sizes.shape[1], device=data.device)[:, None]
    src = in_off[sender, recv_idx] + within
    src = torch.clamp(src, 0, cap_in - 1)
    out = data[sender.to(torch.int64), src.to(torch.int64)]
    overflow = _global_overflow(sizes, total, cap_in, out_capacity)
    return ShuffleResult(_masked(out, valid), recv, total, overflow)


def _a2a_dense(data, sizes, out_capacity, peer_capacity):
    """The dense move; ``sizes`` may be rectangular, ``[S, Q]``: S
    senders, Q receivers (a distributed process's receivers are a block
    of the global shards, ``shuffle/distributed.py``)."""
    in_off, send, _, recv, total = exchange_plan(sizes)
    S, cap_in = data.shape[0], data.shape[1]
    Q = sizes.shape[1]
    k = torch.arange(peer_capacity, dtype=torch.int32, device=data.device)
    # padded[s, q, k] = data[s, in_off[s, q] + k]
    src = torch.clamp(in_off[:, :, None] + k, max=cap_in - 1)
    sidx = torch.arange(S, device=data.device)[:, None, None]
    padded = _masked(data[sidx, src.to(torch.int64)],
                     k[None, None, :] < send[:, :, None])
    swapped = padded.transpose(0, 1)          # [receiver, sender, k]
    sender, within, valid = _compact_from_segments(recv, out_capacity)
    within_c = torch.clamp(within, 0, peer_capacity - 1)
    ridx = torch.arange(Q, device=data.device)[:, None]
    out = swapped[ridx, sender.to(torch.int64), within_c.to(torch.int64)]
    seg_bad = (send.max() > peer_capacity) | (recv.max() > peer_capacity)
    overflow = _global_overflow(sizes, total, cap_in, out_capacity) | seg_bad
    return ShuffleResult(_masked(out, valid), recv, total, overflow)


def ragged_shuffle(data: torch.Tensor, sizes: torch.Tensor, *,
                   out_capacity: int, peer_capacity: Optional[int] = None,
                   impl: str = "auto") -> ShuffleResult:
    """One exchange of destination-grouped rows between the P shards.

    ``data``  [P, cap_in, ...] send buffers, rows grouped by destination
              shard in ascending order; rows past ``sizes[p].sum()`` are
              padding and never sent.
    ``sizes`` [P, P] rows shard p sends to shard q (``dense`` and
              ``gather`` also take a rectangular ``[P, Q]``: Q receivers).
    ``peer_capacity`` the dense move's per-segment pad (default
              ``out_capacity``)."""
    if data.dim() < 2:
        raise ValueError("data must be [P, cap_in, ...]")
    impl = select_impl(impl, data.shape[0])
    if impl == "local":
        return _a2a_local(data, sizes, out_capacity)
    if impl == "gather":
        return _a2a_gather(data, sizes, out_capacity)
    if peer_capacity is None:
        peer_capacity = out_capacity
    return _a2a_dense(data, sizes, out_capacity, peer_capacity)


# -- differentiable exchanges -------------------------------------------------
# (seed, [n, w] shape of one shard's rows, device) -> [n, w] float32
# uniforms that every shard of the move rounds with
Uniforms = Callable[[int, tuple, torch.device], torch.Tensor]


def shared_uniforms(seed: int, shape, device: torch.device) -> torch.Tensor:
    """The rounding noise of one differentiable int8 move: ``[n, w]``
    float32 uniforms from :func:`wire_uniforms` seeded with ``seed``. The
    seed is the same on every shard (the JAX package replicates it), so
    every shard rounds with these same uniforms."""
    return wire_uniforms((1,) + tuple(shape), [seed], device)[0]


def group_shuffle(data: torch.Tensor, sizes: torch.Tensor,
                  out_capacity: int, impl: str = "auto"):
    """:func:`ragged_shuffle` of each group of ``[G, P, cap, ...]`` rows
    under its ``[G, P, P]`` sizes, G independent exchanges: (data ``[G, P,
    out_capacity, ...]``, recv_sizes ``[G, P, P]``, overflow ``[G]``
    bool)."""
    rs = [ragged_shuffle(data[g], sizes[g], out_capacity=out_capacity,
                         impl=impl) for g in range(data.shape[0])]
    return (torch.stack([r.data for r in rs]),
            torch.stack([r.recv_sizes for r in rs]),
            torch.stack([r.overflow for r in rs]))


def _poisoned(out: torch.Tensor, overflow: torch.Tensor) -> torch.Tensor:
    """``out`` plus NaN in every group whose exchange overflowed (plus 0
    elsewhere, as the JAX package adds it), on the device: no host sync."""
    flag = overflow.reshape((-1,) + (1,) * (out.dim() - 1))
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return out + torch.where(flag, nan, torch.zeros_like(nan))


# the ``pass`` attr of the differentiable moves' ``moe.exchange`` spans
_FORWARD = {"pass": "forward"}
_BACKWARD = {"pass": "backward"}


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sizes, out_capacity, impl):
        with GLOBAL_TRACER.span("moe.exchange", device_time=data.device,
                                **_FORWARD):
            out, recv, overflow = group_shuffle(data, sizes, out_capacity,
                                                impl)
            if out.is_floating_point():
                out = _poisoned(out, overflow)
        ctx.save_for_backward(recv)
        ctx.cap_in, ctx.impl = data.shape[2], impl
        return out

    @staticmethod
    def backward(ctx, g):
        # the transposed plan: receiver p sends recv_sizes[p, s] rows back
        # to sender s, landing in the sender's original layout
        recv, = ctx.saved_tensors
        with GLOBAL_TRACER.span("moe.exchange", device_time=g.device,
                                **_BACKWARD):
            gb, _, _ = group_shuffle(g.contiguous(), recv, ctx.cap_in,
                                     ctx.impl)
        return gb, None, None, None


def _grouped(data: torch.Tensor, sizes: torch.Tensor):
    """(data, sizes, grouped?) with a group axis of 1 added to the plain
    ``[P, cap, ...]`` / ``[P, P]`` form."""
    if sizes.dim() == 2:
        return data.unsqueeze(0), sizes.unsqueeze(0), False
    if sizes.dim() != 3 or data.dim() < 3 \
            or tuple(sizes.shape) != (data.shape[0], data.shape[1],
                                      data.shape[1]):
        raise ValueError(f"sizes {tuple(sizes.shape)} do not fit data "
                         f"{tuple(data.shape)}: want [P, P] for [P, cap, ...]"
                         f" or [G, P, P] for [G, P, cap, ...]")
    return data, sizes, True


def exchange(data: torch.Tensor, sizes: torch.Tensor, out_capacity: int,
             impl: str = "auto") -> torch.Tensor:
    """Differentiable ragged exchange (the JAX package's ``exchange``).

    Forward: :func:`ragged_shuffle` of destination-grouped rows ``data``
    ``[P, cap_in, ...]`` under ``sizes`` ``[P, P]``, returning the packed
    receive buffers ``[P, out_capacity, ...]``; with a leading group axis
    (``[G, P, cap_in, ...]``, ``[G, P, P]``) each group is its own
    exchange. A float output of a group whose exchange overflowed is NaN
    (no retry loop runs inside a training step, so the loss goes NaN);
    integer payloads are never poisoned. Backward: the same move of the
    cotangent under the transposed plan, back into each sender's layout;
    sizes get no gradient."""
    d, s, grouped = _grouped(data, sizes)
    impl = select_impl(impl, d.shape[1])
    out = _Exchange.apply(d, s, int(out_capacity), impl)
    return out if grouped else out[0]


def _quantized_move(data: torch.Tensor, sizes: torch.Tensor,
                    out_capacity: int, impl: str, seed: int,
                    uniforms: Uniforms):
    """One int8-wire move of ``[G, P, n, w]`` float rows: every row packed
    to int8 + a float32 scale (one quantize launch for all shards, the
    uniforms for seed ``seed`` shared by every shard), moved, unpacked and
    cast back to ``data``'s dtype; (rows, recv_sizes)."""
    G, P, n, w = data.shape
    rows = data.to(torch.float32).contiguous().view(torch.int32)
    u = uniforms(int(seed), (n, w), data.device)
    packed = wire_pack_rows(rows, w, u.expand(G, P, n, w))
    moved, recv, overflow = group_shuffle(packed, sizes, out_capacity, impl)
    out = wire_unpack_rows(moved, w, w).view(torch.float32)
    return _poisoned(out, overflow).to(data.dtype), recv


class _ExchangeQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sizes, seed, out_capacity, impl, uniforms):
        with GLOBAL_TRACER.span("moe.exchange", device_time=data.device,
                                wire="int8", **_FORWARD):
            out, recv = _quantized_move(data, sizes, out_capacity, impl,
                                        seed, uniforms)
        ctx.save_for_backward(recv)
        ctx.cap_in, ctx.impl, ctx.seed = data.shape[2], impl, seed
        ctx.uniforms = uniforms
        return out

    @staticmethod
    def backward(ctx, g):
        # straight-through: the cotangent takes the transposed int8 move,
        # on noise stream 3 of this move's seed
        recv, = ctx.saved_tensors
        with GLOBAL_TRACER.span("moe.exchange", device_time=g.device,
                                wire="int8", **_BACKWARD):
            gb, _ = _quantized_move(g, recv, ctx.cap_in, ctx.impl,
                                    wire_noise_seed(ctx.seed, 3),
                                    ctx.uniforms)
        return gb, None, None, None, None, None


def exchange_quantized(data: torch.Tensor, sizes: torch.Tensor, seed: int,
                       out_capacity: int, impl: str = "auto",
                       uniforms: Optional[Uniforms] = None) -> torch.Tensor:
    """Differentiable ragged exchange on the int8 wire (the JAX package's
    ``exchange_quantized``): :func:`exchange`'s contract for float rows
    ``[P, cap_in, w]`` (or ``[G, P, cap_in, w]``), each row stochastically
    rounded to int8 with a float32 scale (:func:`wire_pack_rows` with no
    exact lanes), moved, and dequantized into ``data``'s dtype. ``seed``
    picks the rounding noise (thread a step counter through it); the
    backward is straight-through and moves the cotangent on the int8 wire
    too, with noise ``wire_noise_seed(seed, 3)``. ``uniforms`` replaces
    :func:`shared_uniforms` as the noise source (tests hand in another
    package's draws with it)."""
    d, s, grouped = _grouped(data, sizes)
    if d.dim() != 4 or not d.is_floating_point():
        raise ValueError(f"exchange_quantized moves float rows [P, cap, w],"
                         f" got {tuple(data.shape)} {data.dtype}")
    impl = select_impl(impl, d.shape[1])
    out = _ExchangeQuantized.apply(d, s, int(seed), int(out_capacity), impl,
                                   uniforms or shared_uniforms)
    return out if grouped else out[0]
