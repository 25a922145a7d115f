"""Expert-parallel MoE riding the shuffle data plane — the port of the
JAX package's ``models/moe.py``.

Top-1 routing, then the expert dispatch and the combine are the port's
own differentiable exchanges (:func:`~sparkucx_tpu_torch.shuffle.
alltoall.exchange`, or :func:`~sparkucx_tpu_torch.shuffle.alltoall.
exchange_quantized` on the int8 wire), so a training step drives the
data plane forward and, through the transposed exchanges, backward.

Grid: ``dp x ep`` logical shards on one device, shard ``(i, j)`` at
index ``i * ep + j`` (the JAX package's ``P((dp, ep))`` order), so the
global tokens ``[B, D]`` are ``x.reshape(dp, ep, T, D)``. Experts are
split over ``ep`` and shared over ``dp``; dispatch and combine cross
only the ``ep`` axis within each dp row (one exchange group per row),
and the shared parameters sum the dp rows' gradients through autograd.

Capacity: tokens past an expert's capacity are dropped (they contribute
zero); an exchange overflow NaN-poisons the activations, so a collapsed
router turns the loss NaN instead of silently zeroing the batch.

Read-path dispatch: :func:`stage_tokens_by_expert`,
:func:`make_device_dispatch_step` (the device-sink consumer of a
``read(sink="device")``) and :func:`host_staged_consume` (the same step
behind a host round trip).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.ops.partition import (blocked_partition_map,
                                              counts_from_sorted)
from sparkucx_tpu_torch.shuffle.alltoall import (Uniforms, exchange,
                                                 exchange_quantized,
                                                 group_shuffle,
                                                 int8_wire_words,
                                                 wire_noise_seed)
from sparkucx_tpu_torch.shuffle.reader import pack_rows
from sparkucx_tpu_torch.utils.metrics import (C_H2D, C_MOE_EXCHANGES,
                                              C_MOE_ROWS, C_PAYLOAD_BYTES,
                                              C_WIRE_BYTES, Metrics)

Params = Dict[str, torch.Tensor]
PARAM_NAMES = ("router", "w1", "w2", "wout")
# rows of each router product (router_logits)
ROUTER_BLOCK = 4096


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_hidden: int = 128
    num_experts: int = 8
    tokens_per_shard: int = 64     # tokens of each (dp, ep) shard
    capacity_factor: float = 2.0   # exchange + expert capacity headroom
    impl: str = "auto"             # exchange implementation
    # wire tier of the dispatch and combine: "raw" moves exact float32
    # rows, "int8" the int8 + per-row scale rows of a2a.wire=int8 (a
    # straight-through gradient); "f32" is an alias of "raw"
    wire: str = "raw"

    @property
    def recv_capacity(self) -> int:
        return max(8, int(self.tokens_per_shard * self.capacity_factor))

    @property
    def wire_int8(self) -> bool:
        if self.wire in ("raw", "f32"):
            return False
        if self.wire == "int8":
            return True
        raise ValueError(
            f"MoEConfig.wire={self.wire!r}: want raw|int8 (the a2a.wire "
            f"tiers the exchange carries; 'f32' = alias of raw; lossless "
            f"is a host-staging tier, meaningless inside a training step)")


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> Params:
    """Global parameters drawn from ``generator`` (on its own device),
    in the JAX package's layouts: ``router [D, E]``, ``w1 [E, D, H]``,
    ``w2 [E, H, D]``, ``wout [D, D]``."""
    dev = backend.resolve_device(device)
    D, H, E = cfg.d_model, cfg.d_hidden, cfg.num_experts

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    s = D ** -0.5
    return {"router": normal(D, E) * s, "w1": normal(E, D, H) * s,
            "w2": normal(E, H, D) * H ** -0.5, "wout": normal(D, D) * s}


def params_from_jax(arrays: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's parameter dict (as numpy arrays) on ``device``,
    layouts unchanged."""
    dev = backend.resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in arrays.items()}


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``x [..., D] @ router [D, E]``, one product of ``ROUTER_BLOCK``
    rows at a time (the last block zero-padded), so a row's logits do not
    depend on how many rows share the call. A matrix library may pick its
    algorithm, and with it a row's summation order, by the row count; the
    raw wire's receiver recomputes the sender's routing over another
    number of rows, and a near-tie decided differently would send the
    token to another expert without an error."""
    lead, D = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, D)
    n = rows.shape[0]
    pad = -n % ROUTER_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, D)])
    out = torch.cat([blk @ router for blk in rows.split(ROUTER_BLOCK)])
    return out[:n].reshape(*lead, router.shape[-1])


def _take(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard row gather: ``rows [G, P, n, ...]``, ``idx [G, P, ...]``
    -> ``rows[g, p, idx[g, p, ...]]``."""
    G, P = rows.shape[:2]
    tail = (1,) * (idx.dim() - 2)
    gi = torch.arange(G, device=rows.device).view(G, 1, *tail)
    pi = torch.arange(P, device=rows.device).view(1, P, *tail)
    return rows[gi, pi, idx]


def _exclusive(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts


def _route(params: Params, xs: torch.Tensor, cfg: MoEConfig, ep: int):
    """Top-1 routing of ``xs [dp, ep, T, D]`` and the dispatch order:
    (gate, expert, order, inverse order, destination-sorted tokens, send
    sizes ``[dp, ep, ep]``)."""
    e_local = cfg.num_experts // ep
    logits = router_logits(xs, params["router"])           # [dp, ep, T, E]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(logits, dim=-1)                  # [dp, ep, T]
    gate = torch.gather(probs, -1, expert[..., None])[..., 0]
    dest = torch.div(expert, e_local, rounding_mode="floor").to(torch.int32)
    order = torch.argsort(dest, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1)
    x_sorted = _take(xs, order)
    counts = counts_from_sorted(torch.gather(dest, -1, order), ep)
    return gate, expert, order, inv_order, x_sorted, counts


def _moe_grid(params: Params, x: torch.Tensor, cfg: MoEConfig, dp: int,
              ep: int, seed: int, uniforms: Optional[Uniforms]):
    """Forward over the ``dp x ep`` grid: route -> dispatch -> expert FFN
    -> combine -> unsort. ``x [dp*ep*T, D]`` -> ``[dp*ep*T, D]``;
    ``seed`` feeds the int8 wire's noise streams."""
    T, D = cfg.tokens_per_shard, cfg.d_model
    E = cfg.num_experts
    if E % ep:
        raise ValueError(f"num_experts={E} must divide over ep={ep}")
    if tuple(x.shape) != (dp * ep * T, D):
        raise ValueError(f"x is {tuple(x.shape)}; want [dp*ep*T, D] = "
                         f"[{dp * ep * T}, {D}]")
    e_local = E // ep
    cap_out = cfg.recv_capacity
    dev = x.device
    xs = x.reshape(dp, ep, T, D)
    gate, expert, order, inv_order, x_sorted, counts = _route(
        params, xs, cfg, ep)

    # -- dispatch over ep within each dp row ---------------------------
    if cfg.wire_int8:
        # stream 0 of the step seed; the combine takes stream 1 and each
        # move's backward stream 3 of its own seed
        recv = exchange_quantized(x_sorted, counts, wire_noise_seed(seed, 0),
                                  cap_out, cfg.impl, uniforms)
        # lossy wire: the expert id travels with the token as exact int
        # rows (recomputing argmax on dequantized rows would disagree with
        # the sender on near-ties); its recv_sizes size the combine
        rid, recv_sizes, _ = group_shuffle(
            torch.gather(expert.to(torch.int32), -1, order)[..., None],
            counts, cap_out, cfg.impl)
        rexpert = rid[..., 0]
    else:
        recv = exchange(x_sorted, counts, cap_out, cfg.impl)
        # exact wire: the received rows are the sender's bits, so the
        # receiver recomputes the routing through the same blocked product
        with torch.no_grad():
            rexpert = torch.argmax(router_logits(recv, params["router"]),
                                   dim=-1)
        recv_sizes = counts.transpose(1, 2).contiguous()
    shard = torch.arange(ep, device=dev).view(1, ep, 1)
    le = (rexpert - shard * e_local).to(torch.int32)      # local expert
    j = torch.arange(cap_out, dtype=torch.int32, device=dev)
    rvalid = j < recv_sizes.sum(dim=-1, keepdim=True)

    # -- group by local expert, capacity-bounded gather -----------------
    cap_e = max(8, int(cap_out * cfg.capacity_factor / max(e_local, 1)))
    le_key = torch.where(rvalid, le, torch.full_like(le, e_local))
    eorder = torch.argsort(le_key, dim=-1, stable=True)
    le_sorted = torch.gather(le_key, -1, eorder)
    rows_sorted = _take(recv, eorder)
    ecounts = counts_from_sorted(le_sorted, e_local)     # [dp, ep, e_local]
    excl = _exclusive(ecounts)
    # a row whose expert is not on this shard (only after an overflow,
    # when the rows are NaN) drops instead of indexing out of range
    le_c = torch.clamp(le_sorted, 0, e_local - 1)
    within = j - torch.gather(excl, -1, le_c.long())
    fits = (within < cap_e) & (le_sorted >= 0) & (le_sorted < e_local)
    within_c = torch.clamp(within, 0, cap_e - 1)
    k = torch.arange(cap_e, dtype=torch.int32, device=dev)
    slot = excl[..., None] + k                     # [dp, ep, e_local, cap_e]
    slot_valid = k < torch.clamp(ecounts, max=cap_e)[..., None]
    ebuf = torch.where(slot_valid[..., None],
                       _take(rows_sorted, torch.clamp(slot, 0, cap_out - 1)),
                       torch.zeros((), dtype=x.dtype, device=dev))

    # -- expert FFN: batched per-expert products -----------------------
    w1 = params["w1"].view(1, ep, e_local, D, cfg.d_hidden)
    w2 = params["w2"].view(1, ep, e_local, cfg.d_hidden, D)
    h = F.gelu(torch.matmul(ebuf, w1), approximate="tanh")
    y = torch.matmul(h, w2)                        # [dp, ep, e_local, cap_e, D]

    # -- back to received order, combine back to the senders -----------
    gi = torch.arange(dp, device=dev).view(dp, 1, 1)
    pi = torch.arange(ep, device=dev).view(1, ep, 1)
    out_sorted = torch.where(fits[..., None],
                             y[gi, pi, le_c.long(), within_c.long()],
                             torch.zeros((), dtype=x.dtype, device=dev))
    out_recv = _take(out_sorted, torch.argsort(eorder, dim=-1))
    if cfg.wire_int8:
        back = exchange_quantized(out_recv, recv_sizes.to(torch.int32),
                                  wire_noise_seed(seed, 1), T, cfg.impl,
                                  uniforms)
    else:
        back = exchange(out_recv, recv_sizes.to(torch.int32), T, cfg.impl)
    combined = _take(back, inv_order)                     # original order
    out = combined * gate[..., None]
    return (out @ params["wout"]).reshape(dp * ep * T, D)


def exchange_traffic(cfg: MoEConfig, tokens: int) -> Tuple[int, int]:
    """(payload_bytes, wire_bytes) one forward's dispatch and combine move
    for ``tokens`` global tokens: every token crosses the ep axis twice at
    d_model float32 lanes; the int8 tier moves ``int8_wire_words`` lanes
    instead and also runs the exact expert-id exchange (one int32 lane a
    token), counted on both sides."""
    payload = 2 * tokens * cfg.d_model * 4
    if not cfg.wire_int8:
        return payload, payload
    ids = tokens * 4
    wire = 2 * tokens * int8_wire_words(cfg.d_model) * 4 + ids
    return payload + ids, wire


def _record_exchange_traffic(cfg: MoEConfig, tokens: int,
                             metrics: Optional[Metrics],
                             backward: bool = False) -> None:
    """Count one forward's (or its backward's) exchanges into ``metrics``
    (a node's): the same ``shuffle.payload.bytes`` / ``shuffle.wire.bytes``
    the read path's tiers describe, plus ``moe.exchange.*``. The backward
    has no expert-id exchange (integer routing data has no cotangent)."""
    if metrics is None:
        return
    payload, wire = exchange_traffic(cfg, tokens)
    if backward and cfg.wire_int8:
        payload -= tokens * 4
        wire -= tokens * 4
    metrics.inc(C_PAYLOAD_BYTES, float(payload))
    metrics.inc(C_WIRE_BYTES, float(wire))
    metrics.inc(C_MOE_EXCHANGES, 2.0)
    metrics.inc(C_MOE_ROWS, float(2 * tokens))


def forward(params: Params, x: torch.Tensor, cfg: MoEConfig, dp: int,
            ep: int, seed: int = 0, metrics: Optional[Metrics] = None,
            uniforms: Optional[Uniforms] = None) -> torch.Tensor:
    """The model over a ``dp x ep`` grid of logical shards on ``x``'s
    device. ``x [B, D]`` global tokens, ``B = dp*ep*tokens_per_shard``;
    ``seed`` is the step counter of the int8 wire's noise (unused on the
    raw wire); ``metrics`` (a node's) counts the exchanges; ``uniforms``
    replaces the int8 wire's noise source (tests)."""
    _record_exchange_traffic(cfg, int(x.shape[0]), metrics)
    return _moe_grid(params, x, cfg, dp, ep, int(seed), uniforms)


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            cfg: MoEConfig, dp: int, ep: int, seed: int = 0,
            metrics: Optional[Metrics] = None,
            uniforms: Optional[Uniforms] = None) -> torch.Tensor:
    pred = forward(params, x, cfg, dp, ep, seed, metrics, uniforms)
    return torch.mean((pred - y) ** 2)


def _adam_count(opt: torch.optim.Adam) -> int:
    """Updates ``opt`` has applied (optax's ``count``): 0 before the
    first step, whose state torch creates then."""
    st = opt.state.get(opt.param_groups[0]["params"][0])
    return int(st["step"]) if st else 0


def make_train_step(cfg: MoEConfig, dp: int, ep: int, lr: float = 1e-3,
                    device=None, metrics: Optional[Metrics] = None,
                    uniforms: Optional[Uniforms] = None):
    """Full training step: forward, backward through both exchanges (the
    transposed moves), Adam(lr, betas=(0.9, 0.999), eps=1e-8).

    Returns ``(init, step)``: ``params, opt = init(source)`` where
    ``source`` is a ``torch.Generator`` (fresh parameters,
    :func:`init_params`) or a parameter dict (copied, e.g. from
    :func:`params_from_jax`); ``params, opt, loss = step(params, opt, x,
    y, step_idx=None)``. The int8 wire's noise follows ``step_idx``, by
    default the optimizer's count before this update (0, 1, 2, ...).
    Each call counts the forward's and the backward's exchanges into
    ``metrics``."""
    dev = backend.resolve_device(device)

    def init(source):
        if isinstance(source, torch.Generator):
            p = init_params(cfg, source, dev)
        else:
            p = {k: source[k].detach().to(dev, torch.float32, copy=True)
                 for k in PARAM_NAMES}
        params = {k: v.requires_grad_() for k, v in p.items()}
        opt = torch.optim.Adam([params[k] for k in PARAM_NAMES], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return params, opt

    def step(params, opt, x, y, step_idx: Optional[int] = None):
        if step_idx is None:
            step_idx = _adam_count(opt)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, y, cfg, dp, ep, step_idx, None, uniforms)
        loss.backward()
        opt.step()
        _record_exchange_traffic(cfg, int(x.shape[0]), metrics)
        _record_exchange_traffic(cfg, int(x.shape[0]), metrics,
                                 backward=True)
        return params, opt, loss.detach()

    return init, step


# -- read-path expert dispatch (read(sink="device")) ------------------------
def stage_tokens_by_expert(mgr, handle, tokens: np.ndarray,
                           expert_ids: np.ndarray) -> None:
    """Stage one shuffle's map outputs for expert dispatch: keys are the
    expert ids (``partitioner="direct"``: key == reduce partition ==
    expert), values the float32 token vectors, split contiguously over
    the handle's map tasks."""
    n = tokens.shape[0]
    per = -(-n // handle.num_maps)
    for mid in range(handle.num_maps):
        lo, hi = mid * per, min(n, (mid + 1) * per)
        w = mgr.get_writer(handle, mid)
        w.write(np.asarray(expert_ids[lo:hi], dtype=np.int64),
                np.ascontiguousarray(tokens[lo:hi], dtype=np.float32))
        w.commit(handle.num_partitions)


def make_device_dispatch_step(cfg: MoEConfig, cap: int, num_shards: int,
                              lr: float = 1e-2, device=None):
    """The device-sink consumer: one training step (forward, backward, SGD)
    over a read's packed receive rows ``[P, cap, W]`` int32 and its
    delivered counts ``[P]`` (``DeviceShuffleReaderResult.device_totals``:
    rows ``[:totals[p]]`` of shard p are valid).

    Per shard it decodes the expert id from lane 0 (the ``direct``
    partitioner's key) and the tokens by bit-cast from lanes ``2:2+D``,
    groups the rows by local expert (every valid row's expert lives on
    this shard), runs the expert FFN and trains against a masked
    reconstruction loss. ``cap`` is the receive capacity of the read.

    Returns ``(init, step)``: ``params = init(generator)`` (``w1 [E, D,
    H]``, ``w2 [E, H, D]``), ``params, loss = step(params, rows, totals)``;
    use as ``result.consume(lambda c, rows, totals: step(c[0], rows,
    totals), (params, None))``."""
    E, D, Hd = cfg.num_experts, cfg.d_model, cfg.d_hidden
    P = int(num_shards)
    if E % P:
        raise ValueError(f"num_experts={E} must divide over the {P} shards "
                         f"for the read-path dispatch")
    e_local = E // P
    dev = backend.resolve_device(device)

    def init(generator: torch.Generator) -> Params:
        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               device=generator.device).to(dev)
        return {"w1": normal(E, D, Hd) * D ** -0.5,
                "w2": normal(E, Hd, D) * Hd ** -0.5}

    def shard_loss(w1, w2, rows, totals):
        if tuple(rows.shape[:2]) != (P, cap) or rows.shape[2] < 2 + D:
            raise ValueError(f"rows {tuple(rows.shape)}; want [{P}, {cap}, "
                             f">= {2 + D}]")
        j = torch.arange(cap, dtype=torch.int32, device=rows.device)
        valid = j < totals.to(torch.int32)[:, None]
        eid = rows[..., 0]
        x = rows[..., 2:2 + D].contiguous().view(torch.float32)
        shard = torch.arange(P, dtype=torch.int32, device=rows.device)
        le = eid - shard[:, None] * e_local
        le_key = torch.where(valid, le, torch.full_like(le, e_local))
        order = torch.argsort(le_key, dim=-1, stable=True)
        le_sorted = torch.gather(le_key, -1, order)
        x_sorted = _take(x[None], order[None])[0]
        counts = counts_from_sorted(le_sorted, e_local)   # [P, e_local]
        slot = _exclusive(counts)[..., None] + j           # [P, e_local, cap]
        slot_valid = j < counts[..., None]
        ebuf = torch.where(
            slot_valid[..., None],
            _take(x_sorted[None], torch.clamp(slot, 0, cap - 1)[None])[0],
            torch.zeros((), dtype=x.dtype, device=x.device))
        h = F.gelu(torch.matmul(ebuf, w1.view(P, e_local, D, Hd)),
                   approximate="tanh")
        y = torch.matmul(h, w2.view(P, e_local, Hd, D))
        err = torch.where(slot_valid[..., None], y - ebuf,
                          torch.zeros((), dtype=x.dtype, device=x.device))
        cnt = slot_valid.sum() * D
        return torch.sum(err * err) / torch.clamp(cnt, min=1)

    def step(params: Params, rows: torch.Tensor, totals: torch.Tensor):
        w1 = params["w1"].detach().requires_grad_()
        w2 = params["w2"].detach().requires_grad_()
        loss = shard_loss(w1, w2, rows, totals)
        g1, g2 = torch.autograd.grad(loss, [w1, w2])
        return ({"w1": (w1 - lr * g1).detach(),
                 "w2": (w2 - lr * g2).detach()}, loss.detach())

    return init, step


def host_staged_consume(result, step, params: Params, cap: int, width: int,
                        num_shards: int, metrics: Optional[Metrics] = None):
    """The round trip the device sink removes, as one call: drain every
    partition of a host-sink ``result`` to numpy (the reader counts the
    D2H), repack the rows per shard with ``reader.pack_rows``, upload them
    to the parameters' device (counted into :data:`C_H2D` of ``metrics``)
    and run the same consumer ``step``. Returns ``(params, loss)``."""
    P = int(num_shards)
    R = result.num_partitions
    p2d = blocked_partition_map(R, P)
    rows = np.zeros((P, cap, width), dtype=np.int32)
    fill = np.zeros(P, dtype=np.int32)
    for r in range(R):
        k, v = result.partition(r)
        n = k.shape[0]
        if not n:
            continue
        s = int(p2d[r])
        off = int(fill[s])
        pack_rows(k, v, width, out=rows[s, off:off + n])
        fill[s] += n
    dev = params["w1"].device
    rows_dev = torch.from_numpy(rows).to(dev)
    totals_dev = torch.from_numpy(fill).to(dev)
    if metrics is not None:
        metrics.inc(C_H2D, float(rows.nbytes + fill.nbytes))
    return step(params, rows_dev, totals_dev)


__all__ = ["MoEConfig", "PARAM_NAMES", "ROUTER_BLOCK", "exchange_traffic",
           "forward", "host_staged_consume", "init_params", "loss_fn",
           "make_device_dispatch_step", "make_train_step", "params_from_jax",
           "router_logits", "stage_tokens_by_expert"]
