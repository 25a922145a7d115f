"""The five-axis MoE transformer — the port of the JAX package's
``models/transformer.py``.

Every parallel axis at once, as logical shards of one device:

  ``dp``  data parallelism     — the batch is cut over ``dp x ep`` token
                                 shards; shared parameters sum every
                                 shard's gradient through autograd
  ``pp``  pipeline parallelism — the layers are cut into ``pp`` stages
  ``sp``  sequence/context     — each sequence is cut into ``sp`` shards;
                                 attention is the ring (``attn="ring"``)
                                 or Ulysses (``attn="ulysses"``: the flash
                                 kernels on the card)
  ``tp``  tensor parallelism   — attention heads and the expert hidden dim
                                 are cut over ``tp``; the partial products
                                 are summed in tp order after each second
                                 matmul (the reference's ``psum``)
  ``ep``  expert parallelism   — the MoE dispatch and combine are the
                                 port's differentiable ragged exchange
                                 (:func:`~sparkucx_tpu_torch.shuffle.
                                 alltoall.exchange`), one exchange group per
                                 ``(dp, sp)`` pair

The shards are leading tensor dims. One microbatch's activations are
``[sp, dp*ep*mb, t, D]`` — sequence shard first, then the token shards in
the reference's ``P(("dp", "ep"))`` order and the microbatch rows — so
the same tensor is the attention's shard-major ``[P, B, ...]`` layout and,
reshaped to ``[sp*dp, ep, mb*t, D]``, the exchange's ``[G, P, n, D]``
groups. Tokens are replicated over ``tp`` and ``pp``, so one exchange
serves every tp group and no activation is copied per tp shard.
:func:`param_specs` says how each parameter is cut; :func:`_shard_view`
turns each cut dim into a ``(shards, size)`` pair of dims.

Pipeline: the reference runs a GPipe tick loop of ``M + S - 1`` ticks in
which stage ``s`` at tick ``i`` runs microbatch ``i - s`` (live when ``0
<= i - s < M``). The port runs the stages one after another over all
``M`` microbatches, with no bubble ticks. This is exact: every collective
inside a stage (the ep exchanges, the sp ring or head trade, the tp sums)
spans only devices of one pp index at one tick, so a live lane computes
from its own microbatch alone; a bubble lane never feeds a live one (a
lane stage 0 injects at tick ``i >= M`` reaches the last stage at tick
``i + S - 1 >= M + S - 1``, after the loop, and a zero-fed lane of stage
``s > 0`` at tick ``i < s`` reaches it at a tick whose microbatch index is
negative), and the last stage banks only live lanes, whose cotangent alone
is non-zero. Each microbatch thus passes through all ``L`` layers in
order, which is what the port computes.

Mixed precision (``compute_dtype="bfloat16"``): parameters are cast once
at the boundary, except ``unembed``; the master copies and the optimizer
stay float32; the router, the ring's softmax accumulators, the
unembedding and the loss run in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.models.moe import router_logits
from sparkucx_tpu_torch.ops import grouped_ffn as gf
from sparkucx_tpu_torch.ops.attention import (NEG_INF, _block_update,
                                              _finalize, make_block_bias)
from sparkucx_tpu_torch.ops.partition import counts_from_sorted
from sparkucx_tpu_torch.parallel.ulysses import _ulysses_sharded
from sparkucx_tpu_torch.shuffle.alltoall import exchange
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

AXES = ("dp", "pp", "sp", "tp", "ep")
PARAM_NAMES = ("embed", "unembed", "ln1", "ln2", "wqkv", "wo", "router",
               "w1e", "w2e")
STAGE_PARAMS = ("ln1", "ln2", "wqkv", "wo", "router", "w1e", "w2e")
# flash_attention impl of the Ulysses path, as the reference passes it:
# "auto" runs the kernels on a CUDA tensor and the blockwise scan on a CPU
# one ("interpret" runs the kernels' plain versions on either)
ULYSSES_IMPL = "auto"

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 32
    num_heads: int = 4
    head_dim: int = 8
    d_ff: int = 64
    num_layers: int = 2
    num_experts: int = 4
    seq_len: int = 64          # global sequence length
    microbatches: int = 2      # pipeline microbatches per local batch
    capacity_factor: float = 2.0
    impl: str = "auto"         # data-plane implementation for the exchange
    attn: str = "ring"         # ring | ulysses context parallelism
    remat: bool = True         # recompute each layer in backward: saved
    # activations drop from one set per layer to one layer boundary
    compute_dtype: str = "float32"  # "bfloat16" = mixed precision (see
    # the module docstring)


@dataclass(frozen=True)
class ShardGrid:
    """The logical shard grid: one size per axis of :data:`AXES` (the
    reference's device mesh, on one device)."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def __post_init__(self):
        for ax in AXES:
            n = getattr(self, ax)
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"{ax}={n!r}: want a positive int")


def mesh_axis_sizes(mesh: ShardGrid) -> Dict[str, int]:
    return {ax: getattr(mesh, ax) for ax in AXES}


def make_mesh(n_devices: int,
              order: tuple = ("ep", "sp", "pp", "tp")) -> ShardGrid:
    """Factor ``n_devices`` logical shards over (dp, pp, sp, tp, ep),
    spending one factor of two on each axis in ``order`` while the count
    stays even, with the remainder on dp: 8 gives ep, sp and pp 2 each;
    ``order=("ep", "tp")`` gives dp, tp and ep 2 each."""
    sizes = {ax: 1 for ax in AXES}
    rem = int(n_devices)
    for ax in order:
        if rem % 2 == 0:
            sizes[ax] = 2
            rem //= 2
    sizes["dp"] = rem
    return ShardGrid(**sizes)


def _check_grid(cfg: TransformerConfig, g: Dict[str, int], batch: int,
                seq: int) -> None:
    """What the reference's sharding implies, as ValueErrors."""
    checks = (
        (cfg.num_layers, g["pp"], "num_layers", "pp"),
        (cfg.num_experts, g["ep"], "num_experts", "ep"),
        (cfg.num_heads, g["tp"], "num_heads", "tp"),
        (cfg.d_ff, g["tp"], "d_ff", "tp"),
        (cfg.seq_len, g["sp"], "seq_len", "sp"),
        (seq, g["sp"], "the tokens' sequence length", "sp"),
        (batch, g["dp"] * g["ep"] * cfg.microbatches, "the batch",
         "dp*ep*microbatches"))
    for n, d, what, by in checks:
        if n % d:
            raise ValueError(f"{what} {n} does not divide over {by}={d}")
    if cfg.attn not in ("ring", "ulysses"):
        raise ValueError(f"attn={cfg.attn!r}: want ring|ulysses")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Global parameters drawn from ``generator`` (on its own device), in
    the reference's layouts: ``embed [V, D]``, ``unembed [D, V]``,
    ``ln1``/``ln2 [L, D]``, ``wqkv [L, 3, D, H, Dh]``, ``wo [L, H, Dh,
    D]``, ``router [L, D, E]``, ``w1e [L, E, D, F]``, ``w2e [L, E, F,
    D]``; leading axis = layer for everything inside the pipeline."""
    dev = backend.resolve_device(device)
    L, D, H, Dh = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
    E, Fd, V = cfg.num_experts, cfg.d_ff, cfg.vocab

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    s = D ** -0.5
    return {
        "embed": normal(V, D),
        "unembed": normal(D, V) * s,
        "ln1": torch.ones(L, D, device=dev),
        "ln2": torch.ones(L, D, device=dev),
        "wqkv": normal(L, 3, D, H, Dh) * s,
        "wo": normal(L, H, Dh, D) * (H * Dh) ** -0.5,
        "router": normal(L, D, E) * s,
        "w1e": normal(L, E, D, Fd) * s,
        "w2e": normal(L, E, Fd, D) * Fd ** -0.5,
    }


def params_from_jax(arrays: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's parameter dict (as numpy arrays) on ``device``,
    layouts unchanged."""
    dev = backend.resolve_device(device)
    return {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
            for k in PARAM_NAMES}


def param_specs() -> Dict[str, Tuple]:
    """The reference's shard_map specs: the grid axis each parameter dim
    is cut over (None: not cut). Layers over pp, heads and d_ff over tp,
    experts over ep."""
    return {
        "embed": (),
        "unembed": (),
        "ln1": ("pp",),
        "ln2": ("pp",),
        "wqkv": ("pp", None, None, "tp", None),
        "wo": ("pp", "tp", None, None),
        "router": ("pp",),
        "w1e": ("pp", "ep", None, "tp"),
        "w2e": ("pp", "ep", "tp", None),
    }


def _shard_view(p: torch.Tensor, spec: Tuple, g: Dict[str, int]):
    """``p`` with each dim that ``spec`` cuts over an axis split into
    ``(axis size, dim / axis size)``: e.g. ``w1e [L, E, D, F]`` ->
    ``[pp, L/pp, ep, E/ep, D, tp, F/tp]``. A view: gradients reach ``p``."""
    shape = []
    for i, n in enumerate(p.shape):
        ax = spec[i] if i < len(spec) else None
        shape += [n] if ax is None else [g[ax], n // g[ax]]
    return p.reshape(shape)


def _rms_norm(x, scale):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def _ring_attn(q, k, v):
    """Causal ring attention on ``[sp, R, H, t, Dh]`` shards (the
    reference's own variant): the online-softmax accumulators ``o``,
    ``m`` and ``l`` are float32 whatever the compute dtype, and the
    output is cast back to q's. ``parallel/ring`` keeps them in q's
    dtype, so it is not called here. As there, the reference's
    ``ppermute`` around the ring is ``torch.roll`` over the shard dim."""
    p, t = q.shape[0], q.shape[3]
    scale = q.shape[-1] ** -0.5
    dev = q.device
    o = [torch.zeros(q.shape[1:], dtype=torch.float32, device=dev)
         for _ in range(p)]
    m = [torch.full(q.shape[1:-1], NEG_INF, dtype=torch.float32, device=dev)
         for _ in range(p)]
    l = [torch.zeros(q.shape[1:-1], dtype=torch.float32, device=dev)
         for _ in range(p)]
    k_blk, v_blk = k, v
    for s in range(p):
        for i in range(p):
            src = (i - s) % p       # where shard i's resident block began
            # the reference's bias is weakly typed: it takes s's dtype
            bias = make_block_bias(t, t, i * t, src * t, True, device=dev,
                                   dtype=q.dtype)
            # p (float32) @ v promotes v to float32, as JAX does
            o[i], m[i], l[i] = _block_update(
                q[i], k_blk[i], v_blk[i].to(torch.float32), o[i], m[i],
                l[i], bias, scale)
        if s < p - 1:
            k_blk = torch.roll(k_blk, 1, dims=0)
            v_blk = torch.roll(v_blk, 1, dims=0)
    return torch.stack([_finalize(o[i], m[i], l[i])
                        for i in range(p)]).to(q.dtype)


def _ulysses_attn(q, k, v, tp: int):
    """Causal Ulysses attention on ``[sp, R, H, t, Dh]`` shards through
    the ported ``_ulysses_sharded``: the token shards, microbatch rows and
    tp head groups all ride the flash call's batch and head dims, so a
    layer's attention is one forward launch (one dq and one dk/dv launch
    in backward). Each tp group's local heads must divide by sp."""
    p = q.shape[0]
    local = q.shape[2] // tp
    if p > 1 and local % p != 0:
        raise ValueError(
            f"ulysses attention needs local heads {local} divisible by "
            f"sp={p}; use attn='ring' for small head counts")
    return _ulysses_sharded(q, k, v, causal=True, scale=None, block_q=256,
                            block_k=512, impl=ULYSSES_IMPL)


def _route(x, router, cfg: TransformerConfig):
    """Top-1 routing of ``x [G, ep, n, D]``: (float32 logits, expert,
    gate in x's dtype). The router runs in float32 even under bf16
    compute (the 1e-7 tie-break is below one bf16 ulp of most logits),
    through :func:`~sparkucx_tpu_torch.models.moe.router_logits`, so a
    row's logits do not depend on the row count of the call. The
    tie-break spreads equal logits over the experts by the row's index
    within its own shard's ``n`` rows, as the reference does."""
    n, E = x.shape[2], cfg.num_experts
    logits = router_logits(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    dev = x.device
    tie = (torch.arange(n, dtype=torch.int32, device=dev)[:, None]
           + 31 * torch.arange(E, dtype=torch.int32, device=dev)[None, :]) % E
    expert = torch.argmax(logits + tie.to(torch.float32) * 1e-7, dim=-1)
    gate = torch.gather(probs, -1, expert[..., None])[..., 0].to(x.dtype)
    return logits, expert, gate


def _rows(x, idx):
    """``x[g, p, idx[g, p, j]]`` for ``x [G, P, n, W]``, ``idx [G, P, m]``."""
    return torch.gather(x, 2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _tp_sum(parts):
    """The partial results ``[tp, ...]`` summed in tp order."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _grouped_experts(lp, recv, rexpert, rvalid, e_local: int):
    """Every local expert's FFN on the rows it received: ``recv [G, ep,
    cap, D]``, ``rexpert`` each row's expert id as it travelled,
    ``rvalid`` the rows received. The rows of all ``G * ep`` receiving
    shards are sorted by global expert (rows past a shard's received count
    and rows of another shard's expert last) in one stable sort, so each
    expert's rows are one contiguous segment and its weight gradient one
    reduction over it;
    :func:`~sparkucx_tpu_torch.ops.grouped_ffn.grouped_ffn` runs the
    products with the counts and offsets on the device. Returns ``[G, ep,
    cap, D]``, zero past the received rows; a received row whose expert
    id no local expert owns (a poisoned exchange on the card) comes back
    NaN, so the loss shows it."""
    G, ep, cap, D = recv.shape
    E, dev = ep * e_local, recv.device
    shard = torch.arange(ep, dtype=rexpert.dtype, device=dev).view(1, ep, 1)
    owned = rvalid & (torch.div(rexpert, e_local, rounding_mode="floor")
                      == shard)
    skey, perm = torch.sort(torch.where(owned, rexpert, E).flatten(),
                            stable=True)
    counts, offsets = gf.segments_from_sorted(skey, E)
    w1 = lp["w1e"].reshape(E, D, -1)                 # [E, D, F], tp-major F
    w2 = lp["w2e"].reshape(E, -1, D)                 # [E, F, D]
    ys = gf.grouped_ffn(recv.reshape(-1, D).index_select(0, perm), w1, w2,
                        counts, lp["w1e"].shape[-2], offsets)
    y = torch.empty_like(ys).index_copy_(0, perm, ys).view(G, ep, cap, D)
    # owned rows are received rows, so the xor is the received unowned ones
    return y.masked_fill((rvalid ^ owned)[..., None], float("nan"))


def _moe_ffn(lp, x, cfg: TransformerConfig):
    """Expert FFN on ``x [G, ep, n, D]`` (G = sp*dp exchange groups of ep
    shards, ``n`` local rows a shard). Dispatch and combine are exchanges
    over ep within each group; the expert hidden dim is cut over tp and
    the partial outputs summed in tp order. ``lp["w1e"]`` is ``[ep,
    e_local, D, tp, F/tp]``, ``lp["w2e"]`` ``[ep, e_local, tp, F/tp,
    D]``."""
    G, ep, n, D = x.shape
    e_local = cfg.num_experts // ep
    cap_out = max(8, int(n * cfg.capacity_factor))
    dev = x.device

    _, expert, gate = _route(x, lp["router"], cfg)
    dest = torch.div(expert, e_local, rounding_mode="floor").to(torch.int32)
    order = torch.argsort(dest, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1)
    counts = counts_from_sorted(torch.gather(dest, -1, order), ep)
    # the sender's expert choice travels with the row as an extra float
    # column, exactly (the receiver must not recompute it: a near-tie
    # decided the other way would silently zero the token's FFN output)
    if cfg.num_experts > 2 ** (_mantissa_bits(x.dtype) + 1):
        raise ValueError(
            f"num_experts={cfg.num_experts} not exactly representable in "
            f"{x.dtype}; the expert-id wire column would corrupt routing")
    xid = torch.cat([_rows(x, order),
                     torch.gather(expert, -1, order).to(x.dtype)[..., None]],
                    dim=-1)
    recv = exchange(xid, counts, cap_out, cfg.impl)    # [G, ep, cap, D+1]
    rexpert = recv[..., -1].to(torch.int32)
    recv = recv[..., :-1]
    recv_sizes = counts.transpose(1, 2).contiguous()   # [g, receiver, sender]
    rvalid = torch.arange(cap_out, device=dev) \
        < recv_sizes.sum(dim=-1, keepdim=True)

    # grouped expert products: the received rows sorted by expert on the
    # device, each expert's rows through its own weights only (the span
    # times the forward and remat's re-forward; the products' backward
    # opens moe.experts.backward)
    with GLOBAL_TRACER.span("moe.experts", device_time=dev,
                            impl=gf.impl_for(dev)):
        y = _grouped_experts(lp, recv, rexpert, rvalid, e_local)

    back = exchange(y, recv_sizes, n, cfg.impl)         # [G, ep, n, D]
    return _rows(back, inv_order) * gate[..., None]


def _mantissa_bits(dtype) -> int:
    return round(-math.log2(torch.finfo(dtype).eps))


def _layer(h, lp, cfg: TransformerConfig, g: Dict[str, int]):
    """One transformer layer on a microbatch's ``[sp, R, t, D]``
    activations (``R = dp*ep*mb``)."""
    sp, R, t, D = h.shape
    tp = g["tp"]
    x = _rms_norm(h, lp["ln1"])
    wqkv = lp["wqkv"].flatten(2, 3)           # [3, D, H, Dh], tp-major heads
    q, k, v = (torch.einsum("srtd,dhk->srhtk", x, wqkv[i]) for i in range(3))
    if cfg.attn == "ulysses":
        attn = _ulysses_attn(q, k, v, tp)     # [sp, R, H, t, Dh]
    else:
        attn = _ring_attn(q, k, v)
    attn = attn.unflatten(2, (tp, attn.shape[2] // tp))
    h = h + _tp_sum(torch.einsum("sruhtk,uhkd->usrtd", attn, lp["wo"]))

    x = _rms_norm(h, lp["ln2"])
    y = _moe_ffn(lp, x.reshape(sp * g["dp"], g["ep"], -1, D), cfg)
    return h + y.reshape(sp, R, t, D)


def _stage(stage_params, h, cfg: TransformerConfig, g: Dict[str, int]):
    """Apply one pipeline stage's layers (``stage_params``: leading dim =
    the stage's layers) to one microbatch."""
    for i in range(stage_params["ln1"].shape[0]):
        lp = {k: v[i] for k, v in stage_params.items()}
        if cfg.remat and torch.is_grad_enabled():
            # recompute the layer in backward instead of saving its
            # activations; its exchanges and kernels run again there
            h = checkpoint(_layer, h, lp, cfg, g, use_reentrant=False)
        else:
            h = _layer(h, lp, cfg, g)
    return h


def forward(params: Params, tokens: torch.Tensor, mesh: ShardGrid,
            cfg: TransformerConfig) -> torch.Tensor:
    """Global-view forward over the logical grid ``mesh`` on the tokens'
    device: ``tokens [B, T]`` -> float32 logits ``[B, T, V]``. B must
    divide over ``dp*ep*microbatches`` and T over ``sp``."""
    g = mesh_axis_sizes(mesh)
    B, T = tokens.shape
    _check_grid(cfg, g, B, T)
    dp, pp, sp, ep = g["dp"], g["pp"], g["sp"], g["ep"]
    M, D = cfg.microbatches, cfg.d_model
    mb, t = B // (dp * ep * M), T // sp

    cdt = getattr(torch, cfg.compute_dtype)
    # the unembedding runs on the float32 master weights (a bf16 round
    # trip would quantize the logits and their gradients)
    p = {k: v if k == "unembed" else v.to(cdt) for k, v in params.items()}
    h = p["embed"][tokens.long()]                          # [B, T, D]
    # [dp, ep, M, mb, sp, t, D] -> per microbatch [sp, dp*ep*mb, t, D]
    h = h.reshape(dp, ep, M, mb, sp, t, D).permute(2, 4, 0, 1, 3, 5, 6) \
        .reshape(M, sp, dp * ep * mb, t, D)

    specs = param_specs()
    views = {k: _shard_view(p[k], specs[k], g) for k in STAGE_PARAMS}
    outs = list(h.unbind(0))
    for s in range(pp):
        stage = {k: v[s] for k, v in views.items()}
        outs = [_stage(stage, x, cfg, g) for x in outs]
    out = torch.stack(outs).reshape(M, sp, dp, ep, mb, t, D) \
        .permute(2, 3, 0, 4, 1, 5, 6).reshape(B, T, D)
    return out.to(torch.float32) @ params["unembed"]


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            mesh: ShardGrid, cfg: TransformerConfig) -> torch.Tensor:
    logits = forward(params, tokens, mesh, cfg)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def make_train_step(mesh: ShardGrid, cfg: TransformerConfig,
                    lr: float = 1e-2, device=None):
    """Full five-axis training step: forward, backward through both
    exchanges and (under ``attn="ulysses"``) the flash kernels, then
    Adam(lr, betas=(0.9, 0.999), eps=1e-8), the reference's
    ``optax.adam(lr)``.

    Returns ``(init, step)``: ``params, opt = init(source)`` where
    ``source`` is a ``torch.Generator`` (fresh parameters,
    :func:`init_params`) or a parameter dict (copied, e.g. from
    :func:`params_from_jax`); ``params, opt, loss = step(params, opt,
    tokens, targets)``. Master parameters stay float32 whatever
    ``compute_dtype``."""
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

    def step(params, opt, tokens, targets):
        with GLOBAL_TRACER.span("train.step"):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, tokens, targets, mesh, cfg)
            loss.backward()
            opt.step()
        return params, opt, loss.detach()

    return init, step


__all__ = ["AXES", "PARAM_NAMES", "ShardGrid", "TransformerConfig",
           "forward", "init_params", "loss_fn", "make_mesh",
           "make_train_step", "mesh_axis_sizes", "param_specs",
           "params_from_jax"]
