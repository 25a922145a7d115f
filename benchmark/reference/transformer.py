"""Plain reference of the MoE transformer's training step at Switch-Base-8's
widths: the model as the configuration states it, on one device, with no
grid, no exchange, no kernel and no recompute.

Per layer ``l`` on activations ``x [tokens, D]``::

    a   = rms_norm(x, ln1[l])                  # x * rsqrt(mean(x^2) + 1e-6)
    q, k, v = a @ wqkv[l, i]                   # H heads of Dh
    x   = x + causal_softmax(q k^T / sqrt(Dh)) v @ wo[l]
    a   = rms_norm(x, ln2[l])
    z   = a @ router[l]                        # float32 router logits
    e   = argmax(z + tie * 1e-7)               # top-1
    x   = x + softmax(z)[e] * gelu_tanh(a @ w1e[l, e]) @ w2e[l, e]

then ``logits = x @ unembed`` and the mean next-token NLL, and Adam
(betas 0.9, 0.999, eps 1e-8). ``tie`` is the model's tie-break of equal
logits, ``(j + 31 * expert) % E`` for a token's row ``j`` inside its
expert-parallel shard: the model states it, and a near-tie would
otherwise route a token differently. Every expert takes every token
routed to it: at capacity factor 2 over two expert shards no receive
buffer can overflow, and the one-hot expert batch has no per-expert
capacity. The batch runs in chunks of sequences whose gradients add up,
so the step fits beside nothing else on the card."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.expert_step import gelu_tanh
from benchmark.reference.precision import matmul_for

LEAVES = ("embed", "unembed", "ln1", "ln2", "wqkv", "wo", "router", "w1e",
          "w2e")
BETAS = (0.9, 0.999)
EPS = 1e-8
TIE = 1e-7


@dataclass(frozen=True)
class Shape:
    vocab: int
    d_model: int
    heads: int
    head_dim: int
    d_ff: int
    layers: int
    experts: int
    seq_len: int
    batch: int
    # the grid's rows: sequences of one expert shard's rows per
    # microbatch, and positions of one sequence shard
    shard_sequences: int
    shard_positions: int


def make_weights(s: Shape, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` on its device, one call per leaf:
    ``embed [V, D]``, ``unembed [D, V]``, ``ln1``/``ln2 [L, D]``,
    ``wqkv [L, 3, D, H, Dh]``, ``wo [L, H, Dh, D]``, ``router [L, D,
    E]``, ``w1e [L, E, D, F]``, ``w2e [L, E, F, D]``."""
    dev = generator.device
    L, D, H, Dh = s.layers, s.d_model, s.heads, s.head_dim
    E, Fd, V = s.experts, s.d_ff, s.vocab

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    r = D ** -0.5
    return {
        "embed": normal(V, D),
        "unembed": normal(D, V).mul_(r),
        "ln1": torch.ones(L, D, device=dev),
        "ln2": torch.ones(L, D, device=dev),
        "wqkv": normal(L, 3, D, H, Dh).mul_(r),
        "wo": normal(L, H, Dh, D).mul_((H * Dh) ** -0.5),
        "router": normal(L, D, E).mul_(r),
        "w1e": normal(L, E, D, Fd).mul_(r),
        "w2e": normal(L, E, Fd, D).mul_(Fd ** -0.5),
    }


def make_batch(s: Shape, generator: torch.Generator):
    """One step's ``(tokens, targets)``, each ``[batch, seq_len]``,
    uniform over the vocabulary."""
    t = torch.randint(0, s.vocab, (s.batch, s.seq_len + 1),
                      generator=generator, device=generator.device)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def _rms_norm(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) \
        * scale


def _tie(s: Shape, b0: int, b1: int, device) -> torch.Tensor:
    """``[b1 - b0, T, E]`` tie-break offsets of sequences ``b0:b1``."""
    seq = torch.arange(b0, b1, device=device)[:, None]
    pos = torch.arange(s.seq_len, device=device)[None, :]
    row = (seq % s.shard_sequences) * s.shard_positions \
        + pos % s.shard_positions
    e = torch.arange(s.experts, device=device)
    return ((row[..., None] + 31 * e) % s.experts).to(torch.float32) * TIE


def chunk_nll(w, tokens, targets, b0: int, s: Shape, mm) -> torch.Tensor:
    """Summed next-token NLL of the sequences ``tokens [b, T]`` (global
    index ``b0`` onwards)."""
    b, T = tokens.shape
    D, H, Dh, E = s.d_model, s.heads, s.head_dim, s.experts
    x = w["embed"][tokens.reshape(-1)]                       # [b*T, D]
    tie = _tie(s, b0, b0 + b, x.device).reshape(b * T, E)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    for l in range(s.layers):
        a = _rms_norm(x, w["ln1"][l])
        q, k, v = (mm(a, w["wqkv"][l, i].reshape(D, H * Dh))
                   .reshape(b, T, H, Dh).transpose(1, 2) for i in range(3))
        sc = mm(q, k.transpose(-1, -2)) * Dh ** -0.5
        p = torch.softmax(sc.masked_fill(causal, float("-inf")), dim=-1)
        o = mm(p, v).transpose(1, 2).reshape(b * T, H * Dh)
        x = x + mm(o, w["wo"][l].reshape(H * Dh, D))
        a = _rms_norm(x, w["ln2"][l])
        z = mm(a, w["router"][l])
        expert = torch.argmax(z.detach() + tie, dim=-1)
        gate = torch.softmax(z, dim=-1).gather(1, expert[:, None])
        y = torch.zeros_like(a)
        for e in range(E):
            idx = torch.nonzero(expert == e)[:, 0]
            if idx.numel():
                ye = mm(gelu_tanh(mm(a[idx], w["w1e"][l, e])),
                        w["w2e"][l, e])
                y = y.index_add(0, idx, ye)
        x = x + y * gate
    logp = F.log_softmax(mm(x, w["unembed"]), dim=-1)
    return -logp.gather(1, targets.reshape(-1, 1)).sum()


def loss_and_grads(w, tokens, targets, s: Shape, tf32: bool = False,
                   chunk: int = 16):
    """The mean NLL over the batch and each leaf's gradient."""
    mm = matmul_for(tf32)
    leaves = {k: w[k].detach().requires_grad_() for k in LEAVES}
    n = tokens.numel()
    total = 0.0
    for b0 in range(0, tokens.shape[0], chunk):
        part = chunk_nll(leaves, tokens[b0:b0 + chunk],
                         targets[b0:b0 + chunk], b0, s, mm) / n
        part.backward()
        total += float(part.detach())
    return total, {k: leaves[k].grad for k in LEAVES}


def adam_steps(w, batches, s: Shape, lr: float, tf32: bool = False,
               chunk: int = 16, marks=()):
    """Adam over ``batches`` from weights ``w``: ``{"losses", "grad1"
    (the first step's gradient norm per leaf), "delta" (each leaf's
    change over all the steps, as a norm), "delta_at" (the same after
    each step count of ``marks``)}``."""
    p = {k: w[k].detach().clone() for k in LEAVES}
    m = {k: torch.zeros_like(p[k]) for k in LEAVES}
    v = {k: torch.zeros_like(p[k]) for k in LEAVES}
    losses: List[float] = []
    grad1 = {}
    delta_at = {}

    def delta():
        return {k: float(torch.linalg.vector_norm(p[k] - w[k]))
                for k in LEAVES}
    for t, (tokens, targets) in enumerate(batches, start=1):
        loss, g = loss_and_grads(p, tokens, targets, s, tf32, chunk)
        losses.append(loss)
        if t == 1:
            grad1 = {k: float(torch.linalg.vector_norm(g[k])) for k in LEAVES}
        c1 = 1 - BETAS[0] ** t
        c2 = 1 - BETAS[1] ** t
        for k in LEAVES:
            m[k].mul_(BETAS[0]).add_(g[k], alpha=1 - BETAS[0])
            v[k].mul_(BETAS[1]).addcmul_(g[k], g[k], value=1 - BETAS[1])
            denom = (v[k].sqrt() / math.sqrt(c2)).add_(EPS)
            p[k].addcdiv_(m[k], denom, value=-lr / c1)
        del g
        if t in marks:
            delta_at[t] = delta()
    return {"losses": losses, "grad1": grad1, "delta": delta(),
            "delta_at": delta_at}
