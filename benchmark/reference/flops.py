"""Operations and bytes that the benchmark's work needs, computed from its
shapes. A model's FLOPs count each product the model states once: no
recompute, no padded rows, no rows an expert does not own. A kernel's
count is what its inputs need: each input byte read once, each output
byte written once, each product of a live (query, key) pair once."""

from __future__ import annotations

from typing import Dict


def causal_pairs(t: int) -> int:
    """Live (query, key) pairs of one causal head of ``t`` positions."""
    return t * (t + 1) // 2


def attention_pairs(t: int, causal: bool) -> int:
    return causal_pairs(t) if causal else t * t


def flash_fwd(bh: int, t: int, d: int, causal: bool) -> Dict[str, float]:
    """The forward: ``S = Q K^T`` and ``O = P V`` (4 d a live pair);
    reads q, k, v, writes o and the row log-sum-exp."""
    pairs = bh * attention_pairs(t, causal)
    return {"flops": 4.0 * d * pairs,
            "bytes": 4.0 * bh * t * (4 * d + 1)}


def flash_bwd(bh: int, t: int, d: int, causal: bool) -> Dict[str, float]:
    """dq and dk/dv together: ``S``, ``dP = dO V^T``, ``dV``, ``dQ``,
    ``dK`` (10 d a live pair); reads q, k, v, dO, the log-sum-exp and
    delta, writes dq, dk, dv."""
    pairs = bh * attention_pairs(t, causal)
    return {"flops": 10.0 * d * pairs,
            "bytes": 4.0 * bh * t * (7 * d + 2)}


def segment_move(payload_bytes: float) -> Dict[str, float]:
    """The segment move: each moved byte read once and written once."""
    return {"flops": 0.0, "bytes": 2.0 * payload_bytes}


def expert_step(tokens: int, d_model: int, d_ff: int) -> float:
    """One read-path expert step: forward ``x w1``, ``h w2`` (4 N D F) and
    the weight gradients ``h^T dy``, ``dy w2^T``, ``x^T dh`` (6 N D F)."""
    return 10.0 * tokens * d_model * d_ff


def attention_layer_forward(heads: int, t: int, d: int, causal: bool,
                            sequences: int = 1) -> float:
    return flash_fwd(sequences * heads, t, d, causal)["flops"]


def transformer_step(vocab: int, d_model: int, heads: int, head_dim: int,
                     d_ff: int, layers: int, experts: int, seq_len: int,
                     batch: int) -> float:
    """One training step of the top-1 MoE transformer: three times the
    forward (the backward takes two products for each of its one).
    Per token and layer: q, k, v and the output projection, the router,
    one expert's two products; per sequence and layer: causal attention;
    per token: the unembedding."""
    inner = heads * head_dim
    per_token_layer = 2 * d_model * (3 * inner) + 2 * inner * d_model \
        + 2 * d_model * experts + 4 * d_model * d_ff
    tokens = batch * seq_len
    forward = tokens * (layers * per_token_layer + 2 * d_model * vocab) \
        + layers * attention_layer_forward(heads, seq_len, head_dim, True,
                                           batch)
    return 3.0 * forward
