"""Cases of the grouped expert products (``ops/grouped_ffn.py``), shared by
the CPU tests (``test_torch_grouped_ffn.py``) and the card tests
(``test_torch_kernels_cuda.py``); imports neither JAX nor the JAX package.

A case is rows sorted by expert, ``x [R, D]``, expert weights ``w1 [E, D,
F]`` and ``w2 [E, F, D]``, and ``counts [E]`` (int32): expert ``j`` owns
``counts[j]`` rows, experts in order from row 0, and rows past
``counts.sum()`` belong to none. :func:`one_hot_ffn` is the one-hot
formula the transformer used before the grouped products: every row
through every expert, the other experts' rows zeroed, the tp partial
products summed in tp order."""

import numpy as np
import torch
import torch.nn.functional as F

# the training cell's shapes (Switch-Base-8 on make_mesh(8)): 2 exchange
# groups x 2 shards x 8,192 receive slots, 8 experts, half the slots live
CELL = dict(R=32768, E=8, D=768, Fd=3072, live=16384)
KINDS = ("random", "one_expert", "tail", "empty")


def segment_counts(kind: str, R: int, E: int, live: int,
                   rng: np.random.Generator) -> np.ndarray:
    """int32 row counts of the ``E`` experts: ``random`` (uneven, two
    experts empty, ``live`` rows in all), ``one_expert`` (every live row
    to one expert), ``tail`` (even, half the rows live), ``empty`` (no
    row live), ``even`` (``live`` rows, as evenly as they split: the
    training cell's near-uniform routing)."""
    if kind == "random":
        p = rng.dirichlet(np.ones(E))
        p[rng.choice(E, 2, replace=False)] = 0
        c = np.floor(p / p.sum() * live).astype(np.int64)
        c[np.argmax(c)] += live - c.sum()
    elif kind == "one_expert":
        c = np.zeros(E, np.int64)
        c[E // 2 + 1 if E > 1 else 0] = live
    elif kind == "tail":
        c = np.full(E, R // 2 // E, np.int64)
    elif kind == "empty":
        c = np.zeros(E, np.int64)
    elif kind == "even":
        c = np.full(E, live // E, np.int64)
        c[:live % E] += 1
    else:
        raise ValueError(kind)
    assert c.sum() <= R
    return c.astype(np.int32)


def grouped_case(kind: str, R: int, E: int, D: int, Fd: int, live: int,
                 dtype=torch.float32, seed: int = 0):
    """(x, w1, w2, counts) on the CPU, weights scaled as the transformer
    draws them; rows of no expert are random too (they must not leak)."""
    rng = np.random.default_rng(seed)
    counts = torch.from_numpy(segment_counts(kind, R, E, live, rng))
    x = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    w1 = torch.from_numpy(
        rng.standard_normal((E, D, Fd)).astype(np.float32)) * D ** -0.5
    w2 = torch.from_numpy(
        rng.standard_normal((E, Fd, D)).astype(np.float32)) * Fd ** -0.5
    return x.to(dtype), w1.to(dtype), w2.to(dtype), counts


def expert_of_rows(counts: torch.Tensor, R: int) -> torch.Tensor:
    """Each row's expert (``E`` for rows of none)."""
    E = counts.shape[0]
    ids = torch.repeat_interleave(torch.arange(E), counts.long().cpu())
    tail = torch.full((R - ids.numel(),), E, dtype=ids.dtype)
    return torch.cat([ids, tail]).to(counts.device)


def one_hot_ffn(x, w1, w2, expert, tp: int = 1):
    """``y [R, D]``: the one-hot expert FFN on rows with expert ids
    ``expert [R]`` (ids outside ``[0, E)`` match no expert)."""
    E, Fd = w1.shape[0], w1.shape[2]
    oh = (expert[:, None] == torch.arange(E, device=x.device)).to(x.dtype)
    xe = torch.einsum("re,rd->erd", oh, x)                 # [E, R, D]
    ft = Fd // tp
    w1t = w1.reshape(E, -1, tp, ft).permute(2, 0, 1, 3)    # [tp, E, D, ft]
    w2t = w2.reshape(E, tp, ft, -1).permute(1, 0, 2, 3)    # [tp, E, ft, D]
    h = F.gelu(torch.matmul(xe[None], w1t), approximate="tanh")
    ye = torch.matmul(h, w2t)                              # [tp, E, R, D]
    parts = torch.einsum("re,uerd->urd", oh, ye)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out
