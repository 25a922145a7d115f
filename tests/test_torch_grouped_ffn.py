"""The grouped expert products (``sparkucx_tpu_torch/ops/grouped_ffn.py``)
on the CPU, where they run their plain versions, against the one-hot
formula the transformer used before them (``torch_grouped_cases.
one_hot_ffn``): the output and the gradients of x, w1 and w2 for uneven
segments with empty experts, every row to one expert, rows past the
owned ones, tp = 1 and 2, float32 and bfloat16; a NaN row poisons its
output and its expert's weight gradients; the transformer's grouping
(``models/transformer._grouped_experts``) against the one-hot formula on
received rows, its poison for a row whose expert id no local expert owns,
and the wrapper's refusals. The card tests (``test_torch_kernels_cuda.
py -k grouped``) hold the kernels against these plain versions."""

import numpy as np
import pytest
import torch

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.models import transformer as tt
from sparkucx_tpu_torch.ops import grouped_ffn as gf
from torch_grouped_cases import (KINDS, expert_of_rows, grouped_case,
                                 one_hot_ffn)

R, E, D, FD = 96, 4, 16, 32
# float32: the same products in another blocking; bfloat16: both sides
# round every product to 8 mantissa bits, at different points
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _close(got, want, rel, what=""):
    got, want = got.float(), want.float()
    if not want.numel():
        assert got.shape == want.shape, what
        return
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _grads(fn, x, w1, w2, seed=1):
    """fn's output and the gradients of <fn(x, w1, w2), g> for a fixed
    random cotangent g."""
    x, w1, w2 = (t.clone().requires_grad_() for t in (x, w1, w2))
    y = fn(x, w1, w2)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
    dx, dw1, dw2 = torch.autograd.grad((y * g.to(y.dtype)).sum(),
                                       (x, w1, w2))
    return y.detach(), dx, dw1, dw2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_ffn_matches_one_hot(kind, tp, dtype):
    x, w1, w2, counts = grouped_case(kind, R, E, D, FD, live=80, dtype=dtype)
    ids = expert_of_rows(counts, R)
    got = _grads(lambda a, b, c: gf.grouped_ffn(a, b, c, counts, tp),
                 x, w1, w2)
    want = _grads(lambda a, b, c: one_hot_ffn(a, b, c, ids, tp), x, w1, w2)
    for name, g, w in zip(("y", "dx", "dw1", "dw2"), got, want):
        _close(g, w, TOL[dtype], name)
    owned = int(counts.sum())
    assert not got[0][owned:].any() and not got[1][owned:].any()
    assert got[0].dtype == dtype and got[2].dtype == dtype


def test_nan_row_poisons_output_and_its_expert():
    x, w1, w2, counts = grouped_case("random", R, E, D, FD, live=80)
    j = int(torch.argmax(counts))
    r = int(gf.segment_offsets(counts)[j]) + 1
    x[r, 3] = float("nan")
    y, dx, dw1, dw2 = _grads(
        lambda a, b, c: gf.grouped_ffn(a, b, c, counts), x, w1, w2)
    assert torch.isnan(y[r]).all()
    rows = torch.ones(R, dtype=torch.bool)
    rows[r] = False
    assert torch.isfinite(y[rows]).all()
    assert torch.isnan(dw1[j]).all() and torch.isnan(dw2[j]).all()
    others = [k for k in range(E) if k != j]
    assert torch.isfinite(dw1[others]).all()


def test_segments_from_sorted_give_counts_and_offsets():
    """One searchsorted gives every expert's int32 count and offset in a
    sorted key, empty experts included; sentinel keys past the last
    expert are in no segment."""
    key = torch.tensor([0, 0, 2, 2, 2, 3, 5, 5, 5], dtype=torch.int32)
    counts, offsets = gf.segments_from_sorted(key, 5)
    assert counts.dtype == offsets.dtype == torch.int32
    assert counts.tolist() == [2, 0, 3, 1, 0]
    assert offsets.tolist() == [0, 2, 2, 5, 6]
    assert offsets.tolist() == gf.segment_offsets(counts).tolist()


def test_plain_primitives_match_matmul_per_segment():
    """grouped_rows' three epilogues and grouped_wgrad against one matmul
    per expert, written out."""
    x, w1, _, counts = grouped_case("random", R, E, D, FD, live=80)
    off = gf.segment_offsets(counts)
    h, pre = gf.grouped_rows(x, w1, counts, off, "gelu")
    g = torch.randn(R, FD, generator=torch.Generator().manual_seed(3))
    dpre = gf.grouped_rows(g, w1.transpose(1, 2).contiguous(), counts, off)
    dw = gf.grouped_wgrad(x, g, counts, off)
    g2 = torch.randn(R, D, generator=torch.Generator().manual_seed(4))
    gg = gf.grouped_rows(g2, w1, counts, off, "gelu_grad", pre)
    for j in range(E):
        o, n = int(off[j]), int(counts[j])
        want = x[o:o + n] @ w1[j]
        _close(pre[o:o + n], want, 1e-6, "pre")
        _close(h[o:o + n], torch.nn.functional.gelu(want, approximate="tanh"),
               1e-6, "gelu")
        _close(dpre[o:o + n], g[o:o + n] @ w1[j].T, 1e-6, "rows")
        _close(dw[j], x[o:o + n].T @ g[o:o + n], 1e-6, "wgrad")
        _close(gg[o:o + n], torch.ops.aten.gelu_backward(
            g2[o:o + n] @ w1[j], want, approximate="tanh"), 1e-6, "gelu_grad")
    assert not dw[counts == 0].any()


def _received(seed, G=2, ep=2, e_local=2, cap=24):
    rng = np.random.default_rng(seed)
    recv = torch.from_numpy(rng.standard_normal((G, ep, cap, D))
                            .astype(np.float32))
    got = rng.integers(0, cap + 1, (G, ep, 1))
    rvalid = torch.from_numpy(np.arange(cap) < got)
    shard = np.arange(ep).reshape(1, ep, 1)
    rexpert = torch.from_numpy(
        (shard * e_local + rng.integers(0, e_local, (G, ep, cap)))
        .astype(np.int32))
    lp = {"w1e": torch.from_numpy(rng.standard_normal(
              (ep, e_local, D, 2, FD // 2)).astype(np.float32)) * D ** -0.5,
          "w2e": torch.from_numpy(rng.standard_normal(
              (ep, e_local, 2, FD // 2, D)).astype(np.float32)) * FD ** -0.5}
    return lp, recv, rexpert, rvalid, e_local


def _one_hot_received(lp, recv, rexpert, rvalid, e_local):
    G, ep, cap, _ = recv.shape
    E = ep * e_local
    shard = torch.arange(ep).view(1, ep, 1)
    le = rexpert - shard * e_local
    ids = torch.where(rvalid & (le >= 0) & (le < e_local), rexpert, E)
    y = one_hot_ffn(recv.reshape(-1, D), lp["w1e"].reshape(E, D, -1),
                    lp["w2e"].reshape(E, -1, D), ids.flatten().long(), tp=2)
    return y.reshape(G, ep, cap, D)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transformer_grouping_matches_one_hot(seed):
    """The transformer's sort by expert over every receiving shard, the
    grouped products and the return to received order, forward and the
    gradients, against the one-hot formula on the received rows (rows
    past a shard's received count give zero)."""
    lp, recv, rexpert, rvalid, e_local = _received(seed)

    def run(fn):
        w1 = lp["w1e"].clone().requires_grad_()
        w2 = lp["w2e"].clone().requires_grad_()
        r = recv.clone().requires_grad_()
        y = fn({"w1e": w1, "w2e": w2}, r, rexpert, rvalid, e_local)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        return (y.detach(),) + torch.autograd.grad((y * g).sum(),
                                                   (r, w1, w2))

    got = run(tt._grouped_experts)
    want = run(_one_hot_received)
    for name, g, w in zip(("y", "drecv", "dw1", "dw2"), got, want):
        _close(g, w, 1e-5, name)
    assert not got[0][~rvalid].any()


def test_transformer_grouping_poisons_unowned_expert_id():
    """A received row whose expert id belongs to another shard's experts,
    or to none (a poisoned exchange's id column), comes back NaN and is
    never dropped; the other rows are untouched."""
    lp, recv, rexpert, rvalid, e_local = _received(0)
    rvalid[:] = True
    rexpert = rexpert.clone()
    rexpert[0, 0, 3] = e_local          # shard 1's first expert
    rexpert[1, 1, 5] = -2 ** 31         # a NaN id cast to int32 on the CPU
    y = tt._grouped_experts(lp, recv, rexpert, rvalid, e_local)
    bad = torch.zeros(rvalid.shape, dtype=torch.bool)
    bad[0, 0, 3] = bad[1, 1, 5] = True
    assert torch.isnan(y[bad]).all() and torch.isfinite(y[~bad]).all()


def test_cpu_runs_plain_and_launches_nothing():
    x, w1, w2, counts = grouped_case("random", R, E, D, FD, live=80)
    before = backend.launch_counts().get(gf.KERNEL_NAME, 0)
    gf.grouped_ffn(x.requires_grad_(), w1, w2, counts).sum().backward()
    assert backend.launch_counts().get(gf.KERNEL_NAME, 0) == before
    assert gf.impl_for(torch.device("cpu")) == "plain"
    assert gf.impl_for(torch.device("cuda", 0)) == "grouped"


def test_wrappers_refuse_bad_input():
    x, w1, _, counts = grouped_case("random", R, E, D, FD, live=80)
    off = gf.segment_offsets(counts)
    with pytest.raises(ValueError, match="CUDA"):
        gf.grouped_rows_kernel(x, w1, counts, off)
    with pytest.raises(ValueError, match="CUDA"):
        gf.grouped_wgrad_kernel(x, x, counts, off)
    with pytest.raises(ValueError, match="int32"):
        gf.grouped_rows(x, w1, counts.long(), off)
    with pytest.raises(ValueError, match="share"):
        gf.grouped_rows(x.double(), w1, counts, off)
    with pytest.raises(ValueError, match="tp"):
        gf.grouped_ffn(x, w1, w1.transpose(1, 2), counts, tp=3)


def test_expert_spans_name_the_impl(monkeypatch):
    """A training step's forward and remat re-forward open one
    ``moe.experts`` span a layer and microbatch, its backward one
    ``moe.experts.backward``; on the CPU both say ``impl="plain"``."""
    from sparkucx_tpu_torch.utils.trace import Tracer
    t = Tracer(enabled=True)
    monkeypatch.setattr(tt, "GLOBAL_TRACER", t)
    monkeypatch.setattr(gf, "GLOBAL_TRACER", t)
    cfg = tt.TransformerConfig()
    g = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in
              tt.init_params(cfg, g, device="cpu").items()}
    toks = torch.randint(0, cfg.vocab, (8, cfg.seq_len + 1), generator=g)
    tt.loss_fn(params, toks[:, :-1], toks[:, 1:], tt.make_mesh(8),
               cfg).backward()
    LM = cfg.num_layers * cfg.microbatches
    fwd, bwd = t.spans("moe.experts"), t.spans("moe.experts.backward")
    assert len(fwd) == 2 * LM and len(bwd) == LM
    assert {s.attrs["impl"] for s in fwd + bwd} == {"plain"}
