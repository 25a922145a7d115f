#!/usr/bin/env python3
"""Time and check the port's flash-attention kernels on one NVIDIA H100.

    python3 flash_bench.py [--root DIR] [--reps N] [--errors] [--cases]

Times the three kernels at the main path's shape, ``[32, 32768, 128]``
float32, causal (one LLaMA-2-7B-32K attention layer, as ``chip_smoke.py``'s
``flash_at_main_shapes``), with SDPA's memory-efficient float32 forward
and backward as the yardstick: CUDA-event medians in ms over ``--reps``
calls after one warm-up call. q, k, v and the cotangent come from a
seeded generator on the card; lse from the forward kernel, delta =
rowsum(dO * O).

``--errors`` adds, at that shape, the largest distance of O and lse from
the plain forward and of dq, dk and dv from the plain backward (on the
plain forward's lse and delta), beside SDPA's distance (O, dq, dk, dv)
from the same plain versions, with the tolerances (O: 1e-4 max|O| +
1e-6; lse: the largest |error| / (1e-5 (1 + |lse|)), at most 1).
``--cases`` adds, for a few small cases (the vanishing gradient at T = 1
among them), each kernel's (forward: O and lse; backward: dq, dk, dv) and
the plain version's largest distance from float64 (O and the gradients),
and the card tests' tolerances (grads: 1e-3 max|g| + max(1e-5, 4 x the
plain version's distance from float64)).

``--root`` names the checkout whose ``sparkucx_tpu_torch`` is imported
(default: this script's directory), so two versions of the kernels can be
compared on one card within one machine session, run in turns (parent,
change, change, parent). Prints one JSON line, with the card's name and
power limit as nvidia-smi reports them. Exits non-zero without a CUDA
device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from chip_smoke import (card_line, float64_grads, grad_tol, median_ms,
                        out_tol)

H, T, D = 32, 32_768, 128
SEED = 20261017
# (BH, T, D, causal): one key (dS cancels), a tile edge, a long causal row
CASES = ((6, 1, 128, False), (6, 1, 128, True), (1, 1, 128, False),
         (6, 1, 64, False), (6, 33, 128, False), (6, 1000, 128, True))


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def lse_ratio(got, want) -> float:
    """The largest |got - want| / (1e-5 (1 + |want|)): at most 1 within
    the lse tolerance."""
    return float(((got - want).abs() / (1e-5 * (1 + want.abs()))).max())


def main_shape_errors(tfa, q, k, v, g, scale) -> dict:
    """O and lse: the forward kernel's largest distance from the plain
    forward (SDPA's O beside it); dq, dk, dv: the kernels' and SDPA's
    largest distance from the plain versions, and the main-shape
    tolerance 1e-3 max|g| + 1e-5."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    po, plse = tfa.flash_fwd_plain(q, k, v, True, scale)
    ko, klse = tfa.flash_fwd_kernel(q, k, v, True, scale)
    out = {"O": {"kernel": max_err(ko, po), "tolerance": out_tol(po)},
           "lse": {"kernel": max_err(klse, plse),
                   "kernel_over_tolerance": lse_ratio(klse, plse)}}
    del ko, klse
    delta = (g * po).sum(dim=-1)
    plain = (tfa.flash_dq_plain(q, k, v, g, plse, delta, True, scale),
             *tfa.flash_dkv_plain(q, k, v, g, plse, delta, True, scale))
    kern = (tfa.flash_dq_kernel(q, k, v, g, plse, delta, True, scale),
            *tfa.flash_dkv_kernel(q, k, v, g, plse, delta, True, scale))
    for name, got, want in zip(("dq", "dk", "dv"), kern, plain):
        out[name] = {"kernel": max_err(got, want),
                     "tolerance": grad_tol(want)}
    del kern
    leaves = [x[None].clone().requires_grad_() for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lo = F.scaled_dot_product_attention(*leaves, is_causal=True)
        out["O"]["sdpa"] = max_err(lo[0].detach(), po)
        lib = torch.autograd.grad(lo, leaves, g[None])
    for name, got, want in zip(("dq", "dk", "dv"), lib, plain):
        out[name]["sdpa"] = max_err(got[0], want)
    return out


def case_errors(tfa, dev) -> list:
    """Per small case: each kernel's and the plain version's largest
    distance from float64, and the card tests' tolerances."""
    import torch
    rows = []
    for bh, t, d, causal in CASES:
        rng = np.random.default_rng(bh * 1_000_003 + t * 1009 + d * 7
                                    + int(causal))
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (bh, t, d)).astype(np.float32)).to(dev) for _ in range(4))
        scale = d ** -0.5
        po, plse = tfa.flash_fwd_plain(q, k, v, causal, scale)
        ko, klse = tfa.flash_fwd_kernel(q, k, v, causal, scale)
        delta = (g * po).sum(dim=-1)
        kern = (tfa.flash_dq_kernel(q, k, v, g, plse, delta, causal, scale),
                *tfa.flash_dkv_kernel(q, k, v, g, plse, delta, causal,
                                      scale))
        plain = (tfa.flash_dq_plain(q, k, v, g, plse, delta, causal, scale),
                 *tfa.flash_dkv_plain(q, k, v, g, plse, delta, causal,
                                      scale))
        o64, truth = float64_grads(q, k, v, g, causal, scale)
        row = {"bh": bh, "t": t, "d": d, "causal": causal,
               "O": {"kernel_vs_plain": max_err(ko, po),
                     "tolerance": out_tol(po),
                     "kernel_vs_float64": max_err(ko.double(), o64),
                     "plain_vs_float64": max_err(po.double(), o64)},
               "lse": {"kernel_vs_plain": max_err(klse, plse),
                       "kernel_over_tolerance": lse_ratio(klse, plse)}}
        for name, got, want, exact in zip(("dq", "dk", "dv"), kern, plain,
                                          truth):
            plain_err = max_err(want.double(), exact)
            row[name] = {
                "kernel_vs_plain": max_err(got, want),
                "tolerance": grad_tol(want, plain_err),
                "kernel_vs_float64": max_err(got.double(), exact),
                "plain_vs_float64": plain_err}
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--cases", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    backend.kernel_library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, g = (torch.randn((H, T, D), generator=gen, device=dev)
                  for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa.flash_fwd_kernel(q, k, v, True, scale)
    delta = (g * o).sum(dim=-1)
    del o
    ms = {
        "flash_fwd": median_ms(lambda: tfa.flash_fwd_kernel(
            q, k, v, True, scale), args.reps, warmup=1),
        "flash_dq": median_ms(lambda: tfa.flash_dq_kernel(
            q, k, v, g, lse, delta, True, scale), args.reps, warmup=1),
        "flash_dkv": median_ms(lambda: tfa.flash_dkv_kernel(
            q, k, v, g, lse, delta, True, scale), args.reps, warmup=1)}
    leaves = [x[None].clone().requires_grad_() for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lo = F.scaled_dot_product_attention(*leaves, is_causal=True)
        sdpa = {
            "forward_ms": median_ms(lambda: F.scaled_dot_product_attention(
                *leaves, is_causal=True), args.reps, warmup=1),
            "backward_ms": median_ms(lambda: torch.autograd.grad(
                lo, leaves, g[None], retain_graph=True), args.reps,
                warmup=1)}
    del lo, leaves
    out = {
        "root": os.path.abspath(args.root), "card": card_line(),
        "shape": [H, T, D], "causal": True, "reps": args.reps,
        "build_s": build_s, "kernel_ms": ms,
        "backward_ms": ms["flash_dq"] + ms["flash_dkv"], "sdpa": sdpa,
        "backward_vs_sdpa": (ms["flash_dq"] + ms["flash_dkv"])
        / sdpa["backward_ms"]}
    if args.errors:
        out["errors_vs_plain"] = main_shape_errors(tfa, q, k, v, g, scale)
    if args.cases:
        del q, k, v, g, lse, delta
        out["cases"] = case_errors(tfa, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
