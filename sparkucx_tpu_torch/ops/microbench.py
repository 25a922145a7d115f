"""Microbench of the segment-reduce kernels (B.3 ``segment_reduce`` and
B.4 ``segment_reduce_wire``), the JAX package's
``ops/pallas/microbench.py`` over the port's kernels. Three arms per
case:

``torch``
    The plain twins (``impl="jnp"`` through the same public wrappers the
    reader calls: ``ops/aggregate.combine_rows``, after
    ``wire_unpack_rows`` on the int8 case). Timed everywhere — on the
    card on CUDA tensors, elsewhere on the CPU.

``cuda``
    The hand-written kernels (``impl="pallas"`` on CUDA tensors). Timed
    on the card; anywhere else the arm records ``status="skipped"`` with
    the reason, never a time.

``parity``
    Kernel against twin on the card, not timed but graded: bit-exact on
    the int32 and the integer-valued float32 cases (sums and carried
    lanes); on the int8-fused case keys and counts exact and each float32
    sum held to the exact (float64) sum: the kernel's within
    :data:`KERNEL_SIGMAS` standard errors of float32 summation in row
    order, the twin's (a float64 prefix-sum difference, rounded once)
    within its worst-case bound. No order is part of the contract.
    Elsewhere skipped with the reason.

The reference's ``programs`` block gates XLA compiles through its step
cache; eager PyTorch compiles nothing per shape, so here it counts the
kernel library's ``nvcc`` builds in the run: at most one on the first
pass (none when the build cache already holds the library), none on the
warm pass. ``launches`` counts each kernel's launches in the run.

``python -m sparkucx_tpu_torch kernelbench`` prints the artifact as one
JSON document.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

_FLIP = np.int32(-0x80000000)
WIRE_SEED = 7
# the int8 grade: a kernel sum may stray from the exact sum by this many
# of float32 summation's standard errors, 2**-24 * sqrt(sum of the run's
# squared partial sums). The kernel sums each run in float32 in row
# order; on an H100 its sums of the 2**20-row case reach 1.59 of them,
# as the same order gives on the CPU. A dropped row or float16
# accumulation lands orders of magnitude past the bound.
KERNEL_SIGMAS = 4.0
NO_CARD = "no CUDA device (torch.cuda.is_available() is false)"


def make_sorted_rows(rng, n: int, cap: int, num_parts: int, width: int,
                     groups: int, sum_words: int,
                     float_vals: bool = False):
    """Sorted-contract rows for the kernels, as numpy: ``n`` valid rows in
    (part, key) order, sentinel-padded to ``cap``, carried lanes (past
    ``sum_words``) per-key constants (the representative row of a run is
    arbitrary, so a non-constant carried lane would be a fault of the
    data). The JAX package's ``make_sorted_rows``, draw for draw."""
    groups = max(1, min(groups, n)) if n else 1
    part = np.sort(rng.integers(0, num_parts, size=groups)
                   .astype(np.int32))
    hi = rng.integers(-5, 5, size=groups).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, size=groups,
                      dtype=np.int64).astype(np.int32)
    order = np.lexsort((lo ^ _FLIP, hi, part))
    part, hi, lo = part[order], hi[order], lo[order]
    gid = np.sort(rng.integers(0, groups, size=n)) if n \
        else np.zeros(0, np.int64)
    sw = sum_words if sum_words > 0 else width - 2
    rows = np.zeros((cap, width), np.int32)
    p = np.full(cap, num_parts, np.int32)
    rows[:n, 0] = lo[gid]
    rows[:n, 1] = hi[gid]
    p[:n] = part[gid]
    carried = rng.integers(-1000, 1000,
                           size=(groups, width - 2 - sw)).astype(np.int32)
    if float_vals:
        # integer-valued float32: exactly summable in any order, so the
        # bit-exact grade is meaningful on the float case too
        sums = rng.integers(-64, 64, size=(n, sw)).astype(np.float32)
        rows[:n, 2:2 + sw] = sums.view(np.int32)
    else:
        rows[:n, 2:2 + sw] = rng.integers(
            -2**31, 2**31, size=(n, sw), dtype=np.int64).astype(np.int32)
    rows[:n, 2 + sw:] = carried[gid]
    return rows, p


def default_cases(rows_log2: int = 13) -> List[dict]:
    """The shape families the sweep times (the JAX package's five):
    ``big_*`` carry the bulk signal (2^rows_log2 rows); the small ones pin
    the ragged corners (unaligned, one segment over many tiles)."""
    n = 1 << rows_log2
    return [
        dict(name="big_i32", n=n, cap=n, parts=16, width=8, groups=256,
             sum_words=2, float_vals=False),
        dict(name="big_f32", n=n, cap=n, parts=16, width=8, groups=256,
             sum_words=2, float_vals=True),
        dict(name="ragged_unaligned", n=129, cap=256, parts=4, width=6,
             groups=37, sum_words=2, float_vals=False),
        dict(name="one_segment_many_tiles", n=max(384, n // 4),
             cap=max(384, n // 4), parts=2, width=6, groups=1,
             sum_words=0, float_vals=False),
        dict(name="wire_int8_fused", n=n, cap=n, parts=16, width=6,
             groups=256, sum_words=0, float_vals=True, wire=True),
    ]


def case_rows(case: dict, seed: int = 0):
    """The case's full-width rows and partitions (numpy; the int8 case's
    float lanes scaled so quantization is not trivial), before any wire
    packing."""
    rng = np.random.default_rng(seed)
    rows, part = make_sorted_rows(
        rng, case["n"], case["cap"], case["parts"], case["width"],
        case["groups"], case["sum_words"],
        float_vals=case["float_vals"])
    if case.get("wire"):
        n = case["n"]
        fl = rows[:n, 2:].view(np.float32) * np.float32(0.37)
        rows[:n, 2:] = fl.view(np.int32)
    return rows, part


def case_uniforms(case: dict) -> torch.Tensor:
    """The int8 case's rounding noise ``[1, cap, width - 2]``, drawn on
    the CPU from seed :data:`WIRE_SEED`, so the card and the CPU see the
    same inputs."""
    from sparkucx_tpu_torch.shuffle.alltoall import wire_uniforms
    return wire_uniforms((1, case["cap"], case["width"] - 2), [WIRE_SEED],
                         torch.device("cpu"))


def case_inputs(case: dict, device, seed: int = 0):
    """``(rows [1, cap, W], part [1, cap])`` tensors on ``device``: one
    shard of the sorted contract; the int8 case's rows in the wire
    format."""
    rows, part = case_rows(case, seed)
    t = torch.from_numpy(rows)[None]
    if case.get("wire"):
        from sparkucx_tpu_torch.shuffle.alltoall import wire_pack_rows
        t = wire_pack_rows(t, case["width"] - 2, case_uniforms(case))
    return (t.contiguous().to(device),
            torch.from_numpy(part)[None].contiguous().to(device))


def build_step(case: dict, impl: str):
    """The case's reduce through the public wrapper: ``impl="jnp"`` the
    twin, ``"pallas"`` the kernel. Returns ``fn(rows, part)``."""
    from sparkucx_tpu_torch.ops.segmented import (segment_reduce_rows,
                                                  segment_reduce_wire_rows)
    if case.get("wire"):
        width = case["width"]

        def fn(rows, part):
            return segment_reduce_wire_rows(
                rows, part, case["parts"], width, width - 2,
                sum_words=case["sum_words"], impl=impl)
    else:
        vdt = np.float32 if case["float_vals"] else np.int32

        def fn(rows, part):
            return segment_reduce_rows(
                rows, part, case["parts"], case["width"] - 2, vdt,
                sum_words=case["sum_words"], impl=impl)
    return fn


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_step(step, rows, part, reps: int) -> dict:
    dev = rows.device
    step(rows, part)                 # warmup
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        step(rows, part)
    _sync(dev)
    wall = (time.perf_counter() - t0) / max(1, reps)
    return {"wall_ms": wall * 1e3,
            "rows_per_s": (rows.shape[1] / wall) if wall > 0 else 0.0}


def _host(out) -> tuple:
    rows, counts, n = out
    return (rows[0].cpu().numpy(), counts[0].cpu().numpy(),
            int(n[0].item()))


def wire_run_sums(case: dict, rows: torch.Tensor, part: torch.Tensor):
    """The int8 case's exact per-run sums and the grade's bounds, from
    the dequantized wire rows (runs of equal (partition, key) in the
    sorted contract): (float64 sums ``[runs, sw]``, the kernel's bound
    ``KERNEL_SIGMAS * 2**-24 * sqrt(sum S_i**2)`` over the run's exact
    partial sums ``S_i``, the twin's worst-case bound
    ``2**-24 * |sum| + 4 * (k + 1) * 2**-53 * sum|v|`` over the ``k`` rows
    its float64 prefix sum runs through up to each run's end)."""
    from sparkucx_tpu_torch.shuffle.alltoall import wire_unpack_rows
    width, n = case["width"], case["n"]
    full = wire_unpack_rows(rows, width, width - 2)[0, :n].cpu().numpy()
    p = part[0, :n].cpu().numpy()
    sw = case["sum_words"] or width - 2
    vals = full[:, 2:2 + sw].view(np.float32).astype(np.float64)
    change = (p[1:] != p[:-1]) | (full[1:, 0] != full[:-1, 0]) \
        | (full[1:, 1] != full[:-1, 1])
    rid = np.concatenate([[0], np.cumsum(change)]) if n else \
        np.zeros(0, np.int64)
    runs = int(rid[-1]) + 1 if n else 0
    starts = np.flatnonzero(np.r_[True, change]) if n else \
        np.zeros(0, np.int64)
    ends = np.r_[starts[1:], n] - 1 if n else np.zeros(0, np.int64)
    incl = np.cumsum(vals, axis=0)
    before = np.zeros((runs, sw))
    if runs > 1:
        before[1:] = incl[starts[1:] - 1]
    partial = incl - before[rid]          # S_i, restarted at each run
    sums, sq = (np.stack([np.bincount(rid, x[:, j], runs)
                          for j in range(sw)], axis=1)
                for x in (vals, partial ** 2))
    cum = np.cumsum(np.abs(vals), axis=0)[ends] if n else sums
    u, u64 = 2.0 ** -24, 2.0 ** -53
    # the twin's float64 prefix error, twice over (the exact sums' own
    # is far below it), then one rounding to float32
    twin = (u * np.abs(sums) + 4 * (ends + 1)[:, None] * u64 * cum) \
        * (1 + 2.0 ** -20)
    return sums, KERNEL_SIGMAS * u * np.sqrt(sq), twin


def parity_grade(case: dict, tout, kout, exact=None) -> dict:
    """Grade the kernel's output against the twin's (the JAX package's
    ``_parity_grade``): counts and n exact; rows bit-exact. On the int8
    case keys exact, and each float sum against the exact sum ``exact``
    (:func:`wire_run_sums`): the kernel's within its statistical bound,
    the twin's within its worst-case one. The reference's fixed
    ``rtol=1e-5, atol=1e-4`` between the two assumes its default runs of
    about 32 rows; ``ref_tolerance_ok`` reports it beside ``maxdiff``."""
    jr, jc, k = _host(tout)
    pr, pc, pn = _host(kout)
    ok_n = k == pn
    ok_c = np.array_equal(jc, pc)
    ja, pa = jr[:k], pr[:k]
    if case.get("wire"):
        ok_keys = np.array_equal(ja[:, :2], pa[:, :2])
        jv = ja[:, 2:].view(np.float32)
        pv = pa[:, 2:].view(np.float32)
        maxdiff = float(np.abs(jv - pv).max()) if k else 0.0
        sums, kbound, tbound = exact
        sw = sums.shape[1]
        same = sums.shape[0] == k
        kerr = np.abs(pv[:, :sw] - sums) if same else None
        terr = np.abs(jv[:, :sw] - sums) if same else None
        ok_v = same and bool((kerr <= kbound).all()
                             and (terr <= tbound).all())

        def over(err, bound):
            return float((err / np.maximum(bound, 1e-300)).max()) \
                if same and k else None
        return {"ok": bool(ok_n and ok_c and ok_keys and ok_v),
                "n_out": k, "maxdiff": maxdiff,
                "kernel_max_err": float(kerr.max()) if same and k else None,
                "kernel_err_over_bound": over(kerr, kbound),
                "twin_err_over_bound": over(terr, tbound),
                "ref_tolerance_ok": bool(
                    np.allclose(jv, pv, rtol=1e-5, atol=1e-4))}
    ok_r = np.array_equal(ja, pa)
    return {"ok": bool(ok_n and ok_c and ok_r), "n_out": k,
            "bitexact": bool(ok_r)}


def run_microbench(reps: int = 5, rows_log2: int = 13,
                   device=None, cases: Optional[List[dict]] = None) -> Dict:
    """The artifact: per-case twin timing everywhere, kernel timing and
    parity grades on the card, the kernel library's builds over a
    first-pass / warm-pass split, and each kernel's launches."""
    from sparkucx_tpu_torch import backend
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = backend.resolve_device(device)
    native = dev.type == "cuda"
    gate = None if native else NO_CARD
    cases = cases if cases is not None else default_cases(rows_log2)

    builds0 = backend.build_count()
    launches0 = backend.launch_counts()
    results = []
    steps = []                       # (step, rows, part) for warm pass
    for case in cases:
        rows, part = case_inputs(case, dev)
        row = {"case": case["name"], "rows": case["n"],
               "cap": case["cap"], "width": case["width"],
               "wire": "int8" if case.get("wire") else "raw"}
        tstep = build_step(case, "jnp")
        steps.append((tstep, rows, part))
        row["torch"] = dict(status="ok", device=dev.type,
                            **_time_step(tstep, rows, part, reps))
        if native:
            kstep = build_step(case, "pallas")
            steps.append((kstep, rows, part))
            row["cuda"] = dict(status="ok",
                               **_time_step(kstep, rows, part, reps))
            exact = wire_run_sums(case, rows, part) if case.get("wire") \
                else None
            row["parity"] = dict(
                status="ok", mode="cuda",
                **parity_grade(case, tstep(rows, part),
                               kstep(rows, part), exact))
        else:
            # a CPU time of the plain version is not the kernel's: a
            # skip with its reason is the record
            row["cuda"] = {"status": "skipped", "reason": gate}
            row["parity"] = {"status": "skipped", "reason": gate}
        results.append(row)

    first_pass = backend.build_count() - builds0
    for step, rows, part in steps:
        step(rows, part)
    _sync(dev)
    warm = backend.build_count() - builds0 - first_pass
    expected = 1 if native else 0
    programs = {"first_pass": first_pass, "expected": expected,
                "warm_recompiles": warm,
                "ok": first_pass <= expected and warm == 0}
    launches1 = backend.launch_counts()
    launches = {k: v - launches0.get(k, 0) for k, v in launches1.items()
                if v - launches0.get(k, 0)}
    parity_ok = all(r["parity"].get("ok", True) for r in results
                    if r["parity"]["status"] == "ok")
    return {"metric": "kernelbench", "backend": dev.type,
            "native_cuda": bool(native), "gate_reason": gate,
            "reps": reps, "cases": results, "programs": programs,
            "launches": launches,
            "ok": bool(parity_ok and programs["ok"])}
