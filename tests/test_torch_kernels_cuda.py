"""The port's kernels on the card: each hand-written kernel against its
plain PyTorch version on identical CUDA tensors, and the plain read
through the kernel against a numpy oracle.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.ops import ragged_a2a as ra
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.shuffle.writer import hash32_np
from torch_attention_cases import (FLASH_BH, FLASH_D, FLASH_T,
                                   flash_inputs, flash_seed, float64_grads,
                                   grad_tolerance, lse_tolerance,
                                   out_tolerance, qkv_rows)
from torch_merge_cases import (MERGE_PATTERNS, MERGE_WIDTHS, OFFSET_WORDS,
                               merge_case)
from torch_wire_cases import PATTERNS as WIRE_PATTERNS
from torch_wire_cases import (QUANT_KINDS, quant_values, runs, sum_tolerance,
                              wire_case)
from torch_wire_cases import R as WIRE_R
from torch_workload_cases import (COMBINE_RUNNERS, WORKLOAD_CASES,
                                  check_same_result, runner)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _sizes(kind: str, P: int, rng) -> np.ndarray:
    if kind == "even":
        return np.full((P, P), 65, np.int32)
    if kind == "skewed":
        s = rng.integers(0, 200, size=(P, P)).astype(np.int32)
        s[0, P - 1] = 0
        s[P // 2, P // 2] = 777
        return s
    if kind == "onehot":
        s = np.zeros((P, P), np.int32)
        s[:, -1] = rng.integers(1, 90, size=P)
        return s
    return np.zeros((P, P), np.int32)


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("width", [1, 10, 25])
@pytest.mark.parametrize("kind", ["even", "skewed", "onehot", "zero",
                                  "recv_overflow"])
def test_ragged_a2a_kernel_matches_plain(card, kind, width, P):
    rng = np.random.default_rng(width * 10 + P)
    chunk = ra.chunk_rows_for(width)
    sizes = np.full((P, P), 300, np.int32) if kind == "recv_overflow" \
        else _sizes(kind, P, rng)        # 300 rows overflow a 1-chunk cap
    cap_in = max(int(ra.align_rows(int(a.sum()), chunk))
                 for a in sizes) + P * chunk
    cap_out = chunk if kind == "recv_overflow" else int(
        ra.align_rows(int(sizes.sum(axis=0).max()), chunk)) + P * chunk
    send = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(P, cap_in, width),
        dtype=np.int64).astype(np.int32)).to(card)
    sz = torch.from_numpy(sizes).to(card)
    before = backend.launch_counts().get(ra.KERNEL_NAME, 0)
    out, recv, roff, total = ra.ragged_a2a(send, sz, out_capacity=cap_out)
    torch.cuda.synchronize()
    assert backend.launch_counts()[ra.KERNEL_NAME] == before + 1
    p_out, p_recv, p_roff, p_total = ra.ragged_a2a(
        send.cpu(), sz.cpu(), out_capacity=cap_out)
    assert torch.equal(total.cpu(), p_total)
    assert torch.equal(recv.cpu(), p_recv)
    if kind == "recv_overflow":
        assert (p_total == -1).all() and not p_recv.any()
        return
    for q in range(P):
        n = int(p_total[q])
        assert torch.equal(out[q, :n].cpu(), p_out[q, :n]), f"receiver {q}"


def test_kernel_rejects_cpu_and_wrong_dtype(card):
    z = torch.zeros((2, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ra.ragged_a2a_kernel(torch.zeros((2, 128, 3), dtype=torch.int32),
                             z, z, z, torch.tensor(False), 128)
    with pytest.raises(ValueError):
        ra.ragged_a2a(torch.zeros((2, 128, 3), dtype=torch.int64,
                                  device=card), z, out_capacity=128)


@pytest.mark.parametrize("impl", ["auto", "pallas", "dense"])
def test_plain_read_on_card(card, impl):
    """connect() defaults to the card; the read goes through the kernel
    (auto/pallas) and matches the numpy oracle, overflow regrow
    included."""
    R, M = 24, 5
    rng = np.random.default_rng(3)
    keys = [rng.zipf(1.3, 3000).astype(np.int64) for _ in range(M)]
    vals = [rng.integers(0, 1 << 30, (3000, 3)).astype(np.int32)
            for _ in range(M)]
    with connect({"spark.shuffle.tpu.a2a.impl": impl,
                  "spark.shuffle.tpu.a2a.capacityFactor": "0.5"},
                 use_env=False) as svc:
        assert svc.device.type == "cuda"
        h = svc.register_shuffle(0, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        before = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        res = svc.read(h)
        launched = backend.launch_counts().get(ra.KERNEL_NAME, 0) - before
        k, v = np.concatenate(keys), np.concatenate(vals)
        part = hash32_np(k) % R
        for r in range(R):
            gk, gv = res.partition(r)
            got = sorted(zip(gk.tolist(), map(tuple, gv.tolist())))
            want = sorted(zip(k[part == r].tolist(),
                              map(tuple, v[part == r].tolist())))
            assert got == want, f"partition {r}"
        rep = svc.report(0)
    if impl == "dense":
        assert launched == 0 and rep.impl == "dense"
    else:
        assert launched == rep.retries + 1 and rep.impl == "pallas"


# -- segment reduce -----------------------------------------------------------
SEG_R = 16
SEG_PATTERNS = ("unique", "one_key", "crossing", "empty", "sentinel")


def _segreduce_shard(rng, cap, width, pattern, dtype):
    """One shard's (rows [cap, W], part [cap]) sorted by (partition, key):
    all-unique keys with a sentinel tail; one key over every row (a run
    longer than any block); runs of 1..600 rows across block edges; an
    empty shard (zero rows, all sentinel); an all-sentinel shard whose
    rows hold data the reduce must ignore."""
    rows = rng.integers(-(1 << 31), 1 << 31, (cap, width)).astype(np.int32)
    if dtype == "float32":
        rows[:, 2:] = rng.standard_normal((cap, width - 2)).astype(
            np.float32).view(np.int32)
    part = np.full(cap, SEG_R, np.int32)
    if pattern == "empty":
        return np.zeros_like(rows), part
    if pattern == "sentinel":
        return rows, part
    n_real = cap - cap // 7 if pattern == "unique" else cap
    if pattern == "unique":
        keys = rng.choice(1 << 40, n_real, replace=False).astype(np.int64)
    elif pattern == "one_key":
        keys = np.full(n_real, -(1 << 35) - 3, np.int64)
    else:
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, n_real),
                         rng.integers(1, 600, n_real))[:n_real]
    p = (rng.integers(0, SEG_R, n_real) if pattern != "one_key"
         else np.full(n_real, 3))
    if pattern == "crossing":              # a key lives in one partition
        p = (keys % SEG_R).astype(np.int64)
    order = np.lexsort((keys, p))
    rows[:n_real, :2] = keys[order].view(np.int32).reshape(n_real, 2)
    part[:n_real] = p[order]
    return rows, part


def _segreduce_case(rng, P, cap, width, pattern, dtype):
    """[P, cap, W] rows and [P, cap] part; with P > 1 the other shards
    cycle through the other patterns."""
    pats = [SEG_PATTERNS[(SEG_PATTERNS.index(pattern) + i)
                         % len(SEG_PATTERNS)] for i in range(P)]
    shards = [_segreduce_shard(rng, cap, width, q, dtype) for q in pats]
    return (np.stack([s[0] for s in shards]),
            np.stack([s[1] for s in shards]))


def _float_tolerance(rows, part, sum_words):
    """Per output row: n * 2**-24 * sum|v| over the run — the bound of
    sequential float32 summation of n terms (the kernel adds a run in row
    order in float32; the plain version adds in float64 and rounds
    once)."""
    from sparkucx_tpu_torch.ops.partition import words_to_key
    P, cap, _ = rows.shape
    tol = np.zeros((P, cap, sum_words))
    key = words_to_key(torch.from_numpy(rows[..., 0]),
                       torch.from_numpy(rows[..., 1])).numpy()
    for p in range(P):
        valid = part[p] < SEG_R
        start = valid.copy()
        start[1:] &= (key[p, 1:] != key[p, :-1]) | (part[p, 1:]
                                                    != part[p, :-1])
        run = np.cumsum(start) - 1
        v = np.abs(rows[p, :, 2:2 + sum_words].copy().view(np.float32)
                   .astype(np.float64))
        n = np.bincount(run[valid], minlength=cap)[:cap]
        for c in range(sum_words):
            s = np.bincount(run[valid], weights=v[valid, c],
                            minlength=cap)[:cap]
            tol[p, :, c] = n * 2.0 ** -24 * s
    return tol


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("width", [3, 6, 25])
@pytest.mark.parametrize("pattern", SEG_PATTERNS)
def test_segment_reduce_kernel_matches_plain(card, pattern, width, P, dtype):
    """Bit-exact for int32 ring sums, carried lanes, n_out and the zero
    tail; float32 sums within the sequential-summation bound of each run.
    Every sum_words from 0 (all carried) through a carry split to the
    whole value row."""
    from sparkucx_tpu_torch.ops import segmented as sg
    rng = np.random.default_rng(width * 100 + P * 10 + len(pattern))
    cap = 2000 if P == 8 else 5000
    rows_np, part_np = _segreduce_case(rng, P, cap, width, pattern, dtype)
    rows = torch.from_numpy(rows_np).to(card)
    part = torch.from_numpy(part_np).to(card)
    vw = width - 2
    for sw in sorted({0, vw // 2, vw}):
        fa = dtype == "float32"
        before = backend.launch_counts().get(sg.KERNEL_NAME, 0)
        kr, kp, kn = sg.segment_reduce(rows, part, SEG_R, sw, fa)
        torch.cuda.synchronize()
        assert backend.launch_counts()[sg.KERNEL_NAME] == before + 1
        pr, pp, pn = sg.segment_reduce_plain(rows, part, SEG_R, sw, fa)
        assert torch.equal(kn, pn) and torch.equal(kp, pp)
        exact = [0, 1] + list(range(2 + sw, width))
        assert torch.equal(kr[..., exact], pr[..., exact]), f"sw={sw}"
        if not fa:
            assert torch.equal(kr, pr), f"sw={sw}"
        elif sw:
            got = kr[..., 2:2 + sw].cpu().view(torch.float32).double()
            want = pr[..., 2:2 + sw].cpu().view(torch.float32).double()
            tol = _float_tolerance(rows_np, part_np, sw)
            assert ((got - want).abs().numpy() <= tol).all(), f"sw={sw}"


def test_segment_reduce_kernel_refuses_bad_input(card):
    """The wrapper rejects what the kernel does not take, and a launch the
    C entry point refuses raises through check_launch."""
    from sparkucx_tpu_torch.ops import segmented as sg
    rows = torch.zeros((2, 300, 4), dtype=torch.int32, device=card)
    part = torch.zeros((2, 300), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                  # sum_words > W - 2
        sg.segment_reduce_kernel(rows, part, 4, 3, False)
    with pytest.raises(ValueError):                  # part shape
        sg.segment_reduce_kernel(rows, part[:, :10], 4, 1, False)
    with pytest.raises(ValueError):                  # int64 rows
        sg.segment_reduce_kernel(rows.long(), part, 4, 1, False)
    with pytest.raises(ValueError):                  # not contiguous
        sg.segment_reduce_kernel(rows.transpose(0, 1), part.t(), 4, 1,
                                 False)
    lib = backend.kernel_library()
    scratch = torch.zeros(8, dtype=torch.int64, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = lib.sxt_segment_reduce(        # sum_words 3 > width 4 - 2
        rows.data_ptr(), part.data_ptr(), rows.data_ptr(), part.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr(), 2, 300, 4, 4, 3, 0, stream)
    with pytest.raises(RuntimeError, match="segment_reduce launch failed"):
        backend.check_launch(sg.KERNEL_NAME, rc)
    assert lib.sxt_segment_reduce_tile_rows(0) == 0
    assert lib.sxt_segment_reduce_tile_rows(1 << 20) == 0


TILE_CASES = ("unaligned_cap", "edge_runs", "multi_tile_run", "all_sentinel",
              "all_unique", "uneven_chains")


def _tile_rows(width_in: int) -> int:
    return backend.kernel_library().sxt_segment_reduce_tile_rows(width_in)


def _run_lengths(rng, case: str, T: int, shard: int):
    """(run lengths, cap) of one shard for a tile-edge case, ``T`` being
    the kernel's rows per tile: caps off every multiple of T and of 4,
    runs ending exactly on tile edges, a run over three tiles, no valid
    row, every row its own run, and shards whose chains hold different
    run counts."""
    cap = 3 * T + 3
    if case == "unaligned_cap":
        cap = 2 * T + 3
        return list(rng.integers(1, 10, cap)), cap
    if case == "edge_runs":
        return [T - 5, 5, T, 3, T - 3], cap
    if case == "multi_tile_run":
        return [T - 3, 2 * T + 9, 5, 1], cap
    if case == "all_sentinel":
        return [], cap
    if case == "all_unique":
        return [1] * cap, cap
    return ([[1] * cap, [cap], [], list(rng.integers(1, 40, cap))]
            [shard % 4], cap)


def _runs_shard(rng, lengths, cap, width, dtype, num_parts):
    """rows [cap, W] and part [cap] of one shard sorted by (partition,
    key): run r of ``lengths[r]`` rows has its own key (both key words
    vary), partitions non-decreasing over the runs, the rows past the
    runs sentinel; the lengths are cut to ``cap`` rows."""
    lengths = np.asarray(lengths, np.int64)
    lengths = lengths[np.cumsum(lengths) <= cap]
    n, nr = int(lengths.sum()), lengths.size
    rows = rng.integers(-(1 << 31), 1 << 31, (cap, width)).astype(np.int32)
    if dtype == "float32":
        rows[:, 2:] = rng.standard_normal((cap, width - 2)).astype(
            np.float32).view(np.int32)
    part = np.full(cap, num_parts, np.int32)
    keys = (np.arange(nr, dtype=np.int64) - nr // 2) * ((1 << 33) + 7)
    rows[:n, :2] = np.repeat(keys, lengths).view(np.int32).reshape(n, 2)
    part[:n] = np.repeat(np.arange(nr) * num_parts // max(nr, 1), lengths)
    return rows, part


def _tile_case(seed, case, width, dtype, T, num_parts=SEG_R):
    rng = np.random.default_rng(seed)
    P = 4 if case == "uneven_chains" else 3
    shards = []
    for p in range(P):
        lengths, cap = _run_lengths(rng, case, T, p)
        shards.append(_runs_shard(rng, lengths, cap, width, dtype,
                                  num_parts))
    return (np.stack([s[0] for s in shards]),
            np.stack([s[1] for s in shards]))


def _check_segment_reduce(card, rows_np, part_np, sw, fa):
    """The kernel against its plain version: n_out, partitions, keys,
    carried lanes and int32 sums bit-exact; float32 sums within the
    sequential-summation bound of each run."""
    from sparkucx_tpu_torch.ops import segmented as sg
    rows = torch.from_numpy(rows_np).to(card)
    part = torch.from_numpy(part_np).to(card)
    before = backend.launch_counts().get(sg.KERNEL_NAME, 0)
    kr, kp, kn = sg.segment_reduce(rows, part, SEG_R, sw, fa)
    torch.cuda.synchronize()
    assert backend.launch_counts()[sg.KERNEL_NAME] == before + 1
    pr, pp, pn = sg.segment_reduce_plain(rows, part, SEG_R, sw, fa)
    assert torch.equal(kn, pn) and torch.equal(kp, pp)
    width = rows_np.shape[2]
    exact = [0, 1] + list(range(2 + sw, width))
    assert torch.equal(kr[..., exact], pr[..., exact]), f"sw={sw}"
    if not fa:
        assert torch.equal(kr, pr), f"sw={sw}"
    elif sw:
        got = kr[..., 2:2 + sw].cpu().view(torch.float32).double()
        want = pr[..., 2:2 + sw].cpu().view(torch.float32).double()
        tol = _float_tolerance(rows_np, part_np, sw)
        assert ((got - want).abs().numpy() <= tol).all(), f"sw={sw}"
    return kn.cpu()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("width", [3, 6, 25])
@pytest.mark.parametrize("case", TILE_CASES)
def test_segment_reduce_kernel_tile_edges(card, case, width, dtype):
    T = _tile_rows(width)
    rows, part = _tile_case(width * 31 + len(case), case, width, dtype, T)
    vw = width - 2
    for sw in sorted({0, vw // 2, vw}):
        n = _check_segment_reduce(card, rows, part, sw, dtype == "float32")
    cap = rows.shape[1]
    if case == "all_sentinel":
        assert not n.any()
    elif case == "all_unique":
        assert (n == cap).all()
    elif case == "edge_runs":
        assert (n == 5).all()
    elif case == "uneven_chains":
        assert n[0] == cap and n[1] == 1 and n[2] == 0


def _wire_runs_case(seed, case, ww, T):
    """Wire rows [P, cap, 2 + ceil(ww/4) + 1], part and the float32 values
    they decode to, over the run lengths of :func:`_run_lengths`."""
    rng = np.random.default_rng(seed)
    qw = -(-ww // 4)
    P = 4 if case == "uneven_chains" else 3
    rows, part, vals = [], [], []
    for p in range(P):
        lengths, cap = _run_lengths(rng, case, T, p)
        r, pt = _runs_shard(rng, lengths, cap, 2 + qw + 1, "int32", WIRE_R)
        q = rng.integers(-127, 128, (cap, 4 * qw)).astype(np.int8)
        q[:, ww:] = 0
        scale = np.exp(rng.normal(0, 3, cap)).astype(np.float32)
        r[:, 2:2 + qw] = q.view(np.int32)
        r[:, 2 + qw] = scale.view(np.int32)
        v = q[:, :ww].astype(np.float32) * scale[:, None]
        v[pt >= WIRE_R] = 0.0
        rows.append(r)
        part.append(pt)
        vals.append(v)
    return np.stack(rows), np.stack(part), np.stack(vals)


@pytest.mark.parametrize("ww", [4, 7, 128])
@pytest.mark.parametrize("case", TILE_CASES)
def test_wire_reduce_kernel_tile_edges(card, case, ww):
    T = _tile_rows(2 + -(-ww // 4) + 1)
    rows, part, vals = _wire_runs_case(ww * 17 + len(case), case, ww, T)
    for sum_words in sorted({0, max(1, ww // 2)}):
        _wire_kernel_vs_plain(card, rows, part, vals, ww, sum_words)


@pytest.mark.parametrize("mode", ["int32", "float32", "wire"])
def test_segment_reduce_kernel_is_deterministic(card, mode):
    """Two launches on one input give the same bits: float sums run in
    row order, whatever order the tiles are taken in."""
    from sparkucx_tpu_torch.ops import segmented as sg
    if mode == "wire":
        T = _tile_rows(2 + 32 + 1)
        r, p, _ = _wire_runs_case(7, "unaligned_cap", 128, T)
        rows, part = torch.from_numpy(r).to(card), torch.from_numpy(p).to(card)

        def run():
            return sg.segment_reduce_wire_kernel(rows, part, WIRE_R, 130, 128,
                                                 128)
    else:
        T = _tile_rows(6)
        r, p = _tile_case(8, "uneven_chains", 6, mode, T)
        rows, part = torch.from_numpy(r).to(card), torch.from_numpy(p).to(card)

        def run():
            return sg.segment_reduce_kernel(rows, part, SEG_R, 4,
                                            mode == "float32")
    first = run()
    for _ in range(3):
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("width", [1, 3, 6, 130])
def test_segment_reduce_tail_matches_mask(card, width):
    """The tail pass alone equals ``_mask_past_n`` on the same buffers:
    n_out from 0 to cap, caps and widths off the 16-byte grid."""
    from sparkucx_tpu_torch.ops import segmented as sg
    rng = np.random.default_rng(width)
    P, cap = 5, 1031
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (
        P, cap, width)).astype(np.int32)).to(card)
    part = torch.from_numpy(rng.integers(0, 9, (P, cap)).astype(
        np.int32)).to(card)
    n_out = torch.tensor([0, 1, 517, cap - 1, cap], dtype=torch.int32,
                         device=card)
    want_rows, want_part = sg._mask_past_n(rows, part, n_out, 9)
    got_rows, got_part = rows.clone(), part.clone()
    before = backend.launch_counts().get(sg.KERNEL_NAME, 0)
    sg.segment_reduce_tail_kernel(got_rows, got_part, n_out, 9)
    torch.cuda.synchronize()
    assert backend.launch_counts().get(sg.KERNEL_NAME, 0) == before
    assert torch.equal(got_rows, want_rows)
    assert torch.equal(got_part, want_part)


def test_default_conf_keeps_waves_and_prefixes_on_card(card):
    """Under the default ``a2a.impl=auto`` a waved read keeps its waves on
    the dense exchange and a plain device-sink read resolves to dense; an
    explicit ``pallas`` plain device-sink read hands consumers each
    shard's delivered rows as a prefix."""
    R, M = 16, 8
    rng = np.random.default_rng(41)
    keys = [rng.integers(-(1 << 40), 1 << 40, 3000).astype(np.int64)
            for _ in range(M)]
    vals = [rng.integers(0, 1 << 30, (3000, 3)).astype(np.int32)
            for _ in range(M)]
    k = np.concatenate(keys)
    with connect({"spark.shuffle.tpu.a2a.waveRows": "1000"},
                 use_env=False) as svc:
        h = svc.register_shuffle(0, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        res = svc.read(h)
        rep = svc.report(0)
        assert rep.waves > 1 and rep.impl == "dense"
        assert sum(res.partition(r)[0].size for r in range(R)) == k.size
    with connect({}, use_env=False) as svc:
        h = svc.register_shuffle(1, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        svc.read(h, sink="device").close()
        assert svc.report(1).impl == "dense"
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"},
                 use_env=False) as svc:
        h = svc.register_shuffle(2, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        res = svc.read(h, sink="device")
        rows = res.device_rows().cpu().numpy()
        totals = res.device_totals().cpu().numpy()
        assert svc.report(2).impl == "pallas"
        assert svc.report(2).d2h_bytes == 0
        res.close()
    shard_of = blocked_partition_map(R, 8)[hash32_np(k) % R]
    for p in range(8):
        got = rows[p, :totals[p], :2].copy().view(np.int64)[:, 0]
        assert sorted(got.tolist()) == sorted(k[shard_of == p].tolist())


@pytest.mark.parametrize("merge", ["auto", "pallas", "jnp"])
def test_combine_and_ordered_reads_on_card(card, merge):
    """combine="sum" through connect() on the card runs the segment-reduce
    kernel (auto/pallas) and matches a numpy int32-wrapping oracle; the
    ordered range read is globally sorted."""
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.partition import ReservoirSampler
    R, M = 24, 5
    rng = np.random.default_rng(11)
    keys = [rng.integers(-5000, 5000, 4000).astype(np.int64) * 977
            for _ in range(M)]
    vals = [rng.integers(-(1 << 31), 1 << 31, (4000, 3)).astype(np.int32)
            for _ in range(M)]
    k, v = np.concatenate(keys), np.concatenate(vals)
    with connect({"spark.shuffle.tpu.read.mergeImpl": merge},
                 use_env=False) as svc:
        h = svc.register_shuffle(0, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        before = backend.launch_counts().get(sg.KERNEL_NAME, 0)
        res = svc.read(h, combine="sum")
        launched = backend.launch_counts().get(sg.KERNEL_NAME, 0) - before
        part = hash32_np(k) % R
        for r in range(R):
            gk, gv = res.partition(r)
            uk, inv = np.unique(k[part == r], return_inverse=True)
            want = np.zeros((uk.size, 3), np.int64)
            np.add.at(want, inv, v[part == r].astype(np.int64))
            assert np.array_equal(gk, uk), f"partition {r}"
            assert np.array_equal(gv, want.astype(np.int32)), f"part {r}"
        rep = svc.report(0)
        assert rep.kernel == ("jnp" if merge == "jnp" else "pallas")
        assert launched == (0 if merge == "jnp" else rep.retries + 1)

        s = ReservoirSampler(512, seed=1)
        for kk in keys:
            s.add(kk)
        h2 = svc.register_shuffle(1, M, R, "range", bounds=s.bounds(R))
        for m in range(M):
            svc.write(h2, m, keys[m], vals[m])
        res = svc.read(h2, ordered=True)
        got = np.concatenate([res.partition(r)[0] for r in range(R)])
        assert np.array_equal(got, np.sort(k))


# -- merge path ---------------------------------------------------------------
def _merge_inputs(pattern, width, P, seed, card):
    """``merge_case`` on the card; under ``offset`` each side tensor is a
    contiguous view at a storage offset of 1-3 words, as on the host."""
    *sides, out_cap = merge_case(np.random.default_rng(seed), P, width,
                                 pattern)
    out = []
    for x, off in zip(sides, OFFSET_WORDS):
        off = off if pattern == "offset" else 0
        buf = torch.empty(x.size + off, dtype=torch.int32, device=card)
        view = buf[off:].view(x.shape)
        view.copy_(torch.from_numpy(np.ascontiguousarray(x)))
        assert view.is_contiguous() and view.storage_offset() == off
        out.append(view)
    return (*out, out_cap)


# 1031: rows wider than the staged kernel takes (one row per block)
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("width", MERGE_WIDTHS + (1031,))
@pytest.mark.parametrize("pattern", MERGE_PATTERNS)
def test_merge_kernel_matches_plain(card, pattern, width, P):
    """Bit-exact on every output row and partition id, ties taking the
    first side, for every pattern of ``torch_merge_cases``: an ``out_cap``
    below ca + cb (in the first tile and inside a later one), runs of one
    side longer than a tile, shard bases and storage offsets off the
    16-byte grid included."""
    from sparkucx_tpu_torch.ops import segmented as sg
    a, ap, b, bp, out_cap = _merge_inputs(
        pattern, width, P, MERGE_PATTERNS.index(pattern) * 1000
        + width * 10 + P, card)
    before = backend.launch_counts().get(sg.MERGE_KERNEL_NAME, 0)
    kr, kp = sg.merge(a, ap, b, bp, out_cap)
    torch.cuda.synchronize()
    launched = backend.launch_counts().get(sg.MERGE_KERNEL_NAME, 0) - before
    assert launched == (1 if kr.shape[1] else 0)
    pr, pp = sg.merge_plain(a, ap, b, bp, out_cap)
    assert torch.equal(kr, pr) and torch.equal(kp, pp)


def test_merge_tile_rows(card):
    """Rows per merge tile: about 50 KB of staged rows, at most 1024; one
    row (no staging) above 800 words; 0 for a width the kernel refuses."""
    lib = backend.kernel_library()
    got = [lib.sxt_merge_tile_rows(w) for w in (1, 2, 6, 25, 130, 800, 801)]
    assert got == [0, 1024, 1024, 512, 98, 16, 1]


@pytest.mark.parametrize("width", [6, 25, 130])
def test_merge_kernel_is_deterministic(card, width):
    """Two launches on the same inputs are bit-identical."""
    from sparkucx_tpu_torch.ops import segmented as sg
    a, ap, b, bp, out_cap = _merge_inputs("long_runs", width, 8, width,
                                          card)
    first = sg.merge_kernel(a, ap, b, bp, out_cap)
    second = sg.merge_kernel(a, ap, b, bp, out_cap)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_merge_kernel_refuses_bad_input(card):
    from sparkucx_tpu_torch.ops import segmented as sg
    a = torch.zeros((2, 300, 4), dtype=torch.int32, device=card)
    pa = torch.zeros((2, 300), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                  # CPU tensor
        sg.merge_kernel(a.cpu(), pa.cpu(), a.cpu(), pa.cpu())
    with pytest.raises(ValueError):                  # not contiguous
        sg.merge_kernel(a[:, ::2], pa[:, ::2], a, pa)
    with pytest.raises(ValueError):                  # out_cap > ca + cb
        sg.merge_kernel(a, pa, a, pa, 601)
    lib = backend.kernel_library()
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = lib.sxt_merge_path(a.data_ptr(), pa.data_ptr(), a.data_ptr(),
                            pa.data_ptr(), a.data_ptr(), pa.data_ptr(),
                            pa.data_ptr(), 2, 300, 300, 601, 4, stream)
    with pytest.raises(RuntimeError, match="merge_path launch failed"):
        backend.check_launch(sg.MERGE_KERNEL_NAME, rc)
    rc = lib.sxt_merge_splits(a.data_ptr(), pa.data_ptr(), a.data_ptr(),
                              pa.data_ptr(), pa.data_ptr(), 2, 300, 300,
                              600, 1, stream)             # width 1
    with pytest.raises(RuntimeError, match="merge_path launch failed"):
        backend.check_launch(sg.MERGE_KERNEL_NAME, rc)


@pytest.mark.parametrize("mode", ["ordered", "combine"])
def test_waved_device_fold_on_card(card, mode):
    """A waved ordered or combine read with the device sink folds its
    waves through the merge kernel, one launch per wave after the first,
    and its host view matches a numpy oracle."""
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.ops.partition import ReservoirSampler
    R, M = 24, 8
    rng = np.random.default_rng(17)
    space = 3000 if mode == "combine" else 1 << 40
    keys = [rng.integers(-space, space, 4000).astype(np.int64) * 977
            for _ in range(M)]
    vals = [rng.integers(-(1 << 31), 1 << 31, (4000, 3)).astype(np.int32)
            for _ in range(M)]
    k, v = np.concatenate(keys), np.concatenate(vals)
    conf = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.a2a.waveRows": "1024"}
    with connect(conf, use_env=False) as svc:
        bounds = None
        if mode == "ordered":
            s = ReservoirSampler(1024, seed=1)
            for kk in keys:
                s.add(kk)
            bounds = s.bounds(R)
        h = svc.register_shuffle(0, M, R, "range" if bounds is not None
                                 else "hash", bounds=bounds)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        before = backend.launch_counts().get(sg.MERGE_KERNEL_NAME, 0)
        kw = {"combine": "sum"} if mode == "combine" else {"ordered": True}
        res = svc.read(h, sink="device", **kw)
        launched = backend.launch_counts().get(sg.MERGE_KERNEL_NAME, 0) \
            - before
        rep = svc.report(0)
        assert rep.waves == 4 and launched == rep.waves - 1
        assert rep.sink == "device" and rep.d2h_bytes == 0
        assert rep.merge_ms > 0
        hv = res.host_view()
        parts = [hv.partition(r) for r in range(R)]
        assert rep.d2h_bytes > 0
    if mode == "ordered":
        got = np.concatenate([p[0] for p in parts])
        assert np.array_equal(got, np.sort(k))
        return
    part = hash32_np(k) % R
    for r in range(R):
        gk, gv = parts[r]
        uk, inv = np.unique(k[part == r], return_inverse=True)
        want = np.zeros((uk.size, 3), np.int64)
        np.add.at(want, inv, v[part == r].astype(np.int64))
        assert np.array_equal(gk, uk), f"partition {r}"
        assert np.array_equal(gv, want.astype(np.int32)), f"partition {r}"


# -- int8 wire: quantize and the fused dequant segment reduce ----------------


@pytest.mark.parametrize("n", [1, 389, 4099])
@pytest.mark.parametrize("w", [1, 3, 4, 128, 1000])
@pytest.mark.parametrize("kind", QUANT_KINDS)
def test_quantize_kernel_bytes_equal_plain(card, kind, w, n):
    """The kernel's q and scale bytes equal the plain version's on the
    same uniforms: rows off the 8-rows-per-block grid, zero rows, widths
    below and above one warp, magnitudes from 1e-30 to 1e30, values
    rounding onto 127."""
    from sparkucx_tpu_torch.ops import quant as tq
    rng = np.random.default_rng(n * 7 + w)
    x = torch.from_numpy(quant_values(rng, n, w, kind)).to(card)
    u = torch.from_numpy(rng.random((n, w), dtype=np.float32)).to(card)
    before = backend.launch_counts().get(tq.KERNEL_NAME, 0)
    kq, ks = tq.quantize_kernel(x, u)
    torch.cuda.synchronize()
    assert backend.launch_counts()[tq.KERNEL_NAME] == before + 1
    pq, ps = tq.quantize_plain(x, u)
    assert torch.equal(kq, pq)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(tq.quantize(x, u)[0], kq)


def test_quantize_kernel_refuses_bad_input(card):
    from sparkucx_tpu_torch.ops import quant as tq
    x = torch.randn(64, 8, device=card)
    u = torch.rand(64, 8, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_kernel(x.cpu(), u.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tq.quantize_kernel(x.t(), u.t())
    with pytest.raises(ValueError, match="float32"):
        tq.quantize_kernel(x.half(), u)
    with pytest.raises(ValueError, match="shape"):
        tq.quantize_kernel(x, u[:5])


def _wire_kernel_vs_plain(card, rows, part, vals, ww, sum_words):
    from sparkucx_tpu_torch.ops import segmented as sg
    width = 2 + ww
    sw = sum_words or ww
    r = torch.from_numpy(rows).to(card)
    p = torch.from_numpy(part).to(card)
    before = backend.launch_counts().get(sg.WIRE_KERNEL_NAME, 0)
    kr, kp, kn = sg.segment_reduce_wire_kernel(r, p, WIRE_R, width, ww, sw)
    torch.cuda.synchronize()
    assert backend.launch_counts()[sg.WIRE_KERNEL_NAME] == before + 1
    pr, pp, pn = sg.segment_reduce_wire_plain(r.cpu(), p.cpu(), WIRE_R,
                                              width, ww, sw)
    kr, kp, kn = kr.cpu(), kp.cpu(), kn.cpu()
    assert torch.equal(kn, pn) and torch.equal(kp, pp)
    exact = [0, 1] + list(range(2 + sw, width))
    assert torch.equal(kr[..., exact], pr[..., exact])
    got = kr[..., 2:2 + sw].contiguous().view(torch.float32).double().numpy()
    want = pr[..., 2:2 + sw].contiguous().view(torch.float32).double().numpy()
    assert (np.abs(got - want) <= sum_tolerance(rows, part, vals, sw)).all()
    # carried lanes: the run's first row, dequantized
    for s, (run, valid) in enumerate(runs(rows, part)):
        firsts = np.flatnonzero(valid & np.r_[True, run[1:] != run[:-1]])
        assert np.array_equal(
            kr[s, :firsts.size, 2 + sw:].contiguous().view(torch.float32)
            .numpy(), vals[s, firsts, sw:])


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("ww", [1, 4, 7, 128])
@pytest.mark.parametrize("pattern", WIRE_PATTERNS)
@pytest.mark.parametrize("split", ["all", "carry"])
def test_wire_reduce_kernel_matches_plain(card, split, pattern, ww, P):
    sum_words = 0 if split == "all" else max(1, ww // 2) if ww > 1 else 1
    rows, part, vals = wire_case(ww * 10 + P, P, 700, ww, sum_words,
                                 patterns=[pattern])
    _wire_kernel_vs_plain(card, rows, part, vals, ww, sum_words)


def test_wire_reduce_kernel_5000_row_run(card):
    rows, part, vals = wire_case(5, 2, 6000, 6, 0, patterns=["huge"])
    _wire_kernel_vs_plain(card, rows, part, vals, 6, 0)


def test_wire_reduce_kernel_refuses_bad_input(card):
    from sparkucx_tpu_torch.ops import segmented as sg
    rows = torch.zeros((2, 300, 2 + 2 + 1), dtype=torch.int32, device=card)
    part = torch.full((2, 300), 5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        sg.segment_reduce_wire_kernel(rows.cpu(), part.cpu(), 5, 7, 5, 5)
    with pytest.raises(ValueError, match="contiguous"):
        sg.segment_reduce_wire_kernel(rows.transpose(0, 1).contiguous()
                                      .transpose(0, 1), part, 5, 7, 5, 5)
    with pytest.raises(ValueError, match="wire rows must be"):
        sg.segment_reduce_wire_kernel(rows[..., :4].contiguous(), part, 5,
                                      7, 5, 5)
    with pytest.raises(ValueError, match="whole value row"):
        sg.segment_reduce_wire_kernel(rows, part, 5, 8, 5, 5)


@pytest.mark.parametrize("impl,mode", [("pallas", "plain"),
                                       ("pallas", "combine"),
                                       ("dense", "combine"),
                                       ("dense", "ordered")])
def test_int8_reads_on_card(card, impl, mode):
    """a2a.wire=int8 through connect() on the card: the quantize kernel
    runs once per exchange and a combine runs the fused reduce; keys are
    exact and values within one step (combine: of each shard's
    partial)."""
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops import segmented as sg
    R, M = 24, 8
    rng = np.random.default_rng(23)
    space = 2000 if mode == "combine" else 1 << 40
    keys = [rng.integers(-space, space, 3000).astype(np.int64) * 977
            for _ in range(M)]
    vals = [rng.standard_normal((3000, 16)).astype(np.float32)
            for _ in range(M)]
    k, v = np.concatenate(keys), np.concatenate(vals)
    conf = {"spark.shuffle.tpu.a2a.impl": impl,
            "spark.shuffle.tpu.a2a.wire": "int8"}
    with connect(conf, use_env=False) as svc:
        h = svc.register_shuffle(0, M, R)
        for m in range(M):
            svc.write(h, m, keys[m], vals[m])
        backend.reset_launch_counts()
        kw = {"combine": "sum"} if mode == "combine" else (
            {"ordered": True} if mode == "ordered" else {})
        res = svc.read(h, **kw)
        parts = [res.partition(r) for r in range(R)]
        rep = svc.report(0)
        counts = backend.launch_counts()
    assert rep.wire == "int8" and rep.wire_dequant_error > 0
    assert counts.get(tq.KERNEL_NAME, 0) == rep.retries + 1
    assert counts.get(sg.WIRE_KERNEL_NAME, 0) == (
        rep.retries + 1 if mode == "combine" else 0)
    part = hash32_np(k) % R
    if mode != "combine":
        for r in range(R):
            gk, gv = parts[r]
            sel = np.flatnonzero(part == r)
            o = np.argsort(k[sel], kind="stable")
            og = np.argsort(gk, kind="stable")
            assert np.array_equal(gk[og], k[sel][o])
            want = v[sel][o]
            step = np.abs(want).max(axis=1, keepdims=True) / 127.0
            assert (np.abs(gv[og] - want) <= step * 1.000001).all()
        return
    shard = np.concatenate([np.full(3000, m % 8) for m in range(M)])
    for r in range(R):
        gk, gv = parts[r]
        sel = part == r
        uk = np.unique(k[sel])
        assert np.array_equal(gk, uk), f"partition {r}"
        tot = np.zeros((uk.size, 16))
        tol = np.zeros((uk.size, 16))
        for s in range(8):
            ss = sel & (shard == s)
            idx = np.searchsorted(uk, k[ss])
            ps = np.zeros((uk.size, 16))
            np.add.at(ps, idx, v[ss].astype(np.float64))
            tot += ps
            tol += np.abs(ps).max(axis=1, keepdims=True) / 127 * 1.00001 \
                + 2.0 ** -20 * np.abs(ps)
        assert (np.abs(gv - tot) <= tol).all(), f"partition {r}"



# -- flash attention: forward, dq and dk/dv ----------------------------------
def _close(got, want, tol, what):
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"{what}: max error {float(err.max())}"


def _check_flash_case(card, bh, t, d, causal):
    """Each of the three kernels against its plain version on the same
    inputs (the backward kernels on the plain forward's lse and delta),
    within the tolerances of ``torch_attention_cases``; one launch of
    each."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    q, k, v, g = (torch.from_numpy(x).to(card) for x in
                  flash_inputs(flash_seed(bh, t, d, causal), bh, t, d))
    scale = d ** -0.5
    before = backend.launch_counts()
    ko, klse = tfa.flash_fwd(q, k, v, causal, scale)
    po, plse = tfa.flash_fwd_plain(q, k, v, causal, scale)
    _close(ko, po, out_tolerance(po.cpu().numpy()), "O")
    _close(klse, plse, torch.from_numpy(lse_tolerance(plse.cpu().numpy()))
           .to(card), "lse")
    delta = (g * po).sum(dim=-1)
    kdq = tfa.flash_dq(q, k, v, g, plse, delta, causal, scale)
    kdk, kdv = tfa.flash_dkv(q, k, v, g, plse, delta, causal, scale)
    torch.cuda.synchronize()
    after = backend.launch_counts()
    for name in (tfa.FWD_KERNEL_NAME, tfa.DQ_KERNEL_NAME,
                 tfa.DKV_KERNEL_NAME):
        assert after.get(name, 0) == before.get(name, 0) + 1, name
    pdq = tfa.flash_dq_plain(q, k, v, g, plse, delta, causal, scale)
    pdk, pdv = tfa.flash_dkv_plain(q, k, v, g, plse, delta, causal, scale)
    _, truth = float64_grads(q, k, v, g, causal, scale)
    for got, want, exact, what in ((kdq, pdq, truth[0], "dq"),
                                   (kdk, pdk, truth[1], "dk"),
                                   (kdv, pdv, truth[2], "dv")):
        plain_err = float((want.double() - exact).abs().max())
        _close(got, want, grad_tolerance(want.cpu().numpy(), plain_err),
               what)


@pytest.mark.parametrize("bh", FLASH_BH)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", FLASH_D)
@pytest.mark.parametrize("t", FLASH_T)
def test_flash_kernels_match_plain(card, t, d, causal, bh):
    _check_flash_case(card, bh, t, d, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_many_tiles(card, causal):
    """33 resident tiles of 128 rows and 129 streamed tiles of 32, the
    last of each 3 rows deep, at the widest head dim: every kernel's
    two-stage copy ring turns over many times and the tile edge falls
    inside a fragment."""
    _check_flash_case(card, 2, 4099, 128, causal)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_is_deterministic(card, causal, d):
    """dq and dk/dv are bit-identical over two launches: every output
    element has one writer block and a fixed order of products."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    q, k, v, g = (torch.from_numpy(x).to(card) for x in
                  flash_inputs(flash_seed(3, 517, d, causal), 3, 517, d))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, causal, scale)
    delta = (g * o).sum(dim=-1)
    runs = [(tfa.flash_dq(q, k, v, g, lse, delta, causal, scale),
             *tfa.flash_dkv(q, k, v, g, lse, delta, causal, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_is_deterministic(card, causal, d):
    """O and lse are bit-identical over two launches of the forward: each
    output element has one writer and a fixed order of products."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    q, k, v, _ = (torch.from_numpy(x).to(card) for x in
                  flash_inputs(flash_seed(3, 517, d, causal), 3, 517, d))
    scale = d ** -0.5
    runs = [tfa.flash_fwd(q, k, v, causal, scale) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 130, 4099])
def test_flash_forward_lse_feeds_backward(card, t, causal):
    """The training path's composition: dq, dk and dv from the kernel
    forward's own O (through delta) and lse stay within
    ``grad_tolerance`` of the plain backward on the plain forward's; the
    backward kernels recompute S as q k^T times scale where the forward
    took (q scale) k^T, so P = exp(scale S - lse) carries both kernels'
    rounding."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    d = 128
    q, k, v, g = (torch.from_numpy(x).to(card) for x in
                  flash_inputs(flash_seed(2, t, d, causal), 2, t, d))
    scale = d ** -0.5
    ko, klse = tfa.flash_fwd(q, k, v, causal, scale)
    kdelta = (g * ko).sum(dim=-1)
    kdq = tfa.flash_dq(q, k, v, g, klse, kdelta, causal, scale)
    kdk, kdv = tfa.flash_dkv(q, k, v, g, klse, kdelta, causal, scale)
    torch.cuda.synchronize()
    po, plse = tfa.flash_fwd_plain(q, k, v, causal, scale)
    pdelta = (g * po).sum(dim=-1)
    pdq = tfa.flash_dq_plain(q, k, v, g, plse, pdelta, causal, scale)
    pdk, pdv = tfa.flash_dkv_plain(q, k, v, g, plse, pdelta, causal, scale)
    _, truth = float64_grads(q, k, v, g, causal, scale)
    for got, want, exact, what in ((kdq, pdq, truth[0], "dq"),
                                   (kdk, pdk, truth[1], "dk"),
                                   (kdv, pdv, truth[2], "dv")):
        plain_err = float((want.double() - exact).abs().max())
        _close(got, want, grad_tolerance(want.cpu().numpy(), plain_err),
               what)


def test_flash_kernels_refuse_bad_input(card):
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    x = torch.randn(2, 70, 32, device=card)
    r = torch.zeros(2, 70, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_kernel(x.cpu(), x.cpu(), x.cpu(), True, 0.2)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_fwd_kernel(x.double(), x.double(), x.double(), True, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        y = x.transpose(0, 1).contiguous().transpose(0, 1)
        tfa.flash_fwd_kernel(y, y, y, True, 0.2)
    with pytest.raises(ValueError, match="exceeds"):
        z = torch.zeros(1, 8, 160, device=card)
        tfa.flash_fwd_kernel(z, z, z, False, 0.1)
    with pytest.raises(ValueError, match="row input"):
        tfa.flash_dq_kernel(x, x, x, x, r[:, :5].contiguous(), r,
                            True, 0.2)
    lib = backend.kernel_library()
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = lib.sxt_flash_fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                           x.data_ptr(), r.data_ptr(), 2, 70, 24, 1, 0.2,
                           stream)                     # no D=24 build
    with pytest.raises(RuntimeError, match="flash_fwd launch failed"):
        backend.check_launch(tfa.FWD_KERNEL_NAME, rc)
    # a head dim between the compiled ones pads up and stays right
    w = torch.randn(3, 50, 24, device=card)
    ko, klse = tfa.flash_fwd(w, w, w, True, 0.2)
    po, plse = tfa.flash_fwd_plain(w, w, w, True, 0.2)
    assert ko.shape == w.shape
    _close(ko, po, out_tolerance(po.cpu().numpy()), "O (D=24)")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_ulysses_attention_grads_on_card(card, impl):
    """ulysses_attention on CUDA tensors runs one launch of each kernel
    and matches the plain versions (impl="interpret") on the same card
    tensors, output and grads."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    from sparkucx_tpu_torch.parallel.ulysses import ulysses_attention
    rng = np.random.default_rng(31)
    xs = [torch.from_numpy(rng.standard_normal((1, 8, 256, 64)).astype(
        np.float32)).to(card) for _ in range(4)]
    cot = xs.pop()
    results = {}
    for which in (impl, "interpret"):
        leaves = [x.clone().requires_grad_() for x in xs]
        backend.reset_launch_counts()
        out = ulysses_attention(*leaves, 4, causal=True, impl=which)
        grads = torch.autograd.grad((cot * out).sum(), leaves)
        torch.cuda.synchronize()
        results[which] = (out.detach(), grads, backend.launch_counts())
    out, grads, counts = results[impl]
    assert counts == {tfa.FWD_KERNEL_NAME: 1, tfa.DQ_KERNEL_NAME: 1,
                      tfa.DKV_KERNEL_NAME: 1}
    pout, pgrads, pcounts = results["interpret"]
    assert pcounts == {}
    _close(out, pout, out_tolerance(pout.cpu().numpy()), "O")
    for a, b in zip(grads, pgrads):
        _close(a, b, grad_tolerance(b.cpu().numpy()), "grad")


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_attention_consumers_on_card(card, which):
    """A range-partitioned device-sink read on the card feeds the
    consumer with no D2H; the Ulysses consumer launches the forward kernel
    once; both match reference_attention."""
    from sparkucx_tpu_torch.ops import flash_attention as tfa
    from sparkucx_tpu_torch.ops.attention import reference_attention
    from sparkucx_tpu_torch.parallel.ring import ring_attention_consumer
    from sparkucx_tpu_torch.parallel.ulysses import \
        ulysses_attention_consumer
    P, heads, hd, t = 8, 8, 16, 48
    qkv, pos = qkv_rows(41, heads, hd, P * t)
    make = ring_attention_consumer if which == "ring" \
        else ulysses_attention_consumer
    step = make(P, t, heads, hd, causal=True)
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"},
                 use_env=False) as svc:
        h = svc.register_shuffle(0, 6, P, "range",
                                 bounds=[t * (i + 1) for i in range(P - 1)])
        per = P * t // 6
        for m in range(6):
            sel = pos[m * per:(m + 1) * per]
            svc.write(h, m, sel.astype(np.int64),
                      qkv[sel].reshape(len(sel), -1))
        res = svc.read(h, ordered=True, sink="device")
        backend.reset_launch_counts()
        out = res.consume(lambda c, rows, totals: step(rows, totals))
        torch.cuda.synchronize()
        counts = backend.launch_counts()
        assert svc.report(0).d2h_bytes == 0
    assert out.device.type == "cuda"
    assert counts.get(tfa.FWD_KERNEL_NAME, 0) == (0 if which == "ring"
                                                  else 1)
    q, k, v = (torch.from_numpy(qkv[:, i].transpose(1, 0, 2)[None].copy())
               for i in range(3))
    ref = reference_attention(q, k, v, causal=True)
    _close(out.cpu(), ref, out_tolerance(ref.numpy()), "O")


# -- analytics workloads: every runner under the default conf ----------------
@pytest.mark.parametrize("case", WORKLOAD_CASES, ids=lambda c: c[0])
def test_workload_runner_on_card(card, case):
    """Each workload runner at its test size on the card under the default
    conf: its own oracle passes, the result equals the same call's on the
    CPU, every read runs the segment move (launched once per read attempt:
    reads + overflow retries) and every combine read the segment reduce
    (once per combine-read attempt)."""
    from chip_smoke import ReadTally
    from sparkucx_tpu_torch.ops import segmented as sg
    _, module, fn, kw = case
    run = runner("sparkucx_tpu_torch", module, fn)
    with connect(num_shards=8, use_env=False) as svc:
        with ReadTally(svc.manager) as tally:
            before = backend.launch_counts()
            got = run(svc.manager, **kw)
            after = backend.launch_counts()
    with connect(device="cpu", num_shards=8, use_env=False) as svc:
        want = run(svc.manager, **kw)
    check_same_result(fn, got, want)
    launched = {k: after.get(k, 0) - before.get(k, 0)
                for k in (ra.KERNEL_NAME, sg.KERNEL_NAME)}
    assert tally.reads > 0 and tally.impls == {"pallas"}
    assert launched == {
        ra.KERNEL_NAME: tally.reads + tally.retries,
        sg.KERNEL_NAME: tally.combine_reads + tally.combine_retries}
    assert (tally.combine_reads > 0) == (fn in COMBINE_RUNNERS)


# -- memory planes: spill, admission, the groupby pipeline's device arm ------
def test_spilled_read_on_card(card, tmp_path):
    """A spilled map output read plain under the default conf: the
    segment move runs once, every partition's (key, value) multiset equals
    the numpy oracle, and the writers' staging went back to the pool."""
    rng = np.random.default_rng(41)
    M, R, n = 8, 16, 6000
    keys = rng.integers(-(1 << 62), 1 << 62, size=M * n, dtype=np.int64)
    vals = rng.integers(-(1 << 31), 1 << 31, size=(M * n, 5)).astype(np.int32)
    conf = {"spark.shuffle.tpu.spill.threshold": "64k",
            "spark.shuffle.tpu.spill.dir": str(tmp_path)}
    with connect(conf, num_shards=8, use_env=False) as svc:
        h = svc.register_shuffle(1, M, R)
        for m in range(M):
            w = svc.writer(h, m)
            for c in range(m * n, (m + 1) * n, 1000):
                w.write(keys[c:c + 1000], vals[c:c + 1000])
            w.commit(R)
        assert svc.stats()["counters"]["shuffle.spill.count"] >= M
        assert svc.node.pool.stats()["in_use_bytes"] == 0
        before = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        res = svc.read(h)
        assert backend.launch_counts()[ra.KERNEL_NAME] == before + 1
        assert svc.report(1).impl == "pallas"
        pid = (hash32_np(keys) % np.uint32(R)).astype(np.int64)
        for r in range(R):
            k, v = res.partition(r)
            want = np.flatnonzero(pid == r)
            got = sorted(zip(k.tolist(), map(bytes, v)))
            assert got == sorted(zip(keys[want].tolist(),
                                     map(bytes, vals[want])))
        svc.unregister_shuffle(1)
    assert not list(tmp_path.iterdir())


def test_pinned_pool_trim_unpins_on_card(card):
    """On a CUDA node the pool's buffers are page-locked; a ``put`` past
    ``max_free_bytes`` drops the longest-free buffer and torch no longer
    holds its pinned bytes, while the kept one is reused."""
    from sparkucx_tpu_torch.runtime.node import HostStagingPool
    pool = HostStagingPool(pinned=True)
    pool.max_free_bytes = 48 << 20
    a, b = pool.get(32 << 20), pool.get(24 << 20)
    assert a.is_pinned() and b.is_pinned()
    pool.put(a)
    del a                                 # the pool's is the last reference
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    pool.put(b)                           # 56 MiB free: a is dropped
    st = pool.stats()
    assert st["free"] == 1 and st["free_bytes"] == 24 << 20
    assert torch.cuda.host_memory_stats()["allocated_bytes.current"] \
        <= held - (32 << 20)
    again = pool.get(20 << 20)
    assert again.data_ptr() == b.data_ptr()
    pool.put(again)
    pool.close()


@pytest.mark.parametrize("sink", ["host", "device"])
def test_capped_submits_defer_and_release_on_card(card, sink):
    """Under a cap of one exchange a second submit is deferred (no
    reservation, not done) until the first releases — at its result on
    the host sink, at its consume on the device sink — then completes;
    nothing stays reserved."""
    rng = np.random.default_rng(42)
    cap = 1 << 10           # below one exchange: each is admitted alone
    with connect({"spark.shuffle.tpu.a2a.maxBytesInFlight": str(cap)},
                 num_shards=8, use_env=False) as svc:
        m = svc.manager
        hs, want = [], []
        for sid in range(2):
            k = rng.integers(0, 1 << 40, size=4000).astype(np.int64)
            h = svc.register_shuffle(sid, 2, 8)
            for mid in range(2):
                svc.write(h, mid, k[mid * 2000:(mid + 1) * 2000])
            hs.append(h)
            want.append(np.sort(k))
        pa = svc.submit(hs[0], sink=sink)
        held = m._inflight_bytes
        pb = svc.submit(hs[1], sink=sink)
        assert held > 0 and m._inflight_bytes == held and not pb.done()
        ra_ = pa.result()
        if sink == "device":
            assert m._inflight_bytes == held
            ra_ = ra_.host_view()
            for _ in ra_.partitions():
                pass                       # the drain releases
        assert m._inflight_bytes == 0
        rb = pb.result()
        if sink == "device":
            rb = rb.host_view()
        for res, w in ((ra_, want[0]), (rb, want[1])):
            got = np.sort(np.concatenate([res.partition(r)[0]
                                          for r in range(8)]))
            np.testing.assert_array_equal(got, w)
        assert m._inflight_bytes == 0
        assert svc.report(1).admit_wait_ms > 0


def test_groupby_pipeline_device_arm_on_card(card, tmp_path):
    """The groupby pipeline's device arm at a small budget under the
    default conf: every wave's combine runs the segment reduce, every fold
    step the merge and the segment reduce, the first and the last launch
    of each bit-equal to the plain version; no payload D2H; the report
    equals the same call's on the CPU."""
    from chip_smoke import KernelCapture, ReadTally
    from sparkucx_tpu_torch.ops import segmented as sg
    from sparkucx_tpu_torch.workloads.groupby import groupby_pipeline
    conf = {"spark.shuffle.tpu.spill.threshold": "8192",
            "spark.shuffle.tpu.a2a.waveRows": "512",
            "spark.shuffle.tpu.spill.dir": str(tmp_path)}
    kw = dict(budget_bytes=64 << 10, total_rows=4800, key_space=150,
              num_partitions=8, chunk_rows=1024, sink="device",
              warm_reads=1, shuffle_id=9512)
    with connect(conf, num_shards=8, use_env=False) as svc:
        with ReadTally(svc.manager) as tally, KernelCapture() as capture:
            before = backend.launch_counts()
            rep = groupby_pipeline(svc.manager, **kw)
            after = backend.launch_counts()
        assert svc.node.pool.stats()["in_use_bytes"] == 0
    checks = capture.check("groupby device arm")
    with connect(conf, device="cpu", num_shards=8, use_env=False) as svc:
        want = groupby_pipeline(svc.manager, **kw)
    assert rep.oracle_ok and rep.extra["d2h_bytes"] == 0
    for k in ("distinct_keys", "truth_distinct", "value_sum", "truth_sum"):
        assert rep.extra[k] == want.extra[k], k
    W = rep.waves
    assert W >= 2 and tally.combine_reads == 2
    launched = {k: after.get(k, 0) - before.get(k, 0)
                for k in (ra.KERNEL_NAME, sg.MERGE_KERNEL_NAME,
                          sg.KERNEL_NAME)}
    assert launched == {
        ra.KERNEL_NAME: 0,
        sg.MERGE_KERNEL_NAME: 2 * (W - 1),
        sg.KERNEL_NAME: 2 * (2 * W - 1) + tally.combine_retries}
    assert set(checks) == {sg.MERGE_KERNEL_NAME, sg.KERNEL_NAME}
    assert all(c["calls"] == 2 for c in checks.values())


# -- the expert-parallel MoE (models/moe.py) ----------------------------------
def _moe_case(wire: str, d: int = 64, h: int = 128, t: int = 64):
    from sparkucx_tpu_torch.models import moe as tm
    cfg = tm.MoEConfig(d_model=d, d_hidden=h, num_experts=8,
                       tokens_per_shard=t, wire=wire)
    g = torch.Generator().manual_seed(11)
    params = tm.init_params(cfg, g, device="cpu")
    x = torch.randn(8 * t, d, generator=g)
    y = torch.randn(8 * t, d, generator=g) * 0.1
    return tm, cfg, params, x, y


def _moe_close(got, want, rel):
    want = want.double()
    err = (got.cpu().double() - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("wire", ["raw", "int8"])
def test_moe_forward_and_train_step_on_card_match_cpu(card, wire):
    """The card's forward and one training step against the port on the
    CPU from the same parameters and the same noise (the uniforms are
    drawn on the CPU and handed to both)."""
    from sparkucx_tpu_torch.shuffle.alltoall import shared_uniforms
    tm, cfg, params, x, y = _moe_case(wire)

    def noise(seed, shape, device):
        return shared_uniforms(seed, shape, torch.device("cpu")).to(device)

    outs, grads, losses = {}, {}, {}
    for dev in (torch.device("cpu"), card):
        p = {k: v.to(dev) for k, v in params.items()}
        outs[dev.type] = tm.forward(p, x.to(dev), cfg, 2, 4, seed=2,
                                    uniforms=noise)
        init, step = tm.make_train_step(cfg, 2, 4, device=dev,
                                        uniforms=noise)
        p, opt = init(params)
        p, opt, loss = step(p, opt, x.to(dev), y.to(dev))
        losses[dev.type] = float(loss)
        grads[dev.type] = {k: v.grad for k, v in p.items()}
    torch.cuda.synchronize()
    # int8: a value whose scaled fraction sits within the two devices'
    # rounding of its uniform may round the other way, one step
    # (amax/127 of its row) apart
    rel = 1e-5 if wire == "raw" else 2e-2
    _moe_close(outs["cuda"], outs["cpu"], rel)
    assert abs(losses["cuda"] - losses["cpu"]) <= rel * losses["cpu"]
    for k in tm.PARAM_NAMES:
        _moe_close(grads["cuda"][k], grads["cpu"][k], max(rel, 1e-4))


def test_moe_int8_step_launches_quantize_three_times(card):
    """The dispatch, the combine and the combine's backward: one quantize
    launch each for all eight shards (the dispatch's backward does not
    run: the tokens are not differentiated), none of the segment move."""
    from sparkucx_tpu_torch.ops import quant as tq
    tm, cfg, params, x, y = _moe_case("int8")
    init, step = tm.make_train_step(cfg, 2, 4, device=card)
    p, opt = init(params)
    before = backend.launch_counts()
    for _ in range(2):
        p, opt, loss = step(p, opt, x.to(card), y.to(card))
    torch.cuda.synchronize()
    after = backend.launch_counts()
    assert after.get(tq.KERNEL_NAME, 0) - before.get(tq.KERNEL_NAME, 0) == 6
    assert after.get(ra.KERNEL_NAME, 0) == before.get(ra.KERNEL_NAME, 0)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("t", [4096, 100, 16])
def test_moe_routing_recompute_agrees_on_card(card, t):
    """On the raw wire the receiver recomputes each row's expert: at
    Switch-Base-8's width (d_model 768), at Switch-Base-8's 4,096 tokens
    a shard and at small counts (where a library is likelier to split a
    product's depth), no received row may disagree with its sender."""
    from chip_smoke import routing_disagreements
    tm, cfg, params, x, _ = _moe_case("raw", d=768, h=64, t=t)
    p = {k: v.to(card) for k, v in params.items()}
    chk = routing_disagreements(p, x.to(card), cfg, 2, 4)
    assert chk["rows"] == x.shape[0] and chk["disagree"] == 0, chk


# -- the five-axis MoE transformer (models/transformer.py) -------------------
def _transformer_case(card, **kw):
    from sparkucx_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**{**dict(
        vocab=128, d_model=64, num_heads=4, head_dim=16, d_ff=128,
        num_layers=2, num_experts=8, seq_len=64, microbatches=2,
        attn="ulysses"), **kw})
    g = torch.Generator().manual_seed(13)
    params = tt.init_params(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab, (8, cfg.seq_len + 1), generator=g)
    return (tt, cfg, params, {k: v.to(card) for k, v in params.items()},
            toks[:, :-1], toks[:, 1:])


def test_transformer_forward_on_card_matches_plain(card):
    """The Ulysses forward on make_mesh(8) through the flash kernels
    against the same forward through their plain versions: routing alike
    (or split only at near-ties, as the smoke's transformer_train holds
    it), logits within 2e-4 of max|logits|, one forward launch a layer and
    microbatch."""
    from chip_smoke import (TF_GAP, TF_LOGIT_TOL, transformer_routed_forward,
                            transformer_routing_check)
    tt, cfg, _, params, x, _ = _transformer_case(card)
    mesh = tt.make_mesh(8)
    before = backend.launch_counts().get("flash_fwd", 0)
    kern = transformer_routed_forward(params, x.to(card), mesh, cfg)
    torch.cuda.synchronize()
    launched = backend.launch_counts().get("flash_fwd", 0) - before
    plain = transformer_routed_forward(params, x.to(card), mesh, cfg,
                                       impl="interpret")
    chk = transformer_routing_check(kern, plain, TF_GAP, TF_LOGIT_TOL,
                                    "card transformer forward")
    assert launched == cfg.num_layers * cfg.microbatches
    assert chk["kept_positions"] > 0


@pytest.mark.parametrize("remat", [True, False])
def test_transformer_train_step_counts_flash_launches(card, remat):
    """One training step on the card: flash_fwd once a layer and
    microbatch (twice under remat: the recompute), flash_dq and flash_dkv
    once; the loss and every gradient within 1e-4 of the same step on the
    CPU (the blockwise scan there)."""
    import dataclasses
    tt, cfg, cpu_params, _, x, y = _transformer_case(card)
    cfg = dataclasses.replace(cfg, remat=remat)
    mesh = tt.make_mesh(8)
    out = {}
    for dev in (torch.device("cpu"), card):
        init, step = tt.make_train_step(mesh, cfg, device=dev)
        p, opt = init(cpu_params)
        before = backend.launch_counts()
        p, opt, loss = step(p, opt, x.to(dev), y.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        after = backend.launch_counts()
        out[dev.type] = (float(loss), {k: v.grad.cpu() for k, v in
                                       p.items()},
                         {k: after.get(k, 0) - before.get(k, 0)
                          for k in ("flash_fwd", "flash_dq", "flash_dkv")})
    LM = cfg.num_layers * cfg.microbatches
    assert out["cuda"][2] == {"flash_fwd": (2 if remat else 1) * LM,
                              "flash_dq": LM, "flash_dkv": LM}
    assert out["cpu"][2] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * out["cpu"][0]
    for k, want in out["cpu"][1].items():
        _moe_close(out["cuda"][1][k], want, 1e-4)


# -- the two-tier topology plane and io/dlpack on the card --------------------
def _hier_maps(seed, M=8, rows=3000, vw=4, key_space=1 << 20, ints=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(M):
        k = rng.integers(0, key_space, rows).astype(np.int64)
        v = rng.integers(-1000, 1000, (rows, vw)).astype(np.int32) if ints \
            else rng.standard_normal((rows, vw)).astype(np.float32)
        out.append((k, v))
    return out


def _hier_read(device, conf, maps, R, **kw):
    with connect({"spark.shuffle.tpu.mesh.numSlices": "2", **conf},
                 device=device, use_env=False) as svc:
        h = svc.register_shuffle(1, len(maps), R)
        for m, (k, v) in enumerate(maps):
            svc.write(h, m, k, v)
        res = svc.read(h, **kw)
        return [res.partition(r) for r in range(R)], svc.report(1)


@pytest.mark.parametrize("mode", ["plain", "ordered", "combine"])
def test_hier_read_on_card_matches_cpu(card, mode):
    """The tiered read under the default conf on a 2-slice node: on the
    card (auto -> dense, both tiers) as on the CPU, partition by
    partition: plain as (key, value) multisets, ordered and int32
    combine exactly."""
    R = 24
    maps = _hier_maps(40 + len(mode), key_space=5000 if mode == "combine"
                      else 1 << 20, ints=mode == "combine")
    kw = {"combine": "sum"} if mode == "combine" else (
        {"ordered": True} if mode == "ordered" else {})
    got, grep_ = _hier_read(card, {}, maps, R, **kw)
    want, wrep = _hier_read("cpu", {}, maps, R, **kw)
    assert grep_.hierarchical and grep_.impl == "dense"
    assert [t["tier"] for t in grep_.tiers] == ["ici", "dcn"]
    assert [t["payload_rows"] for t in grep_.tiers] == \
        [t["payload_rows"] for t in wrep.tiers]
    for r in range(R):
        (gk, gv), (wk, wv) = got[r], want[r]
        if mode == "plain":
            g = sorted(zip(gk.tolist(), map(bytes, gv.view(np.uint8))))
            w = sorted(zip(wk.tolist(), map(bytes, wv.view(np.uint8))))
            assert g == w
        elif mode == "ordered":
            np.testing.assert_array_equal(gk, wk)
            assert (np.diff(gk) >= 0).all()
        else:
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)


def test_hier_int8_read_launches_quantize_twice(card, monkeypatch):
    """On the int8 wire each hop quantizes all of its groups in one
    launch: two launches a single-shot hier read, none of the segment
    move; the first launch is byte-equal to ``quantize_plain`` on its
    inputs, and the keys land as on the raw wire."""
    from sparkucx_tpu_torch.ops import quant as tq
    R = 24
    maps = _hier_maps(50, vw=32)
    seen = []
    real = tq.quantize_kernel

    def spy(x, u):
        out = real(x, u)
        seen.append((x.clone(), u.clone(), out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(tq, "quantize_kernel", spy)
    before = backend.launch_counts()
    got, rep = _hier_read(card, {"spark.shuffle.tpu.a2a.wire": "int8"}, maps,
                          R)
    torch.cuda.synchronize()
    after = backend.launch_counts()
    assert rep.wire == "int8" and rep.hierarchical
    assert after.get(tq.KERNEL_NAME, 0) - before.get(tq.KERNEL_NAME, 0) == 2
    assert after.get(ra.KERNEL_NAME, 0) == before.get(ra.KERNEL_NAME, 0)
    assert len(seen) == 2
    x, u, q, s = seen[0]
    pq, ps = tq.quantize_plain(x.cpu(), u.cpu())
    assert torch.equal(q.cpu(), pq) and torch.equal(
        s.cpu().view(torch.int32), ps.view(torch.int32))
    raw, _ = _hier_read(card, {}, maps, R)
    for r in range(R):
        np.testing.assert_array_equal(np.sort(got[r][0]), np.sort(raw[r][0]))


def test_ingest_foreign_on_card(card):
    """A CUDA tensor on the node's device ingests zero-copy; a CPU tensor
    bounces through the pinned pool onto the card, and the block goes
    back."""
    from sparkucx_tpu_torch.io.dlpack import ingest_foreign, stage_to_device
    from sparkucx_tpu_torch.runtime.node import HostStagingPool
    t = torch.arange(4096, dtype=torch.float32, device=card).reshape(64, 64)
    out = ingest_foreign(t)
    assert out.device == card and out.data_ptr() == t.data_ptr()
    pool = HostStagingPool(pinned=True)
    h = torch.arange(1000, dtype=torch.int32).reshape(10, 100)
    got = ingest_foreign(h, device=card, pool=pool)
    assert got.device == card and torch.equal(got.cpu(), h)
    assert pool.stats()["in_use_bytes"] == 0
    staged = stage_to_device(np.arange(7, dtype=np.int64))
    assert staged.device == card
    assert staged.cpu().tolist() == list(range(7))


# -- the multi-process read plane: two workers sharing the card ------------
@pytest.fixture(scope="module")
def card_world():
    """``torch_cluster_jobs.card_reads`` on two workers sharing the card
    and on two CPU workers, from the same seed (the parent builds the
    kernels before it spawns a worker)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sparkucx_tpu_torch.cluster import run_cluster
    backend.kernel_library()
    card = run_cluster("torch_cluster_jobs:card_reads", 2, 8, device=None,
                       timeout_s=400)
    cpu = run_cluster("torch_cluster_jobs:card_reads", 2, 8, device="cpu",
                      timeout_s=400)
    return card.results, cpu.results


def _world_rows(results, key, vdtype, vw):
    out = {}
    for res in results:
        for r, (k, v) in res[key].items():
            keys = np.frombuffer(bytes.fromhex(k), np.int64)
            vals = np.frombuffer(bytes.fromhex(v), vdtype).reshape(-1, vw)
            out[int(r)] = sorted(zip(keys.tolist(),
                                     (row.tobytes() for row in vals)))
    return out


def test_two_process_read_on_card_matches_cpu(card_world):
    """Plain and int32 combine reads by two workers on the card hold the
    rows of the same reads by two CPU workers, partition by partition."""
    import torch_cluster_jobs as jobs
    card, cpu = card_world
    assert _world_rows(card, "plain", np.float32, jobs.VW) == \
        _world_rows(cpu, "plain", np.float32, jobs.VW)
    assert _world_rows(card, "combine", np.int32, 2) == \
        _world_rows(cpu, "combine", np.int32, 2)
    assert sorted(_world_rows(card, "plain", np.float32, jobs.VW)) == \
        list(range(jobs.R))


def test_two_process_int8_launches_quantize_once_per_process(card_world):
    """Each worker's int8 read launches the quantize kernel once (plus one
    a retry), the first and last launch byte-equal to ``quantize_plain``
    (``KernelCapture``); the keys land as on the CPU workers (the noise
    comes from the card's generator, so the values may round apart)."""
    from sparkucx_tpu_torch.ops import quant as tq
    card, cpu = card_world
    for res in card:
        assert res["int8_launches"] == 1 + res["int8_retries"]
        assert res["int8_checks"][tq.KERNEL_NAME]["calls"] >= 1
        for r, (k, _) in res["int8"].items():
            want = next(w for w in cpu if r in w["int8"])["int8"][r][0]
            assert sorted(np.frombuffer(bytes.fromhex(k), np.int64)) == \
                sorted(np.frombuffer(bytes.fromhex(want), np.int64))


def test_two_process_combine_segment_reduce_matches_plain(card_world):
    """Each worker's combine read finalizes through the segment-reduce
    kernel, its first and last launch bit-equal to the plain version."""
    from sparkucx_tpu_torch.ops import segmented as sg
    card, _ = card_world
    for res in card:
        assert res["combine_launches"] >= 1
        assert res["combine_checks"][sg.KERNEL_NAME]["calls"] >= 1


# -- the failure plane and the pool/fetch surface ----------------------------
def _failure_maps(seed: int, M: int = 8, n: int = 6000, vw: int = 5):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(1 << 62), 1 << 62, size=M * n, dtype=np.int64)
    vals = rng.integers(-(1 << 31), 1 << 31, size=(M * n, vw)).astype(
        np.int32)
    return keys, vals


def _write_maps(svc, sid: int, keys, vals, M: int, R: int):
    h = svc.register_shuffle(sid, M, R)
    per = keys.shape[0] // M
    for m in range(M):
        svc.write(h, m, keys[m * per:(m + 1) * per],
                  vals[m * per:(m + 1) * per])
    return h


def _check_oracle(res, keys, vals, R: int) -> None:
    pid = (hash32_np(keys) % np.uint32(R)).astype(np.int64)
    for r in range(R):
        k, v = res.partition(r)
        want = np.flatnonzero(pid == r)
        assert sorted(zip(k.tolist(), map(bytes, v))) == \
            sorted(zip(keys[want].tolist(), map(bytes, vals[want])))


def test_replayed_pallas_read_leaves_device_memory_on_card(card):
    """An exchange fault under ``failure.policy=replay`` and
    ``a2a.impl=pallas``: the read replays once, the segment move launches
    once (the fault comes before the dispatch), the partitions equal the
    oracle, the pool holds only the writers' staging afterwards and the
    card's allocated bytes return to their value before the read."""
    import gc
    M, R = 8, 16
    keys, vals = _failure_maps(51)
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
            "spark.shuffle.tpu.failure.policy": "replay"}
    with connect(conf, num_shards=8, use_env=False) as svc:
        h = _write_maps(svc, 1, keys, vals, M, R)
        warm = svc.read(h)
        dict(warm.partitions())
        del warm
        gc.collect()
        torch.cuda.synchronize(card)
        staged = svc.node.pool.stats()["in_use_bytes"]
        before = torch.cuda.memory_allocated(card)
        svc.node.faults.arm("exchange", fail_count=1)
        launches = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        res = svc.read(h)
        assert backend.launch_counts()[ra.KERNEL_NAME] == launches + 1
        rep = svc.report(1)
        assert (rep.replays, rep.impl) == (1, "pallas")
        assert svc.node.faults.stats()["exchange"] == (2, 1)
        _check_oracle(res, keys, vals, R)
        assert svc.node.pool.stats()["in_use_bytes"] == staged
        del res
        gc.collect()
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) == before
        svc.unregister_shuffle(1)
        assert svc.node.pool.stats()["in_use_bytes"] == 0


def test_preallocate_pins_blocks_on_card(card):
    """``memory.preAllocateBuffers`` on a card node takes page-locked
    blocks at node start; blocks below ``memory.minAllocationSize`` share
    one pinned slab, and a ``get`` of that size takes a preallocated
    block."""
    conf = {"spark.shuffle.tpu.memory.preAllocateBuffers": "1m:2,4k:3"}
    with connect(conf, num_shards=8, use_env=False) as svc:
        pool = svc.node.pool
        st = pool.stats()
        assert (st["preallocated"], st["free"]) == (5, 5)
        assert all(b.is_pinned() for b in pool._free)
        small = [b for b in pool._free if b.numel() == 4096]
        assert len({b.untyped_storage().data_ptr() for b in small}) == 1
        got = pool.get(4000)
        assert got.is_pinned() and pool.stats()["allocated"] == 5
        pool.put(got)
    with connect({**conf, "spark.shuffle.tpu.memory.pinned": "false"},
                 num_shards=8, use_env=False) as svc:
        assert not any(b.is_pinned() for b in svc.node.pool._free)


def test_partition_fetch_moves_only_the_partition_on_card(card):
    """``io.fetchGranularity=partition``: ``partition(0)`` copies exactly
    that partition's rows (its bytes in ``d2h_bytes``), equal to the
    shard-granular read's, and the device rows go once every partition
    was fetched."""
    M, R = 8, 16
    keys, vals = _failure_maps(52)
    width = 2 + vals.shape[1]
    views = {}
    for gran in ("shard", "partition"):
        conf = {"spark.shuffle.tpu.io.fetchGranularity": gran}
        with connect(conf, num_shards=8, use_env=False) as svc:
            res = svc.read(_write_maps(svc, 1, keys, vals, M, R))
            k0, v0 = res.partition(0)
            moved = svc.report(1).d2h_bytes
            if gran == "partition":
                assert moved == k0.shape[0] * width * 4
                assert res._rows_dev is not None
                _check_oracle(res, keys, vals, R)
                assert res._rows_dev is None
            else:
                assert moved > k0.shape[0] * width * 4
            views[gran] = sorted(zip(k0.tolist(), map(bytes, v0)))
    assert views["shard"] == views["partition"]


def test_staged_pallas_read_reports_integrity_bytes_on_card(card):
    """Under the default ``integrity.verify=staged`` a ``pallas`` read on
    the card verifies every staged byte before the exchange (the
    reference's ``integrity_bytes``: every map's key and value bytes),
    launches the segment move once and matches the oracle."""
    M, R = 8, 16
    keys, vals = _failure_maps(53)
    with connect({"spark.shuffle.tpu.a2a.impl": "pallas"}, num_shards=8,
                 use_env=False) as svc:
        h = _write_maps(svc, 1, keys, vals, M, R)
        launches = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        res = svc.read(h)
        rep = svc.report(1)
        assert (rep.impl, rep.integrity) == ("pallas", "staged")
        assert rep.integrity_bytes == keys.nbytes + vals.nbytes
        assert backend.launch_counts()[ra.KERNEL_NAME] == launches + 1
        _check_oracle(res, keys, vals, R)


def test_corrupt_staged_replay_leaves_device_memory_on_card(card):
    """A ``corrupt.staged`` flip under ``failure.policy=replay`` is found
    before the pack (no launch for the failed attempt), the replay
    launches the segment move once, the partitions equal the oracle and
    the card's allocated bytes return to their value before the read."""
    import gc
    M, R = 8, 16
    keys, vals = _failure_maps(54)
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
            "spark.shuffle.tpu.failure.policy": "replay"}
    with connect(conf, num_shards=8, use_env=False) as svc:
        h = _write_maps(svc, 1, keys, vals, M, R)
        warm = svc.read(h)
        dict(warm.partitions())
        del warm
        gc.collect()
        torch.cuda.synchronize(card)
        staged = svc.node.pool.stats()["in_use_bytes"]
        before = torch.cuda.memory_allocated(card)
        svc.node.faults.arm("corrupt.staged", fail_count=1, offset=4097)
        launches = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        res = svc.read(h)
        assert backend.launch_counts()[ra.KERNEL_NAME] == launches + 1
        rep = svc.report(1)
        assert (rep.replays, rep.integrity) == (1, "staged")
        assert svc.node.metrics.get("shuffle.integrity.corrupt.count") == 1
        _check_oracle(res, keys, vals, R)
        assert svc.node.pool.stats()["in_use_bytes"] == staged
        del res
        gc.collect()
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) == before


# -- the tenancy plane: concurrent async reads on the card -------------------
def _async_svc(conf=None):
    return connect({"spark.shuffle.tpu.a2a.impl": "pallas",
                    "spark.shuffle.tpu.tenant.asyncWorkers": "8",
                    "spark.shuffle.tpu.tenant.m.priority": "high",
                    **(conf or {})}, use_env=False)


def _async_minnows(svc, n: int, rows: int = 20_000, maps: int = 4):
    rng = np.random.default_rng(18)
    hs, want = [], []
    for i in range(n):
        k = rng.integers(0, 1 << 40, rows).astype(np.int64)
        v = np.repeat(k[:, None], 3, axis=1).astype(np.int32)
        h = svc.register_shuffle(300 + i, maps, 8,
                                 tenant="m" if i % 2 else "w")
        per = rows // maps
        for mid in range(maps):
            svc.write(h, mid, k[mid * per:(mid + 1) * per],
                      v[mid * per:(mid + 1) * per])
        hs.append(h)
        want.append(k)
    return hs, want


@pytest.mark.parametrize("cap", ["0", "1"])
def test_concurrent_async_reads_on_card_match_oracle(card, cap):
    """Eight ``read_async`` reads at once on eight workers (the admission
    cap off, or 1 byte so that they serialize through the fair-share
    queue), each against its oracle: every row routed to its hash
    partition with its own value lanes, every written key once; the
    reservations return to 0 and the pool to the writers' bytes."""
    with _async_svc({"spark.shuffle.tpu.a2a.maxBytesInFlight": cap}) as svc:
        hs, want = _async_minnows(svc, 8)
        staged = svc.node.pool.stats()["in_use_bytes"]
        futs = [svc.read_async(h) for h in hs]
        for f, k in zip(futs, want):
            res = f.result(timeout=120)
            got = []
            for r in range(8):
                pk, pv = res.partition(r)
                assert (hash32_np(pk) % 8 == r).all()
                assert (pv == pk[:, None].astype(np.int32)).all()
                got.append(pk)
            np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                          np.sort(k))
        torch.cuda.synchronize(card)
        m = svc.manager
        assert m._inflight_bytes == 0 and not m._admit_queue
        assert svc.node.pool.stats()["in_use_bytes"] == staged
        assert {svc.report(h.shuffle_id).async_workers for h in hs} == {8}


def test_segment_move_launches_once_per_attempt_under_contention(card):
    """Under eight concurrent async reads the segment-move kernel
    launches once per read attempt (the count is process-wide and each
    attempt launches it exactly once)."""
    with _async_svc() as svc:
        hs, _ = _async_minnows(svc, 8)
        svc.read(hs[0])                       # warm (not counted)
        backend.reset_launch_counts()
        futs = [svc.read_async(h) for h in hs]
        for f in futs:
            f.result(timeout=120)
        torch.cuda.synchronize(card)
        attempts = sum(1 + svc.report(h.shuffle_id).retries for h in hs)
        assert backend.launch_counts().get(ra.KERNEL_NAME, 0) == attempts
        assert all(svc.report(h.shuffle_id).impl == "pallas" for h in hs)


def test_device_trace_holds_the_segment_move_on_card(card, tmp_path):
    """A read inside ``tracer.device_trace``, the tracer disabled (the
    profiler makes its spans live), writes a Chrome trace that holds the
    segment move's kernel, each launched from inside a
    ``shuffle.dispatch`` range, at most as often as its launch counter
    moved."""
    import json
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas"}
    with connect(conf, use_env=False) as svc:
        rng = np.random.default_rng(3)
        h = svc.register_shuffle(5, 8, 8)
        for m in range(8):
            svc.write(h, m, rng.integers(0, 1 << 40, size=4096),
                      rng.integers(0, 1 << 20, size=(4096, 2),
                                   dtype=np.int32))
        svc.read(h)                                    # warm
        tracer = svc.node.tracer
        before = backend.launch_counts().get(ra.KERNEL_NAME, 0)
        with tracer.device_trace(str(tmp_path)):
            # a profiler trace can lack the first launches made in it
            # (chip_smoke.PROFILER_LEAD_S)
            time.sleep(0.05)
            svc.read(h)
            torch.cuda.synchronize(card)
        delta = backend.launch_counts()[ra.KERNEL_NAME] - before
        assert not tracer.enabled and not tracer.live
        assert tracer.spans("shuffle.dispatch")
        tracer.clear()
        events = json.load(open(tracer.device_trace_path))["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    kernels = [e for e in xs if e.get("cat") == "kernel"
               and "ragged_segment_copy" in e["name"]]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in xs
              if e["name"] == "shuffle.dispatch"
              and e.get("cat") == "user_annotation"]
    host = {(e.get("args") or {}).get("correlation"): e["ts"] for e in xs
            if e.get("cat") != "kernel"}
    assert 1 <= len(kernels) <= delta and ranges
    for k in kernels:
        ts = host[k["args"]["correlation"]]
        assert any(lo <= ts <= hi for lo, hi in ranges)


def test_devmon_reads_the_card(card):
    """The sampler reads the card's allocator: ``in_use`` at most
    ``limit``, which is the card's total memory, ``peak`` at least
    ``in_use``; no field is null on the card."""
    from sparkucx_tpu_torch.runtime.devmon import device_memory
    from sparkucx_tpu_torch.utils.metrics import G_HBM_IN_USE, labeled
    x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    mem = device_memory(card)
    assert None not in mem.values()
    assert mem["in_use"] >= x.numel() and mem["in_use"] <= mem["limit"]
    assert mem["limit"] == torch.cuda.get_device_properties(card) \
        .total_memory
    assert mem["peak"] >= mem["in_use"]
    with connect({"spark.shuffle.tpu.devmon.enabled": "true",
                  "spark.shuffle.tpu.devmon.intervalMs": "3600000"},
                 use_env=False) as svc:
        svc.node.devmon.sample_once()
        (d,) = svc.node.devmon.samples()[-1]["devices"]
        assert None not in (d["in_use"], d["limit"], d["peak"])
        assert svc.node.metrics.gauges()[labeled(
            G_HBM_IN_USE, device=card.index or 0)] == d["in_use"]
    del x


def test_anatomy_conserves_on_card(card):
    """With the tracer on, a plain ``pallas`` read and a combine read on
    the card each stamp a ledger whose phases plus ``dark_ms`` equal
    ``anatomy_wall_ms`` within the rounding of the stamped values, with
    ``pack`` and ``transfer.ici`` (the completion wait) among the plain
    read's phases; ``shuffle.phase.ms`` adds up to the reads' walls."""
    from sparkucx_tpu_torch.utils.metrics import C_PHASE_MS
    keys, vals = _failure_maps(61)
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
            "spark.shuffle.tpu.trace.enabled": "true"}
    with connect(conf, num_shards=8, use_env=False) as svc:
        h = _write_maps(svc, 1, keys, vals, 8, 16)
        walls = []
        for kw in ({}, {}, {"combine": "sum"}):      # the first warms
            before = backend.launch_counts().get(ra.KERNEL_NAME, 0)
            svc.read(h, **kw)
            torch.cuda.synchronize(card)
            rep = svc.report(1)
            assert backend.launch_counts()[ra.KERNEL_NAME] == before + 1
            total = sum(rep.phases.values()) + rep.dark_ms
            assert abs(total - rep.anatomy_wall_ms) <= \
                1e-3 * (len(rep.phases) + 2)
            walls.append(rep.anatomy_wall_ms)
            if not kw:
                assert {"pack", "transfer.ici"} <= set(rep.phases)
        counted = sum(v for k, v in svc.node.metrics.snapshot().items()
                      if k.startswith(C_PHASE_MS + "{"))
    assert abs(counted - sum(walls)) <= 3e-3


def test_watcher_capture_holds_a_segment_move_on_card(card, tmp_path):
    """A critical finding under reads on the card: the node's watcher
    captures once, and its profiler window's Chrome trace holds at least
    one segment-move kernel of the reads that went on meanwhile."""
    import json
    from sparkucx_tpu_torch.runtime.failures import BlockCorruptionError
    keys, vals = _failure_maps(62)
    conf = {"spark.shuffle.tpu.a2a.impl": "pallas",
            "spark.shuffle.tpu.fault.corrupt.staged.failCount": "3",
            "spark.shuffle.tpu.doctor.watchIntervalSecs": "0.2",
            "spark.shuffle.tpu.doctor.captureMs": "200",
            "spark.shuffle.tpu.doctor.captureDir": str(tmp_path)}
    with connect(conf, num_shards=8, use_env=False) as svc:
        w = svc.node.watcher
        h = _write_maps(svc, 1, keys, vals, 8, 16)
        for _ in range(3):
            with pytest.raises(BlockCorruptionError):
                svc.read(h)
        deadline = time.time() + 30.0
        while not w.captures:
            assert time.time() < deadline, "the watcher never captured"
            svc.read(h)
            torch.cuda.synchronize(card)
        assert w.check_once() == [] and len(w.captures) == 1
        cap = w.captures[0]
    assert (cap["rule"], cap["grade"]) == ("block_corruption", "critical")
    with open(f"{cap['profile_dir']}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert [e for e in events if e.get("cat") == "kernel"
            and "ragged_segment_copy" in str(e.get("name"))]


# -- the kernelbench (ops/microbench.py) ----------------------------------------
@pytest.mark.parametrize("rows_log2", [8, 13])
def test_kernelbench_grades_every_case_on_card(card, rows_log2):
    """The ported kernelbench on the card: every case's ``cuda`` arm
    timed, every parity grade ok (bit-exact on the int32 and the
    integer-valued float32 cases), the kernels launched, no build on the
    warm pass."""
    from sparkucx_tpu_torch.ops.microbench import run_microbench
    from sparkucx_tpu_torch.ops.segmented import (KERNEL_NAME,
                                                  WIRE_KERNEL_NAME)
    out = run_microbench(reps=2, rows_log2=rows_log2, device=card)
    assert out["ok"] and out["native_cuda"], out
    for row in out["cases"]:
        assert row["cuda"]["status"] == "ok" and row["cuda"]["wall_ms"] > 0
        assert row["parity"]["status"] == "ok" and row["parity"]["ok"], row
        if row["wire"] == "raw":
            assert row["parity"]["bitexact"], row
    assert out["programs"]["warm_recompiles"] == 0
    assert out["launches"][KERNEL_NAME] >= 4
    assert out["launches"][WIRE_KERNEL_NAME] >= 1


def test_compile_cache_rebinds_later_builds_on_card(card, tmp_path):
    """``compile.cacheDir`` on the card: a node bound to an empty
    directory loads the already-loaded library (no rebuild in this
    process), and a second node back on the package's directory rebinds
    later builds there."""
    from sparkucx_tpu_torch.config import DEFAULT_BUILD_DIR
    backend.kernel_library()
    builds = backend.build_count()
    conf = {"spark.shuffle.tpu.compile.cacheDir": str(tmp_path)}
    with connect(conf, num_shards=1, use_env=False) as svc:
        assert svc.node.compile_cache_dir == str(tmp_path)
        assert backend.build_dir() == tmp_path
        backend.kernel_library()
    with connect({}, num_shards=1, use_env=False) as svc:
        assert str(backend.build_dir()) == DEFAULT_BUILD_DIR
    assert backend.build_count() == builds


# -- the streaming read plane: per-shard D2H, partitions_ready() -------------
def _stream_read(svc, sid: int, seed: int, R: int = 16):
    keys, vals = _failure_maps(seed)
    res = svc.read(_write_maps(svc, sid, keys, vals, 8, R))
    return res, keys, vals, 2 + vals.shape[1]


def test_partition_pulls_only_its_shard_on_card(card):
    """A plain ``pallas`` read: ``partition(0)`` copies shard 0's extent and
    nothing more; a full walk copies every shard's extent once, and the
    partitions equal the oracle."""
    R = 16
    with connect(num_shards=8, use_env=False) as svc:
        res, keys, vals, width = _stream_read(svc, 1, 61, R=R)
        assert svc.report(1).impl == "pallas"
        res.partition(0)
        extents = [res._runs(s).extent for s in range(8)]
        assert svc.report(1).d2h_bytes == extents[0] * width * 4
        assert list(res._shards) == [0] and res._rows_dev is not None
        _check_oracle(res, keys, vals, R)
        assert svc.report(1).d2h_bytes == sum(extents) * width * 4
        assert res._rows_dev is None


# run in a child: CUDA_DEVICE_MAX_CONNECTIONS is read when CUDA starts
HELD_CHILD = """
import json
import numpy as np
import torch
from chip_smoke import copy_ms, held_walk, sleep_cycles
from sparkucx_tpu_torch import connect
R, M = 16, 8
rng = np.random.default_rng(62)
keys = rng.integers(-(1 << 62), 1 << 62, size=M * 6000, dtype=np.int64)
vals = rng.integers(-(1 << 31), 1 << 31, size=(M * 6000, 5)).astype(np.int32)
dev = torch.device("cuda", 0)
with connect(num_shards=8, use_env=False) as svc:
    h = svc.register_shuffle(2, M, R)
    for m in range(M):
        svc.write(h, m, keys[m * 6000:(m + 1) * 6000],
                  vals[m * 6000:(m + 1) * 6000])
    res = svc.read(h)
    extents = [res._runs(s).extent for s in range(8)]
    cycles = sleep_cycles(dev, max(30 * copy_ms(dev, max(extents), 7), 20.0))
    w = held_walk(res, cycles)
    parts = {str(r): [k.tolist(), [bytes(x).hex() for x in v]]
             for r, (k, v) in w["parts"].items()}
    print(json.dumps({"order": w["order"], "pending": w["pending_at_first"],
                      "p2s": np.asarray(res._part_to_shard).tolist(),
                      "d2h": svc.report(2).d2h_bytes,
                      "extents": extents, "parts": parts}))
"""


def test_partitions_ready_overtakes_a_delayed_shard_on_card(card):
    """Shard 0's copy stream held behind ``torch.cuda._sleep`` for 30 of
    its copy times (in a child whose 8 copy streams have hardware queues
    of their own): its partitions come last, its event is still pending
    at the first yield, every partition arrives once and matches the
    oracle, and every shard's extent is copied once."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", HELD_CHILD], cwd=root, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_DEVICE_MAX_CONNECTIONS": "32"})
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    R = 16
    assert got["pending"] is True
    slow = [r for r in range(R) if got["p2s"][r] == 0]
    assert got["order"][-len(slow):] == slow
    assert sorted(got["order"]) == list(range(R))
    keys, vals = _failure_maps(62)
    pid = (hash32_np(keys) % np.uint32(R)).astype(np.int64)
    for r in range(R):
        k, v = got["parts"][str(r)]
        want = np.flatnonzero(pid == r)
        assert sorted(zip(k, v)) == sorted(
            zip(keys[want].tolist(), (bytes(x).hex() for x in vals[want])))
    assert got["d2h"] == sum(got["extents"]) * 7 * 4


def test_device_rows_drop_once_after_the_last_shard_on_card(card):
    """``_on_device_free`` fires once, when the last of the 8 shards lands,
    and the device rows go with it; a later ``partitions_ready()`` is
    index order over the host blocks."""
    R = 16
    with connect(num_shards=8, use_env=False) as svc:
        res, keys, vals, _ = _stream_read(svc, 3, 63, R=R)
        freed = []
        res._on_device_free = lambda: freed.append(1)
        p2s = np.asarray(res._part_to_shard)
        for s in range(7):
            res.partition(int(np.flatnonzero(p2s == s)[0]))
        assert freed == [] and res._rows_dev is not None
        res.partition(R - 1)
        assert freed == [1] and res._rows_dev is None
        assert [r for r, _ in res.partitions_ready()] == list(range(R))
        _check_oracle(res, keys, vals, R)
        assert freed == [1]


def test_device_rows_unreferenced_when_the_free_hook_fires_on_card(card):
    """Under ``partitions_ready()``, whose copies (and their waiter
    threads) outlive the landing: when the device-free hook fires,
    nothing references the device rows any more."""
    import gc
    import weakref
    R = 16
    with connect(num_shards=8, use_env=False) as svc:
        res, keys, vals, _ = _stream_read(svc, 5, 65, R=R)
        rows = weakref.ref(res._rows_dev)
        alive = []

        def freed():
            gc.collect()
            alive.append(rows() is not None)

        res._on_device_free = freed
        assert sorted(r for r, _ in res.partitions_ready()) == list(range(R))
        assert alive == [False]
        _check_oracle(res, keys, vals, R)


def test_host_view_drain_releases_admission_on_card(card):
    """A device-sink read's ``host_view()`` walked through
    ``partitions_ready()``: the reservation stays while a shard is on the
    card and frees once the last one landed; a later close releases
    nothing twice."""
    R = 16
    with connect({"spark.shuffle.tpu.a2a.maxBytesInFlight": "1g"},
                 num_shards=8, use_env=False) as svc:
        m = svc.manager
        keys, vals = _failure_maps(64)
        res = svc.read(_write_maps(svc, 4, keys, vals, 8, R), sink="device")
        assert m._inflight_bytes > 0 and svc.report(4).d2h_bytes == 0
        hv = res.host_view()
        hv.partition(0)
        assert m._inflight_bytes > 0
        got = dict(hv.partitions_ready())
        assert sorted(got) == list(range(R))
        assert m._inflight_bytes == 0 and hv._rows_dev is None
        res.close()
        assert m._inflight_bytes == 0
        _check_oracle(hv, keys, vals, R)
