"""The device trace's arithmetic: the union of overlapping intervals, the
idle gaps and their labels, and the readers built on them."""

import pytest

from benchmark import trace
from benchmark.metrics import _common


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert trace.union_length(iv) == 25
    assert trace.merged(iv) == [(0, 15), (20, 30), (40, 40)]
    assert trace.union_length([]) == 0
    assert trace.union_length([(3, 4), (0, 10)]) == 10


def test_clip_and_gaps():
    busy = trace.merged(trace.clip([(-5, 2), (4, 6), (8, 20)], 0, 10))
    assert busy == [(0, 2), (4, 6), (8, 10)]
    assert trace.idle_gaps(busy, 0, 10) == [(2, 4), (6, 8)]
    assert trace.idle_gaps([], 0, 10) == [(0, 10)]


def test_gap_labels_take_the_innermost_host_event():
    host = [(0, 100, "bench.step"), (10, 30, "aten::mm"),
            (50, 90, "read"), (60, 70, "pack")]
    got = trace.label_gaps([(20, 24), (62, 68), (95, 99), (200, 210)], host)
    assert got == pytest.approx({"aten::mm": 4e-6, "pack": 6e-6,
                                 "bench.step": 4e-6, "host idle": 10e-6})


def ctx(kernels, busy=1.0, window=4.0, flops=0.0, work=None, spans=None):
    return {"trace": {"busy_s": busy, "window_s": window,
                      "kernels": kernels},
            "peaks": {"tf32_flops_per_s": 100.0, "hbm_bytes_per_s": 10.0},
            "facts": {"model_flops": flops, "kernel_work": work or {},
                      "spans": spans or {}}}


def test_readers():
    work = {"k": {"symbols": ["dq", "dkv"], "flops": 100.0, "bytes": 20.0}}
    c = ctx({"dq(float*)": [1.0, 1.0], "dkv(float*)": [2.0, 2.0],
             "other": [9.0]}, flops=200.0, work=work,
            spans={"read_ms": [3.0, 1.0, 2.0]})
    # two calls, each bound by max(100/100, 20/10) = 2 s, over 6 s
    assert _common.roofline(c, "k") == pytest.approx(100 * 4 / 6)
    assert _common.roofline(c, "absent") is None
    assert _common.roofline(ctx({}, work=work), "k") is None
    assert _common.mfu(c) == pytest.approx(100 * 200 / 4 / 100)
    assert _common.idle(c) == pytest.approx(75.0)
    assert _common.idle(ctx({}, busy=0.0)) is None
    assert _common.span_median(c, "read_ms") == 2.0
    assert _common.span_median(c, "pack_ms") is None
