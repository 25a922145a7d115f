"""The readers of the port's own spans (``metrics/_spans.py`` and the
eight metrics on it) on rings filled at a tiny size on the CPU: a traced
run of each cell through the harness (the window under
``torch.profiler``, which makes the port's spans live with its tracer
disabled), and the empty ring, on which every one of them reads None.
The CPU records no device time, so the device-timed readers read None
there too; their arithmetic is checked with the spans' device times set
by hand."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import tiny
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

READERS = {"switch8_dispatch": ("verify_ms.dispatch", "wait_ms.dispatch"),
           "mpt7b_ulysses": ("verify_ms.attn", "wait_ms.attn",
                             "decode_ms.attn", "keysort_ms.attn"),
           "switch8_train": ("exchange_ms.train", "expert_fwd_ms.train")}
ALL = [m for ms in READERS.values() for m in ms]


@pytest.fixture()
def ring():
    GLOBAL_TRACER.clear()
    yield GLOBAL_TRACER
    GLOBAL_TRACER.clear()


def read(name):
    return harness.metric_reader(name)({})


def timed(names, ms=1.0):
    """Give every ring span named in ``names`` ``ms`` of device time;
    their count."""
    spans = [s for s in GLOBAL_TRACER.spans() if s.name in names]
    for s in spans:
        s._device_ms = ms
    return len(spans)


def test_an_empty_ring_reads_none(ring):
    assert not ring.live
    assert {m: read(m) for m in ALL} == dict.fromkeys(ALL)


@pytest.mark.parametrize("workload", ["switch8_dispatch", "mpt7b_ulysses"])
def test_a_read_cell_reads_its_phases(workload, ring):
    """Verify and wait are the medians of the reads' own spans (nothing
    of a higher phase overlaps them), each read's phases inside its
    wall."""
    line, _ = tiny.run(tiny.tiny_cell(workload), trace=True)
    assert line["correct"]
    got = line["metrics"]
    verify, wait = READERS[workload][:2]
    reads = ring.spans("shuffle.exchange")
    assert len(reads) == line["attempted"]
    for name, metric in (("shuffle.verify", verify),
                         ("shuffle.exchange.wait", wait)):
        spans = ring.spans(name)
        assert len(spans) == len(reads)
        assert got[metric]["value"] == pytest.approx(
            float(np.median([s.dur_ms for s in spans])), rel=1e-6,
            abs=1e-6)
    assert got[verify]["value"] > 0.0
    pack = got[verify.replace("verify", "pack")]["value"]
    assert got[verify]["value"] + got[wait]["value"] + pack <= \
        got[verify.replace("verify", "read")]["value"]
    assert "decode_ms.attn" not in got
    assert "keysort_ms.attn" not in got


def test_the_decode_reads_device_time_per_read(ring):
    tiny.run(tiny.tiny_cell("mpt7b_ulysses"), trace=True)
    decodes = len(ring.spans("ulysses.decode"))
    assert decodes == len(ring.spans("shuffle.exchange")) > 0
    assert read("decode_ms.attn") is None
    # the decode and three trades a read: to heads, to sequence, unshard
    n = timed({"ulysses.decode", "ulysses.heads"})
    assert n == 4 * decodes
    assert read("decode_ms.attn") == pytest.approx(n / decodes)


def test_the_keysort_reads_device_time_per_read(ring):
    """The ordered sink's densify and sort, one span each a read."""
    tiny.run(tiny.tiny_cell("mpt7b_ulysses"), trace=True)
    reads = len(ring.spans("shuffle.exchange"))
    stages = [s.attrs["stage"] for s in ring.spans("shuffle.keysort")]
    assert reads > 0
    assert sorted(stages) == ["densify"] * reads + ["sort"] * reads
    assert read("keysort_ms.attn") is None
    assert timed({"shuffle.keysort"}, 1.5) == 2 * reads
    assert read("keysort_ms.attn") == pytest.approx(3.0)


def test_the_training_step_reads_device_time_per_step(ring):
    line, _ = tiny.run(tiny.tiny_cell("switch8_train"), trace=True)
    assert line["correct"]
    steps = len(ring.spans("train.step"))
    assert steps == line["attempted"] > 0
    assert read("exchange_ms.train") is None
    assert read("expert_fwd_ms.train") is None
    moves = ring.spans("moe.exchange")
    passes = [s.attrs["pass"] for s in moves]
    experts = timed({"moe.experts"}, 2.0)
    # two moves a layer's forward (dispatch and combine), in the forward
    # and remat's re-forward, and their two backward moves
    assert passes.count("forward") == 2 * experts
    assert passes.count("backward") == experts > 0
    assert timed({"moe.exchange"}) == len(moves)
    assert read("exchange_ms.train") == pytest.approx(len(moves) / steps)
    assert read("expert_fwd_ms.train") == pytest.approx(2.0 * experts
                                                        / steps)
