"""Each plain reference agrees with the port at tiny sizes on the CPU:
every cell's run, past the harness's look for a card, comes out correct,
each compared number inside its limit (exact where the limit is 0)."""

import pytest

from benchmark.tests import tiny

CELLS = ["switch8_dispatch", "mpt7b_ulysses", "switch8_train"]


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload):
    cell = tiny.tiny_cell(workload)
    line, lines = tiny.run(cell)
    assert line["correct"], lines
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    # the compared numbers are the run's last lines
    want = [f"check {n} {c['value']!r} limit {c['limit']!r}"
            for n, c in line["checks"].items()]
    assert lines[-len(want):] == want
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_the_same_seed_gives_the_same_inputs(seed):
    import torch
    from benchmark.drivers.expert_dispatch import Driver
    cell = tiny.tiny_cell("switch8_dispatch")
    a, b = (Driver(cell.config, cell.traffic, seed, torch.device("cpu"),
                   None)._inputs() for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
