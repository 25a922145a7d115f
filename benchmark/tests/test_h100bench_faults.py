"""Runs of each cell with the timed path broken underneath
(``benchmark/faults.py``), past the harness's look for a card: ``correct``
has to come out false for every fault the cell can have. A training fault
comes on after set-up's warm steps, so it breaks the timed steps alone."""

import pytest

from benchmark.faults import PLANT, planted
from benchmark.tests import tiny

CELLS = {"switch8_dispatch": "expert_dispatch",
         "mpt7b_ulysses": "ulysses_read", "switch8_train": "moe_train"}
CASES = [(w, f) for w, d in CELLS.items() for f in PLANT[d]]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    cell = tiny.tiny_cell(workload)
    with planted(CELLS[workload], fault,
                 int(cell.traffic.get("warm_steps", 0))):
        line, lines = tiny.run(cell)
    assert not line["correct"], lines
    # the fault is gone after the block
    assert tiny.run(cell)[0]["correct"]
