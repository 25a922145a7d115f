"""On a card: every cell at a tiny size through the harness on CUDA
(the port's kernels and the reference on the device) comes out correct.
Skips where no card is visible."""

import pytest
import torch

from benchmark.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["switch8_dispatch", "mpt7b_ulysses",
                                      "switch8_train"])
def test_tiny_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny.tiny_cell(workload)
    line, lines = tiny.run(cell, device="cuda:0")
    assert line["correct"], lines
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["power_limit_w"] > 0
