"""The control of each cell — its plain reference computed in TF32, put in
the program's place — comes out not correct: it reads over a limit of
the cell. Here at sizes a CPU test can hold (the widths of the dispatch
and attention cells as published); on the card at the cells' own sizes
with ``benchmark/control.py``, whose readings ``PERF.md`` keeps."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SIZES = {
    "switch8_dispatch": ({"d_model": 768, "d_ff": 3072, "num_experts": 8},
                         {"tokens_per_step": 2048}, 60),
    "mpt7b_ulysses": ({"d_model": 4096, "n_heads": 32}, {"tokens": 1024},
                      1),
    "switch8_train": ({}, {}, 1),
}


@pytest.mark.parametrize("workload", sorted(SIZES))
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
def test_the_control_fails_a_limit(workload, seed):
    cell = tiny.tiny_cell(workload)
    config, traffic, steps = SIZES[workload]
    drv = harness.driver_class(cell.traffic)(
        {**cell.config, **config}, {**cell.traffic, **traffic}, seed,
        torch.device("cpu"), None)
    got = drv.control_readings(steps)
    limits = cell.traffic["limits"]
    assert any(v > limits[k] for k, v in got.items()), (got, limits)
