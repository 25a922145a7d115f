"""Cells at sizes a CPU test can hold: the benchmark's own cells with
their widths, lengths and counts cut, every other setting kept."""

import time
from pathlib import Path

import torch

from benchmark import harness

TINY_CONFIG = {
    "switch-base-8": {"d_model": 16, "d_ff": 32, "num_experts": 8,
                      "vocab_size": 64, "d_kv": 8, "num_heads": 4,
                      "num_layers": 4},
    "mpt-7b-storywriter": {"d_model": 64, "n_heads": 8},
}
TINY_TRAFFIC = {
    "expert_dispatch": {"tokens_per_step": 2048},
    "ulysses_document": {"tokens": 1024, "maps": 16},
    "uniform_tokens_train": {"batch": 8, "seq_len": 16},
}


def tiny_cell(workload: str, root: Path = harness.REPO) -> harness.Cell:
    spec = harness.load_spec(root)
    cell = harness.resolve(spec, workload, root)
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    cell.config = {**cell.config, **TINY_CONFIG[w["config"]]}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[w["traffic"]]}
    return cell


def run(cell: harness.Cell, seed: int = 2 ** 33 + 7, seconds: float = 0.3,
        trace: bool = False, device="cpu", root: Path = harness.REPO):
    """One run of ``cell`` on ``device``, past the harness's look for a
    card: (the result line as a dict, the check lines)."""
    import json
    lines = []
    line = harness.run_cell(cell, seed, seconds, trace, torch.device(device),
                            time.perf_counter(), root / ".benchcache" /
                            "kernels", lines.append, root)
    return json.loads(line), lines
