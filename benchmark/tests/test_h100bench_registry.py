"""The harness finds every cell's pieces by name, BENCHMARK.json keeps to
the contract's form, and a configuration, a traffic mix, a per-layer
metric and a cell added as new files and entries run without an edit to
any file that is there."""

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_piece_is_found(workload):
    cell = harness.resolve(SPEC, workload)
    assert callable(harness.driver_class(cell.traffic))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert names - {"setup_s"} == set(cell.traffic["end_to_end"])
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in names


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    root = harness.REPO
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (root / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        body = json.loads((root / c["file"]).read_text())
        assert set(c["reduced"]) == set(body["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        names += [w["name"], w["config"], w["traffic"]]
    assert len(pairs) == len(SPEC["workloads"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for path in (root / "benchmark").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$", path.name)


def test_a_cell_added_as_files_and_entries(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added
    to a copy of the benchmark as new files and entries, make a cell that
    runs; no file of the copy changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    (root / "benchmark" / "configs" / "tiny-moe.json").write_text(
        json.dumps(tiny.TINY_CONFIG["switch-base-8"]))
    mix = json.loads((root / "benchmark" / "traffic" /
                      "expert_dispatch.json").read_text())
    mix.update(tokens_per_step=1024, batches=2)
    (root / "benchmark" / "traffic" / "two_batches.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "metrics" / "steps_read.tiny.py").write_text(
        "def read(ctx):\n    return float(len(ctx['facts']['spans']"
        "['read_ms']))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-moe", "source": "test",
                            "file": "benchmark/configs/tiny-moe.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_dispatch", "config": "tiny-moe",
                              "traffic": "two_batches", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_read.tiny", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves":
                              "dispatch_tokens_per_s",
                              "workloads": ["tiny_dispatch"]})
    for m in spec["end_to_end"]:
        if m["name"].startswith("dispatch_"):
            m["workloads"].append("tiny_dispatch")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(root), "tiny_dispatch", root)
    line, _ = tiny.run(cell, seconds=0.2, root=root)
    assert line["correct"]
    assert set(line["metrics"]) == {"dispatch_tokens_per_s", "setup_s"}
    line, _ = tiny.run(cell, seconds=0.2, trace=True, root=root)
    assert line["metrics"]["steps_read.tiny"]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


def test_a_mix_takes_a_rate_or_a_percentile_from_the_steps():
    """Both rules a mix's ``end_to_end`` can name, so that a later mix can
    bound a tail without a change to the harness."""
    steps = [{"tokens": 10, "step_ms": float(ms)} for ms in range(1, 101)]
    assert harness.step_stat(steps, 4.0, {"stat": "rate",
                                          "of": "tokens"}) == 250.0
    assert harness.step_stat(steps, 4.0, {"stat": "percentile", "q": 95,
                                          "of": "step_ms"}) == \
        pytest.approx(95.05)
