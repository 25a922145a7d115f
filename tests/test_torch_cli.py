"""Port parity for the operator CLI (``python -m sparkucx_tpu_torch``,
``sparkucx_tpu_torch/__main__.py``).

* The reference's CLI cases of ``tests/test_telemetry.py`` (``stats`` and
  ``trace`` of this process; its dumper case, which builds the JAX
  service by hand, as a port copy) and ``tests/test_decisions.py`` (the
  offline
  ``decisions`` audit: a silent split, a clean fleet in both formats, no
  ledger), each run unchanged on the port's CLI
  (``torch_ref_cases.port_view``). The anatomy, doctor and SLO suites'
  CLI cases run in their own port files, the ``--live-url`` case in
  ``tests/test_torch_live.py``, the ``cluster`` cases in
  ``tests/test_torch_fleet.py``.
* Both CLIs over the same files a port node wrote (its final snapshot
  dump, its history log and decision ledger, from two-slice reads of a
  node forced distributed inside a one-rank gloo world): for ``stats``,
  ``trace``, ``timeline``, ``anatomy``, ``doctor``, ``slo``, ``cluster``
  and ``decisions`` in each format and gate, the same exit code, the
  same standard output and the same output files.
* ``keys``: every row names a key of the reference's table with the same
  default, once (``compile.cacheDir`` excepted: its default is the port's
  kernel build directory); ``workload`` and ``kernelbench`` are listed,
  and ``workload`` refuses bad arguments with exit 2.
"""

import contextlib
import io
import json
import os
import socket

import numpy as np
import pytest
import torch.distributed as tdist

from sparkucx_tpu.__main__ import main as jmain
from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.__main__ import main as tmain
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
from torch_ref_cases import port_view, run_case

PFX = "spark.shuffle.tpu."
REF_CASES = [("test_telemetry", "test_cli_stats_live_and_trace"),
             ("test_decisions", "test_cli_decisions_offline_flags_silent_split"),
             ("test_decisions", "test_cli_decisions_offline_clean_and_json"),
             ("test_decisions", "test_cli_decisions_no_ledgers_exit2")]


@pytest.mark.parametrize("modname,name", REF_CASES,
                         ids=[n for _, n in REF_CASES])
def test_reference_case(modname, name, request):
    """One reference case, unchanged, on the port's CLI."""
    run_case(port_view(modname), name, {}, request)


# -- the same files through both CLIs ----------------------------------------
@pytest.fixture(scope="module")
def port_dumps(tmp_path_factory):
    """The files of one port node: reads of two slices forced distributed
    in a one-rank world (agreement rounds land in the decision ledger),
    the tracer on, history windows rolled between reads, a latency
    objective every read misses; ``stop`` writes the final snapshot."""
    d = tmp_path_factory.mktemp("port_dumps")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    GLOBAL_TRACER.clear()
    try:
        svc = connect({PFX + "a2a.impl": "dense",
                       PFX + "mesh.numSlices": "2",
                       PFX + "trace.enabled": "true",
                       PFX + "metrics.dumpDir": str(d),
                       PFX + "metrics.dumpIntervalSecs": "3600",
                       PFX + "history.dir": str(d),
                       PFX + "history.windowSecs": "86400",
                       PFX + "slo.read.p99Ms": "0.001",
                       PFX + "slo.minEvents": "1"},
                      device="cpu", use_env=False)
        svc.node.is_distributed = True
        rng = np.random.default_rng(5)
        traces = []
        try:
            for sid in (41, 42, 43):
                h = svc.register_shuffle(sid, 4, 8)
                for m in range(4):
                    svc.write(h, m, rng.integers(0, 1 << 18, size=96))
                svc.read(h).partition(0)
                traces.append(svc.report(sid).trace_id)
                svc.node.history.roll()
        finally:
            svc.node.is_distributed = False
            svc.stop()
    finally:
        GLOBAL_TRACER.enabled = False
        GLOBAL_TRACER.clear()
        tdist.destroy_process_group()
    names = sorted(os.listdir(d))
    dump = [n for n in names if n.startswith("metrics_")]
    assert len(dump) == 1, names
    assert any(n.startswith("history_") for n in names), names
    assert "decisions_p0.jsonl" in names, names
    return {"dir": str(d), "dump": os.path.join(d, dump[0]),
            "traces": traces}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


COMMANDS = {
    "stats_prometheus": ["stats", "--input", "{dump}"],
    "stats_json": ["stats", "--input", "{dump}", "--format", "json"],
    "trace": ["trace", "--input", "{dump}", "--out", "{out}"],
    "timeline": ["timeline", "--input", "{dir}", "--out", "{out}"],
    "timeline_anatomy": ["timeline", "--input", "{dump}", "--out", "{out}",
                         "--anatomy"],
    "anatomy_text": ["anatomy", "--input", "{dir}"],
    "anatomy_json_trace": ["anatomy", "--input", "{dump}", "--format",
                           "json", "--trace", "{trace}"],
    "anatomy_gate": ["anatomy", "--input", "{dump}", "--min-attributed",
                     "0.999999", "--out", "{out}"],
    "doctor_text": ["doctor", "--input", "{dir}"],
    "doctor_json_gate": ["doctor", "--input", "{dir}", "--format", "json",
                         "--fail-on", "warn"],
    "doctor_dump": ["doctor", "--input", "{dump}", "--strict-anchor"],
    "slo_text": ["slo", "--input", "{dir}"],
    "slo_json_gate": ["slo", "--input", "{dir}", "--format", "json",
                      "--fail-on", "fast"],
    "cluster_dead": ["cluster", "--peers", "http://127.0.0.1:9",
                     "--timeout-s", "1"],
    "cluster_no_registry": ["cluster", "--registry", "{dir}"],
    "decisions_text": ["decisions", "--input", "{dir}"],
    "decisions_json_gate": ["decisions", "--input", "{dir}", "--format",
                            "json", "--fail-on", "warn"],
}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_both_clis_agree_on_a_port_node_s_files(cmd, port_dumps, tmp_path):
    outs = []
    for side, main in (("jax", jmain), ("port", tmain)):
        out_path = str(tmp_path / f"{cmd}.json")
        argv = [a.format(dump=port_dumps["dump"], dir=port_dumps["dir"],
                         out=out_path, trace=port_dumps["traces"][-1])
                for a in COMMANDS[cmd]]
        rc, stdout = _run(main, argv)
        written = None
        if os.path.exists(out_path):
            with open(out_path) as f:
                written = json.load(f)
            os.remove(out_path)
        outs.append((rc, stdout, written))
    assert outs[0] == outs[1]
    rc, stdout, _ = outs[1]
    assert stdout or rc == 2
    if cmd.startswith("cluster"):
        assert rc == 2


def test_the_port_s_files_grade_as_written(port_dumps):
    """What the comparison above runs on: the latency objective burns
    fast, the anatomy holds each read's ledger, the ledgers audit
    clean."""
    rc, out = _run(tmain, ["slo", "--input", port_dumps["dir"],
                           "--format", "json"])
    verdict = json.loads(out)
    assert rc == 0 and verdict["fast_burn"] is True
    rc, out = _run(tmain, ["anatomy", "--input", port_dumps["dump"],
                           "--format", "json"])
    rep = json.loads(out)
    assert rc == 0
    assert [led["trace_id"] for led in rep["ledgers"]] == \
        port_dumps["traces"]
    rc, out = _run(tmain, ["decisions", "--input", port_dumps["dir"],
                           "--format", "json"])
    doc = json.loads(out)
    assert rc == 0 and doc["rounds_audited"] > 0 and doc["splits"] == []


# -- keys and the commands not ported -----------------------------------------
def test_keys_rows_are_the_reference_s():
    ref = {}
    for r in TpuShuffleConf.describe_keys():
        ref.setdefault(r["key"], set()).add(r["default"])
    rows = ShuffleConf.describe_keys()
    keys = [r["key"] for r in rows]
    assert len(keys) == len(set(keys))
    for r in rows:
        assert r["key"] in ref, r["key"]
        if r["key"] == PFX + "compile.cacheDir":
            # the kernel library's build directory, not XLA's cache: the
            # package's own _build/ (runtime/compile_cache.py)
            from sparkucx_tpu_torch.config import DEFAULT_BUILD_DIR
            assert r["default"] == DEFAULT_BUILD_DIR
            continue
        assert r["default"] in ref[r["key"]], r
    # the telemetry keys of this plane are listed
    assert {PFX + k for k in ("metrics.httpPort", "metrics.httpHost",
                              "metrics.httpAdvertiseHost",
                              "fleet.scrapeTimeoutMs")} <= set(keys)
    rc, out = _run(tmain, ["keys"])
    assert rc == 0
    assert _run(tmain, [])[1] == out
    lines = out.splitlines()
    assert lines[0].split() == ["key", "default", "description"]
    assert [ln.split()[0] for ln in lines[2:]] == keys


@pytest.mark.parametrize("argv", [["workload", "bogus"],
                                  ["workload", "terasort", "--conf",
                                   "novalue"]])
def test_unported_commands_exit_2_with_a_reason(argv):
    """The commands ported last (``workload``, ``kernelbench``) are
    listed in ``--help``; ``workload`` refuses an unknown name or a
    malformed ``--conf`` with exit 2 and its reason, as the reference's
    does (their runs: ``tests/test_torch_microbench.py``)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tmain(argv) == 2
    assert ("unknown workload 'bogus'" if argv[1] == "bogus"
            else "--conf wants key=value") in err.getvalue()
    assert "not ported" not in err.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        tmain(["--help"])
    assert "workload" in out.getvalue() and "kernelbench" in out.getvalue()


def test_periodic_dumper_writes_snapshots(tmp_path, rng):
    """The reference's dumper case (``tests/test_telemetry.py``), with its
    CLI half, on a port service: ``stop`` writes the final snapshot and
    ``stats --input`` renders it with the histograms' quantiles."""
    from sparkucx_tpu_torch.utils.export import prom_name
    from sparkucx_tpu_torch.utils.metrics import H_FETCH_WAIT
    svc = connect({PFX + "a2a.impl": "dense", PFX + "io.format": "raw",
                   PFX + "metrics.dumpDir": str(tmp_path / "dumps"),
                   PFX + "metrics.dumpIntervalSecs": "3600"},
                  device="cpu", use_env=False)
    try:
        h = svc.register_shuffle(12, 2, 4)
        for m in range(2):
            svc.write(h, m, rng.integers(0, 1 << 30, size=64,
                                         dtype=np.int64))
        svc.read(h)
    finally:
        svc.stop()
    files = list((tmp_path / "dumps").glob("metrics_*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["counters"]["shuffle.read.count"] == 1
    rc, out = _run(tmain, ["stats", "--input", str(files[0]),
                           "--format", "prometheus"])
    assert rc == 0
    assert f"{prom_name(H_FETCH_WAIT)}_p50 " in out
