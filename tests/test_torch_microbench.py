"""Port parity for the segment-reduce microbench
(``sparkucx_tpu_torch/ops/microbench.py``) and the CLI's ``kernelbench``
and ``workload`` commands.

* The five default cases' inputs equal the JAX package's
  ``_case_inputs`` (``sparkucx_tpu/ops/pallas/microbench.py``): the raw
  cases' rows and partitions bit for bit; the int8 case's full-width rows
  bit for bit, and its wire rows bit for bit when the port packs them
  with the reference's uniforms (the port draws its own from a torch
  generator, ``case_uniforms``).
* The twins (the ``torch`` arm) on the reference's inputs equal the
  reference's ``jnp`` arm: exact on the int32 and the integer-valued
  float32 cases; on the int8 case the port's twin within its float64
  bound of the exact sums and the reference's within its grade's
  tolerance.
* The int8 grade passes the kernel's own order (float32 sums in row
  order, simulated on the CPU) and fails a dropped row and float16
  accumulation.
* On the CPU the artifact times the twins, records the ``cuda`` arm and
  the parity as skips with their reason, and counts no build
  (``tests/test_bench_stages.py``'s kernelbench case, on the port).
* The CLI: ``kernelbench --out`` exits 0 and writes the artifact;
  ``workload`` exits 2 on an unknown name or a malformed ``--conf``, 4
  when the oracle fails, 0 with the report's JSON
  (``tests/test_workloads.py::test_workload_registry_and_cli``, run on
  the CPU by pointing ``run_workload`` at ``device="cpu"``)."""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import microbench as jmb
from sparkucx_tpu_torch import workloads as tworkloads
from sparkucx_tpu_torch.__main__ import main as tmain
from sparkucx_tpu_torch.ops import microbench as tmb
from sparkucx_tpu_torch.shuffle.alltoall import wire_pack_rows

CPU = torch.device("cpu")
CASES = [c["name"] for c in tmb.default_cases(8)]


def _case(name, rows_log2=8):
    return next(c for c in tmb.default_cases(rows_log2) if c["name"] == name)


def _jax_uniforms(case):
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(tmb.WIRE_SEED), (case["cap"], case["width"] - 2)))


def test_default_cases_are_the_reference_s():
    for lg in (8, 13):
        assert tmb.default_cases(lg) == jmb.default_cases(lg)


@pytest.mark.parametrize("name", CASES)
def test_case_inputs_equal_the_reference_s(name):
    case = _case(name)
    jrows, jpart = (np.asarray(x) for x in jmb._case_inputs(case))
    rows, part = tmb.case_inputs(case, CPU)
    np.testing.assert_array_equal(part[0].numpy(), jpart)
    if not case.get("wire"):
        np.testing.assert_array_equal(rows[0].numpy(), jrows)
        return
    # before packing: the reference's rows, scaled
    full, _ = tmb.case_rows(case)
    rng = np.random.default_rng(0)
    want, _ = jmb.make_sorted_rows(rng, case["n"], case["cap"],
                                   case["parts"], case["width"],
                                   case["groups"], case["sum_words"],
                                   float_vals=True)
    want = np.asarray(want).copy()
    n = case["n"]
    want[:n, 2:] = (want[:n, 2:].view(np.float32)
                    * np.float32(0.37)).view(np.int32)
    np.testing.assert_array_equal(full, want)
    # packed with the reference's uniforms: the reference's wire rows as
    # its quantize kernel packs them (interpret mode); ``_case_inputs``
    # on the CPU packs through the reference's jnp fallback, whose scale
    # is a division, so there the key lanes and the lane layout agree
    from sparkucx_tpu.shuffle.alltoall import wire_pack_rows as jpack
    vw = case["width"] - 2
    packed = wire_pack_rows(torch.from_numpy(full)[None], vw,
                            torch.from_numpy(_jax_uniforms(case))[None])
    kernel_packed = np.asarray(jpack(jnp.asarray(full), vw,
                                     jnp.uint32(tmb.WIRE_SEED),
                                     quant_impl="interpret"))
    np.testing.assert_array_equal(packed[0].numpy(), kernel_packed)
    assert packed[0].shape == jrows.shape
    np.testing.assert_array_equal(packed[0].numpy()[:, :2], jrows[:, :2])
    # the port's own draw: the same shape, its own noise
    assert tuple(rows.shape) == tuple(packed.shape)


@pytest.mark.parametrize("name", CASES)
def test_twins_equal_the_reference_jnp_arm(name):
    case = _case(name)
    jrows, jpart = jmb._case_inputs(case)
    jr, jc, jn = (np.asarray(x) for x in
                  jmb._build_step(case, "jnp", None)(jrows, jpart))
    rows = torch.from_numpy(np.array(jrows))[None]
    part = torch.from_numpy(np.array(jpart))[None]
    tr, tc, tn = tmb._host(tmb.build_step(case, "jnp")(rows, part))
    k = int(jn[0])
    assert tn == k
    np.testing.assert_array_equal(tc, jc)
    if not case.get("wire"):
        np.testing.assert_array_equal(tr[:k], jr[:k])
        return
    np.testing.assert_array_equal(tr[:k, :2], jr[:k, :2])
    sums, _kernel, twin = tmb.wire_run_sums(case, rows, part)
    assert (np.abs(tr[:k, 2:].view(np.float32) - sums) <= twin).all()
    # the reference's arm (its own dequantization, float32 sums): held
    # at its grade's tolerance
    np.testing.assert_allclose(jr[:k, 2:].view(np.float32), sums,
                               rtol=1e-5, atol=1e-4)


def test_parity_grade_reads_the_reference_grade():
    """The grade's verdicts: bit-exact raw rows pass, a flipped bit or a
    wrong count fails; on the int8 case an error past the float32 bound
    fails."""
    case = _case("big_i32")
    rows, part = tmb.case_inputs(case, CPU)
    out = tmb.build_step(case, "jnp")(rows, part)
    g = tmb.parity_grade(case, out, out)
    assert g["ok"] and g["bitexact"]
    bad = out[0].clone()
    bad[0, 0, 2] += 1
    assert not tmb.parity_grade(case, out, (bad,) + out[1:])["ok"]
    n = out[2].clone()
    n[0] -= 1
    assert not tmb.parity_grade(case, out, out[:2] + (n,))["ok"]
    wcase = _case("wire_int8_fused")
    wrows, wpart = tmb.case_inputs(wcase, CPU)
    wout = tmb.build_step(wcase, "jnp")(wrows, wpart)
    exact = tmb.wire_run_sums(wcase, wrows, wpart)
    g = tmb.parity_grade(wcase, wout, wout, exact)
    assert g["ok"] and g["maxdiff"] == 0.0 and g["ref_tolerance_ok"]
    off = wout[0].clone()
    v = off[0, 0, 2:3].view(torch.float32)
    v += float(exact[1][0, 0]) * 4 + 1.0
    assert not tmb.parity_grade(wcase, wout, (off,) + wout[1:], exact)["ok"]


def test_cpu_artifact_times_the_twins_and_skips_with_reasons():
    doc = tmb.run_microbench(reps=1, rows_log2=8, device="cpu")
    assert doc["ok"], doc
    assert doc["backend"] == "cpu" and doc["native_cuda"] is False
    assert doc["gate_reason"] == tmb.NO_CARD
    assert [c["case"] for c in doc["cases"]] == CASES
    for c in doc["cases"]:
        assert c["torch"]["status"] == "ok" and c["torch"]["rows_per_s"] > 0
        for arm in ("cuda", "parity"):
            assert c[arm] == {"status": "skipped", "reason": tmb.NO_CARD}
    assert doc["programs"] == {"first_pass": 0, "expected": 0,
                               "warm_recompiles": 0, "ok": True}
    assert doc["launches"] == {}
    assert doc["metric"] == "kernelbench"


def _row_order_sums(case, rows, part, dtype, drop=False):
    """The int8 case's per-run sums accumulated in row order in
    ``dtype`` (the kernel's order in float32), with ``drop`` the middle
    row of the first run left out: the twin's output with these sums in
    its summed lanes."""
    from sparkucx_tpu_torch.shuffle.alltoall import wire_unpack_rows
    out = tmb.build_step(case, "jnp")(rows, part)
    width, n = case["width"], case["n"]
    full = wire_unpack_rows(rows, width, width - 2)[0, :n].numpy()
    vals = full[:, 2:].view(np.float32)
    p = part[0, :n].numpy()
    change = (p[1:] != p[:-1]) | (full[1:, 0] != full[:-1, 0]) \
        | (full[1:, 1] != full[:-1, 1])
    starts = np.flatnonzero(np.r_[True, change])
    ends = np.r_[starts[1:], n]
    mid = (starts[0] + ends[0]) // 2 if drop else None
    assert mid is None or vals[mid].any()
    got = out[0].clone()
    lanes = got[0, :, 2:].view(torch.float32)
    for j, (a, b) in enumerate(zip(starts, ends)):
        keep = [i for i in range(a, b) if i != mid]
        acc = np.cumsum(vals[keep].astype(dtype), axis=0, dtype=dtype)[-1]
        lanes[j] = torch.from_numpy(acc.astype(np.float32))
    return out, (got,) + tuple(out[1:])


@pytest.mark.parametrize("rows_log2", [13, 16])
def test_int8_grade_holds_row_order_float32_and_fails_faults(rows_log2):
    """The kernel sums each run in float32 in row order: that order
    passes the grade well inside its bound, at runs of 32 and of 256
    rows alike; a run with one row dropped, or sums accumulated in
    float16, fail it."""
    case = _case("wire_int8_fused", rows_log2)
    rows, part = tmb.case_inputs(case, CPU)
    exact = tmb.wire_run_sums(case, rows, part)
    twin, seq32 = _row_order_sums(case, rows, part, np.float32)
    g = tmb.parity_grade(case, twin, seq32, exact)
    assert g["ok"], g
    assert g["kernel_err_over_bound"] < 0.5
    assert g["twin_err_over_bound"] <= 1.0
    _, dropped = _row_order_sums(case, rows, part, np.float32, drop=True)
    assert not tmb.parity_grade(case, twin, dropped, exact)["ok"]
    _, half = _row_order_sums(case, rows, part, np.float16)
    assert not tmb.parity_grade(case, twin, half, exact)["ok"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_plain_versions_grade_ok_on_cpu(name):
    """On CPU tensors the kernels' wrappers run their plain versions (the
    card launches the kernels): graded against the twins as the
    ``parity`` arm grades the kernels, every case passes."""
    case = _case(name, 10)
    rows, part = tmb.case_inputs(case, CPU)
    exact = tmb.wire_run_sums(case, rows, part) if case.get("wire") \
        else None
    g = tmb.parity_grade(case, tmb.build_step(case, "jnp")(rows, part),
                         tmb.build_step(case, "pallas")(rows, part), exact)
    assert g["ok"], g


# -- the CLI -----------------------------------------------------------------
def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tmain(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_kernelbench_out_writes_the_artifact(tmp_path):
    path = str(tmp_path / "kb.json")
    rc, out, _ = _run(["kernelbench", "--reps", "1", "--rows-log2", "8",
                       "--out", path])
    assert rc == 0
    doc = json.loads(out)
    with open(path) as f:
        art = json.load(f)
    assert doc["artifact"] == path and "artifact" not in art
    assert art["ok"] and art["reps"] == 1
    assert art["cases"][0]["rows"] == 1 << 8


def test_cli_help_lists_both_commands():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ei:
        tmain(["--help"])
    assert ei.value.code == 0
    assert "kernelbench" in out.getvalue() and "workload" in out.getvalue()
    for cmd in ("kernelbench", "workload"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            tmain([cmd, "--help"])
        assert "--" in out.getvalue()


@pytest.fixture()
def cpu_workloads(monkeypatch):
    """``run_workload`` on the CPU (the CLI's default is the card)."""
    real = tworkloads.run_workload
    calls = []

    def on_cpu(name, **kw):
        calls.append((name, kw))
        return real(name, device="cpu", **kw)

    monkeypatch.setattr(tworkloads, "run_workload", on_cpu)
    return calls


def test_workload_registry_and_cli(cpu_workloads, tmp_path, capsys):
    """The reference's case on the port's CLI: an unknown name exits 2
    with the registry listed; a real run prints the WorkloadReport JSON
    and exits by its oracle's verdict."""
    from sparkucx_tpu.workloads import WORKLOADS as JWORKLOADS
    assert set(tworkloads.WORKLOADS) == set(JWORKLOADS) \
        == {"terasort", "groupby", "join"}
    rc, _, err = _run(["workload", "bogus"])
    assert rc == 2 and "registered: groupby, join, terasort" in err
    rc, out, _ = _run(["workload", "terasort", "--budget-mb", "0.0625",
                       "--scale", "0.1", "--conf",
                       "spark.shuffle.tpu.a2a.impl=dense",
                       f"spark.shuffle.tpu.spill.dir={tmp_path}"])
    rep = json.loads(out)
    assert rc == 0
    assert rep["workload"] == "terasort" and rep["oracle_ok"]
    assert rep["spill_bytes"] > 0
    assert set(rep["phases"]) == {"ingest", "spill", "exchange", "merge",
                                  "emit"}
    name, kw = cpu_workloads[-1]
    assert name == "terasort" and "arrow" not in kw
    assert kw["conf_overrides"]["spark.shuffle.tpu.a2a.impl"] == "dense"


def test_workload_cli_flags_reach_the_pipeline(cpu_workloads, tmp_path):
    """``--arrow``, ``--seed`` and ``--budget-mb`` reach ``run_workload``
    as the reference's CLI passes them; the groupby arrow ingress runs."""
    pytest.importorskip("pyarrow")
    rc, out, _ = _run(["workload", "groupby", "--budget-mb", "0.0625",
                       "--scale", "0.05", "--seed", "3", "--arrow",
                       "--conf", "spark.shuffle.tpu.a2a.impl=dense",
                       f"spark.shuffle.tpu.spill.dir={tmp_path}"])
    assert rc == 0
    rep = json.loads(out)
    assert rep["oracle_ok"] and rep["extra"]["arrow_ingress"] is True
    name, kw = cpu_workloads[-1]
    assert (name, kw["seed"], kw["budget_mb"], kw["arrow"]) \
        == ("groupby", 3, 0.0625, True)


def test_workload_cli_exit_codes(monkeypatch):
    """2 on a malformed ``--conf`` (before any run), 4 when the oracle
    fails."""
    rc, _, err = _run(["workload", "terasort", "--conf", "novalue"])
    assert rc == 2 and "--conf wants key=value" in err

    class Failed:
        oracle_ok = False

        def to_json(self):
            return "{}"

    monkeypatch.setattr(tworkloads, "run_workload",
                        functools.partial(lambda name, **kw: Failed()))
    rc, out, _ = _run(["workload", "join"])
    assert rc == 4 and out.strip() == "{}"


def test_workload_cli_matches_the_reference_cli(cpu_workloads, mesh8,
                                                tmp_path):
    """The same argv through both CLIs: the same exit code and the same
    report keys, rows and oracle verdict."""
    from sparkucx_tpu.__main__ import main as jmain
    argv = ["workload", "terasort", "--budget-mb", "0.0625", "--scale",
            "0.1", "--conf", "spark.shuffle.tpu.a2a.impl=dense"]
    docs = []
    for main, d in ((jmain, "jax"), (tmain, "port")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv + [f"spark.shuffle.tpu.spill.dir={tmp_path / d}"])
        assert rc == 0
        docs.append(json.loads(out.getvalue()))
    j, t = docs
    assert set(t) == set(j)
    for k in ("workload", "rows_in", "rows_out", "bytes_in", "oracle",
              "oracle_ok", "exchanges"):
        assert t[k] == j[k], k
