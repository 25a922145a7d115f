"""The port stands alone: it imports with JAX and the JAX package
blocked, no module of it (nor chip_smoke.py, flash_bench.py,
merge_bench.py or the scripts under tools/) imports either, and its entry points refuse to drop to
the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sparkucx_tpu_torch"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "flash_bench.py",
                                        ROOT / "merge_bench.py"] \
        + sorted((ROOT / "tools").glob("*.py"))


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparkucx_tpu'] = None\n"
        "import sparkucx_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sparkucx_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "import sparkucx_tpu_torch.backend as b\n"
        "assert b._lib is None, 'importing must not build kernels'\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 22


def test_scan_covers_the_wire_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"ops/quant.py", "shuffle/wire.py", "shuffle/alltoall.py",
            "ops/segmented.py"} <= names


def test_scan_covers_the_integrity_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"shuffle/integrity.py", "shuffle/durable.py",
            "shuffle/writer.py", "meta/registry.py",
            "runtime/failures.py"} <= names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "sparkucx_tpu"), \
                f"{path.name}:{node.lineno} imports {m}"


def test_connect_without_device_raises_on_cudaless_box(monkeypatch):
    from sparkucx_tpu_torch import connect
    from sparkucx_tpu_torch.runtime.node import Node
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        connect(use_env=False)
    with pytest.raises(RuntimeError):
        Node.start()
    with pytest.raises(RuntimeError):
        connect(use_env=False, device="cuda")
    svc = connect(use_env=False, device="cpu")     # the explicit request
    assert svc.device.type == "cpu"
    svc.stop()


def test_auto_impl_resolution():
    from sparkucx_tpu_torch.backend import resolve_a2a_impl
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert resolve_a2a_impl("auto", cuda, 8) == "pallas"
    assert resolve_a2a_impl("auto", cpu, 8) == "dense"
    assert resolve_a2a_impl("auto", cpu, 1) == "local"
    assert resolve_a2a_impl("pallas", cpu, 8) == "pallas"
    with pytest.raises(ValueError):
        resolve_a2a_impl("native", cpu, 8)



def test_carry_across_defaults_to_the_card(monkeypatch):
    """interop.from_reference follows the device rule: the card unless
    the caller asks for the CPU, and a raise without either."""
    import numpy as np
    from sparkucx_tpu_torch import interop
    from sparkucx_tpu_torch.meta.segments import SegmentTable
    blob = SegmentTable(np.ones((2, 3), np.uint64)).pack()
    rows = np.arange(8, dtype=np.int32).reshape(2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.from_reference(blob, 2, 3, rows)
    _, t = interop.from_reference(blob, 2, 3, rows, device="cpu")
    assert t.device.type == "cpu" and t.tolist() == rows.tolist()


def test_scan_covers_the_tenancy_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"shuffle/tenancy.py", "shuffle/agreement.py",
            "shuffle/manager.py", "service.py", "config.py",
            "utils/metrics.py"} <= names


def test_scan_covers_the_telemetry_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"utils/trace.py", "utils/history.py", "utils/export.py",
            "shuffle/decisions.py", "runtime/devmon.py"} <= names


def test_scan_covers_the_attention_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"ops/attention.py", "ops/flash_attention.py",
            "parallel/ring.py", "parallel/ulysses.py"} <= names


def test_scan_covers_the_workload_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"io/varlen.py", "shuffle/integrity.py", "workloads/__init__.py",
            "workloads/terasort.py", "workloads/groupby.py",
            "workloads/wordcount.py", "workloads/pagerank.py",
            "workloads/als.py", "workloads/tc.py", "workloads/q23.py",
            "workloads/join.py", "workloads/graphs.py"} <= names


def test_workload_runner_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['sparkucx_tpu'] = None\n"
            "from sparkucx_tpu_torch.workloads.wordcount import "
            "run_wordcount_text\n"
            "from sparkucx_tpu_torch.io.varlen import hash_bytes64\n"
            "print(hash_bytes64(['a'])[0])\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # FNV-1a 64 of b"a", as a signed int64
    assert int(r.stdout) == 0xAF63DC4C8601EC8C - (1 << 64)
