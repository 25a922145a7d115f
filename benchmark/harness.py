"""The benchmark's registry and its measured window.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the workload names a configuration (``configs``'
``file``) and a traffic mix (``traffic/<mix>.json``), the mix names its
driver (``drivers/<driver>.py``) and how each end-to-end metric is taken
from the window's steps, and each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that may not be loaded where the port is measured
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkucx_tpu")
# A traced run traces the first this many seconds of its window: reducing
# a 51 s trace of the training cell took longer than a run may last.
TRACE_SECONDS = 15.0


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(spec: dict, workload: str, root: Path = REPO) -> Cell:
    """The cell ``workload`` of ``spec`` with its configuration, its
    traffic mix and the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, workload)])


def driver_class(traffic: dict):
    """The ``Driver`` of the mix's ``driver`` module."""
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return mod.Driver


def metric_reader(name: str, root: Path = REPO) -> Callable[[dict],
                                                            Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._m_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def step_stat(steps: List[dict], window_s: float, how: dict) -> float:
    """An end-to-end metric over the window's steps: ``{"stat": "rate",
    "of": key}`` is the sum of ``key`` over all steps per second of the
    window; ``{"stat": "percentile", "q": q, "of": key}`` the q-th
    percentile of ``key`` over all steps."""
    vals = [float(s[how["of"]]) for s in steps]
    if how["stat"] == "rate":
        return sum(vals) / window_s
    if how["stat"] == "percentile":
        return float(np.percentile(vals, float(how["q"])))
    raise ValueError(f"unknown stat {how['stat']!r}")


@dataclass
class Window:
    steps: List[dict] = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    trace: Optional[dict] = None


def measure(driver, seconds: float, t_start: float, trace: bool,
            sync: Callable[[], None]) -> Window:
    """Run ``driver.step`` in a closed loop until ``seconds`` have passed;
    the window ends with the step that crosses it, so its rate counts all
    the work and all the time. With ``trace`` the window runs under the
    device trace, reduced afterwards."""
    out = Window()
    with contextlib.ExitStack() as stack:
        tracer = None
        if trace:
            from benchmark.trace import DeviceTrace
            tracer = stack.enter_context(DeviceTrace())
        sync()
        out.setup_s = time.perf_counter() - t_start
        with tracer.window() if tracer else contextlib.nullcontext():
            w0 = time.perf_counter()
            while True:
                s = time.perf_counter()
                rec = driver.step(trace)
                e = time.perf_counter()
                rec["step_ms"] = (e - s) * 1e3
                out.steps.append(rec)
                if e - w0 >= seconds:
                    break
        out.window_s = e - w0
    if tracer:
        out.trace = tracer.reduce()
    return out


def power_limit_w(device) -> Optional[float]:
    """The power limit of the card ``device``, in watts, as ``nvidia-smi``
    reads it (matched by the card's UUID); None where it cannot be read."""
    import subprocess
    import torch
    try:
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
    except (OSError, AttributeError, subprocess.SubprocessError):
        return None
    for row in out.splitlines():
        card, _, watts = row.partition(",")
        if card.strip().removeprefix("GPU-") == uuid.removeprefix("GPU-"):
            try:
                return float(watts)
            except ValueError:
                return None
    return None


def judge(checks: List[dict]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)


def check_lines(checks: List[dict]) -> List[str]:
    return [f"check {c['name']} {c['value']!r} limit {c['limit']!r}"
            for c in checks]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)


def per_layer_metrics(cell: Cell, ctx: dict,
                      root: Path = REPO) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for; the others are left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end_metrics(cell: Cell, win: Window) -> Dict[str, dict]:
    how = cell.traffic["end_to_end"]
    out = {}
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            value = win.setup_s
        else:
            value = step_stat(win.steps, win.window_s, how[m["name"]])
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, kernel_cache: Path, log=print,
             root: Path = REPO) -> str:
    """One run of ``cell`` on ``device``: set-up, the window, the
    comparison that decides ``correct``; returns the result line. The
    compared numbers go to ``log`` as the run's last lines."""
    import torch
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    driver = driver_class(cell.traffic)(cell.config, cell.traffic, seed,
                                        device, kernel_cache)
    if cuda:
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    win = measure(driver, min(seconds, TRACE_SECONDS) if trace else seconds,
                  t_start, trace, sync)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w(device) if cuda else None}
    breakdown = None
    if trace:
        from benchmark.peaks import peaks_for
        tr = win.trace or {"busy_s": 0.0, "window_s": win.window_s,
                           "kernels": {}, "breakdown": None}
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = tr["breakdown"]
        ctx = {"trace": tr, "peaks": peaks_for(kind),
               "facts": driver.facts(win.steps)}
        metrics = per_layer_metrics(cell, ctx, root)
    else:
        metrics = end_to_end_metrics(cell, win)
    ms = [s["step_ms"] for s in win.steps]
    log(f"window {win.window_s:.3f} s, {len(ms)} steps, step ms median "
        f"{np.median(ms):.3f} p5 {np.percentile(ms, 5):.3f} p95 "
        f"{np.percentile(ms, 95):.3f} max {max(ms):.3f}")
    driver.release()
    checks = driver.check()
    for line in check_lines(checks):
        log(line)
    # a step that fails raises, and the run prints no result
    return result_line(judge(checks), len(win.steps), 0, metrics, dev,
                       checks, breakdown)
