"""Local cluster launcher — the counterpart of the JAX package's
``buildlib/run_cluster.py`` with ``buildlib/e2e_worker.py``'s jobs.

:func:`run_cluster` starts ``nprocs`` fresh interpreters (``subprocess``,
never ``fork``: the caller may already hold a CUDA context), each running
``python -m sparkucx_tpu_torch.cluster SPEC``. A worker connects as
process ``rank`` of the world (``connect(conf, distributed=True,
process_id=rank)``, rendezvous on a free localhost port picked for each
world), runs the job on a :class:`WorkerContext` and prints its JSON
result on a line of its own. The launcher gathers each worker's result,
kills every worker at the deadline, and retries once, on a fresh port,
only when a worker reports the classified ``RENDEZVOUS FAILED``; any other
failure fails at once (:class:`ClusterError`, with every worker's output
tail).

A job is the name of a built-in one or ``"module:function"`` (importable
in the workers: they get the caller's ``sys.path``); the function takes
the :class:`WorkerContext` and returns a JSON-able dict. Built-in jobs:

* ``groupby`` — every process writes the maps its shards own, then three
  collective reads (plain, ``combine="sum"``, range-partitioned
  ``ordered=True``), each checked against the oracle rebuilt locally from
  the seed (``args``: ``maps``, ``rows``, ``partitions``, ``seed``);
* ``hierarchical`` — the same on ``mesh.numSlices`` = ``nprocs``: the DCN
  stage crosses processes;
* ``chaos`` — the victim (``args["victim"]``, default the last rank)
  parks after staging and is killed; every survivor's read must raise
  ``PeerLostError`` (``failure.collectiveTimeoutMs`` in the conf);
* ``recovery`` — the drill of the JAX package's recovery test: as chaos,
  then each survivor remeshes over the agreed surviving shards, its stale
  handle must raise ``StaleEpochError``, and the launcher re-runs the full
  map set as ``groupby`` on a fresh world of the survivors.

``device`` is the workers' device (None: the card; ``"cpu"`` in the
tests). Each worker runs with ``torch.set_num_threads(2)``.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

RESULT = "SXT-RESULT "
STAGED = "SXT-STAGED"
RENDEZVOUS = "RENDEZVOUS FAILED"
# seconds a parked victim waits to be killed before it gives up
PARK_S = 300.0


class ClusterError(RuntimeError):
    """A worker failed, or the world outlived its deadline."""


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ClusterRun:
    """One world's outcome: each rank's result dict (None for a killed
    victim), exit codes and the launch attempts; a recovery run carries
    its second world in ``rerun``."""

    results: List[Optional[dict]]
    returncodes: List[int]
    attempts: int
    seconds: float
    rerun: Optional["ClusterRun"] = None


@dataclass
class WorkerContext:
    """What a job sees: its rank, the world size, the service connected as
    that rank, the job's ``args`` and its device."""

    rank: int
    nprocs: int
    svc: object
    args: Dict = field(default_factory=dict)
    device: Optional[str] = None
    # the world lost a member: skip the teardown collectives at exit
    orphaned: bool = False

    def staged(self) -> None:
        """Tell the launcher this worker finished staging its maps."""
        print(STAGED, flush=True)

    def park(self) -> None:
        """Wait to be killed by the launcher (a victim's last act)."""
        time.sleep(PARK_S)
        raise ClusterError("the victim was never killed")

    def connect(self, conf: Mapping[str, str]):
        """Another service on this world (same rank), e.g. under another
        ``mesh.numSlices``; every process must call it in step."""
        from sparkucx_tpu_torch import connect
        base = self.svc.conf
        full = {k: base.get(k) for k in (
            "spark.shuffle.tpu.coordinator.address",
            "spark.shuffle.tpu.numProcesses")}
        full.update(conf)
        return connect(full, device=self.device,
                       num_shards=self.svc.node.num_shards,
                       distributed=True, process_id=self.rank,
                       use_env=False)


# -- the launcher -------------------------------------------------------------
def _spawn(spec: dict, logdir: str):
    path = os.path.join(logdir, f"spec{spec['rank']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    log = open(os.path.join(logdir, f"worker{spec['rank']}.log"), "w+")
    # log FILES, not pipes: a worker blocked on a full pipe would stall
    # the whole world
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparkucx_tpu_torch.cluster", path],
        stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, log


def _read(log) -> str:
    with open(log.name) as f:
        return f.read()


def _world(job: str, nprocs: int, shards: int, conf: Mapping[str, str],
           device, args: dict, deadline: float,
           kill_after_staged: Optional[int], logdir: str):
    """One world: spawn, (kill the victim once every worker staged),
    wait; returns (procs' exit codes, logs, killed)."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    killed = False
    try:
        for rank in range(nprocs):
            p, f = _spawn({"job": job, "rank": rank, "nprocs": nprocs,
                           "shards": shards, "conf": dict(conf),
                           "device": device, "args": args,
                           "coordinator": coordinator}, logdir)
            procs.append(p)
            logs.append(f)
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise ClusterError(
                    f"job {job!r} outlived its deadline:\n"
                    + _tails(logs, procs))
            if kill_after_staged is not None and not killed and all(
                    STAGED in _read(f) for f in logs):
                procs[kill_after_staged].send_signal(signal.SIGKILL)
                killed = True
            time.sleep(0.05)
        return [p.returncode for p in procs], [_read(f) for f in logs], \
            killed
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _tails(logs, procs) -> str:
    out = []
    for rank, (f, p) in enumerate(zip(logs, procs)):
        text = f if isinstance(f, str) else _read(f)
        rc = p if isinstance(p, int) else p.poll()
        out.append(f"--- worker {rank} (exit {rc}) ---\n{text[-4000:]}")
    return "\n".join(out)


def _result_of(text: str) -> Optional[dict]:
    lines = [ln for ln in text.splitlines() if ln.startswith(RESULT)]
    return json.loads(lines[-1][len(RESULT):]) if lines else None


def run_cluster(job: str, nprocs: int, shards: int = 8,
                conf: Optional[Mapping[str, str]] = None, device=None,
                timeout_s: float = 300.0, args: Optional[dict] = None,
                kill_after_staged: Optional[int] = None) -> ClusterRun:
    """Run ``job`` on a fresh world of ``nprocs`` workers of ``shards``
    global logical shards. ``kill_after_staged``: the rank to SIGKILL
    once every worker has staged (the chaos and recovery jobs set their
    victim themselves). Raises :class:`ClusterError` when a worker fails
    (the killed victim excepted) or the deadline passes."""
    conf = dict(conf or {})
    args = dict(args or {})
    if job in ("chaos", "recovery"):
        args.setdefault("victim", nprocs - 1)
        kill_after_staged = args["victim"]
    if job == "recovery":
        per = shards // nprocs
        args.setdefault("survivors", [g for g in range(shards)
                                      if g // per != args["victim"]])
        # the same map set on both worlds
        args.setdefault("maps", 4 * nprocs)
    if job == "hierarchical":
        conf.setdefault("spark.shuffle.tpu.mesh.numSlices", str(nprocs))
    t0 = time.monotonic()
    logdir = tempfile.mkdtemp(prefix="sxt_cluster_")
    try:
        for attempt in (1, 2):
            rcs, texts, killed = _world(
                job, nprocs, shards, conf, device, args,
                time.monotonic() + timeout_s, kill_after_staged, logdir)
            bad = [r for r, rc in enumerate(rcs)
                   if rc != 0 and not (killed and r == kill_after_staged)]
            if not bad:
                break
            # only the classified rendezvous failure is retried, once
            if attempt == 2 or not any(RENDEZVOUS in t for t in texts):
                raise ClusterError(f"job {job!r}: worker(s) {bad} failed:\n"
                                   + _tails(texts, rcs))
        run = ClusterRun([_result_of(t) for t in texts], rcs, attempt,
                         time.monotonic() - t0)
    finally:
        import shutil
        shutil.rmtree(logdir, ignore_errors=True)
    if job == "recovery":
        # the full map set again, on a fresh world of the survivors
        run.rerun = run_cluster(
            "groupby", nprocs - 1, len(args["survivors"]), conf, device,
            timeout_s, {k: v for k, v in args.items()
                        if k not in ("victim", "survivors")})
        run.seconds = time.monotonic() - t0
    return run


# -- the built-in jobs ----------------------------------------------------------
def map_data(m: int, rows: int, seed: int):
    """Map ``m``'s keys and int32 values, the same in every process."""
    rng = np.random.default_rng([seed, m])
    keys = rng.integers(0, 1 << 20, rows).astype(np.int64)
    vals = rng.integers(-1000, 1000, (rows, 2)).astype(np.int32)
    return keys, vals


def my_maps(ctx: WorkerContext, num_maps: int) -> List[int]:
    """The maps this process writes: map ``m`` goes to the process that
    owns shard ``m % P`` (round-robin over the processes in blocks of
    their L shards), so every shard stages the maps it would on one
    process."""
    node = ctx.svc.node
    mine = set(node.local_shard_ids)
    return [m for m in range(num_maps) if m % node.num_shards in mine]


def _job_args(ctx: WorkerContext):
    a = ctx.args
    return (int(a.get("maps", 4 * ctx.nprocs)), int(a.get("rows", 200)),
            int(a.get("partitions", 12)), int(a.get("seed", 7)))


def stage_maps(ctx: WorkerContext, sid: int, num_maps: int, rows: int,
               R: int, seed: int, partitioner: str = "hash", bounds=None):
    """Register shuffle ``sid`` and write this process's maps."""
    svc = ctx.svc
    h = svc.register_shuffle(sid, num_maps, R, partitioner, bounds)
    for m in my_maps(ctx, num_maps):
        k, v = map_data(m, rows, seed)
        svc.write(h, m, k, v)
    return h


def _oracle(num_maps: int, rows: int, seed: int):
    data = [map_data(m, rows, seed) for m in range(num_maps)]
    return (np.concatenate([k for k, _ in data]),
            np.concatenate([v for _, v in data]))


def _local_parts(res) -> Dict[int, tuple]:
    return dict(res.partitions())


def _check_multisets(parts, keys, vals, pid) -> int:
    rows = 0
    for r, (k, v) in parts.items():
        want = np.flatnonzero(pid == r)
        ok = sorted(zip(k.tolist(), map(tuple, v.tolist()))) == sorted(
            zip(keys[want].tolist(), map(tuple, vals[want].tolist())))
        if not ok:
            raise AssertionError(f"partition {r} differs from the oracle")
        rows += k.size
    return rows


def groupby(ctx: WorkerContext) -> dict:
    from sparkucx_tpu_torch.ops.partition import sample_bounds
    from sparkucx_tpu_torch.shuffle.writer import hash32_np
    num_maps, rows, R, seed = _job_args(ctx)
    keys, vals = _oracle(num_maps, rows, seed)
    svc = ctx.svc
    out = {"rank": ctx.rank, "shards": svc.node.local_shard_ids}
    h = stage_maps(ctx, 1, num_maps, rows, R, seed)
    pid = (hash32_np(keys) % np.uint32(R)).astype(np.int64)
    parts = _local_parts(svc.read(h))
    out["plain_rows"] = _check_multisets(parts, keys, vals, pid)
    out["partitions"] = sorted(parts)
    rep = svc.report(1)
    out["distributed"], out["impl"] = rep.distributed, rep.impl
    out["tiers"] = [t["tier"] for t in rep.tiers]
    # combine: one row per key, int32 sums wrapping
    comb = _local_parts(svc.read(h, combine="sum"))
    order = np.argsort(keys, kind="stable")
    uk, start = np.unique(keys[order], return_index=True)
    sums = np.add.reduceat(vals[order].astype(np.int64), start, axis=0)
    want = dict(zip(uk.tolist(), (sums & 0xFFFFFFFF).astype(np.uint32)
                    .view(np.int32).tolist()))
    for r, (k, v) in comb.items():
        if (np.diff(k) <= 0).any() or [want[x] for x in k.tolist()] \
                != v.tolist():
            raise AssertionError(f"combine partition {r} differs")
    out["combine_rows"] = int(sum(k.size for k, _ in comb.values()))
    svc.unregister_shuffle(1)
    # ordered: range partitions, every one key-sorted
    bounds = sample_bounds(keys, R)
    h = stage_maps(ctx, 2, num_maps, rows, R, seed, "range", bounds)
    ordered = _local_parts(svc.read(h, ordered=True))
    rpid = np.searchsorted(bounds, keys, side="right").astype(np.int64)
    for r, (k, _) in ordered.items():
        if (np.diff(k) < 0).any():
            raise AssertionError(f"ordered partition {r} is not sorted")
    out["ordered_rows"] = _check_multisets(ordered, keys, vals, rpid)
    svc.unregister_shuffle(2)
    return out


def hierarchical(ctx: WorkerContext) -> dict:
    if not ctx.svc.manager.hierarchical:
        raise AssertionError("the node did not resolve the hier topology")
    return groupby(ctx)


def _lose_peer(ctx: WorkerContext):
    """Stage, then: the victim parks until killed; a survivor's read must
    raise PeerLostError. Returns (handle, result dict) on a survivor."""
    from sparkucx_tpu_torch.runtime.failures import PeerLostError
    num_maps, rows, R, seed = _job_args(ctx)
    h = stage_maps(ctx, 1, num_maps, rows, R, seed)
    ctx.staged()
    if ctx.rank == int(ctx.args["victim"]):
        ctx.park()
    ctx.orphaned = True
    t0 = time.monotonic()
    try:
        ctx.svc.read(h)
    except PeerLostError as e:
        return h, {"peer_lost": True,
                   "wall_ms": (time.monotonic() - t0) * 1e3,
                   "expiries": ctx.svc.node.watchdog.expiries,
                   "error": str(e)[:300]}
    raise AssertionError("the read returned with a dead peer")


def chaos(ctx: WorkerContext) -> dict:
    return _lose_peer(ctx)[1]


def recovery(ctx: WorkerContext) -> dict:
    from sparkucx_tpu_torch.runtime.failures import StaleEpochError
    h, out = _lose_peer(ctx)
    out["epoch"] = ctx.svc.node.remesh(shards=ctx.args["survivors"],
                                       reason="member loss")
    try:
        ctx.svc.read(h)
    except StaleEpochError as e:
        out["stale_fenced"] = str(e)[:300]
        return out
    raise AssertionError("the stale handle was not fenced")


JOBS = {"groupby": groupby, "hierarchical": hierarchical, "chaos": chaos,
        "recovery": recovery}


def _resolve_job(name: str):
    if name in JOBS:
        return JOBS[name]
    module, _, fn = name.partition(":")
    if not fn:
        raise ValueError(f"job {name!r}: want one of {sorted(JOBS)} or "
                         f"'module:function'")
    return getattr(importlib.import_module(module), fn)


def _worker(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    torch.set_num_threads(2)
    from sparkucx_tpu_torch import connect
    conf = dict(spec["conf"])
    conf["spark.shuffle.tpu.coordinator.address"] = spec["coordinator"]
    conf["spark.shuffle.tpu.numProcesses"] = str(spec["nprocs"])
    try:
        svc = connect(conf, device=spec["device"],
                      num_shards=spec["shards"], distributed=True,
                      process_id=spec["rank"], use_env=False)
    except RuntimeError as e:
        print(f"worker {spec['rank']}: {e}", flush=True)
        return 5 if RENDEZVOUS in str(e) else 1
    ctx = WorkerContext(spec["rank"], spec["nprocs"], svc,
                        spec.get("args") or {}, spec["device"])
    code = 0
    try:
        out = _resolve_job(spec["job"])(ctx)
        print(RESULT + json.dumps(out), flush=True)
    except BaseException:
        traceback.print_exc()
        code = 1
    if not ctx.orphaned:
        svc.close()
    return code


if __name__ == "__main__":
    rc = _worker(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: a thread a fence abandoned inside a dead
    # collective must not hold the exit
    os._exit(rc)
