"""Jobs the port's multi-process tests run on ``cluster.run_cluster``
workers, and the map data both sides of a comparison write. JAX-free, so
the card tests share it.

Map ``m`` goes to the process that owns shard ``m % P``
(``cluster.my_maps``), so every shard stages the same maps in the same
order as on one process: a read of the same maps by one process and by
several then quantizes the same rows with the same noise."""

import numpy as np

from sparkucx_tpu_torch.cluster import my_maps

SEED = 41
R = 12            # partitions
MAPS = 8
ROWS = 40         # rows a map
VW = 3            # value lanes
SKEW_PART = R - 1  # the overflow case's one hot partition


def float_maps(maps: int = MAPS, rows: int = ROWS):
    """``maps`` (keys, float32 values) pairs, values of mixed magnitude."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(maps):
        k = rng.integers(0, 1 << 16, rows).astype(np.int64)
        v = (rng.standard_normal((rows, VW))
             * np.exp(rng.normal(0, 1, (rows, 1)))).astype(np.float32)
        out.append((k, v))
    return out


def float_run_maps(maps: int = MAPS, rows: int = ROWS):
    """As :func:`float_maps`, over :func:`int_maps`' small key space, so a
    float32 combine sums runs of several rows."""
    rng = np.random.default_rng(SEED + 2)
    return [(rng.integers(0, 64, rows).astype(np.int64),
             (rng.standard_normal((rows, VW))
              * np.exp(rng.normal(0, 1, (rows, 1)))).astype(np.float32))
            for _ in range(maps)]


def int_maps(maps: int = MAPS, rows: int = ROWS):
    """``maps`` (keys, int32 values) pairs over a small key space, so the
    combine has runs to sum."""
    rng = np.random.default_rng(SEED + 1)
    return [(rng.integers(0, 64, rows).astype(np.int64),
             rng.integers(-1000, 1000, (rows, 2)).astype(np.int32))
            for _ in range(maps)]


def skew_maps(maps: int = MAPS, rows: int = ROWS):
    """Direct-partitioned maps whose rows all go to the last partition
    (on the last process's last shard): only that process's receiver
    overflows a small ``a2a.capacityFactor``."""
    return [(np.full(rows, SKEW_PART, dtype=np.int64),
             np.arange(rows * 2, dtype=np.int32).reshape(rows, 2) + m)
            for m in range(maps)]


def write(mgr, sid: int, maps, owned, partitioner: str = "hash",
          bounds=None):
    """Register ``sid`` with ``mgr`` and commit the maps in ``owned``."""
    h = mgr.register_shuffle(sid, len(maps), R, partitioner, bounds)
    for m in owned:
        w = mgr.get_writer(h, m)
        w.write(*maps[m])
        w.commit(R)
    return h


def dump(res) -> dict:
    """The partitions a (partial) view holds: ``{r: [keys hex, values
    hex]}``."""
    return {str(r): [k.tobytes().hex(), v.tobytes().hex()]
            for r, (k, v) in res.partitions()}


def _manager(ctx, conf: dict):
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
    return ShuffleManager(ctx.svc.node, ShuffleConf(conf, use_env=False))


def _raises(fn, kind):
    try:
        fn()
    except kind as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"expected {kind.__name__}")


def _report(rep) -> dict:
    return {"distributed": rep.distributed, "impl": rep.impl,
            "process_id": rep.process_id, "retries": rep.retries,
            "wire": rep.wire, "sink": rep.sink, "waves": rep.waves,
            "d2h_bytes": rep.d2h_bytes,
            "tiers": [{k: t[k] for k in ("tier", "payload_rows",
                                          "cross_exact")}
                      for t in rep.tiers]}


def read_suite(ctx) -> dict:
    """Every read shape of the distributed plane on one world: plain,
    ordered, combine (float32 and int32), int8, device sink, waved,
    tiered, an overflow, and the three collective failures."""
    svc = ctx.svc
    mine = my_maps(ctx, MAPS)
    fm, im = float_maps(), int_maps()
    out = {"rank": ctx.rank, "shards": svc.node.local_shard_ids}
    # a failfast node makes no replay group, and refuses a replay binding
    out["replay_group"] = svc.node.replay_group is not None
    out["replay_refused"] = _raises(
        lambda: _manager(ctx, {"spark.shuffle.tpu.failure.policy":
                               "replay"}), ValueError)
    h = write(svc.manager, 1, fm, mine)
    res = svc.read(h)
    out["plain"] = dump(res)
    out["plain_report"] = _report(svc.report(1))
    other = next(r for r in range(R) if not res.is_local(r))
    out["non_local"] = _raises(lambda: res.partition(other), KeyError)
    out["ordered"] = dump(svc.read(h, ordered=True))
    dres = svc.read(h, sink="device")
    out["device_d2h_before"] = svc.report(1).d2h_bytes
    out["device"] = dump(dres.host_view())
    svc.unregister_shuffle(1)

    h = write(svc.manager, 10, float_run_maps(), mine)
    out["combine_f32"] = dump(svc.read(h, combine="sum"))
    svc.unregister_shuffle(10)

    h = write(svc.manager, 2, im, mine)
    out["combine_i32"] = dump(svc.read(h, combine="sum"))
    svc.unregister_shuffle(2)

    m8 = _manager(ctx, {"spark.shuffle.tpu.a2a.wire": "int8"})
    out["int8"] = dump(m8.read(write(m8, 3, fm, mine)))
    out["int8_report"] = _report(m8.report(3))
    m8.unregister_shuffle(3)
    m8.stop()

    mw = _manager(ctx, {"spark.shuffle.tpu.a2a.waveRows": "25"})
    h = write(mw, 4, fm, mine)
    out["waved"] = dump(mw.read(h))
    out["waved_report"] = _report(mw.report(4))
    out["waved_device"] = dump(mw.read(h, ordered=True,
                                       sink="device").host_view())
    mw.unregister_shuffle(4)
    mw.stop()

    mo = _manager(ctx, {"spark.shuffle.tpu.a2a.capacityFactor": "2"})
    out["skew"] = dump(mo.read(write(mo, 5, skew_maps(), mine, "direct")))
    out["skew_report"] = _report(mo.report(5))
    mo.unregister_shuffle(5)
    mo.stop()

    # the completeness barrier: map 0 is never committed
    h = write(svc.manager, 6, fm, [m for m in mine if m != 0])
    out["barrier"] = _raises(lambda: svc.read(h, timeout=0.5),
                             TimeoutError)
    svc.unregister_shuffle(6)
    # one process writes float32 values, the other int32
    maps = fm if ctx.rank == 0 else im
    h = write(svc.manager, 7, maps, mine)
    out["schema"] = _raises(lambda: svc.read(h), ValueError)
    svc.unregister_shuffle(7)
    mp = _manager(ctx, {"spark.shuffle.tpu.a2a.impl": "pallas"})
    h = write(mp, 8, fm, mine)
    out["pallas"] = _raises(lambda: mp.read(h), NotImplementedError)
    mp.unregister_shuffle(8)
    mp.stop()

    # two slices: the slice boundary is the process boundary
    with ctx.connect({"spark.shuffle.tpu.mesh.numSlices":
                      str(ctx.nprocs)}) as hier:
        h = write(hier.manager, 9, fm, mine)
        out["tiered"] = dump(hier.read(h))
        out["tiered_report"] = _report(hier.report(9))
        hier.unregister_shuffle(9)
        h = write(hier.manager, 11, float_run_maps(), mine)
        out["tiered_combine"] = dump(hier.read(h, combine="sum"))
        hier.unregister_shuffle(11)
    return out


def divergence(ctx) -> dict:
    """A unanimity round in which the last process proposes another
    value: every process must raise, naming it."""
    from sparkucx_tpu_torch.shuffle.agreement import (
        AgreementDivergenceError, agree)
    mine = [7, 99 if ctx.rank == ctx.nprocs - 1 else 1]
    agreed = agree("test.warmup", [3, 4]).tolist()
    try:
        agree("test.divergent", mine, conf_key="spark.shuffle.tpu.test")
    except AgreementDivergenceError as e:
        return {"agreed": agreed, "kind": e.kind, "topic": e.topic,
                "dissenters": e.dissenters, "proposals": e.proposals,
                "message": str(e)}
    raise AssertionError("the divergent round was agreed")


def hang(ctx) -> dict:
    """The victim stays alive but never joins the read (it sleeps past the
    deadline, then leaves without a collective): the survivor's fence
    must expire and raise ``PeerLostError``."""
    import time

    from sparkucx_tpu_torch.runtime.failures import PeerLostError
    deadline_ms = ctx.svc.conf.collective_timeout_ms
    h = write(ctx.svc.manager, 1, float_maps(), my_maps(ctx, MAPS))
    ctx.orphaned = True
    if ctx.rank == ctx.nprocs - 1:
        time.sleep(3 * deadline_ms / 1e3)
        return {"victim": True}
    t0 = time.monotonic()
    try:
        ctx.svc.read(h)
    except PeerLostError as e:
        return {"wall_ms": (time.monotonic() - t0) * 1e3,
                "expiries": ctx.svc.node.watchdog.expiries,
                "leaked": ctx.svc.node.watchdog.leaked(),
                "error": str(e)[:300]}
    raise AssertionError("the read returned with a silent peer")


def card_reads(ctx) -> dict:
    """The card tests' world: a plain read, an int8 read and a combine
    read on this process's device, each int8 and segment-reduce launch's
    first and last held against the plain version (``chip_smoke.
    KernelCapture``; run from the repository root)."""
    from chip_smoke import KernelCapture

    from sparkucx_tpu_torch import backend
    from sparkucx_tpu_torch.ops import quant as tq
    from sparkucx_tpu_torch.ops import segmented as sg
    svc = ctx.svc
    mine = my_maps(ctx, MAPS)
    fm, im = float_maps(), int_maps()
    out = {"rank": ctx.rank}
    out["plain"] = dump(svc.read(write(svc.manager, 1, fm, mine)))
    svc.unregister_shuffle(1)
    m8 = _manager(ctx, {"spark.shuffle.tpu.a2a.wire": "int8"})
    h = write(m8, 2, fm, mine)
    backend.reset_launch_counts()
    with KernelCapture() as cap:
        out["int8"] = dump(m8.read(h))
    out["int8_launches"] = backend.launch_counts().get(tq.KERNEL_NAME, 0)
    out["int8_retries"] = m8.report(2).retries
    out["int8_checks"] = cap.check("int8")
    m8.stop()
    h = write(svc.manager, 3, im, mine)
    backend.reset_launch_counts()
    with KernelCapture() as cap:
        out["combine"] = dump(svc.read(h, combine="sum"))
    out["combine_launches"] = backend.launch_counts().get(sg.KERNEL_NAME, 0)
    out["combine_checks"] = cap.check("combine")
    return out


REPLAY_FENCE_MS = 3000.0      # the one-armed case's collective fence
REPLAY_ENTER_MS = 1000.0      # ... and its replay.enter deadline


def replay_suite(ctx) -> dict:
    """The distributed replay (``failure.policy=replay``) on one world:
    an exchange fault on every process (one budget unit spent group-wide
    and the maps' partitions delivered), a divergent ``replayBudget``
    (the ``replay.enter`` round vetoes the replay, no unit spent), the
    round's dedicated deadline (``failure.replayAgreeTimeoutMs`` on the
    node's replay group), and last, on a node of its own under a
    collective fence, a fault on process 0 only: process 0 fails typed
    within the enter deadline and process 1's read fails typed (its
    peer never enters the exchange) or completes."""
    import time

    from sparkucx_tpu_torch.runtime.failures import (InjectedFault,
                                                     TransientError)
    from sparkucx_tpu_torch.shuffle import distributed as tdist
    svc = ctx.svc
    faults = svc.node.faults
    mine = my_maps(ctx, MAPS)
    fm = float_maps()
    out = {"rank": ctx.rank}

    out["replay_group"] = svc.node.replay_group is not None
    mr = _manager(ctx, {"spark.shuffle.tpu.failure.policy": "replay"})
    h = write(mr, 1, fm, mine)
    faults.arm("exchange", fail_count=1)
    out["replay"] = dump(mr.read(h))
    rep = mr.report(1)
    out["replay_report"] = {"replays": rep.replays,
                            "replay_ms": rep.replay_ms,
                            "spent": mr._replay_counts.get(1, 0),
                            "exchange": list(faults.stats()["exchange"])}
    mr.unregister_shuffle(1)
    mr.stop()

    mv = _manager(ctx, {"spark.shuffle.tpu.failure.policy": "replay",
                        "spark.shuffle.tpu.failure.replayBudget":
                            str(2 + ctx.rank)})
    h = write(mv, 2, fm, mine)
    faults.arm("exchange", fail_count=1)
    out["vetoed"] = _raises(lambda: mv.read(h), InjectedFault)
    out["vetoed_spent"] = mv._replay_counts.get(2, 0)
    mv.unregister_shuffle(2)
    mv.stop()

    mt = _manager(ctx, {"spark.shuffle.tpu.failure.policy": "replay",
                        "spark.shuffle.tpu.failure.replayAgreeTimeoutMs":
                            "1234"})
    h = write(mt, 3, fm, mine)
    seen = []
    real = tdist.allgather_blob

    def gather(payload, what="", timeout_ms=None, group=None):
        if "replay.enter" in what:
            seen.append([timeout_ms, group is svc.node.replay_group])
        return real(payload, what=what, timeout_ms=timeout_ms, group=group)

    tdist.allgather_blob = gather
    try:
        faults.arm("exchange", fail_count=1)
        out["timed"] = dump(mt.read(h))
    finally:
        tdist.allgather_blob = real
    out["enter_rounds"] = seen
    mt.unregister_shuffle(3)
    mt.stop()

    # the groups of this last node are left broken: no teardown
    ctx.orphaned = True
    fenced = ctx.connect({
        "spark.shuffle.tpu.failure.policy": "replay",
        "spark.shuffle.tpu.failure.collectiveTimeoutMs":
            str(REPLAY_FENCE_MS),
        "spark.shuffle.tpu.failure.replayAgreeTimeoutMs":
            str(REPLAY_ENTER_MS)})
    h = write(fenced.manager, 4, fm, mine)
    if ctx.rank == 0:
        fenced.node.faults.arm("exchange", fail_count=1)
    t0 = time.monotonic()
    try:
        fenced.read(h)
        out["one_armed"] = "completed"
    except (TransientError, RuntimeError) as e:
        out["one_armed"] = f"{type(e).__name__}: {e}"[:300]
    out["one_armed_ms"] = (time.monotonic() - t0) * 1e3
    return out


def integrity_suite(ctx) -> dict:
    """``integrity.verify=full`` on one world: a plain read whose digest
    tables every process gathers before the exchange (the table as
    submit left it, the partitions and the report), then a read whose
    process 1 holds maps without digest rows (committed below the full
    level): every process skips the post-exchange check together."""
    svc = ctx.svc
    mine = my_maps(ctx, MAPS)
    fm = float_maps()
    full = {"spark.shuffle.tpu.integrity.verify": "full"}
    out = {"rank": ctx.rank}
    mgr = _manager(ctx, full)
    h = write(mgr, 1, fm, mine)
    pending = mgr.submit(h)
    table = mgr._full_expect.get(1)
    out["table"] = None if table is None else {
        k: [int(x) for x in v] for k, v in table.items()}
    out["full"] = dump(pending.result())
    rep = mgr.report(1)
    out["full_report"] = [rep.integrity, rep.integrity_bytes]
    out["staged_bytes"] = int(sum(fm[m][0].nbytes + fm[m][1].nbytes
                                  for m in mine))

    h = write(mgr, 2, fm, mine)
    if ctx.rank == 1:
        for m in mine:
            h.entry.fetch_integrity(m).digests = None
    pending = mgr.submit(h)
    out["lacking_table"] = 2 in mgr._full_expect
    out["lacking"] = dump(pending.result())
    rep = mgr.report(2)
    out["lacking_report"] = [rep.integrity, rep.integrity_bytes]
    mgr.unregister_shuffle(1)
    mgr.unregister_shuffle(2)
    mgr.stop()
    return out


ASYNC_TENANTS = ("lo", "hi", "hi", "lo", "hi", "lo")


def tenancy_suite(ctx) -> dict:
    """The distributed async plane on one world: every process submits
    the same six ``read_async`` reads of two tenants (``lo`` normal,
    ``hi`` high) in the same order, on 4 workers; each batch's order is
    agreed and each read runs under its turnstile ticket. Records every
    batch's agreed order (``tenancy.agreed_submission_order``, wrapped),
    the order the reads ran (their reports' exchange sequence numbers),
    the partial views and the reports. Then one read whose tenant
    differs on process 1: its batch fails typed on every process, and
    the next read still runs."""
    from sparkucx_tpu_torch.shuffle import tenancy
    from sparkucx_tpu_torch.utils.metrics import (C_AGREE_ROUNDS,
                                                  H_TURNSTILE_WAIT, labeled)
    pfx = "spark.shuffle.tpu."
    svc = ctx.connect({pfx + "tenant.hi.priority": "high",
                       pfx + "tenant.asyncWorkers": "4"})
    mine = my_maps(ctx, MAPS)
    fm = float_maps()
    orders = []
    real = tenancy.agreed_submission_order

    def spy(pending, weight_of):
        got = real(pending, weight_of)
        orders.append([int(s) for s in got])
        return got

    tenancy.agreed_submission_order = spy
    out = {"rank": ctx.rank}
    try:
        hs = []
        for i, t in enumerate(ASYNC_TENANTS):
            h = svc.register_shuffle(20 + i, MAPS, R, tenant=t)
            for m in mine:
                w = svc.writer(h, m)
                w.write(*fm[m])
                w.commit(R)
            hs.append(h)
        futs = [svc.read_async(h) for h in hs]
        for i, f in enumerate(futs):
            out[f"read{i}"] = dump(f.result(timeout=120))
        reps = [svc.report(20 + i) for i in range(len(hs))]
        out["ran"] = sorted(range(len(hs)), key=lambda i: reps[i]._seq)
        out["orders"] = list(orders)
        out["tenants"] = [r.tenant for r in reps]
        out["async_workers"] = [r.async_workers for r in reps]
        out["distributed"] = [r.distributed for r in reps]
        m = svc.node.metrics
        out["turnstile_waits"] = m.histogram(H_TURNSTILE_WAIT).snapshot()
        out["rounds"] = {t: m.get(labeled(C_AGREE_ROUNDS, topic=t))
                         for t in ("async.batch", "async.order")}
        # a divergent batch: process 1 holds the read under another tenant
        h = svc.register_shuffle(40, MAPS, R,
                                 tenant="hi" if ctx.rank == 1 else "lo")
        for m_ in mine:
            svc.write(h, m_, *fm[m_])
        try:
            svc.read_async(h).result(timeout=120)
            out["divergent"] = "completed"
        except Exception as e:
            out["divergent"] = f"{type(e).__name__}: {e}"[:400]
        h = svc.register_shuffle(41, MAPS, R, tenant="lo")
        for m_ in mine:
            svc.write(h, m_, *fm[m_])
        out["after"] = dump(svc.read_async(h).result(timeout=120))
    finally:
        tenancy.agreed_submission_order = real
        svc.stop()
    return out


def decisions_suite(ctx) -> dict:
    """The decision plane on one world of two slices (the world's conf
    sets ``mesh.numSlices``, ``history.dir`` and ``trace.enabled``): a
    flat waved read (its ``a2a.waveRows`` / ``a2a.waveSizes`` rounds)
    and a two-tier read (``tier.crossRows`` and the ``hier.*`` rounds).
    Each process returns the reads' partitions and agreement summaries,
    its ledger's records and path, the rounds its metrics counted, the
    gathered spans and anchors and the gathered reports."""
    from sparkucx_tpu_torch.utils.metrics import C_AGREE_ROUNDS
    svc = ctx.svc
    node = svc.node
    mine = my_maps(ctx, MAPS)
    fm = float_maps()
    out = {"rank": ctx.rank, "ledger_path": node.decisions.path}
    rounds0, total0 = node.metrics.get(C_AGREE_ROUNDS), node.decisions.total
    mw = _manager(ctx, {"spark.shuffle.tpu.a2a.topology": "flat",
                        "spark.shuffle.tpu.a2a.waveRows": "10"})
    h = write(mw, 1, fm, mine)
    out["waved"] = dump(mw.read(h))
    rep = mw.report(1)
    out["waved_report"] = {"waves": rep.waves, "trace_id": rep.trace_id,
                           "agreement": rep.agreement}
    mw.unregister_shuffle(1)
    mw.stop()
    h = write(svc.manager, 2, fm, mine)
    out["tiered"] = dump(svc.read(h))
    rep = svc.report(2)
    out["tiered_report"] = {"tiers": [t["tier"] for t in rep.tiers],
                            "trace_id": rep.trace_id,
                            "agreement": rep.agreement}
    out["gathered_reports"] = svc.manager.gather_reports(2)
    svc.unregister_shuffle(2)
    out["rounds"] = node.metrics.get(C_AGREE_ROUNDS) - rounds0
    out["records"] = node.decisions.total - total0
    out["topics"] = sorted({r["topic"] for r in node.decisions.tail()})
    out["anchors"] = node.cluster_anchors
    out["spans"] = svc.manager.gather_spans()
    node.decisions.close()
    return out


def fleet_suite(ctx) -> dict:
    """The fleet plane on one world (the world's conf sets
    ``metrics.httpPort`` and a shared ``failure.ledgerDir``): a plain read
    of the float maps, then rank 0 scrapes ``/cluster/snapshot`` and
    ``/cluster/doctor`` of its own node while every peer is still up (a
    barrier after the scrape). Each process returns its live URL, its
    registry and the snapshot's ``fleet_registry``."""
    import json
    import urllib.request

    from sparkucx_tpu_torch.shuffle.distributed import allgather_blob
    svc = ctx.svc
    node = svc.node
    h = write(svc.manager, 1, float_maps(), my_maps(ctx, MAPS))
    out = {"rank": ctx.rank, "url": node.live.url, "read": dump(svc.read(h)),
           "registry": {str(p): u for p, u in node.fleet.peers().items()},
           "snapshot_registry": node.telemetry_snapshot()["fleet_registry"],
           "scrape_hooked": node.watchdog.peer_scrape is not None}
    svc.unregister_shuffle(1)
    if ctx.rank == 0:
        for route in ("snapshot", "doctor"):
            with urllib.request.urlopen(f"{node.live.url}/cluster/{route}",
                                        timeout=30) as r:
                out[route] = json.loads(r.read().decode())
        out["snapshot"] = {k: out["snapshot"][k] for k in (
            "expected", "missing_peers", "processes_answered")}
        out["doctor"] = out["doctor"]["fleet"]["processes_answered"]
    allgather_blob(np.zeros(1, dtype=np.int64), what="fleet barrier")
    return out


def streaming_suite(ctx) -> dict:
    """``partitions_ready()`` on the two partial views of one plain read:
    the host sink's (drained as the read settled) and the device sink's
    ``host_view()`` (pulled shard by shard as the iterator goes). Each
    process returns the order and the partitions of both."""
    svc = ctx.svc
    h = write(svc.manager, 1, float_maps(), my_maps(ctx, MAPS))
    host = svc.read(h)
    out = {"rank": ctx.rank, "shards": svc.node.local_shard_ids,
           "host_order": [r for r, _ in host.partitions_ready()],
           "host": dump(host)}
    dres = svc.read(h, sink="device")
    out["device_d2h_before"] = svc.report(1).d2h_bytes
    view = dres.host_view()
    parts = dict()
    out["device_order"] = []
    for r, kv in view.partitions_ready():
        out["device_order"].append(r)
        parts[r] = kv
    out["device_shards_pulled"] = len(view._shards)
    out["device"] = {str(r): [k.tobytes().hex(), v.tobytes().hex()]
                     for r, (k, v) in parts.items()}
    svc.unregister_shuffle(1)
    return out
