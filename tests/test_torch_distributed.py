"""Port parity for the multi-process read plane (``shuffle/distributed.py``,
``cluster.py``, the distributed arm of ``shuffle/manager.py``).

Two halves, the same seeded map data on every side
(``tests/torch_cluster_jobs.py``):

* one process: the port's distributed code with ``numProcesses=1`` on a
  one-rank gloo group (``node.is_distributed`` forced, as the JAX
  package's ``dist_mgr`` does on its started node) against the JAX
  package's distributed arm on its 8 virtual CPU devices;
* two real processes on the CPU (``cluster.run_cluster(...,
  device="cpu")``, one world for the whole module): every process's
  partial view against the JAX package's single-process read of the same
  maps, the int8 read against the port's one-process read, the tiered
  read's DCN rows against numpy, and the collective failures on every
  process.

Tolerances, stated once: exact for keys, per-partition multisets, int32
combine sums, retries, cross rows and the int8 bytes (both sides round
with the same uniforms: the JAX package's draws handed to the port, or
the same port seeds by global shard id); float32 combine sums (over
``float_run_maps``' small key space, so runs of several rows are summed)
within :func:`_f32_tol`, a bound per key and lane: each combine runs on
one shard over its ``n`` rows of absolute sum ``S``, and the JAX
package's float32 prefix differences there lose at most ``2 gamma_n S``
plus the difference's rounding, so ``(2 n + 3) 2**-24 S`` per shard the
key's rows visit at that combine (map side, the relay on a tiered read,
receive side), summed over the combines and doubled (the port's per-run
sums are within the same bound, and both sides differ from the exact
sum); ordered partitions: multisets and non-decreasing keys."""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import torch_cluster_jobs as jobs
from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.runtime.node import TpuNode
from sparkucx_tpu.shuffle.manager import TpuShuffleManager
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.cluster import ClusterError, run_cluster
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.parallel.mesh import local_shard_ids
from sparkucx_tpu_torch.shuffle import distributed as tdistrib
from sparkucx_tpu_torch.shuffle import reader as treader
from sparkucx_tpu_torch.shuffle import topology as ttopo
from sparkucx_tpu_torch.shuffle.writer import hash32_np

R, P = jobs.R, 8
SLICE_SHARDS = P // 2      # the tiered reads' 2 x 4 grid
CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def _pid(keys):
    return (hash32_np(keys) % np.uint32(R)).astype(np.int64)


def _f32_tol(maps, tiered: bool) -> dict:
    """``{key: [VW] bound}`` for the float32 combine of ``maps`` (module
    docstring). Map ``m`` stages on shard ``m % P``; a row's relay on a
    tiered read is its slice's shard in its destination's column."""
    keys = np.concatenate([k for k, _ in maps])
    av = np.abs(np.concatenate([v for _, v in maps]).astype(np.float64))
    send = np.repeat(np.arange(len(maps)) % P, [len(k) for k, _ in maps])
    recv = blocked_partition_map(R, P)[_pid(keys)]
    stages = [send, recv]
    if tiered:
        stages.append(send // SLICE_SHARDS * SLICE_SHARDS
                      + recv % SLICE_SHARDS)
    tol = {int(k): np.zeros(av.shape[1]) for k in np.unique(keys)}
    for shard in stages:
        n = np.bincount(shard, minlength=P)
        S = np.stack([np.bincount(shard, av[:, j], minlength=P)
                      for j in range(av.shape[1])], axis=1)
        per = (2 * n[:, None] + 3) * 2.0 ** -24 * S         # [P, VW]
        for k in tol:
            tol[k] += per[np.unique(shard[keys == k])].sum(axis=0)
    return {k: 2 * t for k, t in tol.items()}


def _rows(k, v):
    """A partition as a sorted list of (key, value bytes) rows."""
    return sorted(zip(k.tolist(),
                      (np.ascontiguousarray(r).tobytes() for r in v)))


def _parts(res):
    return {r: res.partition(r) for r in range(R)}


def _undump(d, vdtype, vw):
    return {int(r): (np.frombuffer(bytes.fromhex(k), np.int64),
                     np.frombuffer(bytes.fromhex(v), vdtype).reshape(-1, vw))
            for r, (k, v) in d.items()}


def _merged(world, key, vdtype=np.float32, vw=jobs.VW):
    """The union of every process's partial view; each partition once."""
    out = {}
    for res in world:
        for r, kv in _undump(res[key], vdtype, vw).items():
            assert r not in out, f"partition {r} on two processes"
            out[r] = kv
    return out


def _check(got, want, mode, tol=None):
    assert sorted(got) == sorted(want) == list(range(R))
    for r in range(R):
        (gk, gv), (wk, wv) = got[r], want[r]
        if mode == "combine_f32":
            np.testing.assert_array_equal(gk, wk)
            bound = np.stack([tol[int(k)] for k in gk])
            assert (np.abs(gv.astype(np.float64) - wv) <= bound).all(), \
                f"partition {r}"
            continue
        if mode in ("combine", "ordered"):
            assert (np.diff(gk) > 0 if mode == "combine"
                    else np.diff(gk) >= 0).all()
        assert _rows(gk, gv) == _rows(wk, wv), f"{mode}: partition {r}"


def _jax_manager(conf):
    """A started JAX node + manager (``tests/test_distributed_parity``'s
    ``dist_mgr`` pattern): ``distributed`` forces the distributed arm."""
    c = TpuShuffleConf({"spark.shuffle.tpu.a2a.impl": "dense", **conf},
                       use_env=False)
    node = TpuNode.start(c)
    return node, TpuShuffleManager(node, c)


def _jax_read(conf, maps, distributed=False, partitioner="hash", **kw):
    node, mgr = _jax_manager(conf)
    node.is_distributed = distributed
    try:
        h = jobs.write(mgr, 1, maps, range(len(maps)), partitioner)
        res = mgr.read(h, **kw)
        if kw.get("sink") == "device":
            res = res.host_view()
        return _parts(res), mgr.report(1)
    finally:
        node.is_distributed = False
        mgr.stop()
        node.close()


# -- two real processes --------------------------------------------------------
@pytest.fixture(scope="module")
def world2():
    run = run_cluster("torch_cluster_jobs:read_suite", 2, P, device="cpu",
                      timeout_s=240)
    assert run.attempts in (1, 2) and run.returncodes == [0, 0]
    return run.results


@pytest.fixture(scope="module")
def jax_flat():
    """The JAX package's single-process reads of the suite's maps."""
    fm, im = jobs.float_maps(), jobs.int_maps()
    node, mgr = _jax_manager({})
    out = {}
    try:
        h = jobs.write(mgr, 1, fm, range(jobs.MAPS))
        out["plain"] = _parts(mgr.read(h))
        out["ordered"] = _parts(mgr.read(h, ordered=True))
        h = jobs.write(mgr, 4, jobs.float_run_maps(), range(jobs.MAPS))
        out["combine_f32"] = _parts(mgr.read(h, combine="sum"))
        h = jobs.write(mgr, 2, im, range(jobs.MAPS))
        out["combine_i32"] = _parts(mgr.read(h, combine="sum"))
        h = jobs.write(mgr, 3, jobs.skew_maps(), range(jobs.MAPS), "direct")
        out["skew"] = _parts(mgr.read(h))
        out["skew_retries"] = mgr.report(3).retries
    finally:
        mgr.stop()
        node.close()
    return out


@pytest.mark.parametrize("key,want,mode", [
    ("plain", "plain", "plain"), ("ordered", "ordered", "ordered"),
    ("device", "plain", "plain"), ("waved", "plain", "plain"),
    ("waved_device", "ordered", "ordered"), ("tiered", "plain", "plain"),
    ("combine_f32", "combine_f32", "combine_f32"),
    ("combine_i32", "combine_i32", "combine"),
    ("tiered_combine", "combine_f32", "combine_f32"),
    ("skew", "skew", "plain")])
def test_two_processes_match_the_reference(world2, jax_flat, key, want,
                                           mode):
    """The two partial views together hold the JAX package's
    single-process read of the same maps, every partition on one process
    (its owner's)."""
    vd, vw = (np.int32, 2) if key in ("combine_i32", "skew") \
        else (np.float32, jobs.VW)
    got = _merged(world2, key, vd, vw)
    _check(got, jax_flat[want], mode,
           _f32_tol(jobs.float_run_maps(), key.startswith("tiered")))
    p2s = blocked_partition_map(R, P)
    for res in world2:
        owned = set(local_shard_ids(P, 2, res["rank"]))
        assert res["shards"] == sorted(owned)
        assert all(p2s[int(r)] in owned for r in res[key])


def test_two_processes_report_and_partial_views(world2):
    for res in world2:
        rep = res["plain_report"]
        assert rep["distributed"] and rep["process_id"] == res["rank"]
        assert rep["impl"] == "dense"          # auto on a distributed read
        assert res["non_local"].startswith("KeyError: 'partition")
        assert res["device_d2h_before"] == 0
        assert res["waved_report"]["waves"] == 2


def test_failfast_node_makes_no_replay_group(world2, replay_world):
    """Only a node started under ``failure.policy=replay`` makes the
    ``replay.enter`` group; a replay binding on a failfast distributed
    node is refused at construction."""
    for res in world2:
        assert res["replay_group"] is False
        assert res["replay_refused"].startswith(
            "ValueError: failure.policy=replay on a distributed node")
    assert all(res["replay_group"] is True for res in replay_world)


def test_two_process_overflow_retries_in_lockstep(world2, jax_flat):
    """Only the last process's receiver overflows; both regrow and retry
    the same number of times, as the JAX package's read of the maps."""
    retries = [res["skew_report"]["retries"] for res in world2]
    assert retries[0] == retries[1] == jax_flat["skew_retries"] > 0


@pytest.mark.parametrize("key,kind", [
    ("barrier", "TimeoutError: shuffle 6: only 7/8 map outputs"),
    ("schema", "ValueError: mixed value schema across processes"),
    ("pallas", "NotImplementedError: a2a.impl='pallas' on a distributed"),
])
def test_collective_failures_raise_on_every_process(world2, key, kind):
    assert all(res[key].startswith(kind) for res in world2), \
        [res[key] for res in world2]


def test_two_process_int8_equals_one_process_bytes(world2):
    """Every shard quantizes from its GLOBAL id's seed, so the two
    processes' int8 read delivers the port's one-process bytes."""
    fm = jobs.float_maps()
    conf = {"spark.shuffle.tpu.a2a.wire": "int8"}
    with connect(conf, device="cpu", use_env=False) as svc:
        want = _parts(svc.read(jobs.write(svc.manager, 3, fm,
                                          range(jobs.MAPS))))
        assert svc.report(3).wire == "int8"
    got = _merged(world2, "int8")
    assert all(res["int8_report"]["wire"] == "int8" for res in world2)
    for r in range(R):
        assert _rows(*got[r]) == _rows(*want[r]), f"partition {r}"


def test_two_process_tiered_dcn_rows_cross_processes(world2):
    """mesh.numSlices = 2 over 2 processes: stage 2 is the only hop that
    crosses processes, and its agreed cross rows are the rows whose
    source and destination shards lie on different processes."""
    fm = jobs.float_maps()
    keys = np.concatenate([k for k, _ in fm])
    src = np.repeat([m % P for m in range(jobs.MAPS)], jobs.ROWS)
    dst = blocked_partition_map(R, P)[_pid(keys)]
    for res in world2:
        ici, dcn = res["tiered_report"]["tiers"]
        assert (ici["tier"], dcn["tier"]) == ("ici", "dcn")
        assert ici["cross_exact"] and dcn["cross_exact"]
        assert dcn["payload_rows"] == int(((src // 4) != (dst // 4)).sum())
        assert ici["payload_rows"] == int(((src % 4) != (dst % 4)).sum())


# -- the distributed replay (failure.policy=replay) ---------------------------
@pytest.fixture(scope="module")
def replay_world():
    run = run_cluster("torch_cluster_jobs:replay_suite", 2, P, device="cpu",
                      conf={"spark.shuffle.tpu.failure.policy": "replay"},
                      timeout_s=240)
    assert run.attempts in (1, 2) and run.returncodes == [0, 0]
    return run.results


def _jax_dist_replay(maps):
    """The JAX package's distributed arm (one process, ``dist_mgr``
    pattern) under replay with one exchange fault: its partitions, report
    replays and budget spent."""
    node, mgr = _jax_manager({"spark.shuffle.tpu.failure.policy": "replay"})
    node.is_distributed = True
    try:
        h = jobs.write(mgr, 1, maps, range(len(maps)))
        node.faults.arm("exchange", fail_count=1)
        parts = _parts(mgr.read(h))
        return parts, mgr.report(1).replays, mgr._replay_counts.get(1, 0)
    finally:
        node.is_distributed = False
        mgr.stop()
        node.close()


def test_distributed_collective_replay_one_budget_unit(replay_world,
                                                       jax_flat):
    """An exchange fault on every process replays group-wide: each
    process spends ONE unit, the report counts one replay, and the two
    partial views hold the JAX package's read of the maps (whose own
    distributed arm spends one unit too)."""
    got = _merged(replay_world, "replay")
    _check(got, jax_flat["plain"], "plain")
    want_parts, jreplays, jspent = _jax_dist_replay(jobs.float_maps())
    _check(got, want_parts, "plain")
    for res in replay_world:
        rep = res["replay_report"]
        assert (rep["replays"], rep["spent"], rep["exchange"]) == \
            (jreplays, jspent, [2, 1]) == (1, 1, [2, 1])
        assert rep["replay_ms"] > 0


def test_distributed_replay_vetoed_on_divergence(replay_world):
    """Processes with different replay budgets disagree in the
    ``replay.enter`` round: the replay is vetoed on every process, the
    fault surfaces typed, and no unit is spent."""
    for res in replay_world:
        assert res["vetoed"].startswith("InjectedFault: injected fault at "
                                        "site 'exchange'")
        assert res["vetoed_spent"] == 0


def test_replay_enter_rides_dedicated_timeout(replay_world, jax_flat):
    """Both rounds of ``replay.enter`` (header and payload) run on the
    node's replay group under ``failure.replayAgreeTimeoutMs``, and the
    replayed read delivers the maps."""
    _check(_merged(replay_world, "timed"), jax_flat["plain"], "plain")
    for res in replay_world:
        assert res["enter_rounds"] == [[1234.0, True], [1234.0, True]]


def test_one_armed_fault_fails_typed_within_the_enter_deadline(
        replay_world):
    """A fault on process 0 only: its ``replay.enter`` round has no
    partner, so it fails typed once the enter deadline passes; process 1,
    inside the exchange its peer never joins, fails typed within the
    collective fence (or completes). Neither waits past the fence."""
    first, second = replay_world
    assert first["one_armed"].startswith("InjectedFault")
    assert jobs.REPLAY_ENTER_MS <= first["one_armed_ms"] \
        < jobs.REPLAY_FENCE_MS
    assert second["one_armed"] == "completed" \
        or second["one_armed"].startswith("PeerLostError"), second
    assert second["one_armed_ms"] < 2 * jobs.REPLAY_FENCE_MS


# -- one process against the JAX package's distributed arm --------------------
@pytest.fixture()
def one_rank_world():
    """A one-rank gloo world, as a one-process cluster's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    yield
    tdist.destroy_process_group()


def _port_dist_read(conf, maps, partitioner="hash", **kw):
    with connect(conf, device="cpu", use_env=False) as svc:
        svc.node.is_distributed = True
        h = jobs.write(svc.manager, 1, maps, range(len(maps)), partitioner)
        res = svc.read(h, **kw)
        rep = svc.report(1)
        if kw.get("sink") == "device":
            assert rep.d2h_bytes == 0       # nothing drained yet
            res = res.host_view()
        return _parts(res), rep


def _jax_uniforms(shape, seeds, device):
    """The uniforms the JAX package's int8 quantize draws for each
    shard's seed (``jax.random.uniform(PRNGKey(seed), [rows, w])``)."""
    return torch.stack([torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(int(s)), tuple(shape[1:]), jax.numpy.float32)))
        for s in seeds]).to(device)


SLICES = {"spark.shuffle.tpu.mesh.numSlices": "2"}
WAVES = {"spark.shuffle.tpu.a2a.waveRows": "25"}


@pytest.mark.parametrize("conf,kw,maps,mode", [
    ({}, {}, "float", "plain"),
    ({}, {"ordered": True}, "float", "ordered"),
    ({}, {"combine": "sum"}, "int", "combine"),
    ({}, {"combine": "sum"}, "float", "combine_f32"),
    ({}, {"sink": "device"}, "float", "plain"),
    (WAVES, {}, "float", "plain"),
    (WAVES, {"ordered": True, "sink": "device"}, "float", "ordered"),
    (SLICES, {}, "float", "plain"),
    (SLICES, {"combine": "sum"}, "int", "combine"),
])
def test_one_process_matches_jax_distributed(one_rank_world, conf, kw,
                                             maps, mode):
    m = jobs.int_maps() if maps == "int" else (
        jobs.float_run_maps() if mode == "combine_f32" else jobs.float_maps())
    got, rep = _port_dist_read(conf, m, **kw)
    want, jrep = _jax_read(conf, m, distributed=True, **kw)
    _check(got, want, mode, _f32_tol(m, bool(conf.get(
        "spark.shuffle.tpu.mesh.numSlices"))))
    assert rep.distributed and jrep.distributed
    assert rep.impl == "dense"
    assert rep.sink == jrep.sink and rep.waves == jrep.waves
    assert rep.hierarchical == jrep.hierarchical
    if rep.tiers:
        for t, jt in zip(rep.tiers, jrep.tiers):
            assert (t["tier"], t["payload_rows"], t["cross_exact"]) == \
                (jt["tier"], jt["payload_rows"], jt["cross_exact"])


@pytest.mark.parametrize("conf,kw,maps", [
    ({}, {}, "float"), ({}, {"ordered": True}, "float"),
    ({}, {"combine": "sum"}, "int"), (WAVES, {}, "float"),
    (SLICES, {}, "float"), (SLICES, {"combine": "sum"}, "int"),
    ({"spark.shuffle.tpu.a2a.wire": "int8"}, {}, "float")],
    ids=["plain", "ordered", "combine_i32", "waved", "slices_plain",
         "slices_combine", "int8"])
def test_one_process_report_bytes_match_jax_distributed(one_rank_world,
                                                        conf, kw, maps):
    """The distributed report's byte contract: ``payload_bytes``,
    ``wire_bytes`` and ``pad_ratio`` equal the JAX package's distributed
    arm's on the same maps (exact)."""
    m = jobs.int_maps() if maps == "int" else jobs.float_maps()
    _, rep = _port_dist_read(conf, m, **kw)
    _, jrep = _jax_read(conf, m, distributed=True, **kw)
    assert (rep.payload_bytes, rep.wire_bytes, rep.pad_ratio) == \
        (jrep.payload_bytes, jrep.wire_bytes, jrep.pad_ratio)
    assert rep.wire == jrep.wire
    if not conf and not kw:
        assert (rep.payload_bytes, rep.wire_bytes, rep.pad_ratio) == \
            (6_400, 102_400, 16.0)


@pytest.mark.parametrize("conf", [{}, SLICES])
def test_one_process_int8_bytes_equal_given_same_uniforms(
        one_rank_world, monkeypatch, conf):
    """Fed the JAX package's uniforms (stable sorts on both sides, so
    every row meets the same uniforms), the int8 read delivers the JAX
    distributed read's bytes, flat and on both tiers."""
    conf = {**conf, "spark.shuffle.tpu.a2a.wire": "int8",
            "spark.shuffle.tpu.a2a.sortImpl": "argsort"}
    m = jobs.float_maps()
    want, jrep = _jax_read(conf, m, distributed=True)
    monkeypatch.setattr(treader, "wire_uniforms", _jax_uniforms)
    monkeypatch.setattr(ttopo, "wire_uniforms", _jax_uniforms)
    got, rep = _port_dist_read(conf, m)
    assert rep.wire == jrep.wire == "int8"
    for r in range(R):
        assert _rows(*got[r]) == _rows(*want[r]), f"partition {r}"


def test_wire_seeds_come_from_global_shard_ids():
    """The reference's ``(base * P + shard_id) & 0x7FFFFFFF`` by GLOBAL
    shard id: shard 5's noise is the same on any process."""
    from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
    plan = ShufflePlan(P, R, 8, 8, "dense", wire="int8", wire_words=2)
    everyone = treader.wire_shard_seeds(plan, 3)
    assert everyone == [(3 * P + p) & 0x7FFFFFFF for p in range(P)]
    assert treader.wire_shard_seeds(plan, 3, [4, 5, 6, 7]) == everyone[4:]
    raw = ShufflePlan(P, R, 8, 8, "dense")
    assert treader.wire_shard_seeds(raw, 3, [4]) is None


# -- impl resolution, the metadata plane, the launcher -------------------------
@pytest.mark.parametrize("device", [CPU, CUDA])
@pytest.mark.parametrize("waved", [False, True])
@pytest.mark.parametrize("sink", ["host", "device"])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_distributed_auto_resolves_to_dense(device, waved, sink,
                                            hierarchical):
    """``auto`` on a distributed read is ``dense`` on the card too (the
    segment move is device-local); explicit values pass through (the
    manager refuses 'pallas' before any collective)."""
    kw = dict(waved=waved, sink=sink, hierarchical=hierarchical,
              distributed=True)
    assert backend.resolve_a2a_impl("auto", device, P, **kw) == "dense"
    assert backend.resolve_a2a_impl("gather", device, P, **kw) == "gather"
    assert backend.resolve_a2a_impl("pallas", device, P, **kw) == "pallas"
    single = backend.resolve_a2a_impl(
        "auto", device, P, waved=waved, sink=sink, hierarchical=hierarchical)
    assert single == ("pallas" if device.type == "cuda" and not waved
                      and sink == "host" and not hierarchical else "dense")


def test_allgather_blob_keeps_its_contract_without_a_group():
    out = tdistrib.allgather_blob(np.arange(4, dtype=np.int64))
    assert out.shape == (1, 4) and out.tolist() == [[0, 1, 2, 3]]
    assert tdistrib.allgather_json({"a": 1}) == [{"a": 1}]
    row = tdistrib.allgather_sizes([5, 6], [1, 3], 4)
    assert row.tolist() == [0, 5, 0, 6]


@pytest.mark.parametrize("P_,n,pid,want", [
    (8, 2, 1, [4, 5, 6, 7]), (6, 3, 2, [4, 5]), (8, 1, 0, list(range(8)))])
def test_local_shard_ids_are_contiguous_blocks(P_, n, pid, want):
    assert local_shard_ids(P_, n, pid) == want


def test_local_shard_ids_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="8 shards do not divide into 3 "
                                         "processes"):
        local_shard_ids(8, 3, 0)


def test_conf_keys_match_the_reference():
    keys = {"spark.shuffle.tpu.failure.collectiveTimeoutMs": "1500",
            "spark.shuffle.tpu.failure.dcn.timeoutMs": "700",
            "spark.shuffle.tpu.numProcesses": "3"}
    c, j = ShuffleConf(keys, use_env=False), TpuShuffleConf(keys,
                                                            use_env=False)
    for name in ("coordinator_address", "num_processes", "meta_buffer_size",
                 "collective_timeout_ms", "ici_timeout_ms",
                 "dcn_timeout_ms"):
        assert getattr(c, name) == getattr(j, name), name
    d, jd = ShuffleConf({}, use_env=False), TpuShuffleConf({},
                                                           use_env=False)
    assert (d.coordinator_address, d.num_processes,
            d.collective_timeout_ms) == (jd.coordinator_address,
                                         jd.num_processes,
                                         jd.collective_timeout_ms)
    bad = {"spark.shuffle.tpu.failure.collectiveTimeoutMs": "-1"}
    with pytest.raises(ValueError, match="collectiveTimeoutMs=-1.0: want"):
        ShuffleConf(bad, use_env=False)


def test_rendezvous_failure_is_classified():
    """Nobody listens at the coordinator: the node raises the classified
    error the launcher retries on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = {"spark.shuffle.tpu.coordinator.address": f"127.0.0.1:{port}",
            "spark.shuffle.tpu.numProcesses": "2",
            "spark.shuffle.tpu.network.timeoutMs": "1500"}
    with pytest.raises(RuntimeError, match="RENDEZVOUS FAILED"):
        connect(conf, device="cpu", distributed=True, process_id=1,
                use_env=False)
    assert not tdist.is_initialized()


def test_launcher_fails_at_once_on_a_job_error():
    with pytest.raises(ClusterError, match="worker"):
        run_cluster("torch_cluster_jobs:no_such_job", 2, P, device="cpu",
                    timeout_s=60)


# -- integrity.verify=full across processes ----------------------------------
@pytest.fixture(scope="module")
def integrity_world():
    run = run_cluster("torch_cluster_jobs:integrity_suite", 2, P,
                      device="cpu", timeout_s=240)
    assert run.attempts in (1, 2) and run.returncodes == [0, 0]
    return run.results


def test_distributed_full_verify_table_matches_jax(integrity_world,
                                                   jax_flat):
    """Every process gathers the same digest tables, equal bit for bit to
    the JAX package's ``aggregate_digests`` over every map (words at and
    above 2**63 included), verifies its partitions against them, and the
    partial views hold the reference's read."""
    from sparkucx_tpu.shuffle import integrity as jinteg
    node, mgr = _jax_manager({"spark.shuffle.tpu.integrity.verify": "full"})
    try:
        h = jobs.write(mgr, 1, jobs.float_maps(), range(jobs.MAPS))
        want = {"full": jinteg.aggregate_digests(h.entry, jobs.MAPS, False),
                "key": jinteg.aggregate_digests(h.entry, jobs.MAPS, True)}
    finally:
        mgr.stop()
        node.close()
    want = {k: [int(x) for x in v] for k, v in want.items()}
    assert any(x >= 1 << 63 for x in want["full"] + want["key"])
    _check(_merged(integrity_world, "full"), jax_flat["plain"], "plain")
    for res in integrity_world:
        assert res["table"] == want
        integ, nbytes = res["full_report"]
        assert integ == "full" and nbytes > res["staged_bytes"]


def test_distributed_full_verify_skips_together(integrity_world,
                                                jax_flat):
    """One process lacking digest rows makes every process skip the
    post-exchange check (the staged verify still ran on each), and the
    read still delivers the reference's partitions."""
    _check(_merged(integrity_world, "lacking"), jax_flat["plain"], "plain")
    for res in integrity_world:
        assert res["lacking_table"] is False
        assert res["lacking_report"] == ["full", res["staged_bytes"]]



# -- the async plane across processes (shuffle/tenancy.py) --------------------
@pytest.fixture(scope="module")
def tenancy_world():
    run = run_cluster("torch_cluster_jobs:tenancy_suite", 2, P,
                      device="cpu", timeout_s=240)
    assert run.attempts in (1, 2) and run.returncodes == [0, 0]
    return run.results


def test_async_reads_across_processes_match_the_reference(tenancy_world,
                                                          jax_flat):
    """Six ``read_async`` reads on each of two processes (4 workers
    each): every read's partial views together hold the JAX package's
    read of the same maps, each report names its tenant and the width
    4, and the read after a divergent batch still runs."""
    for i in range(len(jobs.ASYNC_TENANTS)):
        _check(_merged(tenancy_world, f"read{i}"), jax_flat["plain"],
               "plain")
    _check(_merged(tenancy_world, "after"), jax_flat["plain"], "plain")
    for res in tenancy_world:
        assert res["tenants"] == list(jobs.ASYNC_TENANTS)
        assert res["async_workers"] == [4] * 6
        assert all(res["distributed"])


def test_async_execution_follows_the_agreed_order(tenancy_world):
    """Both processes ran the reads in the same order, and that order is
    the concatenation of the batches' agreed DRR orders (seqs 1..6 are
    the reads in submission order); each batch cost one async.batch and
    one async.order round, and every ticket's wait was observed."""
    a, b = tenancy_world
    assert a["orders"] == b["orders"] and a["ran"] == b["ran"]
    flat = [s - 1 for batch in a["orders"] for s in batch]
    assert flat[:len(jobs.ASYNC_TENANTS)] == a["ran"]
    assert sorted(a["ran"]) == list(range(6))
    lo = [i for i, t in enumerate(jobs.ASYNC_TENANTS) if t == "lo"]
    assert [i for i in a["ran"] if i in lo] == lo      # FIFO in a tenant
    for res in tenancy_world:
        assert res["rounds"]["async.order"] >= 1
        assert res["rounds"]["async.batch"] >= res["rounds"]["async.order"]
        assert res["turnstile_waits"]["count"] >= 6 + len(res["orders"])


def test_async_divergent_batch_fails_typed_on_every_process(
        tenancy_world):
    for res in tenancy_world:
        got = res["divergent"]
        assert got.startswith("AgreementDivergenceError"), got
        assert "async.order" in got and "asyncAgreedOrder" in got
        assert "process(es) [1]" in got or "process(es) [0]" in got


# -- the decision plane across processes (shuffle/decisions.py) ---------------
@pytest.fixture(scope="module")
def decisions_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("decisions")
    run = run_cluster("torch_cluster_jobs:decisions_suite", 2, P,
                      conf={"spark.shuffle.tpu.mesh.numSlices": "2",
                            "spark.shuffle.tpu.history.dir": str(d),
                            "spark.shuffle.tpu.trace.enabled": "true"},
                      device="cpu", timeout_s=240)
    assert run.attempts in (1, 2) and run.returncodes == [0, 0]
    return run.results, d


def test_decisions_ledgers_audit_clean_across_processes(decisions_world,
                                                        jax_flat):
    """Every agreement round each process closed is in its ledger (one
    record a counted round), both ``decisions_p<rank>.jsonl`` files
    align round by round with one topic and one winner digest, and the
    audit (both packages') finds nothing; the reads hold the
    reference's partitions."""
    from sparkucx_tpu.shuffle import decisions as jdec
    from sparkucx_tpu_torch.shuffle import decisions as tdec
    results, d = decisions_world
    _check(_merged(results, "waved"), jax_flat["plain"], "plain")
    _check(_merged(results, "tiered"), jax_flat["plain"], "plain")
    paths = tdec.decisions_files(str(d))
    assert paths == [str(d / "decisions_p0.jsonl"),
                     str(d / "decisions_p1.jsonl")]
    for res in results:
        assert res["ledger_path"] == paths[res["rank"]]
        assert res["records"] == res["rounds"] > 0
        assert {"a2a.waveRows", "a2a.waveSizes", "tier.crossRows",
                "hier.ici.overflow", "hier.dcn.overflow"} <= \
            set(res["topics"])
    ledgers = {p: tdec.load_decisions_file(path)
               for p, path in enumerate(paths)}
    rounds = tdec.align_rounds(ledgers)
    assert len(rounds) == results[0]["records"]
    for row in rounds:
        recs = row["records"]
        assert set(recs) == {0, 1}
        assert len({r["topic"] for r in recs.values()}) == 1
        assert len({r["winner"] for r in recs.values()}) == 1
        assert tdec.audit_round(row) is None
        assert jdec.audit_round(row) is None


def test_decisions_report_agreement_summary(decisions_world):
    """Each read's report carries the rounds it closed, equal on both
    processes, and so does the gathered report."""
    results, _ = decisions_world
    for key in ("waved_report", "tiered_report"):
        a, b = (res[key]["agreement"] for res in results)
        assert a["rounds"] == b["rounds"] > 0
        assert a["slowest_topic"] and a["divergent"] == 0
        assert results[0][key]["trace_id"] == results[1][key]["trace_id"]
    assert results[0]["waved_report"]["agreement"]["rounds"] >= 2
    assert results[0]["tiered_report"]["tiers"] == ["ici", "dcn"]
    for res in results:
        got = res["gathered_reports"]
        assert [g["process_id"] for g in got] == [0, 1]
        assert [g["agreement"]["rounds"] for g in got] == \
            [results[0]["tiered_report"]["agreement"]["rounds"]] * 2


def test_decisions_timeline_merges_both_workers(decisions_world):
    """``gather_spans`` plus the gathered clock anchors, through
    ``merge_timeline``: one document with one track a worker, each
    holding that worker's read spans, and with ``anatomy=True`` the
    phase child tracks of each worker's reads."""
    from sparkucx_tpu_torch.utils.export import merge_timeline
    results, _ = decisions_world
    spans = results[0]["spans"]
    assert spans == results[1]["spans"]
    anchors = {a["process_id"]: a for a in results[0]["anchors"]}
    assert sorted(anchors) == [0, 1]
    assert results[0]["anchors"] == results[1]["anchors"]
    docs = [dict(s, anchor=anchors[s["process_id"]]) for s in spans]
    doc = merge_timeline(docs)
    assert doc["metadata"]["processes"] == 2
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"process 0", "process 1"}
    for p in (0, 1):
        evs = [e for e in doc["traceEvents"]
               if e["pid"] == p and e["ph"] == "X"]
        got = {e["name"] for e in evs}
        assert {"shuffle.exchange", "shuffle.wave", "shuffle.tier",
                "shuffle.agree"} <= got
        traces = {e["args"].get("trace") for e in evs
                  if e["name"] == "shuffle.exchange"}
        assert traces == {results[0]["waved_report"]["trace_id"],
                          results[0]["tiered_report"]["trace_id"]}
        # the anatomy's child tracks tile each of the worker's reads
        tracks = [e for e in merge_timeline(docs, anatomy=True)
                  ["traceEvents"] if e["pid"] == p
                  and (e.get("args") or {}).get("anatomy")]
        assert {e["args"]["trace"] for e in tracks} == traces
