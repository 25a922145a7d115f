"""Port parity for the versioned-adapter seam
(``sparkucx_tpu_torch/compat/``): the 11 cases of ``tests/test_compat.py``
and the v2 cases held back from ``tests/test_slo.py``
(``test_v2_facade_slo_surface``), ``tests/test_doctor.py``
(``test_v2_facade_doctor``) and ``tests/test_tenancy.py``
(``test_v2_async_futures``).

Each case runs one script on the JAX package's ``connect`` (8 virtual CPU
devices, ``a2a.impl=dense``) and on the port's ``connect(device="cpu")``
(8 logical shards) from the same seeded numpy inputs, checks the
reference's assertions on both, and holds what the port observed (the
partitions' key multisets, raised texts, counters) against what the JAX
package observed. One difference is kept on purpose: the port compiles
nothing per shape, so every fetch wait — the cached readers' included —
lands in ``shuffle.read.wait_ms`` where the reference files a
compile-bearing dispatch's under ``first_wait_ms``."""

import numpy as np
import pytest

import sparkucx_tpu
import sparkucx_tpu_torch
from sparkucx_tpu.compat.v2 import ShuffleDependency as JDep
from sparkucx_tpu.compat.v2 import ShuffleServiceV2 as JV2
from sparkucx_tpu.service import ShuffleService as JV1
from sparkucx_tpu_torch.compat import ADAPTER_VERSIONS, resolve_adapter
from sparkucx_tpu_torch.compat.v2 import ShuffleDependency as TDep
from sparkucx_tpu_torch.compat.v2 import ShuffleServiceV2 as TV2
from sparkucx_tpu_torch.service import ShuffleService as TV1
from sparkucx_tpu_torch.shuffle.writer import hash32_np

PFX = "spark.shuffle.tpu."
SIDES = ["jax", "port"]


class Side:
    def __init__(self, name, tmp_path):
        self.name = name
        self.jax = name == "jax"
        self.Dep = JDep if self.jax else TDep
        self.V1 = JV1 if self.jax else TV1
        self.V2 = JV2 if self.jax else TV2
        self.base = {PFX + "a2a.impl": "dense",
                     PFX + "spill.dir": str(tmp_path / name),
                     PFX + "io.format": "raw"}

    def connect(self, extra=None):
        conf = {**self.base, **(extra or {})}
        if self.jax:
            return sparkucx_tpu.connect(conf, use_env=False)
        return sparkucx_tpu_torch.connect(conf, device="cpu", use_env=False)

    def v2(self, extra=None):
        return self.connect({PFX + "compat.version": "v2", **(extra or {})})


@pytest.fixture()
def both(mesh8, tmp_path):
    return [Side(n, tmp_path) for n in SIDES]


def _multisets(parts: dict) -> dict:
    return {int(r): np.sort(np.asarray(k)) for r, (k, _) in parts.items()}


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for r in a:
        np.testing.assert_array_equal(a[r], b[r])


def _errors(fn) -> str:
    try:
        fn()
    except Exception as e:  # the text is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


# -- tests/test_compat.py ----------------------------------------------------
def _run_v1(svc, rng, R=8, M=4, N=300):
    h = svc.register_shuffle(11, M, R)
    allk = []
    for m in range(M):
        keys = rng.integers(0, 1 << 31, size=N).astype(np.int64)
        svc.write(h, m, keys, keys.astype(np.int32).reshape(-1, 1))
        allk.append(keys)
    out = dict(svc.read(h).partitions())
    svc.unregister_shuffle(11)
    return np.concatenate(allk), out


def _run_v2(side, svc, rng, R=8, M=4, N=300):
    h = svc.register(side.Dep(shuffle_id=11, num_maps=M, num_partitions=R))
    allk = []
    for m in range(M):
        keys = rng.integers(0, 1 << 31, size=N).astype(np.int64)
        w = svc.writer(h, m, attempt_id=0)
        w.write(keys, keys.astype(np.int32).reshape(-1, 1))
        w.commit()
        allk.append(keys)
    out = dict(svc.reader(h))
    svc.unregister(11)
    return np.concatenate(allk), out


def test_same_workload_both_adapters(both):
    """Identical partitioning through both contracts, on both packages."""
    seen = []
    for side in both:
        with side.connect({PFX + "compat.version": "v1"}) as svc:
            assert isinstance(svc, side.V1)
            sent1, out1 = _run_v1(svc, np.random.default_rng(5))
        with side.v2() as svc:
            assert isinstance(svc, side.V2)
            sent2, out2 = _run_v2(side, svc, np.random.default_rng(5))
        np.testing.assert_array_equal(sent1, sent2)
        _same(_multisets(out1), _multisets(out2))
        seen.append(_multisets(out2))
    _same(*seen)


def test_default_version_is_v1(both):
    for side in both:
        with side.connect() as svc:
            assert isinstance(svc, side.V1)
    assert ADAPTER_VERSIONS == ("v1", "v2")
    assert resolve_adapter(" V2 ") is TV2


def test_unknown_version_rejected_at_connect(both):
    texts = []
    for side in both:
        with pytest.raises(ValueError, match="compat.version") as ei:
            side.connect({PFX + "compat.version": "v9"})
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


def test_v2_partition_range_reader(both):
    seen = []
    for side in both:
        with side.v2() as svc:
            R, M, N = 8, 2, 200
            h = svc.register(side.Dep(12, M, R))
            rng = np.random.default_rng(7)
            for m in range(M):
                w = svc.writer(h, m)
                w.write(rng.integers(0, 1 << 31, size=N).astype(np.int64))
                w.commit()
            got = svc.reader(h, 2, 5).batch()
            assert set(got) == {2, 3, 4}
            for r, (k, v) in got.items():
                assert (hash32_np(np.asarray(k)) % np.uint32(R) == r).all()
            err = _errors(lambda: svc.reader(h, 5, R + 1))
            assert err.startswith("IndexError")
            seen.append((_multisets(got), err))
            svc.unregister(12)
    _same(seen[0][0], seen[1][0])
    assert seen[0][1] == seen[1][1]


def test_v2_dependency_declares_aggregation(both):
    """The combine spec rides in the dependency; reads execute it."""
    for side in both:
        with side.v2() as svc:
            R, M = 4, 2
            h = svc.register(side.Dep(13, M, R, combine="sum"))
            for m in range(M):
                w = svc.writer(h, m)
                keys = np.repeat(np.arange(20, dtype=np.int64), 5)
                w.write(keys, np.ones((keys.size, 1), np.int32))
                w.commit()
            total = {}
            for r, (k, v) in svc.reader(h):
                assert k.size == np.unique(k).size, "combine must dedupe"
                for key, s in zip(k, v[:, 0]):
                    total[int(key)] = int(s)
            assert total == {k: 10 for k in range(20)}
            svc.unregister(13)


def _first_commit_script(side, svc):
    h = svc.register(side.Dep(14, 2, 4))
    w0 = svc.writer(h, 0, attempt_id=0)
    w0.write(np.arange(10, dtype=np.int64))
    w1 = svc.writer(h, 0, attempt_id=1)
    w1.write(np.arange(10, 20, dtype=np.int64))
    w1.commit()
    stale = _errors(lambda: svc.writer(h, 0, attempt_id=0))
    newer = _errors(lambda: svc.writer(h, 0, attempt_id=2))
    w = svc.writer(h, 1, attempt_id=0)
    w.write(np.arange(5, dtype=np.int64))
    w.commit()
    seen = np.sort(np.concatenate([k for _, (k, _) in svc.reader(h)]))
    svc.unregister(14)
    return stale, newer, seen


def test_v2_attempts_first_commit_wins(both):
    got = []
    for side in both:
        with side.v2() as svc:
            stale, newer, seen = _first_commit_script(side, svc)
        assert "stale attempt" in stale
        assert "first commit" in newer
        np.testing.assert_array_equal(
            seen, np.sort(np.concatenate([np.arange(10, 20),
                                          np.arange(5)])))
        got.append((stale, seen))
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_v2_failed_lease_does_not_advance_watermark(both):
    """A rejected writer lease must not advance the attempt watermark."""
    texts = []
    for side in both:
        with side.v2() as svc:
            h = svc.register(side.Dep(15, 1, 4))
            w = svc.writer(h, 0, attempt_id=1)
            w.write(np.arange(8, dtype=np.int64))
            w.commit()
            t7 = _errors(lambda: svc.writer(h, 0, attempt_id=7))
            t2 = _errors(lambda: svc.writer(h, 0, attempt_id=2))
            t0 = _errors(lambda: svc.writer(h, 0, attempt_id=0))
            assert "first commit" in t7 and "first commit" in t2
            assert "attempt 1 already ran" in t0
            texts.append(t0)
            svc.unregister(15)
    assert texts[0] == texts[1]


def test_v2_superseded_attempt_cannot_publish(both):
    """A superseded attempt committing late raises instead of publishing
    an empty size row; the real attempt's rows are what readers see."""
    for side in both:
        with side.v2() as svc:
            h = svc.register(side.Dep(16, 1, 4))
            w0 = svc.writer(h, 0, attempt_id=0)
            w0.write(np.arange(10, dtype=np.int64))
            w1 = svc.writer(h, 0, attempt_id=1)
            w1.write(np.arange(10, 20, dtype=np.int64))
            w1.commit()
            with pytest.raises(RuntimeError, match="released"):
                w0.commit()
            with pytest.raises(RuntimeError, match="released"):
                w0.write(np.arange(3, dtype=np.int64))
            keys = np.sort(np.concatenate(
                [k for _, (k, _) in svc.reader(h)]))
            np.testing.assert_array_equal(keys, np.arange(10, 20))
            svc.unregister(16)


def test_v2_equal_attempt_rellease_rejected(both):
    """Re-leasing the same live attempt id is rejected; a committed
    equal attempt reports first-commit-wins."""
    texts = []
    for side in both:
        with side.v2() as svc:
            h = svc.register(side.Dep(17, 2, 4))
            w = svc.writer(h, 0, attempt_id=3)
            w.write(np.arange(5, dtype=np.int64))
            live = _errors(lambda: svc.writer(h, 0, attempt_id=3))
            assert "live writer lease" in live
            w.commit()
            assert w.committed
            done = _errors(lambda: svc.writer(h, 0, attempt_id=3))
            assert "already committed" in done
            w2 = svc.writer(h, 1, attempt_id=0)
            w2.write(np.arange(2, dtype=np.int64))
            w2.commit()
            texts.append(live)
            svc.unregister(17)
    assert texts[0] == texts[1]


def test_v2_partition_readers_share_one_exchange(both):
    """N range readers of one shuffle run one exchange; unregister drops
    the cached result."""
    seen = []
    for side in both:
        with side.v2() as svc:
            R, M = 8, 4
            h = svc.register(side.Dep(18, M, R))
            rng = np.random.default_rng(5)
            staged = []
            for m in range(M):
                w = svc.writer(h, m)
                keys = rng.integers(0, 1 << 31, size=200).astype(np.int64)
                staged.append(keys)
                w.write(keys)
                w.commit()
            reads0 = svc.node.metrics.get("shuffle.read.count")
            parts = {}
            for r in range(R):
                for rr, kv in svc.reader(h, r, r + 1):
                    parts[rr] = kv
            assert sorted(parts) == list(range(R))
            np.testing.assert_array_equal(
                np.sort(np.concatenate([k for k, _ in parts.values()])),
                np.sort(np.concatenate(staged)))
            assert svc.node.metrics.get("shuffle.read.count") - reads0 == 1
            assert svc.node.metrics.get("shuffle.read.cached.count") \
                == R - 1
            svc.unregister(18)
            assert 18 not in svc._results
            seen.append(_multisets(parts))
    _same(*seen)


def test_v2_cached_readers_record_their_own_fetch_wait(both):
    """Each PartitionReader records its own fetch wait: N readers give N
    observations over one exchange. The reference files all of them
    under ``first_wait_ms`` when its dispatch compiled; the port, which
    compiles nothing, under ``wait_ms``."""
    from sparkucx_tpu.shuffle.stepcache import GLOBAL_STEP_CACHE
    from sparkucx_tpu.utils import metrics as jm
    from sparkucx_tpu_torch.utils import metrics as tm
    GLOBAL_STEP_CACHE.clear()
    for side in both:
        m = jm if side.jax else tm
        with side.v2() as svc:
            R, M = 8, 2
            h = svc.register(side.Dep(19, M, R))
            rng = np.random.default_rng(7)
            for mi in range(M):
                w = svc.writer(h, mi)
                w.write(rng.integers(0, 1 << 31, size=100).astype(np.int64))
                w.commit()
            for r in range(R):
                list(svc.reader(h, r, r + 1))
            first = svc.node.metrics.histogram(m.H_FETCH_FIRST)
            wait = svc.node.metrics.histogram(m.H_FETCH_WAIT)
            counts = [0 if x is None else x.count for x in (first, wait)]
            assert counts == ([R, 0] if side.jax else [0, R])
            assert svc.node.metrics.get("shuffle.read.cached.count") \
                == R - 1
            assert svc.node.metrics.get("shuffle.read.count") == 1
            svc.unregister(19)


# -- the v2 cases held back from the slo, doctor and tenancy suites ----------
def test_v2_facade_slo_surface(both):
    docs = []
    for side in both:
        with side.v2({PFX + "slo.read.p99Ms": "500"}) as svc:
            assert type(svc).__name__ == "ShuffleServiceV2"
            v = svc.slo()
            assert v["healthy"] and v["objectives"][0]["target"] == 0.99
            assert "slo.read.p99Ms" in svc.slo("text")
            docs.append([(o["objective"], o["target"])
                         for o in v["objectives"]])
    assert docs[0] == docs[1]


def test_v2_facade_doctor(both):
    """v2 exposes the same doctor() as v1, on both packages."""
    for side in both:
        rng = np.random.default_rng(3)
        with side.v2() as svc:
            assert isinstance(svc, side.V2)
            h = svc.register(side.Dep(31, 2, 4))
            for m in range(2):
                w = svc.writer(h, m, attempt_id=0)
                w.write(rng.integers(0, 1 << 30, size=32, dtype=np.int64))
                w.commit()
            list(svc.reader(h))
            assert isinstance(svc.doctor(), list)
            assert svc.doctor("text").startswith("doctor:")
            assert isinstance(svc.stats("prometheus"), str)


def test_v2_async_futures(both):
    got = []
    for side in both:
        with side.v2({PFX + "a2a.maxBytesInFlight": "1"}) as svc:
            rng = np.random.default_rng(4)
            dep = side.Dep(shuffle_id=5, num_maps=2, num_partitions=8,
                           tenant="bob")
            h = svc.register(dep)
            assert h.tenant == "bob"
            keys = rng.integers(0, 1 << 30, 600).astype(np.int64)
            for m in range(2):
                w = svc.writer(h, m)
                w.write(keys[m * 300:(m + 1) * 300])
                w.commit()
            batch = svc.read_async(h).result(timeout=60)
            flat = np.sort(np.concatenate([kv[0] for kv in batch.values()]))
            np.testing.assert_array_equal(flat, np.sort(keys))
            res = svc.submit_async(h).result(timeout=60)
            assert res is not None
            assert svc.manager.report(5).tenant == "bob"
            got.append(_multisets(batch))
    _same(*got)


# -- the port's own seams ----------------------------------------------------
def test_v2_refuses_arrow_and_read_device_on_a_host_pin(both):
    for side in both:
        with pytest.raises(ValueError, match="io.format=raw only"):
            side.v2({PFX + "io.format": "arrow"})
    side = both[1]
    with side.v2({PFX + "read.sink": "host"}) as svc:
        h = svc.register(side.Dep(40, 1, 4))
        with pytest.raises(RuntimeError, match="host sink"):
            svc.read_device(h)
        svc.unregister(40)
        with pytest.raises(KeyError, match="not registered"):
            svc.reader(h)


def test_v2_read_device_matches_the_shared_read(both):
    """The port's read_device: the device result's host view holds the
    rows the range readers see (both packages' readers equal)."""
    side = both[1]
    rng = np.random.default_rng(9)
    with side.v2() as svc:
        h = svc.register(side.Dep(42, 3, 8))
        for m in range(3):
            w = svc.writer(h, m)
            k = rng.integers(0, 1 << 40, size=150).astype(np.int64)
            w.write(k, rng.integers(0, 9, size=(150, 2)).astype(np.int32))
            w.commit()
        res = svc.read_device(h)
        assert res.sink == "device"
        view = res.host_view()
        dev = {r: view.partition(r) for r in range(8)}
        _same(_multisets(dev), _multisets(dict(svc.reader(h))))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_metrics_reporter_sees_the_read_counters(both, version):
    """``connect(metrics_reporter=fn)``: ``fn(name, value)`` sees every
    counter increment of the facade's reads, on both packages, and is
    detached at ``stop``."""
    names = []
    for side in both:
        seen = []
        conf = {**side.base, PFX + "compat.version": version}
        fn = lambda n, v, _s=seen: _s.append(n)  # noqa: E731
        svc = sparkucx_tpu.connect(conf, use_env=False, metrics_reporter=fn) \
            if side.jax else sparkucx_tpu_torch.connect(
                conf, device="cpu", use_env=False, metrics_reporter=fn)
        try:
            rng = np.random.default_rng(2)
            if version == "v1":
                h = svc.register_shuffle(3, 1, 4)
                svc.write(h, 0, rng.integers(0, 1 << 30, size=40))
                svc.read(h).partition(0)
            else:
                h = svc.register(side.Dep(3, 1, 4))
                w = svc.writer(h, 0)
                w.write(rng.integers(0, 1 << 30, size=40))
                w.commit()
                list(svc.reader(h, 0, 2))
                list(svc.reader(h, 2, 4))
        finally:
            svc.stop()
        assert "shuffle.read.count" in seen
        n = len(seen)
        svc.node.metrics.inc("shuffle.read.count", 1)
        assert len(seen) == n, "the reporter outlived stop()"
        names.append("shuffle.read.cached.count" in seen)
    assert names == [version == "v2"] * 2
