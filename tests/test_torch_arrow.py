"""Port parity for the Arrow columnar ingress/egress
(``sparkucx_tpu_torch/io/arrow.py``, ``io.format=arrow`` on the service,
the pipelines' ``arrow=True`` legs): the arrow cases of
``tests/test_io.py`` and the arrow-ingress case of
``tests/test_workloads.py``, held against the JAX package.

Codec cases compare ``batch_to_kv``'s arrays with the reference's bit
for bit (keys, the int64 / native carriers and the varlen lanes, a
sliced and a ``large_string`` column included) and the rebuilt batches
column for column. Shuffle cases run one script on the JAX package's
``dense`` manager (8 virtual CPU devices) and on a port manager
(``connect(device="cpu")``, 8 logical shards) with the same seeded
inputs, and compare the returned batches' rows as multisets."""

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import sparkucx_tpu  # noqa: E402
from sparkucx_tpu.io import arrow as jarrow  # noqa: E402
from sparkucx_tpu_torch import connect  # noqa: E402
from sparkucx_tpu_torch.io import arrow as tarrow  # noqa: E402
from sparkucx_tpu_torch.io.varlen import (unpack_varbytes,  # noqa: E402
                                          varbytes_width)

PFX = "spark.shuffle.tpu."
SIDES = ["jax", "port"]


@pytest.fixture()
def managers(mesh8):
    """One fresh manager per package (``a2a.impl=dense``)."""
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.runtime.node import TpuNode
    from sparkucx_tpu.shuffle.manager import TpuShuffleManager
    conf = TpuShuffleConf({PFX + "a2a.impl": "dense"}, use_env=False)
    node = TpuNode.start(conf)
    jm = TpuShuffleManager(node, conf)
    svc = connect({PFX + "a2a.impl": "dense"}, device="cpu", use_env=False)
    yield {"jax": jm, "port": svc.manager}
    jm.stop()
    node.close()
    svc.stop()


def mod(side):
    return jarrow if side == "jax" else tarrow


def _same_kv(a, b):
    ka, va, ra = a
    kb, vb, rb = b
    np.testing.assert_array_equal(ka, kb)
    assert ka.dtype == kb.dtype
    if va is None:
        assert vb is None
    else:
        assert va.dtype == vb.dtype and va.shape == vb.shape
        np.testing.assert_array_equal(va.view(np.uint8), vb.view(np.uint8))
    assert ra == rb


def _rows_of(batches):
    """Every row of every batch as a sorted list of tuples."""
    out = []
    for b in batches:
        cols = [b.column(i).to_pylist() for i in range(b.num_columns)]
        out.extend(zip(*cols))
    return sorted(out, key=repr)


# -- tests/test_io.py's arrow cases ------------------------------------------
def test_batch_kv_roundtrip(rng):
    keys = rng.integers(0, 1 << 40, size=32).astype(np.int64)
    a = rng.normal(size=32)
    b = rng.integers(0, 100, size=32).astype(np.int64)
    batch = pa.RecordBatch.from_arrays(
        [pa.array(keys), pa.array(a), pa.array(b)], names=["k", "a", "b"])
    got = tarrow.batch_to_kv(batch, "k")
    _same_kv(got, jarrow.batch_to_kv(batch, "k"))
    k, v, dtypes = got
    np.testing.assert_array_equal(k, keys)
    back = tarrow.kv_to_batch(k, v, "k", ["a", "b"], dtypes)
    np.testing.assert_array_equal(back.column("a").to_numpy(), a)
    np.testing.assert_array_equal(back.column("b").to_numpy(), b)
    assert back.schema.field("a").type == pa.float64()
    assert back.schema.field("b").type == pa.int64()
    assert back.equals(jarrow.kv_to_batch(k, v, "k", ["a", "b"], dtypes))


def test_batch_kv_bit_exact_large_int64():
    """int64 values beyond 2^53 survive bit-exactly (a float64 carrier
    would round them)."""
    ts = np.array([1_700_000_000_123_456_789, (1 << 62) + 1, -7],
                  dtype=np.int64)
    keys = np.arange(3, dtype=np.int64)
    batch = pa.RecordBatch.from_arrays(
        [pa.array(keys), pa.array(ts)], names=["k", "ts"])
    got = tarrow.batch_to_kv(batch, "k")
    _same_kv(got, jarrow.batch_to_kv(batch, "k"))
    back = tarrow.kv_to_batch(got[0], got[1], "k", ["ts"], got[2])
    np.testing.assert_array_equal(back.column("ts").to_numpy(), ts)


def test_batch_kv_validation():
    batch = pa.RecordBatch.from_arrays(
        [pa.array(["x", "y"]), pa.array([1.0, 2.0])], names=["k", "v"])
    for m in (jarrow, tarrow):
        with pytest.raises(TypeError):
            m.batch_to_kv(batch, "k")
        with pytest.raises(KeyError):
            m.batch_to_kv(batch, "missing")


def test_arrow_shuffle_end_to_end(managers):
    """Columnar in -> shuffle -> columnar out, the same rows on both."""
    seen = []
    for side in SIDES:
        m, mgr = mod(side), managers[side]
        rng = np.random.default_rng(0)
        h = mgr.register_shuffle(9200, 4, 8)
        truth = {}
        for mi in range(4):
            keys = rng.integers(0, 200, size=100).astype(np.int64)
            vals = rng.normal(size=100)
            batch = pa.RecordBatch.from_arrays(
                [pa.array(keys), pa.array(vals)], names=["key", "score"])
            m.write_batches(mgr, h, mi, [batch], "key")
            for k, v in zip(keys, vals):
                truth.setdefault(int(k), []).append(v)
        batches = m.read_batches(mgr, h, "key", ["score"])
        rows = 0
        for b in batches:
            for k, v in zip(b.column("key").to_numpy(),
                            b.column("score").to_numpy()):
                assert any(np.isclose(v, c) for c in truth[int(k)])
            rows += b.num_rows
        assert rows == 400
        seen.append(_rows_of(batches))
        mgr.unregister_shuffle(9200)
    assert seen[0] == seen[1]


def test_arrow_native_carrier_combine(managers):
    """Uniform int32 value columns ride the native carrier, so the arrow
    read combines by key on the device."""
    seen = []
    for side in SIDES:
        m, mgr = mod(side), managers[side]
        rng = np.random.default_rng(5)
        h = mgr.register_shuffle(70, 2, 8)
        truth = {}
        for mid in range(2):
            ks = rng.integers(0, 40, size=500).astype(np.int64)
            a = rng.integers(0, 100, size=500).astype(np.int32)
            b = rng.integers(0, 100, size=500).astype(np.int32)
            batch = pa.RecordBatch.from_arrays(
                [pa.array(ks), pa.array(a), pa.array(b)],
                names=["key", "a", "b"])
            m.write_batches(mgr, h, mid, [batch], "key")
            for k, x, y in zip(ks.tolist(), a.tolist(), b.tolist()):
                ta, tb = truth.get(k, (0, 0))
                truth[k] = (ta + x, tb + y)
        out = m.read_batches(mgr, h, combine="sum")
        got = {}
        for bt in out:
            assert bt.schema.names == ["key", "a", "b"]
            keys = bt.column("key").to_pylist()
            assert keys == sorted(keys)
            for k, x, y in zip(keys, bt.column("a").to_pylist(),
                               bt.column("b").to_pylist()):
                assert k not in got
                got[k] = (x, y)
        assert got == truth
        seen.append(_rows_of(out))
        mgr.unregister_shuffle(70)
    assert seen[0] == seen[1]


def test_arrow_combine_rejected_for_widened_schema(managers):
    texts = []
    for side in SIDES:
        m, mgr = mod(side), managers[side]
        h = mgr.register_shuffle(71, 1, 4)
        batch = pa.RecordBatch.from_arrays(
            [pa.array(np.arange(4, dtype=np.int64)),
             pa.array(np.arange(4, dtype=np.int64))], names=["key", "v"])
        m.write_batches(mgr, h, 0, [batch], "key")
        with pytest.raises(ValueError, match="native 4-byte carrier") as ei:
            m.read_batches(mgr, h, combine="sum")
        texts.append(str(ei.value))
        mgr.unregister_shuffle(71)
    assert texts[0] == texts[1]


def test_arrow_native_carrier_roundtrip_plain(managers):
    """float32 columns in, float32 out, exact bits, on a plain read."""
    seen = []
    for side in SIDES:
        m, mgr = mod(side), managers[side]
        rng = np.random.default_rng(6)
        h = mgr.register_shuffle(72, 1, 4)
        ks = rng.integers(0, 1 << 30, size=200).astype(np.int64)
        v = rng.standard_normal(200).astype(np.float32)
        batch = pa.RecordBatch.from_arrays(
            [pa.array(ks), pa.array(v)], names=["key", "v"])
        m.write_batches(mgr, h, 0, [batch], "key")
        truth = dict(zip(ks.tolist(), v.tolist()))
        out = m.read_batches(mgr, h)
        seen_n = 0
        for bt in out:
            assert bt.schema.field("v").type == pa.float32()
            for k, x in zip(bt.column("key").to_pylist(),
                            bt.column("v").to_pylist()):
                assert truth[k] == x
                seen_n += 1
        assert seen_n == len(truth)
        seen.append(_rows_of(out))
        mgr.unregister_shuffle(72)
    assert seen[0] == seen[1]


def test_arrow_varlen_zero_copy_slice_and_large_string():
    """A string column's lanes equal the reference's bit for bit: whole,
    sliced (re-based offsets) and as ``large_string``."""
    rng = np.random.default_rng(7)
    strs = ["".join(map(chr, rng.integers(97, 123, size=int(n))))
            for n in rng.integers(0, 24, size=2000)]
    strs[0] = ""
    col = pa.array(strs, type=pa.string())
    rows, recipe = tarrow._encode_varlen_col(col, "c", 24)
    jrows, jrecipe = jarrow._encode_varlen_col(col, "c", 24)
    np.testing.assert_array_equal(rows, jrows)
    assert recipe == jrecipe and recipe[0] == "utf8"
    w = varbytes_width(24)
    back = unpack_varbytes(
        rows.view(np.uint8).reshape(rows.shape[0], -1)[:, :w])
    assert [b.decode() for b in back] == strs
    rows_sl, _ = tarrow._encode_varlen_col(col.slice(100, 500), "c", 24)
    rows_fresh, _ = tarrow._encode_varlen_col(
        pa.array(strs[100:600], type=pa.string()), "c", 24)
    np.testing.assert_array_equal(rows_sl, rows_fresh)
    rows_lg, _ = tarrow._encode_varlen_col(
        pa.array(strs, type=pa.large_string()), "c", 24)
    np.testing.assert_array_equal(rows_lg, rows)


# -- codec parity over mixed schemas -----------------------------------------
SCHEMAS = {
    "int32_native": lambda rng, n: {
        "a": pa.array(rng.integers(-9, 9, n).astype(np.int32)),
        "b": pa.array(rng.integers(-9, 9, n).astype(np.int32))},
    "float32_native": lambda rng, n: {
        "f": pa.array(rng.standard_normal(n).astype(np.float32))},
    "mixed_widened": lambda rng, n: {
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "u32": pa.array(rng.integers(0, 1 << 32, n).astype(np.uint32)),
        "f16": pa.array(rng.standard_normal(n).astype(np.float16)),
        "f64": pa.array(rng.standard_normal(n))},
    "strings_binary": lambda rng, n: {
        "s": pa.array([f"row{i}-" + "z" * int(i % 17) for i in range(n)]),
        "blob": pa.array([bytes([i % 256]) * int(i % 9) for i in range(n)],
                         type=pa.binary()),
        "x": pa.array(rng.integers(0, 1 << 40, n))},
    "keys_only": lambda rng, n: {},
}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_batch_to_kv_bit_equal_to_reference(schema):
    rng = np.random.default_rng(len(schema))
    n = 257
    cols = {"key": pa.array(rng.integers(-(1 << 62), 1 << 62, n))}
    cols.update(SCHEMAS[schema](rng, n))
    batch = pa.record_batch(cols)
    got = tarrow.batch_to_kv(batch, "key", string_max_bytes=40)
    _same_kv(got, jarrow.batch_to_kv(batch, "key", string_max_bytes=40))
    names = [c for c in cols if c != "key"]
    back = tarrow.kv_to_batch(got[0], got[1], "key", names or None,
                              got[2] or None)
    assert back.equals(batch)


# -- the service under io.format=arrow ---------------------------------------
def test_service_arrow_format_matches_reference(mesh8, tmp_path):
    """``connect`` under ``io.format=arrow``: ``write`` takes batches,
    ``read`` returns one batch per non-empty partition, the same rows on
    both packages; ``sink="device"`` is refused; the port's default stays
    ``raw``."""
    conf = {PFX + "a2a.impl": "dense", PFX + "io.format": "arrow",
            PFX + "io.keyColumn": "id", PFX + "io.stringMaxBytes": "12"}
    seen = []
    for side in SIDES:
        rng = np.random.default_rng(3)
        svc = sparkucx_tpu.connect(conf, use_env=False) if side == "jax" \
            else connect(conf, device="cpu", use_env=False)
        try:
            assert svc.io_format == "arrow" and svc.key_column == "id"
            h = svc.register_shuffle(5, 3, 6)
            for m in range(3):
                n = 40 + m
                svc.write(h, m, [pa.record_batch({
                    "id": pa.array(rng.integers(0, 1 << 20, n)),
                    "name": pa.array([f"n{i % 7}" * 2 for i in range(n)]),
                    "w": pa.array(rng.standard_normal(n))})])
            out = svc.read(h)
            assert all(isinstance(b, pa.RecordBatch) for b in out)
            assert sum(b.num_rows for b in out) == 123
            with pytest.raises(ValueError, match="sink='device'"):
                svc.read(h, sink="device")
            seen.append(_rows_of(out))
        finally:
            svc.stop()
    assert seen[0] == seen[1]
    with connect({PFX + "a2a.impl": "dense"}, device="cpu",
                 use_env=False) as svc:
        assert svc.io_format == "raw"
    with pytest.raises(ValueError, match="unknown io.format"):
        connect({PFX + "io.format": "parquet"}, device="cpu", use_env=False)


def test_require_arrow_names_the_missing_dependency(monkeypatch):
    monkeypatch.setattr(tarrow, "HAVE_ARROW", False)
    with pytest.raises(RuntimeError, match="pyarrow is not available"):
        tarrow.batch_to_kv(None, "key")
    with pytest.raises(RuntimeError, match="pyarrow is not available"):
        connect({PFX + "io.format": "arrow"}, device="cpu", use_env=False)


# -- the pipelines' arrow legs -----------------------------------------------
@pytest.fixture(scope="module")
def port_svc():
    svc = connect({PFX + "a2a.impl": "dense"}, device="cpu", num_shards=8,
                  use_env=False)
    yield svc
    svc.stop()


def _pipeline_both(dense_manager, port_svc, tmp_path, module, fn, kw):
    import importlib

    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.shuffle.manager import TpuShuffleManager
    from sparkucx_tpu_torch.config import ShuffleConf
    from sparkucx_tpu_torch.shuffle.manager import ShuffleManager
    reps = []
    for pkg in ("sparkucx_tpu", "sparkucx_tpu_torch"):
        cm = {PFX + "a2a.impl": "dense", PFX + "spill.threshold": "8192",
              PFX + "a2a.waveRows": "1024", PFX + "a2a.waveDepth": "2",
              PFX + "spill.dir": str(tmp_path / pkg)}
        m = TpuShuffleManager(dense_manager.node,
                              TpuShuffleConf(cm, use_env=False)) \
            if pkg == "sparkucx_tpu" else \
            ShuffleManager(port_svc.node, ShuffleConf(cm, use_env=False))
        try:
            run = getattr(importlib.import_module(
                f"{pkg}.workloads.{module}"), fn)
            reps.append(run(m, **kw))
        finally:
            m.stop()
    return reps


def test_groupby_external_arrow_ingress(dense_manager, port_svc, tmp_path):
    """Arrow ingress: chunks arrive as RecordBatches and stage through
    ``stage_batches`` on the native int32 carrier; the same exact oracle
    and aggregates as the reference."""
    kw = dict(budget_bytes=64 << 10, total_rows=3072, key_space=100,
              num_partitions=8, chunk_rows=1024, sink="host",
              warm_reads=0, arrow=True, shuffle_id=9514)
    want, got = _pipeline_both(dense_manager, port_svc, tmp_path,
                               "groupby", "groupby_pipeline", kw)
    assert got.oracle_ok and got.extra["arrow_ingress"]
    assert got.spill_bytes > 0
    for k in ("distinct_keys", "truth_distinct", "value_sum", "truth_sum",
              "arrow_ingress"):
        assert got.extra[k] == want.extra[k], k
    assert got.rows_out == want.rows_out


def test_terasort_pipeline_arrow_egress(dense_manager, port_svc, tmp_path):
    """Arrow egress: every emitted chunk built into a batch; the same
    buffer bytes and verdict as the reference."""
    kw = dict(budget_bytes=64 << 10, total_rows=8192, num_partitions=8,
              chunk_rows=2048, arrow=True, shuffle_id=9520)
    want, got = _pipeline_both(dense_manager, port_svc, tmp_path,
                               "terasort", "terasort_pipeline", kw)
    assert got.oracle_ok and want.oracle_ok
    assert got.extra["arrow_egress_bytes"] \
        == want.extra["arrow_egress_bytes"] == 8192 * 8
    assert got.rows_out == want.rows_out
