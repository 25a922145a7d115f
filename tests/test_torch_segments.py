"""Port parity: the segment-table codec is byte-identical with the JAX
package's, the torch ``exchange_plan`` matches the JAX one per device,
and the interop module carries a reference table + rows across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as PS

from sparkucx_tpu.meta import segments as jref
from sparkucx_tpu_torch import interop
from sparkucx_tpu_torch.meta import segments as tport


@pytest.mark.parametrize("R", [1, 7, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_record_bytes_identical(R, seed):
    rng = np.random.default_rng(seed * 100 + R)
    sizes = rng.integers(0, 1 << 40, size=R).astype(np.uint64)
    a = jref.pack_record(5 + seed, sizes)
    b = tport.pack_record(5 + seed, sizes)
    assert a == b
    assert tport.record_size(R) == jref.record_size(R) == len(a)
    mid, got = tport.unpack_record(a)
    assert mid == 5 + seed
    np.testing.assert_array_equal(got, sizes)


@pytest.mark.parametrize("M,R", [(1, 1), (4, 16), (64, 200)])
def test_table_pack_identical_and_crosses(M, R):
    rng = np.random.default_rng(M * R)
    sizes = rng.integers(0, 5000, size=(M, R)).astype(np.uint64)
    sizes[0] = 0                                     # an empty map output
    blob_j = jref.SegmentTable(sizes).pack()
    blob_t = tport.SegmentTable(sizes).pack()
    assert blob_j == blob_t
    back = tport.SegmentTable.unpack(blob_j, M, R)
    np.testing.assert_array_equal(back.sizes, sizes)
    np.testing.assert_array_equal(back.offsets,
                                  jref.SegmentTable(sizes).offsets)
    assert back.block_extent(M - 1, R - 1) == \
        jref.SegmentTable(sizes).block_extent(M - 1, R - 1)


@pytest.mark.parametrize("corrupt", ["magic", "crc", "truncated"])
def test_corrupt_records_rejected_alike(corrupt):
    buf = bytearray(jref.pack_record(3, np.arange(6, dtype=np.uint64)))
    if corrupt == "magic":
        buf[0] ^= 0xFF
    elif corrupt == "crc":
        buf[-1] ^= 0xFF
    else:
        buf = buf[:10]
    for mod in (jref, tport):
        with pytest.raises(ValueError):
            mod.unpack_record(bytes(buf))


def test_validate_row_sizes_alike():
    ok = np.full((4, 4), 1000, np.uint64)
    bad = np.full((4, 4), 1 << 30, np.uint64)
    jref.validate_row_sizes(ok)
    tport.validate_row_sizes(ok)
    for mod in (jref, tport):
        with pytest.raises(ValueError):
            mod.validate_row_sizes(bad)


def test_device_matrix_identical():
    rng = np.random.default_rng(4)
    sizes = rng.integers(0, 100, size=(10, 16)).astype(np.uint64)
    m2d = np.arange(10) % 8
    r2d = np.repeat(np.arange(8), 2)
    np.testing.assert_array_equal(
        tport.SegmentTable(sizes).device_matrix(m2d, r2d, 8),
        jref.SegmentTable(sizes).device_matrix(m2d, r2d, 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_exchange_plan_matches_per_device(mesh8, seed):
    n = 8
    sizes = np.random.default_rng(seed).integers(0, 300, (n, n)) \
        .astype(np.int32)
    mesh = Mesh(np.array(jax.devices()), ("x",))
    fn = jax.jit(jax.shard_map(
        lambda s: tuple(o.reshape(1, -1)
                        for o in jref.exchange_plan(s[0], "x")),
        mesh=mesh, in_specs=(PS("x"),), out_specs=(PS("x"),) * 5,
        check_vma=False))
    want = [np.asarray(o) for o in fn(jnp.asarray(sizes))]
    got = [t.numpy() for t in tport.exchange_plan(torch.from_numpy(sizes))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.reshape(w.shape), w)


@pytest.mark.parametrize("as_bytes", [False, True])
def test_interop_from_reference(as_bytes):
    rng = np.random.default_rng(9)
    sizes = rng.integers(0, 50, size=(3, 5)).astype(np.uint64)
    blob = jref.SegmentTable(sizes).pack()
    rows = rng.integers(-100, 100, size=(2, 16, 4)).astype(np.int32)
    table, t = interop.from_reference(
        blob, 3, 5, rows.tobytes() if as_bytes else rows, width=4,
        device="cpu")
    np.testing.assert_array_equal(table.sizes, sizes)
    np.testing.assert_array_equal(t.numpy().reshape(rows.shape), rows)
    conf = interop.conf_from_dict(
        {"spark.shuffle.tpu.a2a.impl": "dense",
         "spark.shuffle.tpu.a2a.capacityFactor": "1.5",
         "spark.shuffle.tpu.a2a.waveRows": "0"})     # unread keys pass
    assert conf.a2a_impl == "dense" and conf.capacity_factor == 1.5
