"""Port parity for ``io/dlpack`` (the JAX package's
``sparkucx_tpu/io/dlpack.py``): the DLPack round trips, the
``ingest_foreign`` ladder (zero copy, the producer's host copy through a
pinned pool block, the TypeError) and the host-to-device on-ramp, on the
CPU. Values are held exactly (every path copies or aliases bytes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.io import dlpack as jdl
from sparkucx_tpu_torch.io import dlpack as tdl
from sparkucx_tpu_torch.runtime.node import HostStagingPool


class ForeignDevice:
    """A producer whose capsule the consumer rejects (the cross-device
    case) but which can copy itself to the host."""

    def __init__(self, t):
        self._t = t

    def __dlpack__(self, **kw):
        raise RuntimeError("cross-device capsule rejected")

    def __dlpack_device__(self):
        return (2, 0)   # kDLCUDA

    def cpu(self):
        return self._t


class HostOnly:
    """A producer with no capsule at all, only ``__array__``."""

    def __init__(self, arr):
        self._a = arr

    def __array__(self, dtype=None, copy=None):
        return self._a


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64,
                                   np.uint8])
def test_round_trips_match_reference(dtype):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((5, 7)) * 100).astype(dtype)
    t = tdl.from_external(a)
    assert t.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(tdl.to_external(t, "numpy"), a)
    np.testing.assert_array_equal(np.asarray(jdl.from_external(a)), a)
    # a JAX array imports into the port, and the port's tensor into JAX
    np.testing.assert_array_equal(
        tdl.from_external(jnp.asarray(a)).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jdl.from_external(tdl.to_external(t, "torch"))), a)


def test_torch_consumer_shares_memory_and_bad_consumer_raises():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert tdl.to_external(t, "torch").data_ptr() == t.data_ptr()
    assert tdl.from_external(t).data_ptr() == t.data_ptr()
    with pytest.raises(ValueError, match="unknown consumer"):
        tdl.to_external(t, "cupy")


def test_ingest_cpu_tensor_is_zero_copy():
    t = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    out = tdl.ingest_foreign(t, device="cpu")
    assert out.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jdl.ingest_foreign(t)))


def test_ingest_bounces_a_rejected_capsule():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4) * 1.5
    out = tdl.ingest_foreign(ForeignDevice(t), device="cpu")
    np.testing.assert_array_equal(out.numpy(), t.numpy())
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jdl.ingest_foreign(ForeignDevice(t))))


@pytest.mark.parametrize("producer", ["host_only", "foreign"])
def test_ingest_through_the_pool_returns_the_block(producer):
    """The bounce lands in a pool block, the block goes back once the
    copy is done (bytes in use back to 0), and the result does not alias
    the recycled block."""
    pool = HostStagingPool(pinned=False)
    arr = np.arange(40, dtype=np.float32).reshape(8, 5) - 7.25
    src = HostOnly(arr) if producer == "host_only" \
        else ForeignDevice(torch.from_numpy(arr.copy()))
    out = tdl.ingest_foreign(src, device="cpu", pool=pool)
    np.testing.assert_array_equal(out.numpy(), arr)
    st = pool.stats()
    assert st["in_use_bytes"] == 0 and st["free"] == 1
    assert st["peak_bytes"] >= arr.nbytes
    # the block is reused by the next get: the ingested tensor keeps its
    # own bytes
    blk = pool.get(arr.nbytes)
    blk.fill_(0xFF)
    np.testing.assert_array_equal(out.numpy(), arr)
    pool.put(blk)


def test_ingest_refuses_an_object_with_no_protocol():
    with pytest.raises(TypeError, match="cannot ingest object"):
        tdl.ingest_foreign(object(), device="cpu")
    with pytest.raises(TypeError, match="cannot ingest object"):
        jdl.ingest_foreign(object())


def test_nothing_lands_on_the_cpu_unasked(monkeypatch):
    """Without a card the default device raises; an unknown device
    raises; ``device='cpu'`` is the one way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = torch.ones(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdl.ingest_foreign(t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdl.stage_to_device(np.ones(3))
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.stage_to_device(np.ones(3), "meta")
    with pytest.raises(RuntimeError):
        tdl.ingest_foreign(ForeignDevice(t), device="cuda")


def test_stage_to_device_on_the_cpu():
    a = np.arange(10, dtype=np.int32)
    out = tdl.stage_to_device(a, "cpu")
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), a)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jdl.stage_to_device(a)))
    t = torch.arange(6)
    assert tdl.stage_to_device(t, "cpu").data_ptr() == t.data_ptr()
