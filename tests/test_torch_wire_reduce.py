"""Port parity for the int8-dequant-fused segment reduce:
``ops/segmented.segment_reduce_wire_rows`` (its ``pallas`` impl runs the
kernel's plain version on a CPU tensor) against the JAX package's
``segment_reduce_wire_rows`` with ``impl="pallas"`` in interpret mode and
with ``impl="jnp"``, on the same seeded wire rows of 8 shards.

Wire rows are built directly: exact key lanes, random int8 values packed
four to a word (odd ``wire_words`` leave pad bytes), a float32 scale per
row, sorted by (partition, key), sentinel rows last.

Exact: n_out, pcounts, key lanes, the zero/sentinel tail, and carried
(dequantized) lanes — against the Pallas kernel always (both carry a
run's first row), against the jnp path where a key's rows share their
carried lanes and scale (it carries a run's last row). Float32 sums:
within ``n * 2**-24 * sum|v|`` of each n-row run, the bound of sequential
float32 summation (the kernel sums per tile by matmul, the plain version
in float64 rounded once, the jnp path by prefix-sum differences)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkucx_tpu.ops.pallas import segmented as jseg
from sparkucx_tpu_torch.ops import segmented as tseg
from sparkucx_tpu_torch.shuffle.alltoall import int8_wire_words
from torch_wire_cases import R, runs, sum_tolerance, wire_case

P = 8


def _jax(rows, part, width, ww, sw, impl):
    # one compiled program for the 8 shards
    fn = jax.jit(functools.partial(
        jseg.segment_reduce_wire_rows, num_parts=R, width=width,
        wire_words=ww, sum_words=sw, impl=impl, interpret=True))
    outs = [fn(jnp.asarray(rows[p]), jnp.asarray(part[p]))
            for p in range(P)]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]),
            np.array([int(np.asarray(o[2]).reshape(-1)[0]) for o in outs]))


CASES = [
    # (cap, wire_words, sum_words, per-row scale)
    (600, 4, 0, True),
    (700, 7, 3, True),                    # odd: pad bytes in the last word
    (520, 5, 2, False),
    (300, 1, 0, False),
    (300, 128, 0, True),
]


@pytest.mark.parametrize("cap,ww,sum_words,per_row", CASES)
def test_wire_reduce_matches_reference(cap, ww, sum_words, per_row):
    rows, part, vals = wire_case(cap + ww, P, cap, ww, sum_words, per_row)
    width = 2 + ww
    sw = sum_words or ww
    got_rows, got_pc, got_n = tseg.segment_reduce_wire_rows(
        torch.from_numpy(rows), torch.from_numpy(part), R, width, ww,
        sum_words=sum_words, impl="pallas")
    got_rows, got_pc, got_n = (got_rows.numpy(), got_pc.numpy(),
                               got_n.numpy())
    assert got_rows.shape == (P, cap, width)
    tol = sum_tolerance(rows, part, vals, sw)
    tol_prefix = sum_tolerance(rows, part, vals, sw, prefix=True)
    refs = {"pallas": _jax(rows, part, width, ww, sum_words, "pallas"),
            "jnp": _jax(rows, part, width, ww, sum_words, "jnp")}
    tj_rows, tj_pc, tj_n = tseg.segment_reduce_wire_rows(
        torch.from_numpy(rows), torch.from_numpy(part), R, width, ww,
        sum_words=sum_words, impl="jnp")
    refs["port_jnp"] = (tj_rows.numpy(), tj_pc.numpy(), tj_n.numpy())
    for name, (w_rows, w_pc, w_n) in refs.items():
        np.testing.assert_array_equal(got_n, w_n, err_msg=name)
        np.testing.assert_array_equal(got_pc, w_pc, err_msg=name)
        for p in range(P):
            n = int(got_n[p])
            g, w = got_rows[p, :n], w_rows[p, :n]
            np.testing.assert_array_equal(g[:, :2], w[:, :2], err_msg=name)
            if name == "pallas" or not per_row:
                np.testing.assert_array_equal(g[:, 2 + sw:], w[:, 2 + sw:],
                                              err_msg=name)
            d = np.abs(g[:, 2:2 + sw].view(np.float32).astype(np.float64)
                       - w[:, 2:2 + sw].view(np.float32))
            t = tol_prefix[p, :n] if name == "jnp" else tol[p, :n]
            assert (d <= t).all(), (name, p, float(d.max()))
            # the tail past n_out: zero rows (the sentinel in pcounts)
            assert not got_rows[p, n:].any()
    # carried lanes are the run's first row, dequantized
    for p, (run, valid) in enumerate(runs(rows, part)):
        firsts = np.flatnonzero(valid & np.r_[True, run[1:] != run[:-1]])
        np.testing.assert_array_equal(
            got_rows[p, :firsts.size, 2 + sw:].view(np.float32),
            vals[p, firsts, sw:])


def test_wire_reduce_shape_checks():
    rows = torch.zeros((2, 8, 2 + int8_wire_words(6)), dtype=torch.int32)
    part = torch.full((2, 8), R, dtype=torch.int32)
    with pytest.raises(ValueError, match="wire_words > 0"):
        tseg.segment_reduce_wire_rows(rows, part, R, 2, 0, impl="pallas")
    with pytest.raises(ValueError, match="whole value row"):
        tseg.segment_reduce_wire_rows(rows, part, R, 9, 6, impl="pallas")
    with pytest.raises(ValueError, match="wire rows must be"):
        tseg.segment_reduce_wire_rows(rows[..., :-1], part, R, 8, 6,
                                      impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tseg.segment_reduce_wire_kernel(rows, part, R, 8, 6, 6)
    out, out_part, n = tseg.segment_reduce_wire(rows, part, R, 8, 6, 6)
    assert not n.any() and (out_part == R).all() and not out.any()
