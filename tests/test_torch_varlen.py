"""Port parity for ``io/varlen``: the port's numpy codec against the JAX
package's ``sparkucx_tpu.io.varlen`` on the same items — ``hash_bytes64``
bit for bit (the routing of string keys depends on it), the varbytes and
counted-varbytes rows byte for byte, and both unpacks round-tripping NUL
bytes, empty items and multi-byte UTF-8; an over-long item and a corrupt
length raise in both."""

import numpy as np
import pytest

from sparkucx_tpu.io import varlen as jvl
from sparkucx_tpu_torch.io import varlen as tvl


def _items(kind: str):
    rng = np.random.default_rng(len(kind))
    if kind == "words":
        return ["the", "of", "a", "word0042", "pneumonoultramicroscopic"]
    if kind == "utf8":
        return ["naïve", "résumé", "Straße", "日本語", "😀x", "Ω"]
    if kind == "nul_empty":
        return [b"", b"\x00", b"a\x00b", b"\x00\x00\x00\x00", b"", b"z"]
    if kind == "random":
        return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 41, 300)]
    return []                                          # "none"


KINDS = ["words", "utf8", "nul_empty", "random", "none"]


@pytest.mark.parametrize("kind", KINDS)
def test_hash_bytes64_bit_equal(kind):
    items = _items(kind)
    got = tvl.hash_bytes64(items)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jvl.hash_bytes64(items))


@pytest.mark.parametrize("max_bytes", [40, 41, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_pack_varbytes_byte_equal_and_round_trips(kind, max_bytes):
    items = _items(kind)
    rows = tvl.pack_varbytes(items, max_bytes)
    want = jvl.pack_varbytes(items, max_bytes)
    assert rows.dtype == want.dtype and rows.shape == want.shape
    assert rows.tobytes() == want.tobytes()
    raw = [x.encode("utf-8") if isinstance(x, str) else x for x in items]
    assert tvl.unpack_varbytes(rows) == raw == jvl.unpack_varbytes(want)
    # as int32 transport words (zero rows included)
    assert tvl.unpack_varbytes(rows.view(np.int32)) == raw


@pytest.mark.parametrize("kind", KINDS)
def test_counted_varbytes_byte_equal_and_round_trips(kind):
    items = _items(kind)
    counts = np.arange(len(items), dtype=np.int32) * 7 - 3
    got, sw = tvl.pack_counted_varbytes(items, counts, 48)
    assert sw == 1 and got.dtype == np.int32
    assert got.shape == (len(items), 1 + tvl.varbytes_words(48))
    raw = [x.encode("utf-8") if isinstance(x, str) else x for x in items]
    c, words = tvl.unpack_counted_varbytes(got)
    np.testing.assert_array_equal(c, counts.astype(np.int64))
    assert words == raw
    if items:       # the JAX package's codec needs at least one row
        want, jsw = jvl.pack_counted_varbytes(items, counts, 48)
        assert jsw == 1 and got.tobytes() == want.tobytes()
        jc, jwords = jvl.unpack_counted_varbytes(want)
        np.testing.assert_array_equal(c, jc)
        assert words == jwords
    # as a read hands the values back: an [n, ...] block of other shape
    c2, words2 = tvl.unpack_counted_rows(got.shape[0],
                                         got.view(np.uint8).copy())
    np.testing.assert_array_equal(c2, c)
    assert words2 == raw


@pytest.mark.parametrize("max_bytes", range(0, 10))
def test_widths_match(max_bytes):
    assert tvl.varbytes_width(max_bytes) == jvl.varbytes_width(max_bytes)
    assert tvl.varbytes_words(max_bytes) == jvl.varbytes_words(max_bytes)


@pytest.mark.parametrize("mod", [tvl, jvl], ids=["port", "jax"])
def test_over_long_item_and_corrupt_length_raise(mod):
    with pytest.raises(ValueError, match="never truncated"):
        mod.pack_varbytes([b"abc", b"x" * 9], 8)
    with pytest.raises(ValueError, match="never truncated"):
        mod.pack_counted_varbytes(["naïve"], np.ones(1, np.int32), 5)
    rows = mod.pack_varbytes([b"abcd"], 8)
    rows[0, :4] = np.array([13, 0, 0, 0], np.uint8)   # length past the row
    with pytest.raises(ValueError, match="corrupt varbytes length"):
        mod.unpack_varbytes(rows)
    with pytest.raises(TypeError):
        mod.pack_varbytes([3], 8)
