"""Host-side wire codecs: the ``a2a.wire=lossless`` tier, and the int8
tier's dequantization-error estimate. numpy and zlib only, the same
formats and arithmetic as the JAX package's ``shuffle/wire.py``.

``lossless`` re-encodes a drained host block as byte planes + deflate:
the k-th byte of every element is stored together, so sign, exponent and
high bytes (low-entropy in real payloads) form long runs deflate
compresses. The round trip is bit-exact. A waved host-sink read
(``manager.PendingWaveShuffle``) encodes each wave right after it drains
(``reader.LazyShuffleReaderResult.compress_host_blocks``); a block
decodes on its first touch.

:func:`estimate_dequant_error` samples staged float rows, simulates a
round-to-nearest int8 pass and returns a relative RMS error, which an
int8 read reports as ``ExchangeReport.wire_dequant_error``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# deflate level 1: a few % of ratio for several times the throughput (the
# codec runs on the wave drain path)
_DEFLATE_LEVEL = 1


@dataclass(frozen=True)
class LosslessBlock:
    """One host block compressed: the deflate payload and the shape and
    dtype that restore the exact array; ``raw_bytes`` is the size before
    the codec."""

    payload: bytes
    shape: Tuple[int, ...]
    dtype: str
    raw_bytes: int

    @property
    def nbytes(self) -> int:
        return len(self.payload)


def encode_block(arr: np.ndarray) -> LosslessBlock:
    """Byte planes + deflate of one host array (any dtype and shape)."""
    a = np.ascontiguousarray(arr)
    itemsize = max(1, a.dtype.itemsize)
    planes = a.view(np.uint8).reshape(-1, itemsize).T
    blob = zlib.compress(np.ascontiguousarray(planes).tobytes(),
                         _DEFLATE_LEVEL)
    return LosslessBlock(blob, tuple(a.shape), a.dtype.str, int(a.nbytes))


def decode_block(block: LosslessBlock) -> np.ndarray:
    """Exact inverse of :func:`encode_block`."""
    dt = np.dtype(block.dtype)
    itemsize = max(1, dt.itemsize)
    raw = zlib.decompress(block.payload)
    planes = np.frombuffer(raw, np.uint8).reshape(itemsize, -1)
    out = np.ascontiguousarray(planes.T).reshape(-1)
    return out.view(dt).reshape(block.shape).copy()


def estimate_dequant_error(values: np.ndarray,
                           sample_rows: int = 256) -> float:
    """Mean over sampled rows of ``rms(error) / rms(typical values)`` for
    a per-row-scaled round-to-nearest int8 pass. At most ``sample_rows``
    rows, picked by a deterministic stride. A row's typical values are
    those within 8x its median magnitude, so a row whose one outlier
    stretches the scale reports the error relative to the values it
    destroyed. All-zero rows are skipped; 0.0 for empty input."""
    v = np.asarray(values, dtype=np.float32)
    if v.size == 0:
        return 0.0
    v = v.reshape(1, -1) if v.ndim == 1 else v.reshape(v.shape[0], -1)
    if v.shape[0] > sample_rows:
        idx = np.linspace(0, v.shape[0] - 1, sample_rows).astype(np.int64)
        v = v[idx]
    av = np.abs(v)
    amax = av.max(axis=1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    q = np.clip(np.rint(v / scale), -127, 127)
    err = np.square(v - q * scale, dtype=np.float64)
    typical = av <= 8.0 * np.median(av, axis=1, keepdims=True)
    num = np.sum(err * typical, axis=1)
    den = np.sum(np.square(v, dtype=np.float64) * typical, axis=1)
    live = den > 0.0
    if not live.any():
        return 0.0
    return float(np.mean(np.sqrt(num[live] / den[live])))


__all__ = ["LosslessBlock", "encode_block", "decode_block",
           "estimate_dequant_error"]
