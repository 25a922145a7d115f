"""Block integrity — checksums for staged bytes, drained rows and the
durable ledger's files.

* At ``commit()`` the writer computes an :class:`IntegrityRecord` over
  its staged key/value bytes (a spilled writer's over the mapped views
  the read path packs from) and publishes it in the registry beside the
  size row.
* ``integrity.verify=staged`` (the default) re-verifies those bytes at
  pack time, before they enter the exchange.
* ``integrity.verify=full`` also verifies the result after the exchange:
  per reduce partition on the host sink, against order-free digest sums
  (the rows cross the exchange destination-sorted, so a positional
  checksum cannot survive it; a sum of per-row digests can, and splits
  by partition like the size rows); by re-routing the sampled key lanes
  on the device sink.

Three checksums, by path temperature:

* crc32 (zlib): the disk checksum of the ledger's sealed files, its
  manifest and the restart scan; a cold path.
* fold64: the hot pack-time verify — an xor-fold of the uint64 lanes
  bound to the length; any single flipped bit changes it.
* row digests: splitmix64 per row, summed per reduce partition, for the
  full level's post-exchange check. The int8 wire dequantizes value
  lanes, so its check uses the key-only digest rows.

Everything here is host-side numpy, bit for bit the JAX package's
(``sparkucx_tpu/shuffle/integrity.py``): no device program gains a
verification argument, so every verify level launches the same kernels.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

VERIFY_LEVELS = ("off", "staged", "full")


def validate_verify_level(v: str, conf_key: str = "integrity.verify") -> str:
    if v not in VERIFY_LEVELS:
        raise ValueError(
            f"{conf_key}={v!r}: want one of {'|'.join(VERIFY_LEVELS)}")
    return v


# -- primitives ---------------------------------------------------------------
_U64 = np.uint64
_FOLD_LEN_SALT = _U64(0x9E3779B97F4A7C15)


def _as_bytes_view(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of an array's bytes (a copy only for a
    non-contiguous input)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def fold64(arr: Optional[np.ndarray]) -> int:
    """xor-fold of the array's uint64 lanes (a zero-padded tail lane for
    the last bytes), xored with the byte length times a salt."""
    if arr is None:
        return 0
    b = _as_bytes_view(arr)
    n8 = (b.nbytes // 8) * 8
    acc = _U64(0)
    if n8:
        acc ^= np.bitwise_xor.reduce(b[:n8].view(_U64))
    if b.nbytes > n8:
        tail = np.zeros(8, np.uint8)
        tail[: b.nbytes - n8] = b[n8:]
        acc ^= tail.view(_U64)[0]
    # the length binding in python ints (numpy scalars warn on wrap)
    return int(acc) ^ ((b.nbytes * 0x9E3779B97F4A7C15)
                       & 0xFFFFFFFFFFFFFFFF)


def crc32_of(arr: Optional[np.ndarray]) -> int:
    """zlib crc32 over an array's bytes (the ledger's file checksum)."""
    if arr is None:
        return 0
    return zlib.crc32(_as_bytes_view(arr)) & 0xFFFFFFFF


def crc32_file(path: str, chunk: int = 1 << 22) -> int:
    """Streaming crc32 of a file (the restart scan)."""
    acc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            acc = zlib.crc32(b, acc)
    return acc & 0xFFFFFFFF


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (in-place temps on one copy)."""
    x = x.astype(_U64, copy=True)
    x += _U64(0x9E3779B97F4A7C15)
    x ^= x >> _U64(30)
    x *= _U64(0xBF58476D1CE4E5B9)
    x ^= x >> _U64(27)
    x *= _U64(0x94D049BB133111EB)
    x ^= x >> _U64(31)
    return x


def row_digests(keys: np.ndarray,
                values: Optional[np.ndarray]) -> np.ndarray:
    """[N] uint64 per-row digests of (key, value-row bytes): the mixed key
    plus the sum of the mixed value words, each salted by its position in
    the row. Row identity only, never row order."""
    n = keys.shape[0]
    h = _mix64(np.ascontiguousarray(keys, dtype=np.int64).view(_U64))
    if values is not None and n:
        v = np.ascontiguousarray(values)
        row_bytes = v.dtype.itemsize * int(
            np.prod(v.shape[1:], dtype=np.int64) or 1)
        raw = v.view(np.uint8).reshape(n, row_bytes)
        pad = (-row_bytes) % 8
        if pad:
            raw = np.concatenate(
                [raw, np.zeros((n, pad), np.uint8)], axis=1)
        words = raw.view(_U64)                      # [N, K]
        salts = _FOLD_LEN_SALT * (
            np.arange(1, words.shape[1] + 1, dtype=_U64))
        h = h + _mix64(words ^ salts[None, :]).sum(axis=1, dtype=_U64)
    return h


def partition_digests(keys: np.ndarray, values: Optional[np.ndarray],
                      parts: np.ndarray, num_partitions: int,
                      key_only_too: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(full_digests[R], key_digests[R]): per-reduce-partition sums of the
    row digests, of the whole rows and of the key lane alone."""
    full = np.zeros(num_partitions, dtype=_U64)
    keyd = np.zeros(num_partitions, dtype=_U64)
    if keys.shape[0]:
        p = np.ascontiguousarray(parts, dtype=np.int64)
        np.add.at(full, p, row_digests(keys, values))
        if key_only_too:
            if values is None:
                keyd[:] = full
            else:
                np.add.at(keyd, p, row_digests(keys, None))
    return full, keyd


def digest_sum(keys: np.ndarray, values: Optional[np.ndarray]) -> int:
    """Sum (mod 2**64) of one row set's digests."""
    if keys.shape[0] == 0:
        return 0
    return int(row_digests(keys, values).sum(dtype=_U64))


# -- the published record -----------------------------------------------------
@dataclass
class IntegrityRecord:
    """What one committed map output publishes beside its size row:
    ``keys_fold`` / ``vals_fold`` for the staged verify, ``keys_crc`` /
    ``vals_crc`` for the ledger (0 without one), the digest rows only
    when the writer ran at ``integrity.verify=full``, and the value
    schema, so a manifest row alone can rebuild the view."""

    rows: int
    keys_bytes: int
    vals_bytes: int
    keys_fold: int
    vals_fold: int
    keys_crc: int
    vals_crc: int
    digests: Optional[List[int]] = None       # [R] uint64 full-row sums
    key_digests: Optional[List[int]] = None   # [R] key-lane sums
    val_dtype: Optional[str] = None
    val_tail: Optional[Tuple[int, ...]] = None

    def to_dict(self) -> Dict:
        d = {"rows": self.rows, "keys_bytes": self.keys_bytes,
             "vals_bytes": self.vals_bytes, "keys_fold": self.keys_fold,
             "vals_fold": self.vals_fold, "keys_crc": self.keys_crc,
             "vals_crc": self.vals_crc, "val_dtype": self.val_dtype,
             "val_tail": list(self.val_tail)
             if self.val_tail is not None else None}
        if self.digests is not None:
            d["digests"] = [int(x) for x in self.digests]
            d["key_digests"] = [int(x) for x in (self.key_digests or [])]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "IntegrityRecord":
        return cls(
            rows=int(d["rows"]), keys_bytes=int(d["keys_bytes"]),
            vals_bytes=int(d["vals_bytes"]),
            keys_fold=int(d["keys_fold"]), vals_fold=int(d["vals_fold"]),
            keys_crc=int(d["keys_crc"]), vals_crc=int(d["vals_crc"]),
            digests=[int(x) for x in d["digests"]]
            if d.get("digests") is not None else None,
            key_digests=[int(x) for x in d["key_digests"]]
            if d.get("key_digests") is not None else None,
            val_dtype=d.get("val_dtype"),
            val_tail=tuple(d["val_tail"])
            if d.get("val_tail") is not None else None)


def compute_record(keys: Optional[np.ndarray],
                   values: Optional[np.ndarray],
                   parts: Optional[np.ndarray], num_partitions: int,
                   with_digests: bool,
                   with_crc: bool = False) -> IntegrityRecord:
    """The commit-time record. ``parts`` is the per-row partition vector
    the commit derived for the size row (None for an empty output);
    ``with_crc`` adds the crc32 pair, which only the durable ledger
    reads."""
    if keys is None or keys.shape[0] == 0:
        rec = IntegrityRecord(0, 0, 0, 0, 0, 0, 0)
        if with_digests:
            rec.digests = [0] * num_partitions
            rec.key_digests = [0] * num_partitions
        return rec
    rec = IntegrityRecord(
        rows=int(keys.shape[0]),
        keys_bytes=int(keys.nbytes),
        vals_bytes=int(values.nbytes) if values is not None else 0,
        keys_fold=fold64(keys), vals_fold=fold64(values),
        keys_crc=crc32_of(keys) if with_crc else 0,
        vals_crc=crc32_of(values) if with_crc else 0,
        val_dtype=np.dtype(values.dtype).str if values is not None
        else None,
        val_tail=tuple(int(x) for x in values.shape[1:])
        if values is not None else None)
    if with_digests:
        full, keyd = partition_digests(keys, values, parts,
                                       num_partitions)
        rec.digests = [int(x) for x in full]
        rec.key_digests = [int(x) for x in keyd]
    return rec


class _StagedMismatch(Exception):
    """A verify's mismatch; the manager raises it as
    ``BlockCorruptionError`` naming the shuffle, the map and the block."""


def verify_staged(keys: np.ndarray, values: Optional[np.ndarray],
                  rec: IntegrityRecord) -> int:
    """Pack-time staged verify: the bytes about to enter the exchange must
    fold to what commit published. Returns the verified bytes; raises
    :class:`_StagedMismatch` describing the mismatch."""
    problems = []
    if int(keys.nbytes) != rec.keys_bytes:
        problems.append(f"keys {keys.nbytes} B != committed "
                        f"{rec.keys_bytes} B")
    elif fold64(keys) != rec.keys_fold:
        problems.append("keys bytes changed since commit (fold mismatch)")
    vb = int(values.nbytes) if values is not None else 0
    if vb != rec.vals_bytes:
        problems.append(f"values {vb} B != committed {rec.vals_bytes} B")
    elif values is not None and fold64(values) != rec.vals_fold:
        problems.append("value bytes changed since commit (fold mismatch)")
    if problems:
        raise _StagedMismatch("; ".join(problems))
    return int(keys.nbytes) + vb


def aggregate_digests(entry, num_maps: int, key_only: bool
                      ) -> Optional[np.ndarray]:
    """[R] uint64 expected per-partition digest sums over every map output
    of ``entry``, or None when any record lacks digest rows (committed
    below the full level: the read keeps the staged verdict)."""
    acc = None
    for m in range(num_maps):
        rec = entry.fetch_integrity(m)
        rows = rec.key_digests if (rec is not None and key_only) \
            else (rec.digests if rec is not None else None)
        if rows is None:
            return None
        v = np.asarray(rows, dtype=_U64)
        acc = v.copy() if acc is None else acc + v
    return acc


# -- the device sink's key-lane check ------------------------------------------
def host_partition_ids(keys: np.ndarray, num_partitions: int,
                       partitioner: str = "hash",
                       bounds=None) -> np.ndarray:
    """Host twin of the device routing over int64 keys: hash — the 32-bit
    mixing hash of the low key word; direct — the low int32 word clipped
    to ``[0, R)``; range — ``searchsorted(bounds, key, 'right')``."""
    keys = np.asarray(keys, dtype=np.int64)
    if partitioner == "direct":
        lo = (keys & np.int64(0xFFFFFFFF)).astype(np.uint32) \
            .view(np.int32)
        return np.clip(lo.astype(np.int64), 0, num_partitions - 1)
    if partitioner == "range":
        b = np.asarray(bounds, dtype=np.int64)
        return np.searchsorted(b, keys, side="right").astype(np.int64)
    from sparkucx_tpu_torch.shuffle.writer import hash32_np
    return (hash32_np(keys) % np.uint32(num_partitions)).astype(np.int64)


def verify_key_routing(rows: np.ndarray, totals: np.ndarray,
                       num_partitions: int, num_shards: int,
                       partitioner: str = "hash", bounds=None,
                       shard_ids=None) -> int:
    """Every valid row of shard p must carry a key whose partition, routed
    again on the host, belongs to p under the blocked partition map. Key
    lanes are exact on every wire tier and survive a combine, so this
    holds where per-row digests cannot.

    ``rows`` — [P*cap, width] int32 transport rows (width >= 2, the key
    lanes first); ``totals`` — [P] valid rows per shard, each a prefix of
    its shard's ``cap`` rows. With ``shard_ids`` (a distributed partial
    view) ``rows`` and ``totals`` hold those global shards only, in that
    order. Returns the verified key bytes; raises
    :class:`_StagedMismatch` naming the shard and the stray partition."""
    from sparkucx_tpu_torch.ops.partition import blocked_partition_map
    rows = np.asarray(rows)
    totals = np.asarray(totals, dtype=np.int64).reshape(-1)
    held = list(range(num_shards)) if shard_ids is None \
        else [int(g) for g in shard_ids]
    cap = rows.shape[0] // max(len(held), 1)
    p2d = np.asarray(blocked_partition_map(num_partitions, num_shards))
    verified = 0
    for i, s in enumerate(held):
        n = int(totals[i])
        if n <= 0:
            continue
        blk = rows[i * cap:i * cap + min(n, cap)]
        keys = np.ascontiguousarray(blk[:, :2]).view(np.int64).ravel()
        part = host_partition_ids(keys, num_partitions, partitioner,
                                  bounds)
        owner = p2d[np.clip(part, 0, num_partitions - 1)]
        bad = np.nonzero((owner != s)
                         | (part < 0) | (part >= num_partitions))[0]
        if bad.size:
            j = int(bad[0])
            raise _StagedMismatch(
                f"shard {s} row {j}: key {int(keys[j])} routes to "
                f"partition {int(part[j])} (owner shard "
                f"{int(owner[j]) if 0 <= part[j] < num_partitions else '?'}) "
                f"— delivered to the wrong shard, or key lanes "
                f"corrupted in flight")
        verified += int(keys.nbytes)
    return verified


# -- the corrupt fault sites ----------------------------------------------------
class _FlipToken:
    """One injected bit flip and its undo. The ``corrupt.*`` sites model
    transient corruption: the flip lasts exactly as long as the verify
    that must detect it, so a replay finds the bytes intact."""

    def __init__(self, restore):
        self._restore = restore
        self.done = False

    def restore(self) -> None:
        if not self.done:
            self.done = True
            self._restore()


def flip_array_byte(arr: np.ndarray, offset: int) -> _FlipToken:
    """XOR one bit into a writable staged array (offset modulo its
    bytes)."""
    b = arr.reshape(-1).view(np.uint8)
    off = int(offset) % b.nbytes
    b[off] ^= 0x01

    def _undo():
        b[off] ^= 0x01
    return _FlipToken(_undo)


def flip_file_byte(path: str, offset: int) -> _FlipToken:
    """XOR one bit into a file on disk (offset modulo its size). Shared
    read-only mappings of the file see the flip through the page cache,
    so the staged verify over them detects it without reopening."""
    size = os.path.getsize(path)
    off = int(offset) % max(size, 1)
    with open(path, "r+b") as f:
        f.seek(off)
        orig = f.read(1)
        f.seek(off)
        f.write(bytes([orig[0] ^ 0x01]))
        f.flush()

    def _undo():
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(orig)
            f.flush()
    return _FlipToken(_undo)
