"""Map-side routing on tensors: the mixing hash, the range partitioner,
destination sorts and segment counts of the JAX package's
``ops/partition.py``.

Every function here is batched over a leading shard dimension: rows are
``[B, cap, W]`` int32, per-row ids ``[B, cap]``, valid counts ``[B]`` —
the P logical shards of one device sort in one call, no loop over
shards. Padding rows (``idx >= num_valid``) route to a sentinel that
sorts last.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x, c < 2**32 held in int64, with no int64
    product overflow: split x into 16-bit halves (each product < 2**48)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer of the low 32 bits of integer keys — bit-exact
    with the JAX package's uint32 ``hash32``. Returns int64 values in
    [0, 2**32) (torch has no full uint32 arithmetic)."""
    x = keys.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_partition(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """keys -> reduce-partition id in [0, num_partitions), int32."""
    return (hash32(keys) % num_partitions).to(torch.int32)


def words_to_key(key_lo: torch.Tensor, key_hi: torch.Tensor) -> torch.Tensor:
    """The signed int64 key from its two int32 transport words [lo, hi]
    (lexicographic (hi signed, lo unsigned) order IS signed int64
    order)."""
    return (key_hi.to(torch.int64) << 32) | (key_lo.to(torch.int64) & _MASK32)


def to_device(array, device: torch.device,
              dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """A small host array as a tensor on ``device`` without waiting for
    the device: a copy from pageable memory to a CUDA device first waits
    for all earlier work on the stream (which would serialise a waved
    read's pipeline); a pinned, non-blocking copy is queued behind it."""
    t = torch.as_tensor(np.asarray(array), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def range_partition_words(key_lo: torch.Tensor, key_hi: torch.Tensor,
                          bounds) -> torch.Tensor:
    """Range partition of int64 keys held as transport words: partition
    = #(b <= key) over the sorted int64 split points ``bounds`` (signed
    compare). The JAX package counts it by a broadcast compare, O(n*R);
    a binary search over the rebuilt key gives the same ids in
    O(n log R). int32 ids, the shape of ``key_lo``."""
    b = to_device(np.asarray(bounds, dtype=np.int64), key_lo.device)
    key = words_to_key(key_lo, key_hi)
    if b.numel() == 0:
        return torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    return torch.searchsorted(b, key.contiguous(), right=True) \
        .to(torch.int32)


def range_partition(keys: Union[np.ndarray, torch.Tensor], bounds):
    """keys -> partition via sorted split points (TeraSort's range
    partitioner: partition r holds keys in [bounds[r-1], bounds[r]), so
    concatenating key-sorted partitions gives a globally sorted
    sequence). numpy in, numpy out; a tensor stays a tensor."""
    if isinstance(keys, np.ndarray):
        return np.searchsorted(np.asarray(bounds, dtype=np.int64), keys,
                               side="right").astype(np.int32)
    b = to_device(np.asarray(bounds, dtype=np.int64), keys.device)
    return torch.searchsorted(b, keys.to(torch.int64).contiguous(),
                              right=True).to(torch.int32)


def sample_bounds(keys, num_partitions: int) -> np.ndarray:
    """Host-side quantile split points for range partitioning."""
    qs = np.linspace(0, 1, num_partitions + 1)[1:-1]
    return np.quantile(np.asarray(keys), qs).astype(np.asarray(keys).dtype)


class ReservoirSampler:
    """Streaming uniform sample of a key stream (vectorized Algorithm R)
    — Spark's RangePartitioner sketch at O(capacity) memory. The first
    ``capacity`` keys fill the reservoir; each later key replaces a
    uniform slot with probability capacity / seen_so_far."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.seen = 0
        self._rng = np.random.default_rng(seed)
        self._buf: Optional[np.ndarray] = None   # dtype of the first keys

    def add(self, keys) -> None:
        """Fold one chunk of keys (1-D array) into the reservoir."""
        keys = np.asarray(keys)
        if keys.ndim != 1:
            raise ValueError("reservoir keys must be 1-D")
        if keys.size == 0:
            return
        if self._buf is None:
            self._buf = np.empty(self.capacity, dtype=keys.dtype)
        n = keys.shape[0]
        fill = min(self.capacity - self.seen, n) \
            if self.seen < self.capacity else 0
        if fill > 0:
            self._buf[self.seen:self.seen + fill] = keys[:fill]
        tail = keys[fill:]
        if tail.size:
            # tail item i is the (seen + fill + i + 1)-th of the stream
            ranks = self.seen + fill + 1 \
                + np.arange(tail.size, dtype=np.float64)
            accept = self._rng.random(tail.size) < (self.capacity / ranks)
            idx = np.flatnonzero(accept)
            if idx.size:
                slots = self._rng.integers(0, self.capacity, size=idx.size)
                # later duplicates win a slot: sequential Algorithm R's
                # last-write order
                self._buf[slots] = tail[idx]
        self.seen += n

    def sample(self) -> np.ndarray:
        """The reservoir's filled prefix."""
        if self._buf is None:
            return np.zeros(0, dtype=np.int64)
        return self._buf[:min(self.seen, self.capacity)]

    def bounds(self, num_partitions: int) -> np.ndarray:
        """Split points for :func:`range_partition` from the reservoir."""
        if self.seen == 0:
            raise ValueError("cannot derive bounds from an empty stream")
        return sample_bounds(self.sample(), num_partitions)


def counts_from_sorted(sorted_key: torch.Tensor,
                       num_bins: int) -> torch.Tensor:
    """Bucket counts ``[..., num_bins]`` from ascending-sorted keys
    ``[..., n]``, as searchsorted differences. Keys >= num_bins (padding
    sentinels) are not counted."""
    lead = sorted_key.shape[:-1]
    edges = torch.arange(num_bins + 1, dtype=sorted_key.dtype,
                         device=sorted_key.device)
    edges = edges.expand(*lead, num_bins + 1).contiguous()
    pos = torch.searchsorted(sorted_key.contiguous(), edges, side="left")
    return (pos[..., 1:] - pos[..., :-1]).to(torch.int32)


def _sentinel_key(dest: torch.Tensor, num_valid: torch.Tensor,
                  num_dests: int) -> torch.Tensor:
    """int32 grouping key ``[B, cap]``: destination for real rows, the
    ``num_dests`` sentinel for padding."""
    cap = dest.shape[-1]
    idx = torch.arange(cap, dtype=torch.int32, device=dest.device)
    valid = idx[None, :] < num_valid.reshape(-1, 1)
    return torch.where(valid, dest.to(torch.int32),
                       torch.full_like(dest, num_dests, dtype=torch.int32))


def _gather_rows(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """rows[b, order[b, k]] for every b, as one flat index_select (a
    per-element gather index would be W times larger)."""
    B, n, W = rows.shape
    base = torch.arange(B, dtype=torch.int64, device=rows.device) * n
    flat = (order.to(torch.int64) + base[:, None]).reshape(-1)
    return rows.reshape(B * n, W).index_select(0, flat) \
        .reshape(B, order.shape[1], W)


def destination_sort(rows: torch.Tensor, dest: torch.Tensor,
                     num_valid: torch.Tensor, num_dests: int,
                     method: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group padded rows by destination, padding last.

    rows ``[B, cap, W]``, dest ``[B, cap]``, num_valid ``[B]``. Returns
    (sorted_rows ``[B, cap, W]``, counts ``[B, num_dests]`` int32). One
    key sort plus one row gather whatever ``method`` names; 'argsort' and
    'counting' keep arrival order inside a destination (stable), the
    others allow any order — the JAX package's per-method contract."""
    key = _sentinel_key(dest, num_valid, num_dests)
    stable = method in ("argsort", "counting")
    skey, order = torch.sort(key, dim=-1, stable=stable)
    return _gather_rows(rows, order), counts_from_sorted(skey, num_dests)


def partition_major_sort_aligned(
    rows: torch.Tensor,
    part: torch.Tensor,
    num_valid: torch.Tensor,
    num_parts: int,
    dev_bounds,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition-major send buffer with each DEVICE segment padded to a
    chunk multiple — the layout the segment-move kernel needs.

    ``dev_bounds`` is the static ``[P+1]`` numpy partition-range table
    (device d owns partitions [dev_bounds[d], dev_bounds[d+1])). Sort key:
    real row -> part*2; the ``(-dev_count) % chunk`` armed dummy rows of
    device d -> (last partition of d)*2 + 1, so they land at the tail of
    d's segment; padding and unused dummies -> the 2R+1 sentinel, last.
    Dummy rows are zero.

    Returns (sorted_rows ``[B, cap + P*chunk, W]``, rcounts ``[B, R]``
    real rows per partition, dev_counts ``[B, P]`` real rows per
    device)."""
    B, cap, W = rows.shape
    dev = rows.device
    bounds = np.asarray(dev_bounds, dtype=np.int64)
    P = bounds.shape[0] - 1
    pad_rows = P * chunk
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = idx[None, :] < num_valid.reshape(-1, 1)
    pkey = torch.where(valid, part.to(torch.int32),
                       torch.full_like(part, num_parts, dtype=torch.int32))

    # per-partition histogram (the sentinel bin R is dropped)
    hist = torch.zeros((B, num_parts + 1), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, pkey.to(torch.int64),
                      torch.ones_like(pkey, dtype=torch.int32))
    rcounts = hist[:, :num_parts]
    cum = torch.zeros((B, num_parts + 1), dtype=torch.int32, device=dev)
    cum[:, 1:] = torch.cumsum(rcounts, dim=1, dtype=torch.int32)
    b_hi = to_device(bounds[1:], dev)
    b_lo = to_device(bounds[:-1], dev)
    dev_counts = cum[:, b_hi] - cum[:, b_lo]                  # [B, P]
    pad_per = (-dev_counts) % chunk

    # an empty device range keeps its own start as "last partition", so
    # its dummies still sort between its neighbours
    last_part = to_device(np.maximum(bounds[1:] - 1, bounds[:-1]), dev,
                          torch.int32)
    slot = torch.arange(pad_rows, dtype=torch.int64, device=dev)
    blk = slot // chunk
    within = (slot % chunk).to(torch.int32)
    sentinel = 2 * num_parts + 1
    armed = within[None, :] < pad_per[:, blk]
    dummy_key = torch.where(armed, (last_part[blk] * 2 + 1)[None, :],
                            torch.full_like(armed, sentinel,
                                            dtype=torch.int32))
    real_key = torch.where(valid, pkey * 2,
                           torch.full_like(pkey, sentinel))
    _, order = torch.sort(torch.cat([real_key, dummy_key], dim=1), dim=-1,
                          stable=False)
    # dummy slots (order >= cap) read row 0 and are zeroed afterwards —
    # cheaper than materializing the zero-extended row buffer
    is_dummy = order >= cap
    out = _gather_rows(rows, torch.where(is_dummy, 0, order))
    out.masked_fill_(is_dummy.unsqueeze(-1), 0)
    return out, rcounts.contiguous(), dev_counts.to(torch.int32)


def blocked_partition_map(num_partitions: int,
                          num_devices: int) -> np.ndarray:
    """Default reduce-partition -> device assignment: contiguous blocks,
    the remainder spread over the first devices. numpy int32 [R]."""
    base, rem = divmod(num_partitions, num_devices)
    counts = [base + (1 if d < rem else 0) for d in range(num_devices)]
    return np.repeat(np.arange(num_devices, dtype=np.int32), counts)
