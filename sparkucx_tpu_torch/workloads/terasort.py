"""TeraSort — range-partition by key, shuffle, sort each partition;
concatenating the partitions in order yields the globally sorted dataset
(HiBench Terasort's shape).

:func:`run_terasort` is the in-memory formulation: split points from a
:class:`~sparkucx_tpu_torch.ops.partition.ReservoirSampler` (the
RangePartitioner sketch), then either ``mode="range"`` — the device
routes by range and key-sorts every partition (``read(ordered=True)``) —
or ``mode="direct"`` — the map side computes partition ids itself and
the reduce side sorts on the host. :func:`keystream` is the deterministic
splitmix64 key stream the external-memory pipeline replays; the pipeline
itself (sealed sorted runs, the k-way merge) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.ops.partition import ReservoirSampler, range_partition
from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


def keystream(seed: int, start: int, n: int) -> np.ndarray:
    """Deterministic 62-bit uniform keys for global row indices
    [start, start+n) — splitmix64 of the index stream, so a sampling pass
    and an oracle can replay the dataset instead of storing it."""
    from sparkucx_tpu_torch.shuffle.integrity import _mix64
    with np.errstate(over="ignore"):       # the seed's offset wraps mod 2**64
        idx = np.arange(start, start + n, dtype=np.uint64) \
            + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
    return (_mix64(idx) >> np.uint64(2)).astype(np.int64)


def run_terasort(manager: ShuffleManager, *, num_mappers: int = 8,
                 rows_per_mapper: int = 2000, num_partitions: int = 32,
                 shuffle_id: int = 9002, seed: int = 0,
                 mode: str = "range") -> Dict[str, int]:
    """Distributed sort of random uint keys; verifies global order.
    Returns {'rows', 'partitions'}."""
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 1 << 40, size=rows_per_mapper).astype(np.int64)
              for _ in range(num_mappers)]
    # sampled split points (the RangePartitioner reservoir-sampling role)
    sampler = ReservoirSampler(capacity=max(512, 64 * num_partitions),
                               seed=seed)
    for s in shards:
        sampler.add(s)
    bounds = sampler.bounds(num_partitions)

    if mode == "range":
        h = manager.register_shuffle(shuffle_id, num_mappers,
                                     num_partitions, partitioner="range",
                                     bounds=bounds)
    else:
        h = manager.register_shuffle(shuffle_id, num_mappers,
                                     num_partitions, partitioner="direct")
    try:
        for m, keys in enumerate(shards):
            w = manager.get_writer(h, m)
            if mode == "range":
                w.write(keys)                      # the key IS the payload
            else:
                part = np.asarray(range_partition(keys, bounds),
                                  dtype=np.int64)
                w.write(part, keys.reshape(-1, 1))
            w.commit(num_partitions)
        res = manager.read(h, ordered=(mode == "range"), sink="host")

        out = []
        rows = 0
        for r in range(num_partitions):
            if mode == "range":
                local, _ = res.partition(r)
                if (np.diff(local) < 0).any():
                    raise AssertionError(
                        f"device-sorted partition {r} is out of order")
            else:
                pid, v = res.partition(r)
                assert (pid == r).all(), "direct routing misplaced rows"
                local = np.sort(v[:, 0])
            # range invariant: partition r's keys fall inside its bounds
            if local.size:
                if r > 0:
                    assert local[0] >= bounds[r - 1]
                if r < num_partitions - 1:
                    assert local[-1] <= bounds[r]
            out.append(local)
            rows += local.size
        merged = np.concatenate(out)
        want = np.sort(np.concatenate(shards))
        if not np.array_equal(merged, want):
            raise AssertionError("terasort output is not globally sorted")
        return {"rows": rows, "partitions": num_partitions}
    finally:
        manager.unregister_shuffle(shuffle_id)
