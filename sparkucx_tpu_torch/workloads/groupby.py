"""GroupBy — Spark's ``GroupByTest``: mappers generate random KV pairs,
the shuffle groups them by key, the job counts distinct keys.

:func:`run_groupby` is the host-contract job (numpy partition views).
The key-set oracle is ``np.unique`` over every written and every read
key, where the JAX runner builds Python sets. The device-combiner arm
and the external-memory pipeline are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


def run_groupby(manager: ShuffleManager, *, num_mappers: int = 8,
                pairs_per_mapper: int = 1000, num_partitions: int = 32,
                key_space: int = 500, value_width: int = 4,
                shuffle_id: int = 9001, seed: int = 0) -> Dict[str, int]:
    """Returns {'distinct_keys', 'rows'} after verifying grouping."""
    rng = np.random.default_rng(seed)
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        expected_rows = 0
        written = []
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            keys = rng.integers(0, key_space,
                                size=pairs_per_mapper).astype(np.int64)
            vals = rng.normal(
                size=(pairs_per_mapper, value_width)).astype(np.float32)
            w.write(keys, vals)
            w.commit(num_partitions)
            expected_rows += pairs_per_mapper
            written.append(keys)
        truth_keys = np.unique(np.concatenate(written))
        res = manager.read(h, sink="host")
        got = []
        rows = 0
        for r, (k, v) in res.partitions():
            assert v is not None and v.shape[0] == k.shape[0]
            got.append(k)
            rows += k.shape[0]
        distinct = np.unique(np.concatenate(got))
        if rows != expected_rows:
            raise AssertionError(f"row loss: {rows} != {expected_rows}")
        if not np.array_equal(distinct, truth_keys):
            raise AssertionError("key set mismatch after grouping")
        return {"distinct_keys": int(distinct.size), "rows": rows}
    finally:
        manager.unregister_shuffle(shuffle_id)
