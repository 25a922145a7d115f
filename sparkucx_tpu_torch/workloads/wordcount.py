"""WordCount — HiBench's WordCount shape.

Map side emits (word, 1) pairs; the shuffle groups by word; the device
sums per key on both sides of the wire (``combine="sum"``: the map-side
combine before the exchange, the segment-reduce kernel after it), the
pipeline Spark runs on executor CPUs.

:func:`run_wordcount` counts word ids in float32 count lanes, exact while
every count stays below 2**24. Its oracle is ``np.unique`` with counts
over the written words, where the JAX runner accumulates a Python dict.
:func:`run_wordcount_text` counts real strings: each word's FNV-1a key
routes and groups it, its UTF-8 bytes ride as carried lanes beside an
int32 count lane (``io/varlen.pack_counted_varbytes``,
``combine_sum_words=1``), and the reduce side recovers exact (word,
count) pairs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparkucx_tpu_torch.shuffle.manager import ShuffleManager


def run_wordcount(manager: ShuffleManager, *, num_mappers: int = 8,
                  words_per_mapper: int = 5000, vocab: int = 1000,
                  num_partitions: int = 32, shuffle_id: int = 9003,
                  seed: int = 0, combine: bool = True) -> Dict[str, int]:
    """Returns {'distinct_words', 'total_words'} after checking every
    word's count exactly."""
    rng = np.random.default_rng(seed)
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        written = []
        for m in range(num_mappers):
            w = manager.get_writer(h, m)
            # zipf-ish skewed word distribution, the realistic stressor
            words = (rng.zipf(1.3, size=words_per_mapper) % vocab).astype(
                np.int64)
            w.write(words, np.ones((words_per_mapper, 1), dtype=np.float32))
            w.commit(num_partitions)
            written.append(words)
        truth_words, truth_counts = np.unique(np.concatenate(written),
                                              return_counts=True)
        res = manager.read(h, combine="sum" if combine else None, sink="host")
        got_k, got_v = [], []
        for r, (k, v) in res.partitions():
            if combine and np.unique(k).size != len(k):
                # explicit raise: a bare assert vanishes under python -O
                # and the totals check below re-accumulates duplicates,
                # so it alone would not catch a broken combine
                raise AssertionError(
                    f"combined partition {r} has duplicate keys")
            got_k.append(k)
            got_v.append(v[:, 0].astype(np.int64))     # int() truncation
        got_words, inv = np.unique(np.concatenate(got_k),
                                   return_inverse=True)
        got_counts = np.zeros(got_words.size, dtype=np.int64)
        np.add.at(got_counts, inv.reshape(-1), np.concatenate(got_v))
        if not (np.array_equal(got_words, truth_words)
                and np.array_equal(got_counts, truth_counts)):
            raise AssertionError("wordcount totals mismatch")
        return {"distinct_words": int(got_words.size),
                "total_words": num_mappers * words_per_mapper}
    finally:
        manager.unregister_shuffle(shuffle_id)


def run_wordcount_text(manager: ShuffleManager, *, num_mappers: int = 4,
                       words_per_mapper: int = 3000,
                       num_partitions: int = 16, shuffle_id: int = 9013,
                       seed: int = 0, max_word_bytes: int = 24,
                       combine: bool = True) -> Dict[str, int]:
    """WordCount over actual words (strings), not word ids: word -> 64-bit
    FNV key (routing + grouping) with the word BYTES riding as a carried
    varlen payload next to an int32 count lane; the device combiner sums
    the count lane and carries the bytes. Verified against a host
    dictionary of real string keys. Returns {'distinct_words',
    'total_words'}."""
    from sparkucx_tpu_torch.io.varlen import (hash_bytes64,
                                              pack_counted_varbytes,
                                              unpack_counted_rows)
    rng = np.random.default_rng(seed)
    # a realistic vocabulary: zipf-weighted words of varied length,
    # including unicode and single-letter words
    vocab = (["the", "of", "and", "to", "a", "in", "is", "it", "was",
              "naïve", "résumé", "Straße", "pneumonoultramicroscopic"]
             + [f"word{i:04d}" for i in range(400)])
    h = manager.register_shuffle(shuffle_id, num_mappers, num_partitions)
    try:
        truth: Dict[str, int] = {}
        for m in range(num_mappers):
            idx = rng.zipf(1.3, size=words_per_mapper) % len(vocab)
            words = [vocab[i] for i in idx]
            for wd in words:
                truth[wd] = truth.get(wd, 0) + 1
            keys = hash_bytes64(words)
            values, sum_words = pack_counted_varbytes(
                words, np.ones(len(words), np.int32), max_word_bytes)
            w = manager.get_writer(h, m)
            w.write(keys, values)
            w.commit(num_partitions)
        res = manager.read(h, combine="sum" if combine else None,
                           combine_sum_words=sum_words if combine else 0,
                           sink="host")
        got: Dict[str, int] = {}
        for r, (k, v) in res.partitions():
            if v is None or not k.shape[0]:
                continue
            counts, words_b = unpack_counted_rows(k.shape[0], v)
            for c, wb in zip(counts, words_b):
                wd = wb.decode("utf-8")
                got[wd] = got.get(wd, 0) + int(c)
        if got != truth:
            extra = {k: v for k, v in got.items() if truth.get(k) != v}
            raise AssertionError(
                f"text wordcount mismatch: {len(got)} vs {len(truth)} "
                f"distinct; first diffs {dict(list(extra.items())[:4])}")
        return {"distinct_words": len(got),
                "total_words": num_mappers * words_per_mapper}
    finally:
        manager.unregister_shuffle(shuffle_id)
