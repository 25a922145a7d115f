"""The workload runner calls the port's tests share (no JAX import here,
so the card tests can use them too): each case names the runner's module
under ``workloads/``, its function and its keyword arguments, at the
sizes of the JAX package's own workload tests."""

import importlib

# (case id, module, function, keyword arguments)
WORKLOAD_CASES = [
    ("terasort_range", "terasort", "run_terasort",
     dict(num_mappers=8, rows_per_mapper=1000, num_partitions=16,
          mode="range")),
    ("terasort_direct", "terasort", "run_terasort",
     dict(num_mappers=8, rows_per_mapper=1000, num_partitions=16,
          mode="direct", shuffle_id=9012)),
    ("groupby", "groupby", "run_groupby",
     dict(num_mappers=8, pairs_per_mapper=500, key_space=100,
          num_partitions=16)),
    ("wordcount", "wordcount", "run_wordcount",
     dict(num_mappers=4, words_per_mapper=2000, vocab=300,
          num_partitions=16)),
    ("wordcount_text", "wordcount", "run_wordcount_text",
     dict(shuffle_id=9023)),
    ("pagerank", "pagerank", "run_pagerank",
     dict(num_vertices=48, num_edges=300, num_partitions=8, num_mappers=4,
          iterations=8)),
    ("als", "als", "run_als", dict(iterations=3)),
    ("tc", "tc", "run_tc", dict(num_vertices=30, num_edges=70)),
    ("q23", "q23", "run_q23", dict(shuffle_id=9300)),
    ("join", "join", "run_join",
     dict(num_mappers=4, build_rows=1000, probe_rows=4000,
          num_partitions=16, key_space=500, hot_keys=3, hot_fraction=0.6)),
    ("join_varchar", "join", "run_join_varchar", dict()),
]

# the runners whose reads combine on the device (segment reduce)
COMBINE_RUNNERS = {"run_wordcount", "run_wordcount_text", "run_pagerank",
                   "run_q23"}


def runner(package: str, module: str, fn: str):
    """``package.workloads.<module>.<fn>``."""
    return getattr(importlib.import_module(f"{package}.workloads.{module}"),
                   fn)


def check_same_result(fn: str, got: dict, want: dict) -> None:
    """Two runs of one runner call agree: exactly, except PageRank's
    ``max_err`` (each within the runner's tol, the two within 1e-5:
    float32 contributions summed in another order) and ALS's
    ``rmse_final`` (within 1e-9 relative: the solves batch differently)."""
    assert got.keys() == want.keys()
    if fn == "run_pagerank":
        for k in ("vertices", "edges", "iterations"):
            assert got[k] == want[k]
        assert got["max_err"] <= 1e-3 and want["max_err"] <= 1e-3
        assert abs(got["max_err"] - want["max_err"]) <= 1e-5
    elif fn == "run_als":
        assert got["rmse_initial"] == want["rmse_initial"]
        assert got["iterations"] == want["iterations"]
        assert abs(got["rmse_final"] - want["rmse_final"]) \
            <= 1e-9 * abs(want["rmse_final"])
    else:
        assert got == want

