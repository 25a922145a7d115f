"""The kernel library's build cache (``sparkucx_tpu_torch/runtime/
compile_cache.py`` over ``backend._build``): the port's counterpart of the
JAX package's persistent XLA cache seam (``tests/test_stepcache.py::
test_configure_compile_cache``, ``tests/test_plan_buckets.py::
test_compile_conf_keys_round_trip``).

The conf keys parse and validate as the reference's do;
``compile.minCompileTimeSecs`` has no effect. Precedence: an explicit
``compile.cacheDir``, else the package's ``_build/`` (the reference's
``JAX_COMPILATION_CACHE_DIR`` has no meaning here and is ignored). Disabled, or on an unusable directory, builds go to a private
directory of the process and a read still runs. A second call with
another directory rebinds later builds and keeps a loaded library.
``nvcc`` is stubbed: the build writes stand-in objects and a stand-in
library, which is never loaded."""

import logging
import os
import stat

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu_torch import backend, connect
from sparkucx_tpu_torch.config import DEFAULT_BUILD_DIR, ShuffleConf
from sparkucx_tpu_torch.runtime import compile_cache as cc

PFX = "spark.shuffle.tpu."


@pytest.fixture(autouse=True)
def restore_binding():
    """The binding is process-global: every test leaves it as it found
    it."""
    saved = (backend._bound_dir, backend._bound_private, backend._builds,
             backend._private_dir, cc._configured_dir)
    backend._private_dir = None          # a fresh private directory
    yield
    (backend._bound_dir, backend._bound_private, backend._builds,
     backend._private_dir, cc._configured_dir) = saved


@pytest.fixture()
def fake_nvcc(monkeypatch):
    """``nvcc`` stubbed: every command writes its ``-o`` target."""
    calls = []

    def run_all(cmds):
        for c in cmds:
            calls.append(c)
            out = c[c.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"stand-in")

    monkeypatch.setattr(backend, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(backend, "_run_all", run_all)
    return calls


def _conf(extra=None):
    return ShuffleConf(extra or {}, use_env=False)


def test_compile_conf_keys_round_trip():
    """The three keys parse and validate as the reference's; defaults:
    enabled, the package's build directory (no pid in it), 1.0 s."""
    m = {PFX + "compile.cacheEnabled": "false",
         PFX + "compile.cacheDir": "/tmp/x_cache",
         PFX + "compile.minCompileTimeSecs": "2.5"}
    for conf in (_conf(m), TpuShuffleConf(m, use_env=False)):
        assert conf.compile_cache_enabled is False
        assert conf.compile_cache_dir == "/tmp/x_cache"
        assert conf.compile_min_compile_time_secs == 2.5
    d = _conf()
    assert d.compile_cache_enabled is True
    assert d.compile_cache_dir == DEFAULT_BUILD_DIR
    assert str(os.getpid()) not in d.compile_cache_dir
    assert d.compile_min_compile_time_secs == 1.0
    bad = {PFX + "compile.minCompileTimeSecs": "-1"}
    for mk in (_conf, lambda m: TpuShuffleConf(m, use_env=False)):
        with pytest.raises(ValueError, match="minCompileTimeSecs"):
            mk(bad)
    keys = {r["key"] for r in ShuffleConf.describe_keys()}
    assert {PFX + "compile.cacheEnabled", PFX + "compile.cacheDir",
            PFX + "compile.minCompileTimeSecs"} <= keys


def test_configure_precedence_and_entry_count(tmp_path, monkeypatch):
    """Explicit dir -> created, bound and returned; the default -> the
    package's ``_build/``; ``JAX_COMPILATION_CACHE_DIR`` is ignored."""
    d = str(tmp_path / "kcache")
    got = cc.configure_compile_cache(_conf({
        PFX + "compile.cacheDir": d,
        PFX + "compile.minCompileTimeSecs": "0.5"}))
    assert got == d and os.path.isdir(d)
    assert backend.build_dir() == type(backend.BUILD_DIR)(d)
    assert cc.cache_entry_count(d) == 0
    assert cc.cache_entry_count(str(tmp_path / "missing")) == 0
    for name in ("libsxt_kernels_abc.so", "libsxt_kernels_def.so",
                 "libsxt_kernels.123.so", "ragged.o", "other.so"):
        open(os.path.join(d, name), "wb").close()
    assert cc.cache_entry_count(d) == 2
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cc.configure_compile_cache(_conf()) == DEFAULT_BUILD_DIR
    assert not (tmp_path / "env").exists()


def test_disabled_builds_privately_and_leaves_nothing_shared(
        tmp_path, fake_nvcc):
    shared = tmp_path / "shared"
    off = _conf({PFX + "compile.cacheEnabled": "false",
                 PFX + "compile.cacheDir": str(shared)})
    assert cc.configure_compile_cache(off) is None
    assert not shared.exists()
    path = backend._build()
    assert path.parent == backend.private_build_dir()
    assert not shared.exists() and path.exists()
    assert backend.build_count() >= 1


def test_build_lands_in_the_bound_dir_and_is_reused(tmp_path, fake_nvcc):
    """One build per digest: the first call builds into the bound dir,
    the second loads it (no nvcc); objects are removed."""
    d = tmp_path / "kc"
    cc.configure_compile_cache(_conf({PFX + "compile.cacheDir": str(d)}))
    b0 = backend.build_count()
    path = backend._build()
    assert path.parent == d
    assert path.name == f"libsxt_kernels_{backend.library_digest()}.so"
    n_sources = len(list(backend.CSRC_DIR.glob("*.cu")))
    assert len(fake_nvcc) == n_sources + 1      # compile each, then link
    assert backend.build_count() == b0 + 1
    assert sorted(os.listdir(d)) == [path.name]
    assert backend._build() == path
    assert backend.build_count() == b0 + 1
    assert cc.cache_entry_count(str(d)) == 1


def test_min_compile_time_does_not_keep_a_build_private(tmp_path,
                                                        fake_nvcc):
    """``minCompileTimeSecs`` is validated and not read (XLA's
    per-program threshold; the port has one library build): a stubbed
    build far quicker than it still lands shared and is reused."""
    d = tmp_path / "kc"
    cc.configure_compile_cache(_conf({
        PFX + "compile.cacheDir": str(d),
        PFX + "compile.minCompileTimeSecs": "3600"}))
    path = backend._build()
    assert path.parent == d
    assert cc.cache_entry_count(str(d)) == 1
    n = len(fake_nvcc)
    assert backend._build() == path and len(fake_nvcc) == n


def test_rebinding_logs_and_keeps_a_loaded_library(tmp_path, monkeypatch):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep(logging.WARNING)
    cc.log.addHandler(keep)
    sentinel = object()
    monkeypatch.setattr(backend, "_lib", sentinel)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cc.configure_compile_cache(_conf({PFX + "compile.cacheDir": a})) \
        == a
    try:
        assert cc.configure_compile_cache(
            _conf({PFX + "compile.cacheDir": b})) == b
    finally:
        cc.log.removeHandler(keep)
    assert any("rebinding" in m for m in records)
    assert str(backend.build_dir()) == b
    assert backend.kernel_library() is sentinel


def test_unwritable_dir_falls_back_without_failing_a_read(tmp_path):
    """A cache directory that cannot be made (under a file) or written
    (mode 0500) logs and falls back to the private build; the node
    starts and a read runs."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    ro = tmp_path / "ro"
    ro.mkdir()
    ro.chmod(stat.S_IRUSR | stat.S_IXUSR)
    try:
        for d in (blocker / "cache", ro):
            svc = connect({PFX + "a2a.impl": "dense",
                           PFX + "compile.cacheDir": str(d)},
                          device="cpu", use_env=False)
            try:
                if os.access(str(d), os.W_OK):
                    continue            # running as a user who may write
                assert svc.node.compile_cache_dir is None
                assert backend._bound_private
                h = svc.register_shuffle(1, 2, 4)
                rng = np.random.default_rng(0)
                for m in range(2):
                    svc.write(h, m, rng.integers(0, 1 << 30, size=50))
                got = sum(svc.read(h).partition(r)[0].size
                          for r in range(4))
                assert got == 100
            finally:
                svc.stop()
    finally:
        ro.chmod(stat.S_IRWXU)


def test_node_start_binds_the_conf_dir(tmp_path):
    d = str(tmp_path / "nodecache")
    with connect({PFX + "compile.cacheDir": d}, device="cpu",
                 use_env=False) as svc:
        assert svc.node.compile_cache_dir == d
        assert str(backend.build_dir()) == d
    with connect({}, device="cpu", use_env=False) as svc:
        assert svc.node.compile_cache_dir == DEFAULT_BUILD_DIR
