"""The kernel library's build cache — the ``compile.*`` conf seam.

The JAX package points XLA's persistent compilation cache at a directory
here. The port compiles no program per shape: what a fresh process pays
is the one ``nvcc`` build of the CUDA kernels (``backend._build``), a
digest-keyed ``libsxt_kernels_<digest>.so``. These keys say where that
library is built and loaded from, so a second process (or a restart)
loads the first one's build instead of compiling again:

    spark.shuffle.tpu.compile.cacheEnabled        master switch (default on)
    spark.shuffle.tpu.compile.cacheDir            shared directory
                                                  (default the package's
                                                  ``_build/``)
    spark.shuffle.tpu.compile.minCompileTimeSecs  validated, no effect
                                                  (XLA's per-program
                                                  threshold; the port has
                                                  one library build)

With the cache off, a process builds into a private directory of its own
(removed at exit) and leaves nothing shared behind. ``Node.start`` calls
:func:`configure_compile_cache` with its conf, as the JAX package's node
does. Best-effort throughout: an unwritable directory logs and falls back
to the private build; cache plumbing never fails a shuffle.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.compile_cache")

_lock = threading.Lock()
_configured_dir: Optional[str] = None


def configure_compile_cache(conf) -> Optional[str]:
    """Bind this process's kernel builds to the conf's cache directory.
    Returns the shared directory, or None when the cache is off or the
    directory is unusable (builds then stay private to the process). A
    later call with a DIFFERENT directory logs and rebinds later builds;
    a library already loaded stays loaded."""
    global _configured_dir
    if not conf.compile_cache_enabled:
        log.debug("kernel build cache disabled by conf")
        backend.bind_build_dir(None, private=True)
        return None
    cache_dir = os.path.abspath(conf.compile_cache_dir)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        if not os.access(cache_dir, os.W_OK | os.X_OK):
            raise PermissionError(f"{cache_dir} is not writable")
        with _lock:
            if _configured_dir is not None and _configured_dir != cache_dir:
                log.warning("rebinding kernel build cache %s -> %s",
                            _configured_dir, cache_dir)
            backend.bind_build_dir(cache_dir)
            _configured_dir = cache_dir
        log.info("kernel build cache at %s", cache_dir)
        return cache_dir
    except Exception as e:
        # never let cache plumbing cost a shuffle
        log.warning("kernel build cache unavailable (%s); builds stay "
                    "private to this process", e)
        backend.bind_build_dir(None, private=True)
        return None


def cache_entry_count(cache_dir: str) -> int:
    """Kernel libraries in ``cache_dir`` (one ``libsxt_kernels_*.so`` per
    source digest); 0 for a missing directory."""
    try:
        return sum(1 for n in os.listdir(cache_dir)
                   if n.startswith("libsxt_kernels_") and n.endswith(".so"))
    except OSError:
        return 0
