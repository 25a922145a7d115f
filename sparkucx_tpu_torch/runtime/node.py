"""The per-process runtime: device, metrics, shuffle registry and the
host staging pool.

A :class:`Node` is an object the caller creates and passes (no process
singleton). It owns the device every shuffle of its manager runs on, the
number of logical shards ``P`` the exchange splits that device into and
their grid (``parallel/mesh.SliceGrid``: ``[S, P/S]`` when
``mesh.numSlices`` = S > 1) — the role the JAX package's mesh plays."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.backend import resolve_device
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.meta.registry import ShuffleRegistry
from sparkucx_tpu_torch.parallel.mesh import make_shuffle_grid
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import Metrics

log = get_logger("runtime.node")

# the reference read runs on an 8-device mesh; the port's default shard
# count matches so one conf and one dataset drive both packages alike
DEFAULT_SHARDS = 8


def _empty_host_cache() -> None:
    """Hand torch's cached page-locked blocks that nothing uses back to
    the CUDA runtime (torch keeps every freed pinned block for reuse)."""
    fn = getattr(torch.accelerator, "empty_host_cache", None) \
        or torch._C._host_emptyCache
    fn()


class HostStagingPool:
    """Reusable host byte buffers for map-side staging and the pack
    stage. On a CUDA node the buffers are page-locked
    (``pin_memory=True``), so the staged rows reach the device in one DMA
    with no pageable bounce; pinning is slow to allocate, so freed
    buffers are kept and handed out again, up to ``max_free_bytes``: a
    ``put`` past it drops the longest-free buffers and, on a CUDA node,
    empties torch's cache of unused pinned blocks, so a process keeps no
    more than that of an earlier, larger job's staging.

    Byte accounting at the ``get``/``put`` seam, as the JAX package's
    pool keeps it: ``stats()["in_use_bytes"]`` is the summed ``numel()``
    of the buffers checked out now (a reused buffer may be up to twice
    the request, and counts whole), ``peak_bytes`` its high-water mark
    since the last :meth:`reset_peak_bytes`. A second ``put`` of one
    buffer raises and moves no count."""

    # a 1 GB shuffle's staging plus its pack buffer come to about 2.4 GB:
    # jobs of that size one after another keep reusing their blocks
    max_free_bytes = 4 << 30

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._free: List[torch.Tensor] = []     # longest free first
        self._free_bytes = 0
        self._out: Dict[int, torch.Tensor] = {}   # id -> checked-out buffer
        self._in_use_bytes = 0
        self._peak_bytes = 0
        self._lock = threading.Lock()

    def get(self, nbytes: int) -> torch.Tensor:
        """A uint8 buffer of at least ``nbytes`` (at most twice that when
        a free one is reused)."""
        nbytes = max(int(nbytes), 1)
        with self._lock:
            fits = [i for i, b in enumerate(self._free)
                    if nbytes <= b.numel() <= 2 * nbytes]
            buf = self._free.pop(min(
                fits, key=lambda i: self._free[i].numel())) if fits else None
            if buf is not None:
                self._free_bytes -= buf.numel()
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self.pinned)
        with self._lock:
            self._out[id(buf)] = buf
            self._in_use_bytes += buf.numel()
            self._peak_bytes = max(self._peak_bytes, self._in_use_bytes)
        return buf

    def put(self, buf: torch.Tensor) -> None:
        with self._lock:
            if self._out.pop(id(buf), None) is None:
                raise ValueError("pool.put of a buffer that is not checked "
                                 "out (a second put of one buffer?)")
            self._in_use_bytes -= buf.numel()
            self._free.append(buf)
            self._free_bytes += buf.numel()
            dropped = 0
            while self._free_bytes > self.max_free_bytes:
                self._free_bytes -= self._free.pop(0).numel()
                dropped += 1
        if dropped and self.pinned:
            _empty_host_cache()

    def stats(self) -> Dict[str, int]:
        """{'in_use', 'in_use_bytes', 'peak_bytes', 'free', 'free_bytes'}:
        buffers and bytes checked out, the high-water mark of the bytes,
        and the buffers and bytes kept for reuse."""
        with self._lock:
            return {"in_use": len(self._out),
                    "in_use_bytes": self._in_use_bytes,
                    "peak_bytes": self._peak_bytes,
                    "free": len(self._free),
                    "free_bytes": self._free_bytes}

    def reset_peak_bytes(self) -> int:
        """Reset the high-water mark to the bytes in use now; returns the
        prior peak (one measurement window per call)."""
        with self._lock:
            prior = self._peak_bytes
            self._peak_bytes = self._in_use_bytes
        return prior

    def close(self) -> None:
        with self._lock:
            if self._out:
                log.warning("closing the staging pool with %d buffers "
                            "(%d B) checked out", len(self._out),
                            self._in_use_bytes)
            self._free.clear()
            self._free_bytes = 0


class MappedFile:
    """A read-only ``np.memmap`` of a file as uint8 (``.data``); the
    spill files map their sealed columns back through it. (The JAX
    package maps through its native library when it is built; the port
    keeps numpy's mapping only.)"""

    def __init__(self, path: str):
        self.path = path
        self.data = np.memmap(path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return self.data.size

    def close(self) -> None:
        """Drop this mapping; it unmaps once no view of it is left."""
        self.data = None


class Node:
    """Device + metrics + registry + staging pool for one process."""

    def __init__(self, conf: Optional[ShuffleConf] = None, device=None,
                 num_shards: int = DEFAULT_SHARDS):
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        self.conf = conf or ShuffleConf()
        self.device = resolve_device(device)
        self.num_shards = int(num_shards)
        self.grid = make_shuffle_grid(self.num_shards, self.conf)
        self.metrics = Metrics()
        self.registry = ShuffleRegistry()
        self.pool = HostStagingPool(pinned=self.device.type == "cuda")
        self._closed = False

    @classmethod
    def start(cls, conf: Optional[ShuffleConf] = None, device=None,
              num_shards: int = DEFAULT_SHARDS) -> "Node":
        """Bring up a node on ``device`` (default: the CUDA device; raises
        without one unless ``device="cpu"``)."""
        return cls(conf, device=device, num_shards=num_shards)

    def stats(self) -> Dict[str, float]:
        return self.metrics.snapshot()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.registry.clear()
        self.pool.close()
