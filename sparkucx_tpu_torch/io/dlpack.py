"""DLPack interop and the host-to-device on-ramp (the JAX package's
``sparkucx_tpu/io/dlpack.py``).

Zero-copy import and export of tensors through the DLPack protocol, on
``torch.from_dlpack``, and :func:`stage_to_device`, the pinned
non-blocking copy every pending exchange stages its rows with
(``shuffle/reader.py``, ``shuffle/topology.py``). Every function lands
on the card unless the caller names the CPU (``device="cpu"``); a
failing copy or an unknown device raises."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sparkucx_tpu_torch.backend import resolve_device


def from_external(tensor: Any) -> torch.Tensor:
    """Import any ``__dlpack__``-capable tensor (numpy, cupy, another
    framework's) without copying where the producer's memory allows;
    other array-likes go through numpy."""
    if hasattr(tensor, "__dlpack__"):
        return torch.from_dlpack(tensor)
    return torch.from_numpy(np.asarray(tensor))


def to_external(t: torch.Tensor, consumer: str = "numpy") -> Any:
    """Export a tensor. ``consumer``: numpy (a host array, copied off the
    card when the tensor lives there) | torch (the DLPack round trip: a
    tensor sharing ``t``'s memory)."""
    if consumer == "numpy":
        return t.detach().cpu().numpy()
    if consumer == "torch":
        return torch.from_dlpack(t)
    raise ValueError(f"unknown consumer {consumer!r}")


def _host_copy(tensor: Any) -> torch.Tensor:
    """The producer's own host materialization (``.cpu()`` for torch,
    ``.get()`` for cupy, ``__array__`` otherwise) as a CPU tensor."""
    if hasattr(tensor, "cpu"):
        host = tensor.cpu()
    elif hasattr(tensor, "get"):
        host = tensor.get()
    elif hasattr(tensor, "__array__") or isinstance(tensor, np.ndarray):
        host = np.asarray(tensor)
    else:
        raise TypeError(
            f"cannot ingest {type(tensor).__name__}: no DLPack capsule "
            f"the backend accepts and no host materialization protocol "
            f"(.cpu()/.get()/__array__)")
    if isinstance(host, torch.Tensor):
        return host
    return torch.from_numpy(np.ascontiguousarray(host))


def ingest_foreign(tensor: Any, device=None, pool=None) -> torch.Tensor:
    """Ingest a foreign tensor onto ``device`` (default: the card).

    The ladder, fastest first:

    1. zero-copy ``torch.from_dlpack`` when the producer's memory is
       already on ``device``;
    2. the producer's own host copy (:func:`_host_copy`), through a
       page-locked block of ``pool`` (a ``runtime/node.HostStagingPool``)
       when one is given, then :func:`stage_to_device`; the block goes
       back to the pool once the copy has finished;
    3. a ``TypeError`` for an object with neither.

    A capsule that cannot be imported falls through to the host copy,
    which still lands on ``device``."""
    device = resolve_device(device)
    if hasattr(tensor, "__dlpack__"):
        try:
            out = torch.from_dlpack(tensor)
        except Exception:
            out = None    # a capsule torch cannot import: bounce it
        if out is not None and out.device == device:
            return out
    host = _host_copy(tensor)
    if pool is None:
        return stage_to_device(host, device)
    nbytes = host.numel() * host.element_size()
    buf = pool.get(nbytes)
    try:
        staged = buf[:nbytes].view(host.dtype).reshape(host.shape)
        staged.copy_(host)
        if device.type == "cpu":
            return staged.clone()       # the block goes back to the pool
        out = stage_to_device(staged, device)
        # the copy reads the block asynchronously: wait before the pool
        # can hand it out again
        torch.cuda.current_stream(device).synchronize()
        return out
    finally:
        pool.put(buf)


def stage_to_device(host, device=None) -> torch.Tensor:
    """The host-to-device on-ramp: ``host`` (a numpy array or a CPU
    tensor) copied onto ``device`` (default: the card) from page-locked
    memory without blocking the caller — a pageable source is pinned
    first. On the CPU the tensor is returned as it is (no copy)."""
    device = resolve_device(device)
    t = host if isinstance(host, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cpu":
        return t.cpu()
    if t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
