"""Checkpoint / resume — train state and shuffle-state snapshots.

* :class:`TrainCheckpointer` — step checkpoints of a training state (a
  nested dict / list / tuple of tensors, numpy arrays and Python
  scalars: parameters, optimizer state, a step counter) with retention
  and latest-step resume, over ``torch.save`` / ``torch.load``. The JAX
  package's is Orbax; this keeps its surface (``save``, ``latest_step``,
  ``all_steps``, ``restore(step, target)``, ``keep`` retention, a
  ``FileNotFoundError`` when nothing is saved). ``target`` puts every
  tensor back on the target's device and dtype, the counterpart of
  Orbax's restore shardings. Writes are atomic (``utils/atomicio``).
* :func:`snapshot_shuffles` / :func:`restore_shuffles` — persist a shuffle
  manager's live state (registration, partitioner, every writer's staged
  keys and values and whether it committed) so a preempted job resumes
  mid-shuffle instead of recomputing every map task. One ``.npz`` per
  shuffle, the JAX package's layout and version (``_SNAP_VERSION``), so a
  snapshot written by either package restores in the other.
"""

from __future__ import annotations

import io
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.utils.atomicio import atomic_write_bytes
from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.checkpoint")

_STEP_RE = re.compile(r"step_(\d+)\.pt")
_NDARRAY = "__ndarray__"


def _encode(x):
    """A state tree with its numpy leaves as byte tensors (what
    ``torch.load(weights_only=True)`` reads back) and its tensors on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.array(x, copy=True, order="C")
        return (_NDARRAY, torch.from_numpy(a.reshape(-1).view(np.uint8)
                                           .copy()),
                a.dtype.str, list(a.shape), isinstance(x, np.generic))
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    return x


def _decode(x, target=None):
    """Inverse of :func:`_encode`; a tensor leaf goes to the matching
    ``target`` leaf's device and dtype."""
    if isinstance(x, tuple) and len(x) == 5 and x[0] == _NDARRAY:
        _, raw, dtype, shape, scalar = x
        a = np.frombuffer(raw.numpy().tobytes(),
                          dtype=np.dtype(dtype)).reshape(shape).copy()
        return a[()] if scalar else a
    if isinstance(x, torch.Tensor):
        if isinstance(target, torch.Tensor):
            return x.to(device=target.device, dtype=target.dtype)
        return x
    if isinstance(x, dict):
        t = target if isinstance(target, dict) else {}
        return {k: _decode(v, t.get(k)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        t = target if isinstance(target, (list, tuple)) \
            and len(target) == len(x) else [None] * len(x)
        return type(x)(_decode(v, tv) for v, tv in zip(x, t))
    return x


class TrainCheckpointer:
    """Step-indexed state checkpoints with retention: one
    ``step_<N>.pt`` per saved step under ``directory``, the newest
    ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(1, int(keep))

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{int(step)}.pt")

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Persist ``state`` at ``step``. A step already saved is kept
        unless ``force``; returns whether this call wrote."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            return False
        buf = io.BytesIO()
        torch.save({"step": int(step), "state": _encode(state)}, buf)
        atomic_write_bytes(path, buf.getvalue())
        for old in self.all_steps()[:-self._keep]:
            try:
                os.unlink(self._path(old))
            except FileNotFoundError:
                pass
        return True

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for n in os.listdir(self._dir)
                      for m in [_STEP_RE.fullmatch(n)] if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None) -> Any:
        """The state saved at ``step`` (default: latest). ``target`` — a
        state of the same structure (e.g. the freshly initialized one):
        every tensor comes back on its target leaf's device and dtype;
        without it, tensors come back on the host."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self._dir}")
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self._dir}")
        doc = torch.load(path, map_location="cpu", weights_only=True)
        return _decode(doc["state"], target)

    def close(self) -> None:
        pass

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- shuffle-state snapshots ----------------------------------------------
_SNAP_VERSION = 1


def snapshot_shuffles(manager, directory: str) -> int:
    """Persist every live shuffle of ``manager`` to ``directory``.

    Written per shuffle: the registration shape, the partitioner (and a
    range partitioner's bounds), and each writer's staged (keys, values)
    with whether it committed. One ``.npz`` per shuffle keeps the format
    inspectable and versioned. Returns the number of shuffles written."""
    os.makedirs(directory, exist_ok=True)
    count = 0
    for sid in manager.live_shuffles():
        entry = manager.node.registry.get(sid)
        staged = manager.export_shuffle(sid)
        payload: Dict[str, Any] = {
            "version": np.int64(_SNAP_VERSION),
            "shuffle_id": np.int64(sid),
            "num_maps": np.int64(entry.num_maps),
            "num_partitions": np.int64(entry.num_partitions),
            "partitioner": np.bytes_(entry.partitioner.encode()),
        }
        if entry.bounds is not None:
            payload["bounds"] = np.asarray(entry.bounds, dtype=np.int64)
        for map_id, (keys, values, committed) in staged.items():
            payload[f"keys_{map_id}"] = keys
            payload[f"committed_{map_id}"] = np.bool_(committed)
            if values is not None:
                payload[f"values_{map_id}"] = values
        # stored, not deflated: staged key and value words are close to
        # random, so deflate saves under 1% at a high cost in time;
        # np.load reads both layouts
        np.savez(os.path.join(directory, f"shuffle_{sid}.npz"), **payload)
        count += 1
    log.info("snapshot: %d shuffles -> %s", count, directory)
    return count


def restore_shuffles(manager, directory: str) -> Dict[int, Any]:
    """Re-register and re-stage every shuffle found in ``directory``.

    Committed map outputs are published again (their size rows follow
    from the staged keys, so the table matches the snapshot); uncommitted
    writers come back staged but uncommitted. Returns ``{shuffle_id:
    ShuffleHandle}``. When some snapshots fail, the rest still restore
    and the raised ``RuntimeError`` carries their handles as
    ``.handles``."""
    handles: Dict[int, Any] = {}
    failures = []
    for name in sorted(os.listdir(directory)):
        m = re.fullmatch(r"shuffle_(\d+)\.npz", name)
        if not m:
            continue
        try:
            _restore_one(manager, directory, name, handles)
        except Exception as e:
            failures.append((name, e))
    if failures:
        detail = "; ".join(f"{n}: {e}" for n, e in failures)
        err = RuntimeError(
            f"restored {len(handles)} shuffles but {len(failures)} "
            f"failed ({detail}); the restored ones remain registered — "
            f"their handles ride on this exception as .handles")
        # no manager API rebuilds a handle from an id: the restored
        # shuffles are reachable only through these
        err.handles = handles
        raise err
    log.info("restore: %d shuffles <- %s", len(handles), directory)
    return handles


def _restore_one(manager, directory: str, name: str,
                 handles: Dict[int, Any]) -> None:
    with np.load(os.path.join(directory, name)) as z:
        version = int(z["version"])
        if version > _SNAP_VERSION:
            raise ValueError(
                f"{name}: snapshot version {version} is newer than "
                f"supported {_SNAP_VERSION}")
        sid = int(z["shuffle_id"])
        num_maps = int(z["num_maps"])
        num_partitions = int(z["num_partitions"])
        partitioner = bytes(z["partitioner"]).decode()
        bounds = z["bounds"] if "bounds" in z else None
        h = manager.register_shuffle(sid, num_maps, num_partitions,
                                     partitioner=partitioner,
                                     bounds=bounds)
        try:
            for map_id in range(num_maps):
                kname = f"keys_{map_id}"
                if kname not in z:
                    continue
                keys = z[kname]
                vname = f"values_{map_id}"
                values = z[vname] if vname in z else None
                w = manager.get_writer(h, map_id)
                if keys.shape[0]:
                    w.write(keys, values)
                if bool(z[f"committed_{map_id}"]):
                    w.commit(num_partitions)
        except Exception:
            # a snapshot failing after registration must not stay
            # registered: a retry would hit 'already registered', and a
            # read would wait on maps that never publish
            manager.unregister_shuffle(sid)
            raise
        handles[sid] = h
