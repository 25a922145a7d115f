"""The logical shard grid of one node — the port's counterpart of the JAX
package's shuffle mesh (``sparkucx_tpu/parallel/mesh.py``).

The P logical shards of one device take the places of the mesh's
devices. Single-slice (``mesh.numSlices`` <= 1): a 1-D grid ``(shuffle=P)``.
Multi-slice: a 2-D grid ``(dcn=S, shuffle=P/S)``, slice-major, so global
shard ``g = s * D + d`` and the hierarchical exchange
(``shuffle/topology.py``) runs stage 1 within each row of the grid and
stage 2 down each column. The axes carry the JAX package's default names,
``dcn`` and ``shuffle``.

Across processes (a distributed node, ``numProcesses`` = N > 1) the P
global shards are split into N contiguous blocks, process p owning
``[p * L, (p + 1) * L)`` with L = P / N (:func:`local_shard_ids`): the
JAX mesh's device order, so with ``mesh.numSlices`` = N the slice
boundary is the process boundary."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from sparkucx_tpu_torch.config import ShuffleConf

DCN_AXIS = "dcn"
ICI_AXIS = "shuffle"


@dataclass(frozen=True)
class SliceGrid:
    """Shape and axis names of a node's logical shards: ``shape`` is
    ``(P,)`` or ``(S, P // S)``, ``axis_names`` the matching names."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_shuffle_grid(num_shards: int, conf: ShuffleConf) -> SliceGrid:
    """Lay ``num_shards`` shards out as the JAX package lays devices out
    (``make_shuffle_mesh``): 2-D ``(dcn, ici)`` when ``mesh.numSlices`` >
    1, else 1-D. Raises when the slices do not divide the shards."""
    slices = conf.num_slices
    if num_shards % max(slices, 1) != 0:
        raise ValueError(
            f"{num_shards} shards do not divide into {slices} slices")
    if slices > 1:
        return SliceGrid((slices, num_shards // slices),
                         (DCN_AXIS, ICI_AXIS))
    return SliceGrid((num_shards,), (ICI_AXIS,))


def local_shard_ids(num_shards: int, num_processes: int,
                    process_id: int) -> List[int]:
    """Global shard ids process ``process_id`` of ``num_processes`` owns:
    a contiguous block of ``num_shards / num_processes``. Raises when the
    processes do not divide the shards."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} out of [0, "
                         f"{num_processes})")
    if num_shards % num_processes != 0:
        raise ValueError(
            f"{num_shards} shards do not divide into {num_processes} "
            f"processes")
    per = num_shards // num_processes
    return list(range(process_id * per, (process_id + 1) * per))
