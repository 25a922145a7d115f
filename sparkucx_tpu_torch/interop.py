"""Carrying shuffle state across from the JAX package.

There are no weights; the state that crosses is the control plane — the
segment table (its byte codec is shared) and packed ``[.., W]`` int32
rows — plus the conf. Inputs are numpy arrays or bytes only, so this
module needs nothing of the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.meta.segments import SegmentTable


def from_reference(table_blob: bytes, num_maps: int, num_partitions: int,
                   rows: Optional[Union[np.ndarray, bytes]] = None,
                   width: Optional[int] = None, device=None
                   ) -> Tuple[SegmentTable, Optional[torch.Tensor]]:
    """A reference-side ``SegmentTable.pack()`` blob and packed rows ->
    the port's (SegmentTable, int32 rows tensor on ``device``). ``device``
    defaults to the CUDA device and raises without one, as every entry
    point does; ``device="cpu"`` is the explicit CPU request.

    ``rows`` — an int32 array of any leading shape ``[..., W]``, or raw
    little-endian int32 bytes with ``width`` giving W."""
    dev = backend.resolve_device(device)
    table = SegmentTable.unpack(bytes(table_blob), num_maps, num_partitions)
    if rows is None:
        return table, None
    if isinstance(rows, (bytes, bytearray, memoryview)):
        if not width:
            raise ValueError("row bytes need their width")
        arr = np.frombuffer(bytes(rows), dtype="<i4").reshape(-1, width)
    else:
        arr = np.asarray(rows)
        if arr.dtype != np.int32:
            raise ValueError(f"rows must be int32, got {arr.dtype}")
    return table, torch.from_numpy(np.array(arr, copy=True)).to(dev)


def conf_from_dict(conf: Mapping[str, str],
                   use_env: bool = False) -> ShuffleConf:
    """The port's conf from the flat ``spark.shuffle.tpu.*`` dict the JAX
    package takes (no environment overlay unless asked)."""
    return ShuffleConf(conf, use_env=use_env)
