"""Versioned host-engine adapters — the compat seam.

The same data plane behind two differently shaped facades, as the JAX
package's ``compat`` carries them:

- ``v1`` — ``service.ShuffleService``: positional
  ``register_shuffle(id, num_maps, num_partitions, ...)``, whole-result
  ``read()``.
- ``v2`` — :mod:`sparkucx_tpu_torch.compat.v2`: registration takes a
  ``ShuffleDependency`` descriptor, writers carry a (map_id, attempt_id)
  pair with first-commit-wins on attempts, and reads go through a reader
  object scoped to a partition range.

Selection is by conf key alone — ``spark.shuffle.tpu.compat.version``
(default ``v1``) — through :func:`sparkucx_tpu_torch.connect`. Both
adapters drive the one manager; neither reimplements the data plane.
"""

from __future__ import annotations

ADAPTER_VERSIONS = ("v1", "v2")


def resolve_adapter(version: str):
    """Adapter class for a ``compat.version`` conf value (ValueError on
    an unknown version — at connect() time, not first use)."""
    v = version.strip().lower()
    if v == "v1":
        from sparkucx_tpu_torch.service import ShuffleService
        return ShuffleService
    if v == "v2":
        from sparkucx_tpu_torch.compat.v2 import ShuffleServiceV2
        return ShuffleServiceV2
    raise ValueError(
        f"unknown spark.shuffle.tpu.compat.version {version!r}; "
        f"want one of {ADAPTER_VERSIONS}")
