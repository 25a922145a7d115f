"""Hierarchical multi-slice shuffle — the FUSED two-stage exchange (the
JAX package's ``sparkucx_tpu/shuffle/hierarchical.py``).

Both stages of ``shuffle/topology.py`` in one step with no host join
between them: stage 1's totals feed stage 2 on the card, stage 2 draws
its int8 noise from a distinct stream of each shard's seed
(``wire_noise_seed(seed, 1)``), and the two overflow flags OR, so one
overflow regrows ``cap_out`` (the relay and the receive capacity alike)
and re-runs both stages — the flat reader's retry contract. The stage
bodies are topology's, so the fused and the tiered forms cannot drift.

    route (s, d) -> (s', d')  as  (s, d) --ICI--> (s, d') --DCN--> (s', d')

The managers read through the tiered form (per-tier walls and retries),
so in one process nothing but the tests calls this form. It is kept for
the multi-process pending (ROADMAP item 7), which dispatches the fused
step across processes as the JAX package's ``shuffle/distributed.py``
does."""

from __future__ import annotations

import numpy as np
import torch

from sparkucx_tpu_torch.parallel.mesh import SliceGrid
from sparkucx_tpu_torch.shuffle.alltoall import wire_noise_seed
from sparkucx_tpu_torch.shuffle.plan import ShufflePlan
from sparkucx_tpu_torch.shuffle.reader import PendingShuffle
from sparkucx_tpu_torch.shuffle.topology import (TopologyDescriptor,
                                                 _stage1_body, _stage2_body,
                                                 check_hier_grid)
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER


def _hier_step_for(topo: TopologyDescriptor):
    """``step_for(plan)`` for :class:`reader.PendingShuffle`: the fused
    step ``(payload [P, cap_in, W], nvalid [P], seeds)`` -> (rows, seg,
    totals, overflow), the flat step's contract."""

    def step_for(plan: ShufflePlan):
        with GLOBAL_TRACER.span("shuffle.hier.build", ici=topo.ici_axis,
                                dcn=topo.dcn_axis):
            stage1 = _stage1_body(plan, topo, int(plan.cap_out))
            stage2 = _stage2_body(plan, topo, int(plan.cap_out))

        def step(payload: torch.Tensor, nvalid: torch.Tensor, seeds=None):
            relay, tot1, ovf1 = stage1(payload, nvalid, seeds)
            seeds2 = None if seeds is None \
                else [wire_noise_seed(s, 1) for s in seeds]
            rows_out, seg, total, ovf2 = stage2(relay, tot1, seeds2)
            return rows_out, seg, total, ovf1 | ovf2

        return step

    return step_for


def submit_shuffle_hierarchical(grid: SliceGrid, dcn_axis: str,
                                ici_axis: str, plan: ShufflePlan,
                                shard_rows: np.ndarray,
                                shard_nvalid: np.ndarray, val_shape,
                                val_dtype, device: torch.device,
                                on_done=None, admit=None) -> PendingShuffle:
    """Dispatch the fused two-stage exchange without blocking over a 2-D
    ``(dcn_axis, ici_axis)`` grid — the submit/poll contract of
    ``reader.submit_shuffle``."""
    S, D = (int(x) for x in grid.shape)
    topo = TopologyDescriptor("hier", ici_axis=ici_axis, dcn_axis=dcn_axis,
                              num_slices=S, per_slice=D)
    check_hier_grid(grid, topo)
    if plan.num_shards != S * D:
        raise ValueError(f"plan has {plan.num_shards} shards for a {S} x {D}"
                         f" grid")
    return PendingShuffle(plan, shard_rows, shard_nvalid, val_shape,
                          val_dtype, device, on_done=on_done, admit=admit,
                          step_for=_hier_step_for(topo))


def read_shuffle_hierarchical(grid: SliceGrid, dcn_axis: str, ici_axis: str,
                              plan: ShufflePlan, shard_rows: np.ndarray,
                              shard_nvalid: np.ndarray, val_shape, val_dtype,
                              device: torch.device):
    """The fused two-stage exchange with the flat reader's overflow-retry
    contract (submit + result)."""
    return submit_shuffle_hierarchical(
        grid, dcn_axis, ici_axis, plan, shard_rows, shard_nvalid,
        val_shape, val_dtype, device).result()
