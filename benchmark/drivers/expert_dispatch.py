"""An MoE trainer that stages tokens by expert through the shuffle and
trains each expert on the device-sink read.

Set-up draws, on the device from the seed, a router ``[D, E]`` and
``batches`` batches of tokens ``[N, D]``; a token's expert is its
router argmax, so the loads are what the seed's router gives
(near-uniform). Each batch is written as one registered shuffle by
``maps`` map tasks, key = expert id (``partitioner="direct"``), one
expert to a shard. A step reads the next batch in turn with
``read(sink="device")`` and consumes it with the port's
``models/moe.make_device_dispatch_step`` (one SGD step of every expert
on a reconstruction loss). Set-up runs one step of each batch; the
window runs the rest. The weights carry from step to step, so the
reference replays every step in order.

Compared after the window: the rows each expert received in the last
step of each batch (exact), every step's loss and the final expert
weights against ``reference/expert_step.py``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.drivers._common import (Clock, Phases, check, port_conf,
                                       rel_gap, row_mismatches, span, sync)
from benchmark.reference import expert_step as ref
from benchmark.reference import flops
from benchmark.reference.precision import strict_float32

SHUFFLE_ID = 500
KERNEL = "ragged_segment_copy"


def gaps(got_losses, got_w1, got_w2, losses, w1, w2, w0) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``weight_gap``: the distance of each final expert weight from the
    reference's, over how far the reference moved it from ``w0``."""
    loss_gap = max(rel_gap(float(a), b) for a, b in zip(got_losses, losses))
    weight_gap = 0.0
    for have, want, start in ((got_w1, w1, w0[0]), (got_w2, w2, w0[1])):
        moved = torch.linalg.vector_norm(want - start.to(want.device))
        weight_gap = max(weight_gap, float(torch.linalg.vector_norm(
            have.to(want.device) - want) / moved))
    return {"loss_gap": loss_gap, "weight_gap": weight_gap}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, kernel_cache: Path):
        self.d = int(config["d_model"])
        self.f = int(config["d_ff"])
        self.e = int(config["num_experts"])
        self.traffic = traffic
        self.n = int(traffic["tokens_per_step"])
        self.batches = int(traffic["batches"])
        self.maps = int(traffic["maps"])
        self.lr = float(traffic["lr"])
        self.seed = int(seed)
        self.device = device
        self.conf = port_conf(traffic, kernel_cache)
        self.i = 0
        self.losses, self.order, self.held = [], [], {}

    # -- inputs: the benchmark's own, shared with the reference -----------
    def _inputs(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        d, e, f = self.d, self.e, self.f
        router = torch.randn(d, e, generator=g, device=self.device) * d ** -.5
        x = torch.randn(self.batches, self.n, d, generator=g,
                        device=self.device)
        eids = torch.argmax(x @ router, dim=-1)
        w1 = torch.randn(e, d, f, generator=g, device=self.device) * d ** -.5
        w2 = torch.randn(e, f, d, generator=g, device=self.device) * f ** -.5
        return x, eids, w1, w2

    def _host_inputs(self):
        x, eids, w1, w2 = self._inputs()
        self.x = x.cpu().numpy()
        self.eids = eids.cpu().numpy()
        self.w0 = (w1.cpu(), w2.cpu())
        return w1, w2

    def setup(self) -> None:
        from sparkucx_tpu_torch import connect
        from sparkucx_tpu_torch.models import moe as tm
        ph = Phases(self.device)
        w1, w2 = self._host_inputs()
        ph.mark("inputs")
        self.svc = connect(self.conf, device=self.device,
                           num_shards=self.e, use_env=False)
        ph.mark("connect")
        self.handles = []
        for b in range(self.batches):
            h = self.svc.register_shuffle(SHUFFLE_ID + b, self.maps, self.e,
                                          partitioner="direct")
            tm.stage_tokens_by_expert(self.svc.manager, h, self.x[b],
                                      self.eids[b])
            self.handles.append(h)
        ph.mark("stage")
        first = self.svc.read(self.handles[0], sink="device")
        cap = int(first.device_rows().shape[1])
        cfg = tm.MoEConfig(d_model=self.d, d_hidden=self.f,
                           num_experts=self.e)
        _, self.step_fn = tm.make_device_dispatch_step(
            cfg, cap, self.e, lr=self.lr, device=self.device)
        self.params = {"w1": w1, "w2": w2}
        self._consume(first)
        ph.mark("first_step")
        for _ in range(1, self.batches):
            self.step(False)
        ph.mark("warm_steps")
        ph.report()
        self.payload_bytes = self.svc.report(SHUFFLE_ID).payload_bytes

    def _consume(self, res) -> None:
        b = self.i % self.batches

        def fn(carry, rows, totals):
            self.held[b] = (rows, totals)
            return self.step_fn(carry[0], rows, totals)

        self.params, loss = res.consume(fn, (self.params, None))
        self.losses.append(loss)
        self.order.append(b)
        self.i += 1

    def step(self, trace: bool) -> dict:
        h = self.handles[self.i % self.batches]
        rec = {"tokens": self.n}
        if trace:
            with span("bench.read"), Clock(self.device) as c:
                res = self.svc.read(h, sink="device")
            rec["read_ms"] = c.ms
            rec["pack_ms"] = self.svc.report(h.shuffle_id).pack_ms
        else:
            res = self.svc.read(h, sink="device")
        with span("bench.consume", trace):
            self._consume(res)
            sync(self.device)
        return rec

    def facts(self, steps) -> dict:
        return {
            "model_flops": len(steps) * flops.expert_step(self.n, self.d,
                                                          self.f),
            "kernel_work": {"segment_move": {
                "symbols": [KERNEL], **flops.segment_move(
                    self.payload_bytes)}},
            "spans": {k: [s[k] for s in steps if k in s]
                      for k in ("read_ms", "pack_ms")}}

    def release(self) -> None:
        self.svc.stop()
        del self.svc, self.handles, self.step_fn
        self.final = {k: v.detach() for k, v in self.params.items()}
        del self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def expected_rows(self, b: int, shard: int) -> np.ndarray:
        sel = self.eids[b] == shard
        out = np.zeros((int(sel.sum()), 2 + self.d), dtype=np.int32)
        out[:, 0] = shard
        out[:, 2:] = self.x[b][sel].view(np.int32)
        return out

    def rows_wrong(self) -> int:
        wrong = 0
        for b, (rows, totals) in sorted(self.held.items()):
            rows, totals = rows.cpu().numpy(), totals.cpu().numpy()
            for p in range(self.e):
                wrong += row_mismatches(rows[p, :totals[p], :2 + self.d],
                                        self.expected_rows(b, p),
                                        (0, 2, 3, 4, 5))
        return wrong

    def replay(self, tf32: bool = False):
        """The reference over the same steps: ``(losses, w1, w2)``."""
        strict_float32()
        dev = self.device
        groups = []
        for b in range(self.batches):
            x = torch.from_numpy(self.x[b]).to(dev)
            e = torch.from_numpy(self.eids[b]).to(dev)
            groups.append(ref.group_by_expert(x, e, self.e))
        w1, w2 = (w.to(dev) for w in self.w0)
        losses = []
        for b in self.order:
            w1, w2, loss = ref.sgd_step(w1, w2, groups[b], self.lr, tf32)
            losses.append(loss)
        return losses, w1, w2

    def control_readings(self, steps: int) -> dict:
        """The control in the program's place: the reference in TF32 over
        ``steps`` steps in the window's order, against the reference."""
        self._host_inputs()
        self.order = [i % self.batches for i in range(steps)]
        losses, w1, w2 = self.replay(tf32=True)
        want = self.replay()
        return gaps(losses, w1, w2, *want, self.w0)

    def check(self) -> list:
        got = torch.stack(self.losses).double().cpu().tolist()
        r = gaps(got, self.final["w1"], self.final["w2"], *self.replay(),
                 self.w0)
        return [check(self.traffic, "rows_wrong", self.rows_wrong())] + \
            [check(self.traffic, k, v) for k, v in r.items()]
