"""A sequence-parallel attention job fed by the shuffle: one document's
fused q|k|v rows, range-partitioned by position, read to the device and
consumed by the port's Ulysses attention.

Set-up draws each of ``documents`` documents on the device from the
seed: ``tokens`` rows of ``3 * heads * head_dim`` float32 lanes, in map
order, and a permutation that gives each row its position (the key).
Each document is written as one registered shuffle by ``maps`` map tasks
(each a contiguous block of rows, so the positions are permuted across
maps), ``shards`` range partitions of equal length, one a shard. A step
reads the next document in turn with ``read(ordered=True,
sink="device")`` and consumes it with the port's
``parallel/ulysses.ulysses_attention_consumer`` (causal): the
head/sequence trades and the flash forward. Set-up runs one step of each
document.

Compared after the window: the rows each shard received and the output O
of the last step of each document and of one step early in the window
drawn from the seed, against the written rows (exact) and
``reference/attention.py``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.drivers._common import (Clock, Phases, check, port_conf,
                                       span, sync)
from benchmark.reference import flops
from benchmark.reference.attention import causal_attention
from benchmark.reference.precision import strict_float32

SHUFFLE_ID = 700
KERNELS = {"segment_move": ["ragged_segment_copy"],
           "flash_fwd": ["flash_fwd"]}


def o_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest elementwise gap over the largest ``|want|``."""
    return float((got - want).abs().max() / want.abs().max())


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, kernel_cache: Path):
        self.heads = int(config["n_heads"])
        self.head_dim = int(config["d_model"]) // self.heads
        self.traffic = traffic
        self.t = int(traffic["tokens"])
        self.docs = int(traffic["documents"])
        self.maps = int(traffic["maps"])
        self.shards = int(traffic["shards"])
        self.causal = bool(traffic["causal"])
        self.seed = int(seed)
        self.device = device
        self.conf = port_conf(traffic, kernel_cache)
        self.i = 0
        self.held = {}
        # one step early in the window, drawn from the seed, is kept too
        self.sample = self.docs + self.seed % self.docs
        self.lanes = 3 * self.heads * self.head_dim

    def _documents(self) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        self.vals, self.pos = [], []
        for _ in range(self.docs):
            v = torch.randn(self.t, self.lanes, generator=g,
                            device=self.device)
            p = torch.randperm(self.t, generator=g, device=self.device)
            self.vals.append(v.cpu().numpy())
            self.pos.append(p.cpu().numpy().astype(np.int64))
            del v, p

    def setup(self) -> None:
        from sparkucx_tpu_torch import connect
        from sparkucx_tpu_torch.parallel.ulysses import \
            ulysses_attention_consumer
        ph = Phases(self.device)
        self._documents()
        ph.mark("documents")
        per_shard = self.t // self.shards
        self.svc = connect(self.conf, device=self.device,
                           num_shards=self.shards, use_env=False)
        ph.mark("connect")
        self.handles = []
        per = self.t // self.maps
        for d in range(self.docs):
            h = self.svc.register_shuffle(
                SHUFFLE_ID + d, self.maps, self.shards, "range",
                bounds=[per_shard * (i + 1) for i in range(self.shards - 1)])
            for m in range(self.maps):
                sl = slice(m * per, (m + 1) * per)
                self.svc.write(h, m, self.pos[d][sl], self.vals[d][sl])
            self.handles.append(h)
        ph.mark("stage")
        self.step_fn = ulysses_attention_consumer(
            self.shards, per_shard, self.heads, self.head_dim,
            causal=self.causal)
        for d in range(self.docs):
            self.step(False)
            ph.mark(f"warm_step{d}")
        ph.report()
        self.payload_bytes = self.svc.report(SHUFFLE_ID).payload_bytes

    def step(self, trace: bool) -> dict:
        i, d = self.i, self.i % self.docs
        h = self.handles[d]
        rec = {"tokens": self.t}
        if trace:
            with span("bench.read"), Clock(self.device) as c:
                res = self.svc.read(h, ordered=True, sink="device")
            rec["read_ms"] = c.ms
            rec["pack_ms"] = self.svc.report(h.shuffle_id).pack_ms
        else:
            res = self.svc.read(h, ordered=True, sink="device")

        def fn(carry, rows, totals):
            out = self.step_fn(rows, totals)
            self.held[("last", d)] = (rows, totals, out)
            if i == self.sample:
                self.held[("sample", d)] = (rows, totals, out)
            return out

        with span("bench.consume", trace):
            res.consume(fn)
            sync(self.device)
        self.i += 1
        return rec

    def facts(self, steps) -> dict:
        fwd = flops.flash_fwd(self.heads, self.t, self.head_dim, self.causal)
        return {
            "model_flops": len(steps) * fwd["flops"],
            "kernel_work": {
                "segment_move": {"symbols": KERNELS["segment_move"],
                                 **flops.segment_move(self.payload_bytes)},
                "flash_fwd": {"symbols": KERNELS["flash_fwd"], **fwd}},
            "spans": {k: [s[k] for s in steps if k in s]
                      for k in ("read_ms", "pack_ms")}}

    def release(self) -> None:
        self.svc.stop()
        del self.svc, self.handles, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def document(self, d: int) -> torch.Tensor:
        """Document ``d``'s rows in position order, on the device."""
        out = torch.empty(self.t, self.lanes, device=self.device)
        out[torch.from_numpy(self.pos[d]).to(self.device)] = \
            torch.from_numpy(self.vals[d]).to(self.device)
        return out

    def qkv(self, doc: torch.Tensor):
        """q, k, v ``[H, T, Dh]`` of a position-ordered document."""
        x = doc.view(self.t, 3, self.heads, self.head_dim)
        return tuple(x[:, j].transpose(0, 1) for j in range(3))

    def rows_wrong(self, rows, totals, doc: torch.Tensor) -> int:
        """Rows of the document that a shard lacks or holds altered, on
        the device: each shard's delivered rows sorted by position, then
        compared bit for bit with the positions of its range."""
        per = self.t // self.shards
        bits = doc.view(torch.int32)
        wrong = 0
        for p in range(self.shards):
            n = int(totals[p])
            r = rows[p, :n, :2 + self.lanes]
            key = r[:, 0].long() + (r[:, 1].long() << 32)
            r = r[torch.argsort(key)]
            m = min(n, per)
            want = torch.arange(p * per, p * per + m, device=r.device)
            bad = (r[:m, 0] != want) | (r[:m, 1] != 0) \
                | (r[:m, 2:] != bits[p * per:p * per + m]).any(dim=1)
            wrong += int(bad.sum()) + abs(n - per)
        return wrong

    def reference(self, d: int, tf32: bool = False) -> torch.Tensor:
        strict_float32()
        q, k, v = self.qkv(self.document(d))
        if not self.causal:
            raise ValueError("the reference is causal attention")
        return causal_attention(q, k, v, self.head_dim ** -0.5, tf32)

    def control_readings(self, steps: int) -> dict:
        """The control in the program's place: the reference in TF32 on
        each document, against the reference."""
        self._documents()
        err = 0.0
        for d in range(self.docs):
            want = self.reference(d)
            err = max(err, o_error(self.reference(d, tf32=True), want))
            del want
        return {"o_error": err}

    def check(self) -> list:
        wrong, err = 0, 0.0
        for d in range(self.docs):
            got = [v for (kind, dd), v in self.held.items() if dd == d]
            if not got:
                continue
            doc = self.document(d)
            for rows, totals, _ in got:
                wrong += self.rows_wrong(rows, totals, doc)
            del doc
            want = self.reference(d)
            for _, _, out in got:
                err = max(err, o_error(out[0], want))
            del want
        return [check(self.traffic, "rows_wrong", wrong),
                check(self.traffic, "o_error", err)]
