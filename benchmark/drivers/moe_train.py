"""A Switch trainer's step through the differentiable exchange: the port's
``models/transformer.make_train_step`` (the five-axis MoE transformer on
one card's logical grid), Adam, a fresh batch of uniform tokens each step.

Set-up draws the weights on the device from the seed and hands them to
the port, which copies them; it then drives that one trainer through its
first ``warm_steps`` steps (the same call and feed as the window's, each
on its own batch). After step 1 it reads the first gradient of each leaf
as Adam holds it (its first moment over ``1 - beta1``); after the last
it reads how far each leaf has moved. The window runs the steps that
follow on the same trainer; once it has closed, the driver reads how
far each leaf has moved in all and how many steps Adam counted.

Compared after the window against ``reference/transformer.py``, which
replays every step, warm and timed, from the seed's weights and
batches: each warm step's loss, the first gradient's norm and the change
after the warm steps; each timed step's loss and the change after the
last, each change by its worst leaf; and Adam's step count on every
leaf against the steps run (exact)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.drivers._common import (Phases, bind_kernel_cache, check,
                                       log_detail, rel_gap, span, sync)
from benchmark.reference import flops
from benchmark.reference import transformer as ref
from benchmark.reference.precision import strict_float32

KERNELS = {"flash_fwd": ["flash_fwd"], "flash_bwd": ["flash_dq",
                                                     "flash_dkv"]}
# leaves whose reference gradient is under this share of the median
# leaf's are nought to rounding and left out of the comparison
QUIET_LEAF = 1e-3


def leaf_gap(got: dict, want: dict, moved: dict) -> float:
    """The worst leaf's ``|got - want|`` over the larger of its ``want``
    and the median leaf's, over the leaves that ``moved`` (the
    reference's first gradient) does not leave out."""
    med = float(np.median(list(moved.values())))
    med_want = float(np.median(list(want.values())))
    return max(abs(got[k] - want[k]) / max(want[k], med_want)
               for k in want if moved[k] >= QUIET_LEAF * med)


def readings(losses, grad1, delta_warm, delta_end, want: dict,
             warm: int) -> dict:
    """The compared numbers of a run of ``len(losses)`` steps, the first
    ``warm`` of them set-up's, against the reference's ``adam_steps``
    result ``want`` (``delta_at`` holding step ``warm``)."""
    gaps = [rel_gap(a, b) for a, b in zip(losses, want["losses"])]
    out = {"loss_gap": max(gaps[:warm]),
           "grad_gap": leaf_gap(grad1, want["grad1"], want["grad1"]),
           "delta_gap": leaf_gap(delta_warm, want["delta_at"][warm],
                                 want["grad1"])}
    if len(losses) > warm:
        out["window_loss_gap"] = max(gaps[warm:])
        out["window_delta_gap"] = leaf_gap(delta_end, want["delta"],
                                           want["grad1"])
    return out


def detail(losses, grad1, delta_warm, delta_end, want: dict,
           warm: int) -> dict:
    """Each step's loss gap and each leaf's gradient and change gaps (over
    the leaf's own reference norm), for the record."""
    return {"loss": [rel_gap(a, b) for a, b in zip(losses, want["losses"])],
            "grad": {k: rel_gap(grad1[k], want["grad1"][k]) for k in grad1},
            "delta": {k: rel_gap(delta_warm[k], want["delta_at"][warm][k])
                      for k in delta_warm},
            "delta_end": {k: rel_gap(delta_end[k], want["delta"][k])
                          for k in delta_end}}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, kernel_cache: Path):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = device
        self.kernel_cache = kernel_cache
        self.grid = {k: int(config["grid"][k])
                     for k in ("dp", "pp", "sp", "tp", "ep")}
        g = self.grid
        self.batch = int(traffic["batch"])
        self.seq = int(traffic["seq_len"])
        self.micro = int(traffic["microbatches"])
        self.lr = float(traffic["lr"])
        self.warm = int(traffic["warm_steps"])
        self.shape = ref.Shape(
            vocab=int(config["vocab_size"]), d_model=int(config["d_model"]),
            heads=int(config["num_heads"]), head_dim=int(config["d_kv"]),
            d_ff=int(config["d_ff"]), layers=int(config["num_layers"]),
            experts=int(config["num_experts"]), seq_len=self.seq,
            batch=self.batch,
            shard_sequences=self.batch // (g["dp"] * g["ep"] * self.micro),
            shard_positions=self.seq // g["sp"])
        self.losses = []

    def _generator(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def setup(self) -> None:
        from sparkucx_tpu_torch.models import transformer as tt
        ph = Phases(self.device)
        if self.device.type == "cuda":
            bind_kernel_cache(self.kernel_cache)
        s, c = self.shape, self.config
        cfg = tt.TransformerConfig(
            vocab=s.vocab, d_model=s.d_model, num_heads=s.heads,
            head_dim=s.head_dim, d_ff=s.d_ff, num_layers=s.layers,
            num_experts=s.experts, seq_len=self.seq,
            microbatches=self.micro,
            capacity_factor=float(c["capacity_factor"]),
            attn=self.traffic["attn"], remat=bool(self.traffic["remat"]),
            compute_dtype=c["dtype"])
        init, self.step_fn = tt.make_train_step(
            tt.ShardGrid(**self.grid), cfg, lr=self.lr, device=self.device)
        self.gen = self._generator()
        w0 = ref.make_weights(s, self.gen)
        self.params, self.opt = init(w0)
        ph.mark("weights")
        beta1 = self.opt.param_groups[0]["betas"][0]
        for i in range(self.warm):
            self.step(False)
            ph.mark(f"warm_step{i}")
            if i == 0:
                self.grad1 = {k: self._first_gradient(k, beta1)
                              for k in ref.LEAVES}
        self.delta_warm = self._delta(w0)
        del w0
        ph.report()

    def _first_gradient(self, leaf: str, beta1: float) -> float:
        """The norm of the leaf's first gradient as Adam holds it: its
        first moment over ``1 - beta1`` (0 where Adam holds none)."""
        st = self.opt.state.get(self.params[leaf], {})
        if "exp_avg" not in st:
            return 0.0
        return float(torch.linalg.vector_norm(st["exp_avg"] / (1 - beta1)))

    def step(self, trace: bool) -> dict:
        tokens, targets = ref.make_batch(self.shape, self.gen)
        with span("bench.step", trace):
            self.params, self.opt, loss = self.step_fn(
                self.params, self.opt, tokens, targets)
            self.losses.append(loss)
            sync(self.device)
        return {"tokens": tokens.numel()}

    def facts(self, steps) -> dict:
        s = self.shape
        bh = self.batch // self.micro * s.heads
        return {
            "model_flops": len(steps) * flops.transformer_step(
                s.vocab, s.d_model, s.heads, s.head_dim, s.d_ff, s.layers,
                s.experts, s.seq_len, s.batch),
            "kernel_work": {
                "flash_fwd": {"symbols": KERNELS["flash_fwd"],
                              **flops.flash_fwd(bh, s.seq_len, s.head_dim,
                                                True)},
                "flash_bwd": {"symbols": KERNELS["flash_bwd"],
                              **flops.flash_bwd(bh, s.seq_len, s.head_dim,
                                                True)}},
            "spans": {}}

    def _delta(self, w0: dict) -> dict:
        """Each leaf's change from ``w0``, as a norm."""
        return {k: float(torch.linalg.vector_norm(
            self.params[k].detach() - w0[k])) for k in ref.LEAVES}

    def release(self) -> None:
        """What the window left: every step's loss, each leaf's change
        from the seed's weights (made again) and Adam's step count on
        each leaf; then the trainer is freed."""
        self.all_losses = [float(x) for x in self.losses]
        n = len(self.all_losses)
        self.steps_off = max(
            abs(int(self.opt.state.get(self.params[k], {}).get("step", 0))
                - n) for k in ref.LEAVES)
        self.delta_end = self._delta(ref.make_weights(self.shape,
                                                      self._generator()))
        del self.params, self.opt, self.step_fn, self.losses
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, steps: int, tf32: bool = False) -> dict:
        """The reference over the seed's weights and its first ``steps``
        batches, with each leaf's change after the warm steps."""
        strict_float32()
        g = self._generator()
        w0 = ref.make_weights(self.shape, g)
        batches = [ref.make_batch(self.shape, g) for _ in range(steps)]
        return ref.adam_steps(w0, batches, self.shape, self.lr, tf32,
                              marks=(min(self.warm, steps),))

    def control_readings(self, steps: int) -> dict:
        """The control in the program's place: the reference in TF32 over
        ``steps`` steps, against the reference."""
        c = self.reference(steps, tf32=True)
        want = self.reference(steps)
        warm = min(self.warm, steps)
        log_detail(detail(c["losses"], c["grad1"], c["delta_at"][warm],
                          c["delta"], want, warm))
        return readings(c["losses"], c["grad1"], c["delta_at"][warm],
                        c["delta"], want, warm)

    def check(self) -> list:
        want = self.reference(len(self.all_losses))
        log_detail(detail(self.all_losses, self.grad1, self.delta_warm,
                          self.delta_end, want, self.warm))
        r = readings(self.all_losses, self.grad1, self.delta_warm,
                     self.delta_end, want, self.warm)
        r["adam_steps_off"] = self.steps_off
        return [check(self.traffic, k, v) for k, v in r.items()]
