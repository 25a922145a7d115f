"""Faults planted in the port's timed path, for the check that a broken
run comes out not correct (``tests/test_h100bench_faults.py`` at a CPU
test's size; ``control.py --faults`` at a cell's own size on the card).

The faults: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; the exchange left out (each shard
keeps its own rows); a token or an answer altered where it is produced.
``planted(driver, fault, after)`` plants one for the length of a
``with``; a training fault comes on only after the trainer's first
``after`` steps (set-up's warm steps), so that it breaks the timed steps
alone."""

from __future__ import annotations

import contextlib

import torch


def _no_move(send, in_off, in_sz, out_off, overflow, out_capacity):
    """The segment move left out: every shard keeps its own send rows."""
    P, cap_in, width = send.shape
    out = torch.zeros((P, out_capacity, width), dtype=send.dtype,
                      device=send.device)
    n = min(cap_in, out_capacity)
    out[:, :n] = send[:, :n]
    return out


def _no_exchange(data, sizes, out_capacity, impl="auto"):
    """The differentiable exchange left out: each shard's rows stay."""
    G, P, n = data.shape[:3]
    out = data.new_zeros((G, P, out_capacity) + tuple(data.shape[3:]))
    m = min(n, out_capacity)
    return out.index_copy(2, torch.arange(m, device=data.device),
                          data[:, :, :m])


def _altered_move(move):
    """The segment move with one value lane of one delivered row altered
    where the move writes it."""
    def broken(*args):
        out = move(*args)
        out[0, 0, 2] ^= 0x00400000
        return out
    return broken


def _halve(rows, totals):
    """Half of each shard's rows left out: the rest is all the consumer
    sees."""
    keep = totals // 2
    j = torch.arange(rows.shape[1], device=rows.device)[None, :, None]
    return torch.where(j < keep[:, None, None], rows,
                       torch.zeros_like(rows)), keep


class _Patches:
    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def _move(p: _Patches, altered: bool) -> None:
    import sparkucx_tpu_torch.ops.ragged_a2a as ra
    for name in ("ragged_a2a_plain", "ragged_a2a_kernel"):
        p.set(ra, name, _altered_move(getattr(ra, name)) if altered
              else _no_move)


def _dispatch(p: _Patches, change_rows=None, keep_state=False) -> None:
    from sparkucx_tpu_torch.models import moe as tm
    make = tm.make_device_dispatch_step

    def wrapped(*a, **k):
        init, step = make(*a, **k)

        def broken(params, rows, totals):
            if change_rows:
                rows, totals = change_rows(rows, totals)
            new, loss = step(params, rows, totals)
            return (params if keep_state else new), loss
        return init, broken
    p.set(tm, "make_device_dispatch_step", wrapped)


def _ulysses(p: _Patches, change_rows=None, change_out=None) -> None:
    from sparkucx_tpu_torch.parallel import ulysses as tu
    make = tu.ulysses_attention_consumer

    def wrapped(*a, **k):
        step = make(*a, **k)

        def broken(rows, totals):
            if change_rows:
                rows, totals = change_rows(rows, totals)
            out = step(rows, totals)
            return change_out(out) if change_out else out
        return broken
    p.set(tu, "ulysses_attention_consumer", wrapped)


def _train(p: _Patches, after: int, keep_state=False, alter_answer=False,
           live=None) -> None:
    """The trainer's step broken from its ``after + 1``-th call on;
    ``live["on"]`` says whether the current step is broken."""
    from sparkucx_tpu_torch.models import transformer as tt
    make = tt.make_train_step
    live = {} if live is None else live

    def wrapped(mesh, cfg, **k):
        init, step = make(mesh, cfg, **k)
        calls = [0]

        def broken(params, opt, tokens, targets):
            calls[0] += 1
            live["on"] = calls[0] > after
            if live["on"] and keep_state:
                with torch.no_grad():
                    loss = tt.loss_fn(params, tokens, targets, mesh, cfg)
                return params, opt, loss
            params, opt, loss = step(params, opt, tokens, targets)
            if live["on"] and alter_answer:
                with torch.no_grad():
                    params["wo"].view(-1)[0] += 1.0
            return params, opt, loss
        return init, broken
    p.set(tt, "make_train_step", wrapped)


def _half_loss(p: _Patches, after: int) -> None:
    """The loss over half of the batch's sequences (each twice, so the
    shapes stand), the mean over them."""
    from sparkucx_tpu_torch.models import transformer as tt
    live = {}
    _train(p, after, live=live)
    loss = tt.loss_fn

    def broken(params, tokens, targets, mesh, cfg):
        if not live.get("on"):
            return loss(params, tokens, targets, mesh, cfg)
        h = tokens.shape[0] // 2
        return loss(params, torch.cat([tokens[:h], tokens[:h]]),
                    torch.cat([targets[:h], targets[:h]]), mesh, cfg)
    p.set(tt, "loss_fn", broken)


def _exchange(p: _Patches, after: int) -> None:
    from sparkucx_tpu_torch.models import transformer as tt
    live = {}
    _train(p, after, live=live)
    exchange = tt.exchange

    def broken(*a, **k):
        return (_no_exchange if live.get("on") else exchange)(*a, **k)
    p.set(tt, "exchange", broken)


PLANT = {
    "expert_dispatch": {
        "state_unchanged": lambda p, a: _dispatch(p, keep_state=True),
        "half_batch": lambda p, a: _dispatch(p, _halve),
        "exchange_left_out": lambda p, a: _move(p, False),
        "token_altered": lambda p, a: _move(p, True),
    },
    "ulysses_read": {
        "half_batch": lambda p, a: _ulysses(p, _halve),
        "exchange_left_out": lambda p, a: _move(p, False),
        "token_altered": lambda p, a: _move(p, True),
        "answer_altered": lambda p, a: _ulysses(
            p, change_out=lambda o: o + 1e-3 * o.abs().max()),
    },
    "moe_train": {
        "state_unchanged": lambda p, a: _train(p, a, keep_state=True),
        "half_batch": _half_loss,
        "exchange_left_out": _exchange,
        "answer_altered": lambda p, a: _train(p, a, alter_answer=True),
    },
}


@contextlib.contextmanager
def planted(driver: str, fault: str, after: int = 0):
    """``PLANT[driver][fault]`` in place for the body, a training fault
    from the trainer's ``after + 1``-th step on."""
    p = _Patches()
    try:
        PLANT[driver][fault](p, after)
        yield
    finally:
        p.undo()
