"""Segment reduce and merge over sorted rows — the port of the JAX
package's ``ops/pallas/segmented.py``: the receive-side combine of a
multi-shard combine read, and the device fold of a waved ordered or
combine read (``shuffle/reader.device_merge_fold``).

:func:`segment_reduce_rows` reduces each run of equal (partition, key)
in a (partition, key)-sorted buffer to one row: the leading ``sum_words``
value words are summed (int32 ring sums, or float32), the other words
are carried from the run's first row. Two impls, named as in the JAX
package's ``read.mergeImpl``:

* ``pallas`` — :func:`segment_reduce`: the hand-written CUDA kernel
  (``csrc/segment_reduce.cu``) for a CUDA tensor, its plain PyTorch
  version (:func:`segment_reduce_plain`) for a CPU tensor — the
  counterpart of the JAX package's interpret mode. Nothing else chooses
  between them; a CUDA tensor never reaches the plain version here.
* ``jnp`` — the torch-op formulation, :func:`~sparkucx_tpu_torch.ops.
  aggregate.combine_rows`, which sorts internally and accepts any order.

Rows carry the reader's int32 format (cols 0, 1 = int64 key as [lo, hi]);
partition ids arrive as a lane of their own, the sentinel ``num_parts``
marking invalid rows, which sort last. Output rows past the run count
are zero with the sentinel partition, so the two impls agree on the
whole buffer.

:func:`segment_reduce_wire_rows` is the same reduce over rows still in
the ``a2a.wire=int8`` wire format: each value is dequantized (int8 times
the row's scale) before the float32 sums, and the output is full width
(the fused kernel, ``sxt_segment_reduce_wire``, on a CUDA tensor;
:func:`segment_reduce_wire_plain` on a CPU tensor).

:func:`merge_rows` merges two (partition, key)-sorted buffers, ties
taking the first: ``pallas`` is :func:`merge` (the merge-path kernel,
``csrc/merge_path.cu``, on a CUDA tensor; :func:`merge_plain` on a CPU
tensor), ``jnp`` one ``keysort_rows`` over the concatenation.
:func:`merge_reduce_rows` is a merge followed by the segment reduce.
Both are batched over the leading shard dimension (one kernel launch per
call, not one per shard) and take ``out_cap``: only output rows
``[0, out_cap)`` are produced, so a fold whose valid rows fit its
accumulator never materialises the sentinel tail.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.config import MERGE_IMPLS
from sparkucx_tpu_torch.ops.aggregate import (KEY_WORDS, combine_rows,
                                              is_float_dtype, keysort_rows)
from sparkucx_tpu_torch.ops.partition import (_gather_rows,
                                              counts_from_sorted,
                                              words_to_key)
from sparkucx_tpu_torch.shuffle.alltoall import (int8_wire_words,
                                                 wire_unpack_rows)

KERNEL_NAME = "segment_reduce"
WIRE_KERNEL_NAME = "segment_reduce_wire"
MERGE_KERNEL_NAME = "merge_path"


def pallas_reduce_supported(val_dtype) -> bool:
    """The kernel sums whole int32 transport words, so only 4-byte value
    dtypes ride it; a sub-word schema (int8/16, float16) packs several
    values per word and keeps the torch-op path."""
    return np.dtype(val_dtype).itemsize == 4


def resolve_kernel_impl(requested: str, device: torch.device, *,
                        combine_dtype=None) -> Tuple[str, Optional[str]]:
    """Resolve ``read.mergeImpl`` to what runs -> ``(impl, reason)``.

    * ``jnp``    — always honoured.
    * ``auto``   — ``pallas`` on a CUDA device, ``jnp`` on the CPU (not a
      fallback: auto never offers the kernel off the card, as the JAX
      package's auto never offers it off the TPU).
    * ``pallas`` — honoured on both devices (on the CPU the wrapper runs
      the kernel's plain version, the counterpart of interpret mode).

    Where pallas was offered, a sub-word combine dtype resolves ``jnp``
    with reason ``'subword_dtype'``, the reference's own gate; ``reason``
    is non-None exactly then, and the caller counts and reports it."""
    if requested == "jnp":
        return "jnp", None
    if requested not in MERGE_IMPLS:
        raise ValueError(
            f"unknown kernel impl {requested!r}; want one of {MERGE_IMPLS}")
    if requested == "auto" and device.type != "cuda":
        return "jnp", None
    if combine_dtype is not None and not pallas_reduce_supported(
            np.dtype(combine_dtype)):
        return "jnp", "subword_dtype"
    return "pallas", None


def _mask_past_n(rows_out: torch.Tensor, part: torch.Tensor,
                 n: torch.Tensor, num_parts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the rows at and past ``n`` (per shard) and give them the
    sentinel partition — the combine contract for the unused tail."""
    cap = rows_out.shape[1]
    live = torch.arange(cap, device=n.device)[None, :] < n.reshape(-1, 1)
    rows_out = rows_out.masked_fill(~live.unsqueeze(-1), 0)
    part = torch.where(live, part, torch.full_like(part, num_parts))
    return rows_out, part


def _drop_sentinel_group(n: torch.Tensor, part: torch.Tensor,
                         num_parts: int) -> torch.Tensor:
    """``combine_rows`` counts the zeroed sentinel rows (part ==
    num_parts) as one more group whenever the buffer holds any; its row
    sorts last, so correcting ``n`` is a subtraction. Keeps the jnp
    impl's ``n`` equal to the kernel's, which never counts sentinels."""
    has_pad = (part >= num_parts).any(dim=1).to(n.dtype)
    return torch.clamp(n - has_pad, min=0)


def _check_inputs(rows: torch.Tensor, part: torch.Tensor,
                  sum_words: int) -> None:
    if rows.dim() != 3 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be [P, cap, W] int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if part.dtype != torch.int32 or tuple(part.shape) != tuple(
            rows.shape[:2]):
        raise ValueError(f"part must be [P, cap] int32 matching rows, got "
                         f"{tuple(part.shape)} {part.dtype}")
    if not 0 <= sum_words <= rows.shape[2] - KEY_WORDS:
        raise ValueError(f"sum_words={sum_words} out of [0, "
                         f"{rows.shape[2] - KEY_WORDS}] for width "
                         f"{rows.shape[2]}")


def segment_reduce_plain(rows: torch.Tensor, part: torch.Tensor,
                         num_parts: int, sum_words: int, float_acc: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The plain PyTorch version of the kernel, for CPU tensors and as
    the kernel's reference: run starts by comparison with the previous
    row, run ids by a prefix sum, sums by ``index_add_`` (int64, wrapped
    to int32; or float64, rounded once to float32), the run's first row
    as its representative. Returns (rows_out ``[P, cap, W]``, part_out
    ``[P, cap]``, n_out ``[P]``)."""
    _check_inputs(rows, part, sum_words)
    P, cap, W = rows.shape
    dev = rows.device
    valid = part < num_parts
    key = words_to_key(rows[..., 0], rows[..., 1])
    same = torch.zeros((P, cap), dtype=torch.bool, device=dev)
    same[:, 1:] = (key[:, 1:] == key[:, :-1]) & (part[:, 1:] == part[:, :-1])
    start = valid & ~same
    n_out = start.sum(dim=1, dtype=torch.int32)
    run = torch.cumsum(start, dim=1) - 1                # run id of each row
    # flat destination of every row's contribution; sentinel rows go to a
    # dump row past the end
    base = torch.arange(P, device=dev)[:, None] * cap
    dump = P * cap
    dest = torch.where(valid, run + base, dump).reshape(-1)
    first = torch.where(start, run + base, dump).reshape(-1)

    # (the dump row takes many writes; it is dropped)
    out = torch.zeros((P * cap + 1, W), dtype=torch.int32, device=dev)
    out.index_copy_(0, first, rows.reshape(-1, W))
    out_part = torch.full((P * cap + 1,), num_parts, dtype=torch.int32,
                          device=dev)
    out_part.index_copy_(0, first, part.reshape(-1))
    if sum_words:
        lanes = rows[..., KEY_WORDS:KEY_WORDS + sum_words].reshape(
            -1, sum_words)
        if float_acc:
            acc = lanes.view(torch.float32).to(torch.float64)
        else:
            acc = lanes.to(torch.int64)
        sums = torch.zeros((P * cap + 1, sum_words), dtype=acc.dtype,
                           device=dev)
        sums.index_add_(0, dest, acc)
        if float_acc:
            words = sums.to(torch.float32).view(torch.int32)
        else:
            words = (torch.remainder(sums + (1 << 31), 1 << 32)
                     - (1 << 31)).to(torch.int32)
        out[:, KEY_WORDS:KEY_WORDS + sum_words] = words
    rows_out = out[:-1].reshape(P, cap, W)
    part_out = out_part[:-1].reshape(P, cap)
    rows_out, part_out = _mask_past_n(rows_out, part_out, n_out, num_parts)
    return rows_out, part_out, n_out


def _check_card(name: str, rows: torch.Tensor, part: torch.Tensor) -> None:
    dev = rows.device
    if dev.type != "cuda" or part.device != dev:
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{dev} and {part.device}")
    if not (rows.is_contiguous() and part.is_contiguous()):
        raise ValueError("rows and part must be contiguous")


@functools.lru_cache(maxsize=None)
def _tile_rows(width_in: int) -> int:
    tile = backend.kernel_library().sxt_segment_reduce_tile_rows(width_in)
    if tile <= 0:
        raise ValueError(f"rows of {width_in} words do not fit the segment-"
                         f"reduce kernel's shared-memory tile")
    return tile


def _reduce_scratch(rows: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scratch, n_out), zeroed by one fill: the kernel's chained-scan
    scratch (one 64-bit status word per tile of every shard, then the
    tile counter) and, behind it, the ``[P]`` int32 run counts the
    kernel raises."""
    P, cap, width_in = rows.shape
    words = P * -(-cap // _tile_rows(width_in)) + 1
    buf = torch.zeros(words + -(-P // 2), dtype=torch.int64,
                      device=rows.device)
    return buf[:words], buf[words:].view(torch.int32)[:P]


def segment_reduce_tail_kernel(out_rows: torch.Tensor,
                               out_part: torch.Tensor, n_out: torch.Tensor,
                               num_parts: int) -> None:
    """The kernels' zero-tail pass alone, in place on the current stream:
    rows at and past ``n_out[p]`` of ``out_rows [P, cap, W]`` zeroed and
    their ``out_part`` set to ``num_parts`` (what :func:`_mask_past_n`
    does). Both reduce wrappers run it after their tile pass; it is
    exposed to time it and test it on its own, and counts no launch."""
    _check_card("segment_reduce_tail_kernel", out_rows, out_part)
    P, cap, W = out_rows.shape
    if (out_rows.dtype != torch.int32 or out_part.dtype != torch.int32
            or tuple(out_part.shape) != (P, cap)
            or n_out.dtype != torch.int32 or tuple(n_out.shape) != (P,)
            or n_out.device != out_rows.device):
        raise ValueError("want int32 out_rows [P, cap, W], out_part [P, cap] "
                         "and n_out [P] on one device")
    if P == 0 or cap == 0 or W == 0:
        return
    backend.check_sm90(out_rows.device)
    lib = backend.kernel_library()
    with torch.cuda.device(out_rows.device):
        stream = torch.cuda.current_stream(out_rows.device).cuda_stream
        rc = lib.sxt_segment_reduce_tail(
            out_rows.data_ptr(), out_part.data_ptr(), n_out.data_ptr(), P,
            cap, W, num_parts, stream)
    backend.check_launch(KERNEL_NAME + "_tail", rc)


def segment_reduce_kernel(rows: torch.Tensor, part: torch.Tensor,
                          num_parts: int, sum_words: int, float_acc: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Launch the CUDA segment reduce on the current stream (no host
    synchronisation). Same contract as :func:`segment_reduce_plain`."""
    _check_inputs(rows, part, sum_words)
    _check_card("segment_reduce_kernel", rows, part)
    dev = rows.device
    P, cap, W = rows.shape
    out_rows = torch.empty((P, cap, W), dtype=torch.int32, device=dev)
    out_part = torch.empty((P, cap), dtype=torch.int32, device=dev)
    if P == 0 or cap == 0:
        return out_rows, out_part, torch.zeros((P,), dtype=torch.int32,
                                               device=dev)
    backend.check_sm90(dev)
    lib = backend.kernel_library()
    scratch, n_out = _reduce_scratch(rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sxt_segment_reduce(
            rows.data_ptr(), part.data_ptr(), out_rows.data_ptr(),
            out_part.data_ptr(), n_out.data_ptr(), scratch.data_ptr(), P,
            cap, W, num_parts, sum_words, int(bool(float_acc)), stream)
    backend.check_launch(KERNEL_NAME, rc)
    backend.count_launch(KERNEL_NAME)
    return out_rows, out_part, n_out


def segment_reduce(rows: torch.Tensor, part: torch.Tensor, num_parts: int,
                   sum_words: int, float_acc: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, its plain version for a CPU one."""
    fn = segment_reduce_kernel if rows.is_cuda else segment_reduce_plain
    return fn(rows, part, num_parts, sum_words, float_acc)


def segment_reduce_rows(rows: torch.Tensor, part: torch.Tensor,
                        num_parts: int, val_words: int, val_dtype,
                        op: str = "sum", sum_words: int = 0,
                        compaction: str = "stable", *, impl: str = "jnp"
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One row per distinct (partition, key) of each shard: sum the
    leading ``sum_words`` value words (0 = the whole value row), carry
    the rest.

    rows ``[P, cap, W]`` int32 and part ``[P, cap]`` int32 (sentinel
    ``num_parts`` on invalid rows). ``impl='pallas'`` needs them sorted
    by (partition, key); ``impl='jnp'`` sorts internally.

    Returns (rows_out ``[P, cap, W]``, pcounts ``[P, num_parts]``, n_out
    ``[P]``); n_out never counts sentinel rows."""
    if op != "sum":
        raise ValueError(f"unknown combiner {op!r}")
    vdt = np.dtype(val_dtype)
    if impl == "jnp":
        ro, pc, n = combine_rows(rows, part, rows.shape[1], num_parts,
                                 val_words, vdt, op, sum_words=sum_words,
                                 compaction=compaction)
        return ro, pc, _drop_sentinel_group(n, part, num_parts)
    if impl != "pallas":
        raise ValueError(f"unknown reduce impl {impl!r}; want jnp|pallas")
    if not pallas_reduce_supported(vdt):
        raise ValueError(
            f"the segment-reduce kernel needs a 4-byte value dtype, got "
            f"{vdt} — use impl='jnp' (pallas_reduce_supported gates)")
    sw = sum_words if sum_words > 0 else val_words
    rows_out, part_out, n = segment_reduce(
        rows, part.to(torch.int32).contiguous(), num_parts, sw,
        float_acc=is_float_dtype(vdt))
    return rows_out, counts_from_sorted(part_out, num_parts), n


# -- the int8-dequant-fused reduce -------------------------------------------

def _check_wire_inputs(rows: torch.Tensor, part: torch.Tensor, width: int,
                       wire_words: int, sum_words: int) -> None:
    """The JAX package's two shape checks, then the tensor checks."""
    if wire_words <= 0:
        raise ValueError("the fused dequant reduce needs wire_words > 0 "
                         "(a2a.wire=int8 plans only)")
    if width != KEY_WORDS + wire_words:
        raise ValueError(
            f"the fused dequant reduce needs the wire tier to cover the "
            f"whole value row (width == 2 + wire_words), got width="
            f"{width}, wire_words={wire_words}")
    w_in = KEY_WORDS + int8_wire_words(wire_words)
    if rows.dim() != 3 or rows.shape[2] != w_in:
        raise ValueError(
            f"wire rows must be [P, cap, {w_in}] (2 exact key lanes + "
            f"packed int8 + scale), got {tuple(rows.shape)}")
    _check_inputs(rows, part, 0)
    if not 0 <= sum_words <= wire_words:
        raise ValueError(f"sum_words={sum_words} out of [0, {wire_words}]")


def segment_reduce_wire_plain(rows: torch.Tensor, part: torch.Tensor,
                              num_parts: int, width: int, wire_words: int,
                              sum_words: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain PyTorch version of the fused kernel: ``wire_unpack_rows``
    (one rounded product per value), then :func:`segment_reduce_plain`
    with float sums over the leading ``sum_words`` lanes. Returns
    (rows_out ``[P, cap, width]``, part_out ``[P, cap]``, n_out ``[P]``)."""
    _check_wire_inputs(rows, part, width, wire_words, sum_words)
    full = wire_unpack_rows(rows, width, wire_words)
    return segment_reduce_plain(full, part, num_parts, sum_words, True)


def segment_reduce_wire_kernel(rows: torch.Tensor, part: torch.Tensor,
                               num_parts: int, width: int, wire_words: int,
                               sum_words: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch the fused dequant segment reduce on the current stream (no
    host synchronisation). Same contract as
    :func:`segment_reduce_wire_plain`."""
    _check_wire_inputs(rows, part, width, wire_words, sum_words)
    _check_card("segment_reduce_wire_kernel", rows, part)
    dev = rows.device
    P, cap, _ = rows.shape
    out_rows = torch.empty((P, cap, width), dtype=torch.int32, device=dev)
    out_part = torch.empty((P, cap), dtype=torch.int32, device=dev)
    if P == 0 or cap == 0:
        return out_rows, out_part, torch.zeros((P,), dtype=torch.int32,
                                               device=dev)
    backend.check_sm90(dev)
    lib = backend.kernel_library()
    scratch, n_out = _reduce_scratch(rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sxt_segment_reduce_wire(
            rows.data_ptr(), part.data_ptr(), out_rows.data_ptr(),
            out_part.data_ptr(), n_out.data_ptr(), scratch.data_ptr(), P,
            cap, wire_words, num_parts, sum_words, stream)
    backend.check_launch(WIRE_KERNEL_NAME, rc)
    backend.count_launch(WIRE_KERNEL_NAME)
    return out_rows, out_part, n_out


def segment_reduce_wire(rows: torch.Tensor, part: torch.Tensor,
                        num_parts: int, width: int, wire_words: int,
                        sum_words: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel for a CUDA tensor, its plain version for a CPU
    one."""
    fn = segment_reduce_wire_kernel if rows.is_cuda \
        else segment_reduce_wire_plain
    return fn(rows, part, num_parts, width, wire_words, sum_words)


def segment_reduce_wire_rows(rows: torch.Tensor, part: torch.Tensor,
                             num_parts: int, width: int, wire_words: int,
                             sum_words: int = 0, *, impl: str = "jnp"
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The segment reduce of an int8 combine read over rows still in the
    wire format (``[P, cap, 2 + int8_wire_words(wire_words)]`` int32, key
    lanes exact), to full-width rows ``[P, cap, width]`` with float32
    sums over the leading ``sum_words`` dequantized lanes (0 = all) and
    the others carried, dequantized, from a run's first row.

    ``jnp``: ``wire_unpack_rows`` then ``combine_rows`` (any order);
    ``pallas``: :func:`segment_reduce_wire` (input sorted by (partition,
    key)). The wire tier only quantizes whole float32 value rows, so
    ``width == 2 + wire_words``. Returns (rows_out, pcounts ``[P, R]``,
    n_out ``[P]``) as :func:`segment_reduce_rows`."""
    if impl not in ("jnp", "pallas"):
        raise ValueError(f"unknown reduce impl {impl!r}; want jnp|pallas")
    sw = sum_words if sum_words > 0 else wire_words
    _check_wire_inputs(rows, part, width, wire_words, sw)
    if impl == "jnp":
        full = wire_unpack_rows(rows, width, wire_words)
        ro, pc, n = combine_rows(full, part, full.shape[1], num_parts,
                                 wire_words, np.dtype(np.float32), "sum",
                                 sum_words=sum_words)
        return ro, pc, _drop_sentinel_group(n, part, num_parts)
    rows_out, part_out, n = segment_reduce_wire(
        rows, part.to(torch.int32).contiguous(), num_parts, width,
        wire_words, sw)
    return rows_out, counts_from_sorted(part_out, num_parts), n


# -- merge -------------------------------------------------------------------

def _check_merge_inputs(a_rows: torch.Tensor, a_part: torch.Tensor,
                        b_rows: torch.Tensor, b_part: torch.Tensor,
                        out_cap: Optional[int]) -> int:
    """Validate the two sides of a merge; returns the resolved
    ``out_cap`` (default ``ca + cb``)."""
    for name, rows, part in (("a", a_rows, a_part), ("b", b_rows, b_part)):
        if rows.dim() != 3 or rows.dtype != torch.int32:
            raise ValueError(f"{name}_rows must be [P, cap, W] int32, got "
                             f"{tuple(rows.shape)} {rows.dtype}")
        if part.dtype != torch.int32 or tuple(part.shape) != tuple(
                rows.shape[:2]):
            raise ValueError(f"{name}_part must be [P, cap] int32 matching "
                             f"its rows, got {tuple(part.shape)} "
                             f"{part.dtype}")
    if a_rows.shape[0] != b_rows.shape[0] or a_rows.shape[2] != \
            b_rows.shape[2] or a_rows.shape[2] < KEY_WORDS:
        raise ValueError(f"a and b must share P and a width >= {KEY_WORDS}: "
                         f"{tuple(a_rows.shape)} vs {tuple(b_rows.shape)}")
    n = a_rows.shape[1] + b_rows.shape[1]
    out_cap = n if out_cap is None else int(out_cap)
    if not 0 <= out_cap <= n:
        raise ValueError(f"out_cap={out_cap} out of [0, {n}]")
    return out_cap


def merge_plain(a_rows: torch.Tensor, a_part: torch.Tensor,
                b_rows: torch.Tensor, b_part: torch.Tensor,
                out_cap: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the merge kernel, for CPU tensors and
    as the kernel's reference: a STABLE sort of the concatenation
    ``[a; b]`` by (partition, signed int64 key). For sorted inputs that
    is the merge with ties taking ``a`` (an ``a`` row precedes every
    equal ``b`` row, and each side keeps its own order). Returns (rows
    ``[P, out_cap, W]``, part ``[P, out_cap]``)."""
    out_cap = _check_merge_inputs(a_rows, a_part, b_rows, b_part, out_cap)
    cat = torch.cat([a_rows, b_rows], dim=1)
    pcat = torch.cat([a_part, b_part], dim=1)
    key = words_to_key(cat[..., 0], cat[..., 1])
    _, by_key = torch.sort(key, dim=1, stable=True)
    _, by_part = torch.sort(torch.gather(pcat, 1, by_key), dim=1,
                            stable=True)
    order = torch.gather(by_key, 1, by_part)[:, :out_cap]
    return _gather_rows(cat, order), torch.gather(pcat, 1, order)


def merge_kernel(a_rows: torch.Tensor, a_part: torch.Tensor,
                 b_rows: torch.Tensor, b_part: torch.Tensor,
                 out_cap: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA merge-path kernel on the current stream (no host
    synchronisation): the split pre-pass, then the merge, each one launch
    for all shards. Same contract as :func:`merge_plain`."""
    out_cap = _check_merge_inputs(a_rows, a_part, b_rows, b_part, out_cap)
    dev = a_rows.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (a_part, b_rows, b_part)):
        raise ValueError(f"merge_kernel needs CUDA tensors on one device, "
                         f"got {dev}")
    if not all(t.is_contiguous() for t in (a_rows, a_part, b_rows, b_part)):
        raise ValueError("merge inputs must be contiguous")
    P, ca, W = a_rows.shape
    cb = b_rows.shape[1]
    if P == 0 or out_cap == 0:
        return (torch.empty((P, out_cap, W), dtype=torch.int32, device=dev),
                torch.empty((P, out_cap), dtype=torch.int32, device=dev))
    backend.check_sm90(dev)
    lib = backend.kernel_library()
    # the merge-path split of every tile boundary, from the pre-pass, which
    # is launched first so that the output allocations overlap it
    splits = torch.empty(P * (-(-out_cap // lib.sxt_merge_tile_rows(W)) + 1),
                         dtype=torch.int32, device=dev)
    ptrs = (a_rows.data_ptr(), a_part.data_ptr(), b_rows.data_ptr(),
            b_part.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sxt_merge_splits(*ptrs, splits.data_ptr(), P, ca, cb,
                                  out_cap, W, stream)
        backend.check_launch(MERGE_KERNEL_NAME, rc)
        out_rows = torch.empty((P, out_cap, W), dtype=torch.int32,
                               device=dev)
        out_part = torch.empty((P, out_cap), dtype=torch.int32, device=dev)
        rc = lib.sxt_merge_path(*ptrs, out_rows.data_ptr(),
                                out_part.data_ptr(), splits.data_ptr(), P,
                                ca, cb, out_cap, W, stream)
    backend.check_launch(MERGE_KERNEL_NAME, rc)
    backend.count_launch(MERGE_KERNEL_NAME)
    return out_rows, out_part


def merge(a_rows: torch.Tensor, a_part: torch.Tensor, b_rows: torch.Tensor,
          b_part: torch.Tensor, out_cap: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, its plain version for a CPU one."""
    fn = merge_kernel if a_rows.is_cuda else merge_plain
    return fn(a_rows, a_part, b_rows, b_part, out_cap)


def merge_rows(a_rows: torch.Tensor, a_part: torch.Tensor,
               b_rows: torch.Tensor, b_part: torch.Tensor, num_parts: int,
               *, impl: str = "jnp", out_cap: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two partition-major key-sorted buffers of every shard.

    a_rows/b_rows ``[P, ca, W]`` / ``[P, cb, W]`` int32, each sorted by
    (partition, signed int64 key) with invalid rows last; a_part/b_part
    ``[P, ca]`` / ``[P, cb]`` int32, sentinel ``num_parts`` on invalid
    rows.

    Returns (rows ``[P, out_cap, W]``, part ``[P, out_cap]``, pcounts
    ``[P, num_parts]``); pcounts counts real partitions only. Valid rows
    are bit-exact across impls (up to the order of equal keys under
    ``jnp``, whose sort is unstable); rows past the valid total keep the
    sentinel partition, zero when the inputs' invalid rows are zero."""
    out_cap = _check_merge_inputs(a_rows, a_part, b_rows, b_part, out_cap)
    if impl == "jnp":
        cat = torch.cat([a_rows, b_rows], dim=1)
        pcat = torch.cat([a_part, b_part], dim=1)
        spart, srows, _ = keysort_rows(cat, pcat, cat.shape[1], num_parts)
        rows = srows[:, :out_cap].contiguous()
        part = spart[:, :out_cap].contiguous()
    elif impl == "pallas":
        rows, part = merge(a_rows.contiguous(), a_part.contiguous(),
                           b_rows.contiguous(), b_part.contiguous(), out_cap)
    else:
        raise ValueError(f"unknown merge impl {impl!r}; want jnp|pallas")
    return rows, part, counts_from_sorted(part, num_parts)


def merge_reduce_rows(a_rows: torch.Tensor, a_part: torch.Tensor,
                      b_rows: torch.Tensor, b_part: torch.Tensor,
                      num_parts: int, val_words: int, val_dtype,
                      op: str = "sum", sum_words: int = 0,
                      compaction: str = "stable", *, impl: str = "jnp",
                      out_cap: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two combined buffers and re-reduce by key — one fold step of
    a waved combine read (a key in both inputs has one row in each; the
    reduce leaves one). ``jnp``: one ``combine_rows`` over the
    concatenation; ``pallas``: the merge, then the segment reduce.

    Returns (rows_out ``[P, out_cap, W]``, pcounts ``[P, num_parts]``,
    n_out ``[P]``)."""
    out_cap = _check_merge_inputs(a_rows, a_part, b_rows, b_part, out_cap)
    if impl == "jnp":
        if op != "sum":
            raise ValueError(f"unknown combiner {op!r}")
        cat = torch.cat([a_rows, b_rows], dim=1)
        pcat = torch.cat([a_part, b_part], dim=1)
        ro, pc, n = combine_rows(cat, pcat, cat.shape[1], num_parts,
                                 val_words, np.dtype(val_dtype), op,
                                 sum_words=sum_words, compaction=compaction)
        return (ro[:, :out_cap].contiguous(), pc,
                _drop_sentinel_group(n, pcat, num_parts))
    rows, part, _ = merge_rows(a_rows, a_part, b_rows, b_part, num_parts,
                               impl=impl, out_cap=out_cap)
    return segment_reduce_rows(rows, part, num_parts, val_words, val_dtype,
                               op, sum_words=sum_words,
                               compaction=compaction, impl=impl)
