"""Grouped expert products: the transformer's expert FFN over the rows each
expert owns.

Replaces no TPU kernel. The JAX package leaves the expert products to XLA
as one-hot einsums over every received row; on the card that multiplied
every row by every local expert's weights (``e_local`` times the
capacity factor times the owned rows). Here the rows come sorted by
expert, expert ``j`` owning the contiguous rows ``[offsets[j],
offsets[j] + counts[j])`` of ``a``, and each expert multiplies only its
own. ``counts`` and ``offsets`` are int32 tensors on the rows' device:
the kernels read them there, so nothing waits on the host. Rows past the
last expert's are never read, and come back zero where the output is
zero-filled.

Two primitives, each a hand-written CUDA kernel (``csrc/grouped_ffn.cu``)
with a plain PyTorch version that loops over the experts:

* :func:`grouped_rows` — ``c[r] = epi(a[r] @ b[j])`` for every row ``r``
  of expert ``j``, with ``epi`` none, ``"gelu"`` (the tanh GELU; the
  pre-activation is returned too) or ``"gelu_grad"`` (times the GELU's
  derivative at a saved pre-activation).
* :func:`grouped_wgrad` — ``c[j] = a[rows of j]^T @ b[rows of j]``, the
  weight gradients, reduced over each expert's ragged row count.

:func:`grouped_ffn` is the differentiable FFN on sorted rows (a
``torch.autograd.Function``): ``y = sum_t gelu(x @ w1[j])[:, t] @ w2[j,
t]`` with the tp partial products (the hidden dim cut into ``tp``
slices) summed in tp order, as the one-hot form sums them. Its backward
is the same two kernels (four launches) inside a device-timed
``moe.experts.backward`` span.

Precision follows the inputs' dtype: float32 rows are multiplied in
float32 FMAs (never TF32), bfloat16 rows in bf16 products with float32
sums; products are rounded to the storage dtype before the GELU, as a
bf16 ``torch.matmul`` followed by ``F.gelu`` rounds them. A NaN row gives
NaN output rows and NaN weight gradients: nothing drops it.

Every kernel launch counts under ``"grouped_ffn"``. The kernels run for
CUDA tensors and the plain versions for CPU ones; nothing else chooses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER

KERNEL_NAME = "grouped_ffn"
TILE_ROWS = 128            # the kernels' row tile (grid bound: R / 128 + E)
EPILOGUES = {None: 0, "gelu": 1, "gelu_grad": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def impl_for(device: torch.device) -> str:
    """What runs the products on ``device``: the kernels on a CUDA
    device, the plain versions elsewhere."""
    return "grouped" if device.type == "cuda" else "plain"


def segment_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 offsets of the experts' row segments."""
    return (torch.cumsum(counts, 0) - counts).to(torch.int32)


def segments_from_sorted(sorted_key: torch.Tensor, num_experts: int):
    """int32 ``(counts, offsets)`` of the experts ``0 .. num_experts - 1``
    in an ascending 1-D key, from one searchsorted (keys at or past
    ``num_experts`` lie after the last segment); three launches on the
    key's device, no host synchronisation."""
    edges = torch.arange(num_experts + 1, dtype=sorted_key.dtype,
                         device=sorted_key.device)
    pos = torch.searchsorted(sorted_key, edges, out_int32=True)
    return pos.diff(), pos[:-1]


def _check(a: torch.Tensor, b: torch.Tensor, counts: torch.Tensor,
           offsets: torch.Tensor, b_dims: int = 3) -> None:
    """a ``[R, K]`` and b (``[E, K, N]``, or ``[R, N]`` rows for the
    weight gradients) of one float dtype, with int32 ``[E]`` counts and
    offsets, all on one device."""
    if a.dim() != 2 or b.dim() != b_dims:
        raise ValueError(f"a must be 2-D and b {b_dims}-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a and b must share float32 or bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    E = b.shape[0] if b_dims == 3 else counts.shape[0]
    for name, t in (("counts", counts), ("offsets", offsets)):
        if t.dtype != torch.int32 or tuple(t.shape) != (E,):
            raise ValueError(f"{name} must be int32 [{E}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if len({t.device for t in (a, b, counts, offsets)}) != 1:
        raise ValueError("a, b, counts and offsets must share a device")


def _segments(counts: torch.Tensor, offsets: torch.Tensor):
    """(expert, first row, rows) of each non-empty segment (host values:
    the plain versions run where reading them costs nothing)."""
    return [(j, o, c) for j, (o, c) in
            enumerate(zip(offsets.tolist(), counts.tolist())) if c > 0]


def _gelu_grad(g: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    return torch.ops.aten.gelu_backward(g, pre, approximate="tanh")


# -- plain versions ----------------------------------------------------------
@torch.no_grad()
def grouped_rows_plain(a, b, counts, offsets, epilogue: Optional[str] = None,
                       pre: Optional[torch.Tensor] = None):
    """The plain version of :func:`grouped_rows`: one ``torch.matmul`` per
    expert's rows, in the inputs' dtype, then the epilogue."""
    _check(a, b, counts, offsets)
    R, N = a.shape[0], b.shape[2]
    c = torch.zeros((R, N), dtype=a.dtype, device=a.device)
    out_pre = torch.zeros_like(c) if epilogue == "gelu" else None
    for j, o, n in _segments(counts, offsets):
        v = a[o:o + n] @ b[j]
        if epilogue == "gelu":
            out_pre[o:o + n] = v
            v = F.gelu(v, approximate="tanh")
        elif epilogue == "gelu_grad":
            v = _gelu_grad(v, pre[o:o + n])
        c[o:o + n] = v
    return (c, out_pre) if epilogue == "gelu" else c


@torch.no_grad()
def grouped_wgrad_plain(a, b, counts, offsets):
    """The plain version of :func:`grouped_wgrad`: ``a[rows]^T @ b[rows]``
    per expert (zeros for an expert with no rows)."""
    E = counts.shape[0]
    M, N = a.shape[1], b.shape[1]
    c = torch.zeros((E, M, N), dtype=a.dtype, device=a.device)
    for j, o, n in _segments(counts, offsets):
        c[j] = a[o:o + n].transpose(0, 1) @ b[o:o + n]
    return c


# -- kernels -----------------------------------------------------------------
def _aligned(t: torch.Tensor, *strides: int) -> bool:
    """Every stride a multiple of 4 elements, the base 16-byte (float32)
    or 8-byte (bf16) aligned: the kernels' 4-element vector loads."""
    return (all(s % 4 == 0 for s in strides)
            and t.data_ptr() % (4 * t.element_size()) == 0)


def _check_kernel(a, b, counts, offsets, b_dims: int = 3) -> None:
    _check(a, b, counts, offsets, b_dims)
    if a.device.type != "cuda":
        raise ValueError(f"the grouped_ffn kernels need CUDA tensors, got "
                         f"{a.device}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("the grouped_ffn kernels need unit inner strides")
    if not (counts.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("counts and offsets must be contiguous")


def _launch_done(rc: int) -> None:
    backend.check_launch(KERNEL_NAME, rc)
    backend.count_launch(KERNEL_NAME)


def grouped_rows_kernel(a, b, counts, offsets, epilogue: Optional[str] = None,
                        pre: Optional[torch.Tensor] = None,
                        zero_tail: bool = True):
    """Launch the grouped row product on the current stream (no host
    synchronisation). Same contract as :func:`grouped_rows_plain`; with
    ``zero_tail`` false the outputs are not zero-filled first, so rows of
    no expert hold whatever the allocator gave."""
    _check_kernel(a, b, counts, offsets)
    R, K = a.shape
    E, Kb, N = b.shape
    if Kb != K:
        raise ValueError(f"a's K {K} != b's K {Kb}")
    if not (_aligned(a, a.stride(0), K) and _aligned(b, b.stride(0),
                                                     b.stride(1), N)):
        raise ValueError("the grouped_ffn kernels need K, N and the row "
                         "strides a multiple of 4 and aligned bases")
    if (epilogue == "gelu_grad") != (pre is not None):
        raise ValueError("pre is given exactly for epilogue='gelu_grad'")
    if pre is not None and (tuple(pre.shape) != (R, N) or pre.dtype != a.dtype
                            or pre.stride(-1) != 1
                            or not _aligned(pre, pre.stride(0))):
        raise ValueError(f"pre must be an aligned [{R}, {N}] {a.dtype}")
    new = torch.zeros if zero_tail else torch.empty
    c = new((R, N), dtype=a.dtype, device=a.device)
    if epilogue == "gelu":
        pre = new((R, N), dtype=a.dtype, device=a.device)
    row_tiles = -(-R // TILE_ROWS) + E
    if row_tiles > 65535:
        raise ValueError(f"{R} rows exceed the kernel's grid")
    if R == 0:
        return (c, pre) if epilogue == "gelu" else c
    backend.check_sm90(a.device)
    lib = backend.kernel_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.sxt_grouped_rows(
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            b.stride(1), c.data_ptr(), c.stride(0),
            pre.data_ptr() if pre is not None else None,
            pre.stride(0) if pre is not None else 0, counts.data_ptr(),
            offsets.data_ptr(), E, row_tiles, K, N, EPILOGUES[epilogue],
            int(a.dtype == torch.bfloat16), stream)
    _launch_done(rc)
    return (c, pre) if epilogue == "gelu" else c


def grouped_wgrad_kernel(a, b, counts, offsets):
    """Launch the grouped weight-gradient product on the current stream.
    Same contract as :func:`grouped_wgrad_plain`."""
    _check_kernel(a, b, counts, offsets, b_dims=2)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b must be [R, M] and [R, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    E = counts.shape[0]
    M, N = a.shape[1], b.shape[1]
    if not (_aligned(a, a.stride(0), M) and _aligned(b, b.stride(0), N)):
        raise ValueError("the grouped_ffn kernels need M, N and the row "
                         "strides a multiple of 4 and aligned bases")
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    backend.check_sm90(a.device)
    lib = backend.kernel_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.sxt_grouped_wgrad(
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            c.data_ptr(), counts.data_ptr(), offsets.data_ptr(), E, M, N,
            int(a.dtype == torch.bfloat16), stream)
    _launch_done(rc)
    return c


def grouped_rows(a, b, counts, offsets, epilogue: Optional[str] = None,
                 pre: Optional[torch.Tensor] = None, zero_tail: bool = True):
    """The kernel for a CUDA tensor, its plain version for a CPU one."""
    if a.is_cuda:
        return grouped_rows_kernel(a, b, counts, offsets, epilogue, pre,
                                   zero_tail)
    return grouped_rows_plain(a, b, counts, offsets, epilogue, pre)


def grouped_wgrad(a, b, counts, offsets):
    """The kernel for a CUDA tensor, its plain version for a CPU one."""
    fn = grouped_wgrad_kernel if a.is_cuda else grouped_wgrad_plain
    return fn(a, b, counts, offsets)


# -- the differentiable FFN --------------------------------------------------
def _tp_products(h, w2, counts, offsets, tp: int):
    """``sum_t h[:, t] @ w2[:, t]`` over the tp slices of the hidden dim,
    summed in tp order."""
    ft = h.shape[1] // tp
    out = None
    for t in range(tp):
        part = grouped_rows(h[:, t * ft:(t + 1) * ft],
                            w2[:, t * ft:(t + 1) * ft], counts, offsets)
        out = part if out is None else out + part
    return out


class _GroupedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, w2, counts, offsets, tp):
        h, pre = grouped_rows(x, w1, counts, offsets, "gelu",
                              zero_tail=False)
        y = _tp_products(h, w2, counts, offsets, tp)
        ctx.save_for_backward(x, w1, w2, counts, offsets, pre, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, counts, offsets, pre, h = ctx.saved_tensors
        dev = dy.device
        with GLOBAL_TRACER.span("moe.experts.backward", device_time=dev,
                                impl=impl_for(dev)):
            dy = dy.contiguous()
            dpre = grouped_rows(dy, w2.transpose(1, 2).contiguous(), counts,
                                offsets, "gelu_grad", pre, zero_tail=False)
            dx = grouped_rows(dpre, w1.transpose(1, 2).contiguous(), counts,
                              offsets)
            dw1 = grouped_wgrad(x, dpre, counts, offsets)
            dw2 = grouped_wgrad(h, dy, counts, offsets)
        return dx, dw1, dw2, None, None, None


def grouped_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                counts: torch.Tensor, tp: int = 1,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert FFN on rows sorted by expert: ``x [R, D]`` (expert ``j``
    owns ``counts[j]`` rows from ``offsets[j]``; by default the experts'
    segments follow each other from row 0), ``w1 [E, D, F]``, ``w2 [E, F,
    D]`` (``F`` cut into ``tp`` slices) -> ``[R, D]``, zero past the owned
    rows. Differentiable in x, w1 and w2."""
    if x.shape[1] != w1.shape[1] or w1.shape[2] % tp:
        raise ValueError(f"x {tuple(x.shape)} and w1 {tuple(w1.shape)} do "
                         f"not fit tp={tp}")
    counts = counts.to(torch.int32)
    if offsets is None:
        offsets = segment_offsets(counts)
    return _GroupedFFN.apply(x.contiguous(), w1.contiguous(),
                             w2.contiguous(), counts,
                             offsets.to(torch.int32), tp)


__all__ = ["KERNEL_NAME", "grouped_ffn", "grouped_rows",
           "grouped_rows_kernel", "grouped_rows_plain", "grouped_wgrad",
           "grouped_wgrad_kernel", "grouped_wgrad_plain", "impl_for",
           "segment_offsets", "segments_from_sorted"]
