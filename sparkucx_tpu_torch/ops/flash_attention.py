"""Flash attention, forward and backward — the port of the JAX package's
``ops/pallas/flash_attention.py``.

Three kernels, hand-written in CUDA for Hopper (``csrc/flash_attention.cu``),
each with a plain PyTorch version that runs the same block recurrence in
torch ops, blockwise and without autograd:

* ``flash_fwd`` (:func:`flash_fwd_kernel` / :func:`flash_fwd_plain`):
  online-softmax attention over ``[BH, T, D]``, optional causal mask;
  returns O and the logsumexp row ``lse`` ``[BH, T]`` (0 for a row with no
  live key).
* ``flash_dq`` (:func:`flash_dq_kernel` / :func:`flash_dq_plain`): the
  recomputation backward for dq, accumulated over K blocks from the saved
  lse and ``delta = rowsum(dO * O)``.
* ``flash_dkv`` (:func:`flash_dkv_kernel` / :func:`flash_dkv_plain`): dk
  and dv, accumulated over Q blocks.

:func:`flash_fwd`, :func:`flash_dq` and :func:`flash_dkv` launch the
kernel for a CUDA tensor and run the plain version for a CPU one; nothing
else chooses between them. Every input is computed in float32.

:func:`flash_attention` is the differentiable entry point on
``[B, H, T, D]`` (``impl``: ``auto`` | ``pallas`` | ``interpret`` |
``scan``, as in the reference): a ``torch.autograd.Function`` saves q, k,
v, O and lse, computes ``delta`` in torch (the reference computes it in
XLA) and runs the two backward kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sparkucx_tpu_torch import backend
from sparkucx_tpu_torch.ops.attention import NEG_INF, blockwise_attention

FWD_KERNEL_NAME = "flash_fwd"
DQ_KERNEL_NAME = "flash_dq"
DKV_KERNEL_NAME = "flash_dkv"

# head dims the kernels are compiled for; a smaller D pads up to the next
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
PLAIN_BLOCK = 512          # rows per block of the plain versions

IMPLS = ("auto", "pallas", "interpret", "scan")


# -- plain versions ----------------------------------------------------------
def _live(rows, cols, causal: bool):
    """[bq, bk] mask of live (query, key) pairs at global positions."""
    if not causal:
        return None
    return cols[None, :] <= rows[:, None]


@torch.no_grad()
def flash_fwd_plain(q, k, v, causal: bool, scale: float,
                    block_q: int = PLAIN_BLOCK,
                    block_k: int = PLAIN_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O ``[BH, T, D]``, lse ``[BH, T]``) by the kernel's recurrence: per
    Q block, the online softmax over the K blocks at or below its last
    row (all of them without the causal mask)."""
    _check_shapes(q, k, v)
    BH, T, D = q.shape
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, block_q):
        q1 = min(T, q0 + block_q)
        qb = q[:, q0:q1] * scale
        m = torch.full((BH, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros((BH, q1 - q0), device=q.device)
        acc = torch.zeros((BH, q1 - q0, D), device=q.device)
        for k0 in range(0, q1 if causal else T, block_k):
            k1 = min(T, k0 + block_k)
            s = qb @ k[:, k0:k1].transpose(1, 2)
            live = _live(pos[q0:q1], pos[k0:k1], causal)
            if live is not None:
                s = s.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            dead = m_new <= NEG_INF / 2
            m_safe = m_new.masked_fill(dead, 0.0)
            alpha = torch.exp(m - m_safe).masked_fill(dead, 1.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(dead[..., None],
                                                             0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ v[:, k0:k1]
            m = m_new
        denom = torch.where(l <= 0.0, torch.ones_like(l), l)
        o[:, q0:q1] = acc / denom[..., None]
        lse[:, q0:q1] = torch.where(l <= 0.0, torch.zeros_like(l),
                                    m + torch.log(denom))
    return o, lse


def _probs(qb, kb, lse_b, rows, cols, causal, scale):
    """exp(scale * q k^T - lse) on live pairs, 0 elsewhere."""
    p = torch.exp(scale * (qb @ kb.transpose(1, 2)) - lse_b[..., None])
    live = _live(rows, cols, causal)
    return p if live is None else p.masked_fill(~live, 0.0)


@torch.no_grad()
def flash_dq_plain(q, k, v, g, lse, delta, causal: bool, scale: float,
                   block_q: int = PLAIN_BLOCK,
                   block_k: int = PLAIN_BLOCK) -> torch.Tensor:
    """dq ``[BH, T, D]``: per Q block, ``sum_K dS K`` with
    ``dS = P * (dO V^T - delta) * scale``."""
    _check_shapes(q, k, v, g)
    BH, T, D = q.shape
    q, k, v, g = (x.to(torch.float32) for x in (q, k, v, g))
    dq = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, block_q):
        q1 = min(T, q0 + block_q)
        acc = torch.zeros((BH, q1 - q0, D), device=q.device)
        for k0 in range(0, q1 if causal else T, block_k):
            k1 = min(T, k0 + block_k)
            p = _probs(q[:, q0:q1], k[:, k0:k1], lse[:, q0:q1], pos[q0:q1],
                       pos[k0:k1], causal, scale)
            dp = g[:, q0:q1] @ v[:, k0:k1].transpose(1, 2)
            ds = p * (dp - delta[:, q0:q1, None]) * scale
            acc += ds @ k[:, k0:k1]
        dq[:, q0:q1] = acc
    return dq


@torch.no_grad()
def flash_dkv_plain(q, k, v, g, lse, delta, causal: bool, scale: float,
                    block_q: int = PLAIN_BLOCK, block_k: int = PLAIN_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[BH, T, D]``: per K block, ``dv = sum_Q P^T dO`` and
    ``dk = sum_Q dS^T Q`` over the Q blocks at or below its diagonal."""
    _check_shapes(q, k, v, g)
    BH, T, D = q.shape
    q, k, v, g = (x.to(torch.float32) for x in (q, k, v, g))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    pos = torch.arange(T, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(T, k0 + block_k)
        acc_k = torch.zeros((BH, k1 - k0, D), device=q.device)
        acc_v = torch.zeros((BH, k1 - k0, D), device=q.device)
        first = (k0 // block_q) * block_q if causal else 0
        for q0 in range(first, T, block_q):
            q1 = min(T, q0 + block_q)
            p = _probs(q[:, q0:q1], k[:, k0:k1], lse[:, q0:q1], pos[q0:q1],
                       pos[k0:k1], causal, scale)
            acc_v += p.transpose(1, 2) @ g[:, q0:q1]
            dp = g[:, q0:q1] @ v[:, k0:k1].transpose(1, 2)
            ds = p * (dp - delta[:, q0:q1, None]) * scale
            acc_k += ds.transpose(1, 2) @ q[:, q0:q1]
        dk[:, k0:k1] = acc_k
        dv[:, k0:k1] = acc_v
    return dk, dv


# -- kernel wrappers ---------------------------------------------------------
def _check_shapes(*xs) -> None:
    shape = tuple(xs[0].shape)
    if len(shape) != 3:
        raise ValueError(f"expected [BH, T, D] tensors, got {shape}")
    for x in xs[1:]:
        if tuple(x.shape) != shape:
            raise ValueError(f"shape {tuple(x.shape)} differs from {shape}")


def _kernel_dim(D: int) -> int:
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"head_dim {D} exceeds the kernels' largest, "
                     f"{KERNEL_HEAD_DIMS[-1]}")


def _kernel_inputs(name: str, xs, rows):
    """Check device, dtype, shape, contiguity and alignment of the tensors
    a kernel reads; pad D up to a compiled head dim. ``rows`` are the
    ``[BH, T]`` float32 inputs (lse, delta)."""
    _check_shapes(*xs)
    dev = xs[0].device
    BH, T, D = xs[0].shape
    for x in list(xs) + list(rows):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors on one device, got "
                             f"{x.device} and {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} inputs must be 16-byte aligned")
    for r in rows:
        if tuple(r.shape) != (BH, T):
            raise ValueError(f"{name}: row input {tuple(r.shape)}, want "
                             f"{(BH, T)}")
    Dk = _kernel_dim(D)
    if BH * T * Dk >= 1 << 31:
        raise ValueError(f"[{BH}, {T}, {Dk}] exceeds the kernels' int32 "
                         f"tile indices")
    if Dk != D:
        xs = [F.pad(x, (0, Dk - D)) for x in xs]
    backend.check_sm90(dev)
    return xs, Dk


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd_kernel(q, k, v, causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream (no host
    synchronisation). Same contract as :func:`flash_fwd_plain`."""
    D = q.shape[-1]
    (q, k, v), Dk = _kernel_inputs(FWD_KERNEL_NAME, (q, k, v), ())
    BH, T, _ = q.shape
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    if BH and T:
        lib = backend.kernel_library()
        with torch.cuda.device(dev):
            rc = lib.sxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), BH, T, Dk,
                                   int(causal), float(scale), _stream(dev))
        backend.check_launch(FWD_KERNEL_NAME, rc)
        backend.count_launch(FWD_KERNEL_NAME)
    return _unpad(o, D), lse


def _unpad(x, D):
    return x[..., :D].contiguous() if x.shape[-1] != D else x


def flash_dq_kernel(q, k, v, g, lse, delta, causal: bool,
                    scale: float) -> torch.Tensor:
    """Launch the dq kernel. Same contract as :func:`flash_dq_plain`."""
    D = q.shape[-1]
    (q, k, v, g), Dk = _kernel_inputs(DQ_KERNEL_NAME, (q, k, v, g),
                                      (lse, delta))
    BH, T, _ = q.shape
    dev = q.device
    dq = torch.empty_like(q)
    if BH and T:
        lib = backend.kernel_library()
        with torch.cuda.device(dev):
            rc = lib.sxt_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  g.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dq.data_ptr(), BH, T, Dk,
                                  int(causal), float(scale), _stream(dev))
        backend.check_launch(DQ_KERNEL_NAME, rc)
        backend.count_launch(DQ_KERNEL_NAME)
    return _unpad(dq, D)


def flash_dkv_kernel(q, k, v, g, lse, delta, causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel. Same contract as :func:`flash_dkv_plain`."""
    D = q.shape[-1]
    (q, k, v, g), Dk = _kernel_inputs(DKV_KERNEL_NAME, (q, k, v, g),
                                      (lse, delta))
    BH, T, _ = q.shape
    dev = q.device
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if BH and T:
        lib = backend.kernel_library()
        with torch.cuda.device(dev):
            rc = lib.sxt_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   g.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), BH, T, Dk, int(causal),
                                   float(scale), _stream(dev))
        backend.check_launch(DKV_KERNEL_NAME, rc)
        backend.count_launch(DKV_KERNEL_NAME)
    return _unpad(dk, D), _unpad(dv, D)


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The forward kernel for a CUDA tensor, its plain version for a CPU
    one."""
    fn = flash_fwd_kernel if q.is_cuda else flash_fwd_plain
    return fn(q, k, v, causal, scale)


def flash_dq(q, k, v, g, lse, delta, causal: bool, scale: float):
    fn = flash_dq_kernel if q.is_cuda else flash_dq_plain
    return fn(q, k, v, g, lse, delta, causal, scale)


def flash_dkv(q, k, v, g, lse, delta, causal: bool, scale: float):
    fn = flash_dkv_kernel if q.is_cuda else flash_dkv_plain
    return fn(q, k, v, g, lse, delta, causal, scale)


# -- autograd ----------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward saves q, k, v (as
    float32 ``[BH, T, D]``), O and lse; backward runs dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, plain, block_q, block_k):
        B, H, T, D = q.shape
        qf, kf, vf = (x.reshape(B * H, T, D).to(torch.float32).contiguous()
                      for x in (q, k, v))
        if plain:
            o, lse = flash_fwd_plain(qf, kf, vf, causal, scale, block_q,
                                     block_k)
        else:
            o, lse = flash_fwd(qf, kf, vf, causal, scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.cfg = (causal, scale, plain, block_q, block_k)
        return out.reshape(B, H, T, D)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        causal, scale, plain, block_q, block_k = ctx.cfg
        B, H, T, D = g.shape
        gf = g.reshape(B * H, T, D).to(torch.float32)
        # delta = rowsum(dO * O) stays in torch, as the reference keeps it
        # in XLA; the kernels see dO in the inputs' dtype, as there
        delta = (gf * out.to(torch.float32)).sum(dim=-1)
        gk = gf.to(out.dtype).to(torch.float32).contiguous()
        if plain:
            dq = flash_dq_plain(qf, kf, vf, gk, lse, delta, causal, scale,
                                block_q, block_k)
            dk, dv = flash_dkv_plain(qf, kf, vf, gk, lse, delta, causal,
                                     scale, block_q, block_k)
        else:
            dq = flash_dq(qf, kf, vf, gk, lse, delta, causal, scale)
            dk, dv = flash_dkv(qf, kf, vf, gk, lse, delta, causal, scale)
        shape = (B, H, T, D)
        return (dq.reshape(shape).to(out.dtype),
                dk.reshape(shape).to(out.dtype),
                dv.reshape(shape).to(out.dtype), None, None, None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 256,
                    causal: bool = False, scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """``[B, H, T, D]`` attention, differentiable under every impl.

    ``impl``: ``auto`` (``pallas`` on a CUDA tensor, ``scan`` on a CPU
    one); ``pallas`` (the kernels on a CUDA tensor, their plain versions
    on a CPU one); ``interpret`` (the plain versions on any device, the
    counterpart of the Pallas interpreter); ``scan``
    (:func:`~sparkucx_tpu_torch.ops.attention.blockwise_attention`).
    Inputs of another float dtype are computed in float32 and returned in
    their own."""
    scale_ = q.shape[-1] ** -0.5 if scale is None else scale
    if impl == "auto":
        impl = "pallas" if q.is_cuda else "scan"
    if impl == "scan":
        return blockwise_attention(q, k, v, block_k=block_k, causal=causal,
                                   scale=scale_)
    if impl not in ("pallas", "interpret"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _Flash.apply(q, k, v, causal, float(scale_), impl == "interpret",
                        block_q, block_k)


__all__ = ["flash_attention", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain",
           "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"]
