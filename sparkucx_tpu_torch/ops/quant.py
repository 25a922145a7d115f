"""Per-row int8 quantization with stochastic rounding — the port of the
JAX package's ``ops/pallas/quant.py``, the quantize half of the int8 wire
tier (``shuffle/alltoall.wire_pack_rows``).

For each row of ``x`` ``[N, W]`` float32:

    scale = amax(|x|) * RECIP_127   (1.0 for an all-zero row)
    q     = clip(floor(x / scale) + (u < frac), -127, 127)   as int8

where ``frac = x / scale - floor(x / scale)`` (a true division) and
``u`` ``[N, W]`` float32 are uniforms in [0, 1) the CALLER supplies, as
the TPU kernel takes them: fed the same ``u``, the two packages produce
the same bytes. Stochastic rounding keeps the expectation of
``q * scale`` equal to ``x``.

The JAX source writes the scale as ``amax / 127.0``; XLA compiles a
division by a constant into a multiplication by the constant's float32
reciprocal, so the bytes the JAX package produces come from
``amax * float32(1/127)``, which differs from a true division in the
last bit for a few percent of rows. Both versions here multiply by
:data:`RECIP_127`, which is what makes their bytes equal the reference's.

* :func:`quantize_kernel` — the hand-written CUDA kernel
  (``csrc/quant.cu``), for CUDA tensors; counts launches under
  ``"quantize"``.
* :func:`quantize_plain` — its plain PyTorch version, for CPU tensors and
  as the kernel's reference.
* :func:`quantize` — the kernel for a CUDA tensor, the plain version for
  a CPU one; nothing else chooses between them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkucx_tpu_torch import backend

KERNEL_NAME = "quantize"

# float32(1/127), the constant XLA multiplies by for ``amax / 127.0``
RECIP_127 = 1.0 / 127.0


def _check_inputs(x: torch.Tensor, u: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, W] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if u.dtype != torch.float32 or tuple(u.shape) != tuple(x.shape):
        raise ValueError(f"u must be float32 of x's shape {tuple(x.shape)}, "
                         f"got {tuple(u.shape)} {u.dtype}")
    if x.shape[1] < 1:
        raise ValueError("rows must have at least one value lane")


def quantize_plain(x: torch.Tensor, u: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: returns (q ``[N, W]`` int8, scale
    ``[N, 1]`` float32), the reference's arithmetic step for step (the
    scale by the float32 reciprocal of 127, then a true division, floor
    and one comparison with ``u``)."""
    _check_inputs(x, u)
    amax = x.abs().amax(dim=1, keepdim=True)
    recip = torch.tensor(RECIP_127, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * recip, torch.ones_like(amax))
    scaled = x / scale
    lo = torch.floor(scaled)
    frac = scaled - lo
    q = lo + (u < frac).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantize_kernel(x: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA quantize kernel on the current stream (no host
    synchronisation). Same contract as :func:`quantize_plain`."""
    _check_inputs(x, u)
    dev = x.device
    if dev.type != "cuda" or u.device != dev:
        raise ValueError(f"quantize_kernel needs CUDA tensors on one device, "
                         f"got {dev} and {u.device}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("x and u must be contiguous")
    N, W = x.shape
    q = torch.empty((N, W), dtype=torch.int8, device=dev)
    scale = torch.empty((N, 1), dtype=torch.float32, device=dev)
    if N == 0:
        return q, scale
    if N >= 1 << 31:
        raise ValueError(f"{N} rows exceed the kernel's int32 row index")
    backend.check_sm90(dev)
    lib = backend.kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sxt_quantize(x.data_ptr(), u.data_ptr(), q.data_ptr(),
                              scale.data_ptr(), N, W, stream)
    backend.check_launch(KERNEL_NAME, rc)
    backend.count_launch(KERNEL_NAME)
    return q, scale


def quantize(x: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for a CUDA tensor, its plain version for a CPU one."""
    fn = quantize_kernel if x.is_cuda else quantize_plain
    return fn(x, u)


def quantize_rows(x: torch.Tensor, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, W]`` float32 -> (int8 ``[N, W]``, scale ``[N, 1]`` float32),
    rounding by the caller's uniforms ``u`` ``[N, W]``."""
    return quantize(x.contiguous(), u.contiguous())


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` up to the rounding noise: one
    rounded float32 product per element, ``q * scale``."""
    return q.to(torch.float32) * scale
