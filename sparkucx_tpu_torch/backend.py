"""Device choice, the kernel build and loader, and impl resolution.

Device rule: every entry point runs on the CUDA device unless the caller
asks for ``device="cpu"``. With no GPU visible and no explicit CPU
request, :func:`resolve_device` raises — nothing drops to the CPU on its
own.

Kernel build: the CUDA sources under ``csrc/`` have a plain C interface
(no PyTorch headers — those push one ``nvcc`` run to minutes). At first
use every source compiles to an object with its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects link into one shared library
in the build directory (named by a digest of sources and flags, so a stale
build is never loaded) and load through ``ctypes``. The build directory is
the package's ``_build/`` unless ``runtime/compile_cache.py`` binds another
(``compile.cacheDir``) or a private one (``compile.cacheEnabled=false``).
A missing compiler, a failed build or a failed launch raises; there is no
fallback to a kernel's plain version on a CUDA tensor.

Launch counts: each kernel wrapper calls :func:`count_launch` where it
launches its kernel, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

from sparkucx_tpu_torch.config import DEFAULT_BUILD_DIR, validate_impl

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = Path(DEFAULT_BUILD_DIR)

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# C symbol -> (restype, argtypes). Pointers and the stream are c_void_p
# (a bare Python int would be passed as a 32-bit int and cut).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # q, k, v, o, lse, BH, T, D, causal, scale, stream -> cudaError_t
    "sxt_flash_fwd": (ctypes.c_int, [_P] * 5 + [_I] * 4 + [_F, _P]),
    # q, k, v, g, lse, delta, dq, BH, T, D, causal, scale, stream
    # -> cudaError_t
    "sxt_flash_dq": (ctypes.c_int, [_P] * 7 + [_I] * 4 + [_F, _P]),
    # q, k, v, g, lse, delta, dk, dv, BH, T, D, causal, scale, stream
    # -> cudaError_t
    "sxt_flash_dkv": (ctypes.c_int, [_P] * 8 + [_I] * 4 + [_F, _P]),
    # send, out, in_off, in_sz, out_off, overflow, P, cap_in, cap_out,
    # width, blocks_per_pair, stream -> cudaError_t
    "sxt_ragged_a2a": (ctypes.c_int,
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # width_in -> rows per tile (0: a row does not fit shared memory)
    "sxt_segment_reduce_tile_rows": (ctypes.c_int, [_I]),
    # rows, part, out_rows, out_part, n_out, scratch, P, cap, width,
    # num_parts, sum_words, float_acc, stream -> cudaError_t
    "sxt_segment_reduce": (ctypes.c_int, [_P] * 6 + [_I] * 6 + [_P]),
    # rows (wire format), part, out_rows, out_part, n_out, scratch, P, cap,
    # wire_words, num_parts, sum_words, stream -> cudaError_t
    "sxt_segment_reduce_wire": (ctypes.c_int, [_P] * 6 + [_I] * 5 + [_P]),
    # out_rows, out_part, n_out, P, cap, width, num_parts, stream
    # -> cudaError_t
    "sxt_segment_reduce_tail": (ctypes.c_int, [_P] * 3 + [_I] * 4 + [_P]),
    # x, u, q, scale, n, width, stream -> cudaError_t
    "sxt_quantize": (ctypes.c_int, [_P] * 4 + [_I] * 2 + [_P]),
    # width -> rows per merge tile (the splits scratch: P * (ceil(out_cap
    # / T) + 1) int32 words)
    "sxt_merge_tile_rows": (ctypes.c_int, [_I]),
    # a_rows, a_part, b_rows, b_part, splits, P, ca, cb, out_cap, width,
    # stream -> cudaError_t
    "sxt_merge_splits": (ctypes.c_int, [_P] * 5 + [_I] * 5 + [_P]),
    # a_rows, a_part, b_rows, b_part, out_rows, out_part, splits, P, ca,
    # cb, out_cap, width, stream -> cudaError_t
    "sxt_merge_path": (ctypes.c_int, [_P] * 7 + [_I] * 5 + [_P]),
    "sxt_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []          # nvcc output of this process's build
# the build directory binding (runtime/compile_cache.py): the shared
# directory, and whether builds stay private to this process
_bound_dir: Path = BUILD_DIR
_bound_private = False
_private_dir: Optional[Path] = None
_builds = 0                        # nvcc builds this process ran

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the current CUDA
    device and raises when there is none; ``"cpu"`` is the explicit
    CPU request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: want cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           f"device is visible")
    if d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_sm90(device: torch.device) -> None:
    """The kernels are built for ``sm_90a`` only (Hopper)."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}; "
            f"the kernels are built for sm_90a (H100/H200)")


def resolve_a2a_impl(impl: str, device: torch.device, num_shards: int,
                     waved: bool = False, sink: str = "host",
                     hierarchical: bool = False,
                     distributed: bool = False) -> str:
    """Resolve ``a2a.impl``. Explicit values pass through validated.
    ``auto`` resolves as the JAX package's ``ragged_shuffle`` does
    ('local' for one shard, else the dense exchange), with one exception:
    on CUDA a single-shot host-sink read (``waved`` false: no
    ``a2a.waveRows``) of a flat topology on one process takes the hand
    kernel ('pallas'), whose chunk-aligned move gives the same
    partitions. A waved read keeps its waves, a device-sink read keeps
    its valid rows a prefix of each shard, a hierarchical read keeps its
    two stages (the reference never runs them under 'pallas'), and a
    distributed read keeps the dense move (the segment move is
    device-local; the manager refuses an explicit 'pallas' there), as
    under the reference's ``auto``."""
    validate_impl(impl)
    if impl != "auto":
        return impl
    if num_shards == 1:
        return "local"
    if device.type == "cuda" and not waved and sink == "host" \
            and not hierarchical and not distributed:
        return "pallas"
    return "dense"


def count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        _launches.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH); the CUDA "
                       "kernels cannot be built")


def _run_all(cmds: List[List[str]]) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        build_log.append(" ".join(c) + "\n" + out)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def private_build_dir() -> Path:
    """This process's own build directory (made on first use, removed
    at exit)."""
    global _private_dir
    if _private_dir is None:
        _private_dir = Path(tempfile.mkdtemp(prefix="sxt_kernels_"))
        import atexit
        atexit.register(shutil.rmtree, str(_private_dir), True)
    return _private_dir


def bind_build_dir(path, private: bool = False) -> None:
    """Where later builds go and load from: the shared directory
    ``path``, or (``private``) this process's own. A library already
    loaded stays loaded."""
    global _bound_dir, _bound_private
    with _lock:
        _bound_dir = Path(path) if path is not None else BUILD_DIR
        _bound_private = bool(private)


def build_dir() -> Path:
    """The directory the next build goes into and loads from."""
    return private_build_dir() if _bound_private else _bound_dir


def build_count() -> int:
    """nvcc builds this process ran (0 when every load found a build)."""
    return _builds


def library_digest() -> str:
    """Digest of the sources and flags that names the library file."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    global _builds
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = library_digest()
    name = f"libsxt_kernels_{digest}.so"
    out_dir = build_dir()
    lib_path = out_dir / name
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
              for s, o in zip(sources, objs)])
    tmp = out_dir / f"libsxt_kernels.{tag}.so"
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs),
               "-lcudart"]])
    _builds += 1
    os.replace(tmp, lib_path)        # atomic: readers never see a partial
    for o in objs:
        o.unlink(missing_ok=True)
    return lib_path


def kernel_library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call in this process
    when the build directory has no current build)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (res, args) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check_launch(name: str, code: int) -> None:
    """Raise on a non-zero cudaError_t from a kernel's C entry point (a
    refused launch never runs, and a later synchronize would not say
    so)."""
    if code != 0:
        msg = kernel_library().sxt_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {code} ({msg})")
