"""SubnetNorm as a Triton kernel: RMSNorm whose gain row is picked from the
per-subnet table by a ``subnet_id`` read from device memory.

Replaces the Pallas TPU kernel ``repro/kernels/subnet_rmsnorm.py``
(``subnet_rmsnorm``, ``_kernel``). One program per row: the row is loaded
once, reduced in fp32, scaled by ``rsqrt(mean(x^2) + eps)`` and by the
gain row, and stored in the input's dtype; ``BLOCK_D`` is ``d`` rounded up
to a power of two and masked. Switching subnets changes one int32 in
device memory, never the compiled kernel.

What bounds it: it reads each input once and writes each output once with
a few FLOPs per element, so it is memory-bound; at serving shapes (a few
hundred rows of 1536) its time is launch latency.

``triton`` is imported at the first launch, never at module import: hosts
without a GPU import this module for the plain version.
"""
from __future__ import annotations

import os
import threading

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "subnet_rmsnorm"
tl = None               # triton.language, bound at the first launch
_jit = None
_lock = threading.Lock()


def _rmsnorm_rows(x_ptr, g_ptr, sid_ptr, o_ptr, eps,
                  D: tl.constexpr, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    live = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=live, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
    sid = tl.load(sid_ptr)
    g = tl.load(g_ptr + sid * D + cols, mask=live, other=0.0).to(tl.float32)
    tl.store(o_ptr + row * D + cols, (y * g).to(o_ptr.dtype.element_ty),
             mask=live)


def _compiled_variants() -> int:
    """Specializations Triton has compiled for the kernel in this process;
    read by :class:`repro_torch.compat.BuildCounter` at a phase's edges."""
    jit_fn = _jit
    if jit_fn is None:
        return 0
    caches = getattr(jit_fn, "device_caches", None)
    if caches is not None:
        return sum(len(entry[0]) for entry in list(caches.values()))
    return sum(len(c) for c in list(jit_fn.cache.values()))


compat.register_build_source(_compiled_variants)


def _kernel():
    global tl, _jit
    if _jit is None:
        with _lock:
            if _jit is None:
                os.environ.setdefault("TRITON_CACHE_DIR",
                                      str(build.BUILD_ROOT / "triton"))
                import triton
                import triton.language as tl
                _jit = triton.jit(_rmsnorm_rows)
    return _jit


def subnet_rmsnorm_plain(x, gamma_table, subnet_id, *, eps: float = 1e-5):
    """The plain PyTorch version (port of ``ref.subnet_rmsnorm_ref``)."""
    return ref.subnet_rmsnorm_ref(x, gamma_table, subnet_id, eps=eps)


def subnet_rmsnorm(x, gamma_table, subnet_id, *, eps: float = 1e-5):
    """x: (..., d) CUDA bf16/fp16/fp32, contiguous; gamma_table: (n, d)
    fp32 contiguous; subnet_id: int32 CUDA tensor with one element."""
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{NAME}: unsupported dtype {x.dtype}")
    if not isinstance(subnet_id, torch.Tensor) or subnet_id.numel() != 1 \
            or subnet_id.dtype != torch.int32:
        raise TypeError(f"{NAME}: subnet_id must be a one-element int32 "
                        f"tensor on the device")
    d = x.shape[-1]
    if gamma_table.dim() != 2 or gamma_table.shape[1] != d \
            or gamma_table.dtype != torch.float32:
        raise ValueError(f"{NAME}: gamma_table must be fp32 (n, {d}), got "
                         f"{gamma_table.dtype} {tuple(gamma_table.shape)}")
    for name, t in (("x", x), ("gamma_table", gamma_table),
                    ("subnet_id", subnet_id)):
        if t.device != x.device:
            raise ValueError(f"{NAME}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    block_d = 1 << (d - 1).bit_length()
    kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, gamma_table, subnet_id, out, float(eps),
                        D=d, BLOCK_D=block_d, num_warps=8 if d > 2048 else 4)
    compat.note_launch(NAME)
    return out
