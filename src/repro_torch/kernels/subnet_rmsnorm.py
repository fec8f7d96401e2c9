"""SubnetNorm: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/subnet_rmsnorm.cu``) replaces the Pallas TPU kernel
``repro/kernels/subnet_rmsnorm.py`` (``subnet_rmsnorm`` at :27, its
``pallas_call`` at :42): RMSNorm of each row, in fp32, times the gain row
``gamma_table[subnet_id]``, where ``subnet_id`` is read from device
memory, so switching subnets changes one int32 and never the launch.

Two entry points launch the same kernel:

* :func:`subnet_rmsnorm` ``(x, gamma_table, subnet_id) -> h``, the JAX
  function's counterpart;
* :func:`add_subnet_rmsnorm` ``(x, delta, gamma_table, subnet_id) ->
  (s, h)``: the pending residual add fused in front, ``s = x + delta``
  (an fp32 add rounded once to x's type, bit for bit ``torch.add``) and
  ``h`` the norm of that rounded ``s``. The model's blocks hand their
  output to the next block's pre-norm this way, so the residual add costs
  no launch of its own.

What bounds it on the H100: bytes (each element read once or twice and
written once or twice for a few FLOPs); at the served shapes a call is
its launch plus one chain of dependent loads. Design: one block of four
warps a row, the row held in registers as 16-byte vectors, the sum of
squares reduced with warp shuffles and one barrier (see the source). It
takes bf16, fp16 and fp32, ``d`` a multiple of 8, 16-byte aligned rows.

On a CUDA tensor the wrappers launch the kernel or raise; CPU tensors
take the plain versions through :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "subnet_rmsnorm"
_C = {torch.bfloat16: "repro_subnet_rmsnorm_bf16",
      torch.float16: "repro_subnet_rmsnorm_f16",
      torch.float32: "repro_subnet_rmsnorm_f32"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]


def subnet_rmsnorm_plain(x, gamma_table, subnet_id, *, eps: float = 1e-5):
    """The plain PyTorch version (port of ``ref.subnet_rmsnorm_ref``)."""
    return ref.subnet_rmsnorm_ref(x, gamma_table, subnet_id, eps=eps)


def add_subnet_rmsnorm_plain(x, delta, gamma_table, subnet_id, *,
                             eps: float = 1e-5):
    """The plain version of the fused form: ``s = x + delta``, then the
    norm of ``s``."""
    return ref.add_subnet_rmsnorm_ref(x, delta, gamma_table, subnet_id,
                                      eps=eps)


def subnet_rmsnorm(x, gamma_table, subnet_id, *, eps: float = 1e-5):
    """x: (..., d) contiguous CUDA bf16/fp16/fp32; gamma_table: (n, d)
    fp32 contiguous; subnet_id: one int32 on x's device. Returns h, x's
    shape and type."""
    return _run(x, None, gamma_table, subnet_id, eps)


def add_subnet_rmsnorm(x, delta, gamma_table, subnet_id, *,
                       eps: float = 1e-5):
    """``(s, h)`` with ``s = x + delta`` and ``h`` the norm of ``s``; delta
    of x's shape, type and device, contiguous. Both are views of one
    ``(2, *x.shape)`` allocation."""
    if not isinstance(delta, torch.Tensor) or delta.shape != x.shape \
            or delta.dtype != x.dtype or delta.device != x.device \
            or not delta.is_contiguous():
        raise ValueError(f"{NAME}: delta must be a contiguous tensor of x's "
                         f"shape {tuple(x.shape)}, type and device")
    out = _run(x, delta, gamma_table, subnet_id, eps)
    return out[0], out[1]


def _run(x, delta, gamma_table, subnet_id, eps):
    """Checks, allocates the output and launches once."""
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: kernel needs CUDA tensors, got {x.device}")
    c_name = _C.get(x.dtype)
    if c_name is None:
        raise TypeError(f"{NAME}: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if d % 8 or not x.is_contiguous():
        raise ValueError(f"{NAME}: x must be contiguous with a last dim that "
                         f"is a multiple of 8, got {tuple(x.shape)}")
    if gamma_table.dim() != 2 or gamma_table.shape[1] != d \
            or gamma_table.dtype != torch.float32 \
            or not gamma_table.is_contiguous() \
            or gamma_table.device != x.device:
        raise ValueError(f"{NAME}: gamma_table must be contiguous fp32 "
                         f"(n, {d}) on {x.device}, got {gamma_table.dtype} "
                         f"{tuple(gamma_table.shape)} on {gamma_table.device}")
    if not isinstance(subnet_id, torch.Tensor) or subnet_id.numel() != 1 \
            or subnet_id.dtype != torch.int32 or subnet_id.device != x.device:
        raise TypeError(f"{NAME}: subnet_id must be one int32 on {x.device}")
    out = torch.empty(x.shape if delta is None else (2, *x.shape),
                      dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    px, pg = x.data_ptr(), gamma_table.data_ptr()
    pd = 0 if delta is None else delta.data_ptr()
    if (px | pg | pd) & 15:
        raise ValueError(f"{NAME}: x, delta and gamma_table must be 16-byte "
                         f"aligned")
    build.check(NAME, build.function(c_name, _ARGTYPES)(
        px, pd or None, pg, subnet_id.data_ptr(), out.data_ptr(), rows, d,
        eps, torch._C._cuda_getCurrentRawStream(x.get_device())))
    compat.note_launch(NAME)
    return out
