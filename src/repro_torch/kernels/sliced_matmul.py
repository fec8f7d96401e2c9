"""WeightSlice matmul: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/sliced_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/sliced_matmul.py`` (``sliced_matmul``, ``_kernel``) and its
GPU-Pallas twin in ``repro/kernels/triton_kernels.py``:
``y = x[:, :active_in] @ w[:active_in, :active_out]`` with zeros past
``active_out``, bf16 in, fp32 accumulation, bf16 out. The widths are data:
ints, or int32 CUDA tensors of one element that the kernel reads from
device memory, so one launch serves every subnet. K tiles past
``active_in`` are neither loaded nor computed, and a column tile past
``active_out`` only writes zeros.

``segments`` cuts K into equal segments, each with its own active prefix
of ``active_in`` (the GQA output projection, one segment per KV head).

What bounds it on the H100: at serving shapes (M <= 128 rows against the
1536 x 8960 FFN weights) the bytes of the active weight block. Tiles of
64 x 64 on ``mma.sync`` tensor cores, a four-stage ``cp.async`` ring, no
TMA, ``wgmma`` or split-K yet.

The wrapper takes 2-d operands with any row stride that keeps rows 16-byte
aligned, so per-group views need no copy; ``x`` of more dimensions is
flattened to rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat
from repro_torch.kernels import build

NAME = "sliced_matmul"
_C = "repro_sliced_matmul_bf16"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])


def sliced_matmul_plain(x, w, active_in, active_out, *, segments: int = 1):
    """The plain PyTorch version. x: (..., K); w: (K, N); widths None (the
    full width), ints or 0-d integer tensors (used as data). Channel k of
    x counts when ``k % (K // segments) < active_in``; output columns at
    or past ``active_out`` are 0. fp32 accumulation, output in x's dtype."""
    K, N = w.shape
    if active_in is not None:
        keep = (torch.arange(K, device=x.device) % (K // segments)) < active_in
        x = x * keep.to(x.dtype)
    y = x.float() @ w.float()
    if active_out is not None:
        y = y * (torch.arange(N, device=x.device) < active_out).to(y.dtype)
    return y.to(x.dtype)


def _width(name: str, val, full: int, device):
    """(device pointer or None, static value) for one width argument."""
    if val is None:
        return None, full
    if isinstance(val, torch.Tensor):
        if val.device != device or val.dtype != torch.int32 \
                or val.numel() != 1:
            raise TypeError(f"{NAME}: {name} tensor must be one int32 on "
                            f"{device}")
        return val.data_ptr(), 0
    return None, int(val)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{NAME}: {name} needs contiguous, 16-byte aligned "
                         f"rows; got strides {t.stride()}")


def sliced_matmul(x, w, active_in, active_out, *, segments: int = 1):
    """x: (..., K) or a strided (M, K) view; w: (K, N); bf16 CUDA tensors.
    Returns (..., N) bf16 (see :func:`sliced_matmul_plain`)."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{NAME}: {name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: {name} must be bfloat16, got {t.dtype}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{NAME}: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    K, N = w.shape
    if segments < 1 or K % segments or (K // segments) % 8 or N % 8:
        raise ValueError(f"{NAME}: K={K} in {segments} segments and N={N} "
                         f"must be multiples of 8")
    lead = x.shape[:-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    _check_rows("x", x2)
    _check_rows("w", w)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    ai_ptr, ai = _width("active_in", active_in, K // segments, x.device)
    ao_ptr, ao = _width("active_out", active_out, N, x.device)
    fn = build.function(_C, _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, segments,
             x2.stride(0), w.stride(0), y.stride(0), ai_ptr, ai, ao_ptr, ao,
             stream)
    build.check(NAME, err)
    compat.note_launch(NAME)
    return y.reshape(*lead, N)
