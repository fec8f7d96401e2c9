"""Causal GQA flash attention (prefill): the CUDA kernel, its wrapper and
its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py`` (``flash_attention``, ``_kernel``,
``_kv_index``): online softmax over 64-key tiles, causal, optional sliding
window, a valid-kv length that may live in device memory, dead tiles
skipped, a fully masked row emits 0. One block per (64-row q tile, query
head, batch row), four warps of 16 rows; Q K^T and P V on the tensor
cores (``mma.sync`` bf16, fp32 accumulate); m, l and the accumulator in
fp32 registers.

What bounds it on the H100: the bytes it must move (q, k, v, o once);
at serving shapes (S <= 256) the work is small and latency dominates, and
without TMA or ``wgmma`` it stays about 11x above that bound at S=256.

The wrapper takes q/k/v whose rows are contiguous (any b/h/s strides, so
the (B, S, H, d) projections are read in place) and returns a
(B, Hq, Sq, d) view of a (B, Sq, Hq, d) buffer, so the caller's transpose
back costs nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "flash_attention"
HEAD_DIMS = (128,)
_C = "repro_flash_attention_bf16"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal=True, window=0, kv_len=None,
                          q_block=256, kv_block=256):
    """The plain PyTorch version (port of ``ref.flash_attention_ref``)."""
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len, q_block=q_block,
                                   kv_block=kv_block)


def _check_rows(name: str, kernel: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is 16-byte aligned with contiguous rows whose
    strides keep every row 16-byte aligned (the kernel's vector loads)."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} needs contiguous, 16-byte "
                         f"aligned rows; got strides {t.stride()}")


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d); bf16 CUDA tensors, d = 128.
    ``kv_len``: None (all of Sk), an int, or an int32 CUDA tensor with one
    element (read by the kernel). Returns (B, Hq, Sq, d) bf16."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{NAME}: {name} must be on {q.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{NAME}: {name} must be 4-d, got {tuple(t.shape)}")
        _check_rows(name, NAME, t)
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {d} not built; have {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{NAME}: {Hq} query heads over {Hkv} kv heads")
    kv_ptr, kv_static = None, Sk
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device or kv_len.dtype != torch.int32 \
                or kv_len.numel() != 1:
            raise TypeError(f"{NAME}: kv_len tensor must be one int32 on "
                            f"{q.device}")
        kv_ptr = kv_len.data_ptr()
    elif kv_len is not None:
        kv_static = int(kv_len)
    o = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device
                    ).transpose(1, 2)
    fn = build.function(_C, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, Hq, Hkv, Sq, Sk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], int(bool(causal)), int(window), kv_ptr,
             kv_static, float(d ** -0.5), stream)
    build.check(NAME, err)
    compat.note_launch(NAME)
    return o
