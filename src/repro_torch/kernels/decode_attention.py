"""Single-token GQA decode attention: the CUDA kernel, its wrapper and its
plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py`` (``decode_attention``, ``_kernel``):
one query token per row against a (B, Hkv, Smax, d) cache, the G query
heads of a kv head sharing one cache stream, positions past ``index``
neither read nor computed (``window == 0``), the rolling-buffer mask for
``window > 0``, ``index`` read from device memory.

The TPU walks the cache sequentially on one core; on the H100 the grid is
split along the cache, (B * Hkv, n_split), because B * Hkv blocks alone
leave most of the SMs idle at serving batch sizes; ``split_plan`` sizes
the split from the card's own SM count. Each block writes partial
(m, l, acc) in fp32 to scratch that this wrapper allocates, and a second
small kernel combines them.

What bounds it on the H100: memory (4 * d FLOPs per live cache position
and query head, against 4 * d bytes of K and V); at serving shapes the
live cache is small and the time is launch latency.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "decode_attention"
HEAD_DIMS = (128,)
G_MAX = 8
_C = "repro_decode_attention_bf16"
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def decode_attention_plain(q, k_cache, v_cache, index, *, window=0,
                           kv_block=256):
    """The plain PyTorch version (port of ``ref.decode_attention_ref``)."""
    return ref.decode_attention_ref(q, k_cache, v_cache, index,
                                    window=window, kv_block=kv_block)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(batch_kv: int, smax: int, sms: int):
    """(n_split, chunk): enough cache chunks that B * Hkv * n_split blocks
    give each of the card's ``sms`` SMs about two, in chunks of at least
    64 positions."""
    target = max(1, math.ceil(2 * sms / max(batch_kv, 1)))
    n_split = max(1, min(target, math.ceil(smax / 64)))
    chunk = math.ceil(smax / n_split)
    return math.ceil(smax / chunk), chunk


def decode_attention(q, k_cache, v_cache, index, *, window=0):
    """q: (B, Hq, 1, d); caches: (B, Hkv, Smax, d); bf16 contiguous CUDA
    tensors, d = 128, Hq / Hkv <= 8. ``index``: int32 CUDA tensor with one
    element (or an int, written to the device without a host sync).
    Returns (B, Hq, 1, d) bf16."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{NAME}: {name} must be on {q.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be a contiguous 4-d "
                             f"tensor, got {tuple(t.shape)}")
    B, Hq, one, d = q.shape
    _, Hkv, Smax, _ = k_cache.shape
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != d:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)} caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {d} not built; have {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > G_MAX:
        raise ValueError(f"{NAME}: {Hq} query heads over {Hkv} kv heads "
                         f"(at most {G_MAX} per kv head)")
    if not isinstance(index, torch.Tensor):
        index = torch.full((), int(index), dtype=torch.int32, device=q.device)
    if index.device != q.device or index.dtype != torch.int32 \
            or index.numel() != 1:
        raise TypeError(f"{NAME}: index must be one int32 on {q.device}")
    G = Hq // Hkv
    n_split, chunk = split_plan(B * Hkv, Smax, _sm_count(q.device))
    part_m = torch.empty((B * Hkv * n_split * G,), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * Hkv * n_split * G, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    fn = build.function(_C, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             index.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
             part_acc.data_ptr(), out.data_ptr(), B, Hkv, G, Smax, d,
             n_split, chunk, int(window), float(d ** -0.5), stream)
    build.check(NAME, err)
    compat.note_launch(NAME)
    return out
