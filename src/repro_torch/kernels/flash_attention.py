"""Causal GQA flash attention (prefill): the CUDA kernel, its wrapper, its
plain version and the Python mirror of the kernel's schedule.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py`` (``flash_attention``, ``_kernel``,
``_kv_index``): online softmax over kv tiles, causal, optional sliding
window, a valid-kv length that may live in device memory, dead tiles
neither loaded nor computed, a fully masked row emits 0. A block packs
``nh`` query heads of one kv group, ``np`` positions each, into the 64 rows
of one ``wgmma`` tile (``pack_plan``); K and V tiles arrive by TMA and are
staged once for all the heads of the block; S = Q K^T and O += P V run on
``wgmma`` (P from registers, V as an N-major operand); m, l and the
accumulator stay in fp32 registers. With ``head_width`` (WeightSlice
switch mode) the kernel reads the width on the card, computes only the
active heads and writes zeros for the rest. Each head dim of ``HEAD_DIMS``
runs the same body, compiled at that d, on a head padded to 128 columns on
the SM (the tensor maps are d wide and read zeros past d); only d columns
are stored.

What bounds it on the H100: at the served S = 16 the latency of one
block's chain of loads and products; the bytes it must move (q, k, v, o
once) up to a few hundred positions; the tensor cores' operations beyond.

The wrapper takes q/k/v whose rows are contiguous (any b/h/s strides, so
the (B, S, H, d) projections are read in place) and returns a
(B, Hq, Sq, d) view of a (B, Sq, Hq, d) buffer, so the caller's transpose
back costs nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "flash_attention"
HEAD_DIMS = (64, 80, 120, 128)
_C = "repro_flash_attention_bf16"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal=True, window=0, kv_len=None,
                          head_width=None, q_block=256, kv_block=256):
    """The plain PyTorch version (port of ``ref.flash_attention_ref``);
    with ``head_width``, the outputs of inactive heads are 0."""
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                kv_len=kv_len, q_block=q_block,
                                kv_block=kv_block)
    return ref.zero_inactive_heads(o, k.shape[1], head_width)


# --------------------------------------------------------------------------
# the kernel's schedule, in Python (the tests hold it to its spec)
# --------------------------------------------------------------------------


class Plan(NamedTuple):
    """A block packs ``nh`` head slots of ``np`` positions (head-major)
    into its 64 rows, and walks kv tiles of ``kt`` keys, 32 or 64
    (``csrc/flash_attention.cu``, Tile: K in a ring of 2 stages, V in 2
    or 1)."""
    np: int
    nh: int
    kt: int = 64

    @property
    def word(self) -> int:
        """The plan as the kernel's entry point takes it, in one int."""
        return self.np | self.nh << 8 | self.kt << 16


ROWS = 64             # packed rows of a block: one warpgroup's wgmma tile


@functools.lru_cache(maxsize=None)
def pack_plan(Sq: int, G: int) -> Plan:
    """The packing of a launch with ``Sq`` positions and ``G`` query heads
    per kv head, chosen by measurement on the H100 (``tools/flash_bench.py
    --plans``): positions rounded up to 8 (the swizzle's 8-row atom), at
    most 64; as many heads of the group as fill at most half the 64 rows,
    a divisor of G so that the head blocks of a group are even (more rows
    lengthen a block's chain of Q loads more than they save in kv
    staging); tiles of 32 keys up to 32 positions (one tile holds the
    prompt), of 64 beyond (half the tiles, and the larger products)."""
    np_ = min(-(-Sq // 8) * 8, ROWS)
    nh = max(d for d in range(1, G + 1)
             if G % d == 0 and d * np_ <= ROWS // 2 or d == 1)
    return Plan(np=np_, nh=nh, kt=32 if Sq <= 32 else 64)


def active_in_group(j: int, G: int, Hkv: int, head_width) -> int:
    """Active query heads of kv group ``j`` (a prefix of the group): the
    rule of ``models.attention.head_mask``; None keeps every head."""
    if head_width is None:
        return G
    if G > 1:
        return max(0, min(G, head_width // Hkv))
    return 1 if j < head_width else 0


class Block(NamedTuple):
    b: int
    j: int        # kv head
    h0: int       # first head slot of the group
    q0: int       # first position
    npos: int     # positions in range
    nls: int      # live head slots
    lo: int       # first kv tile
    n: int        # kv tiles


def blocks(B: int, Hkv: int, G: int, Sq: int, Sk: int, plan: Plan, *,
           causal: bool = True, window: int = 0, kv_len=None,
           head_width=None) -> Iterator[Block]:
    """Every block of a launch in grid order, as the kernel decodes it
    (``decode``): the last position tiles first, then batch rows, kv heads
    and head blocks; its live head slots and its kv tile range (none
    without a live slot)."""
    n_hb, n_qb = -(-G // plan.nh), -(-Sq // plan.np)
    kvl = max(0, min(Sk if kv_len is None else kv_len, Sk))
    for idx in range(B * Hkv * n_hb * n_qb):
        h0 = idx % n_hb * plan.nh
        rest = idx // n_hb
        j, rest = rest % Hkv, rest // Hkv
        b = rest % B
        q0 = (n_qb - 1 - rest // B) * plan.np
        npos = min(plan.np, Sq - q0)
        nls = max(0, min(plan.nh,
                         active_in_group(j, G, Hkv, head_width) - h0))
        hi = min(kvl, q0 + npos) if causal else kvl
        lo = max(0, q0 - window + 1) // plan.kt if window > 0 else 0
        n = max(0, -(-hi // plan.kt) - lo) if nls > 0 else 0
        yield Block(b, j, h0, q0, npos, nls, lo, n)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------


def _check_rows(name: str, kernel: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is 16-byte aligned with contiguous rows whose
    strides keep every row 16-byte aligned (the kernel's TMA boxes)."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} needs contiguous, 16-byte "
                         f"aligned rows; got strides {t.stride()}")


def _device_int(name: str, value, device):
    """(pointer, static value) of an int argument: None, an int, or an
    int32 tensor of one element on ``device`` (read by the kernel)."""
    if isinstance(value, torch.Tensor):
        if value.device != device or value.dtype != torch.int32 \
                or value.numel() != 1:
            raise TypeError(f"{NAME}: {name} tensor must be one int32 on "
                            f"{device}")
        return value.data_ptr(), 0
    return None, int(value)


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    head_width=None):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d); bf16 CUDA tensors, d in
    ``HEAD_DIMS``.
    ``kv_len``: None (all of Sk), an int, or an int32 CUDA tensor with one
    element (read by the kernel). ``head_width``: None (every head), an
    int, or an int32 CUDA tensor with one element (read by the kernel):
    the active query heads, under GQA the first ``head_width // Hkv`` of
    every kv group, under MHA the first ``head_width``; the kernel computes
    only those and writes zeros for the rest. Returns (B, Hq, Sq, d)
    bf16."""
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
    if Sk == 0:
        raise ValueError(f"{NAME}: no keys (Sk = 0)")
    if isinstance(head_width, int) and head_width < 0:
        raise ValueError(f"{NAME}: head_width {head_width} < 0")
    o = _launch(q, k, v, causal, window,
                (None, Sk) if kv_len is None
                else _device_int("kv_len", kv_len, q.device),
                (None, -1) if head_width is None
                else _device_int("head_width", head_width, q.device),
                pack_plan(Sq, Hq // Hkv))
    compat.note_launch(NAME)
    return o


def _launch(q, k, v, causal, window, kv_len, head_width, plan: Plan):
    """One launch on checked inputs: ``kv_len`` and ``head_width`` as
    (pointer, static value) pairs (``_device_int``; a static head width of
    -1 keeps every head), the packing ``plan``."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    o = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device
                    ).transpose(1, 2)
    fn = build.function(_C, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, Hq, Hkv, Sq, Sk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(bool(causal)), int(window), *kv_len, *head_width, plan.word,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(NAME, err)
    return o
