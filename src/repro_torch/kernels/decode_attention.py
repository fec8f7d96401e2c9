"""Single-token GQA decode attention: the CUDA kernel, its wrapper, its
plain version and the Python mirror of the kernel's schedule.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py`` (``decode_attention`` at :67,
``_kernel`` at :25): one query token per row against a (B, Hkv, Smax, d)
cache, the G query heads of a kv head sharing one cache stream, positions
past ``index`` neither read nor computed (``window == 0``), the
rolling-buffer mask for ``window > 0``, ``index`` read from device memory.

What bounds it on the H100: bytes (4 * d bytes of K and V per live
position and kv head, against 4 * d FLOPs per live position and query
head); at the served caches the live cache is small and the time is one
block's chain of loads, products and stores after the launch.

What the design does about it: one launch, with the live range split on
the card. The grid is fixed here from static facts alone (B * Hkv rows
times ``grid_splits``, from the card's SM count); every block reads
``index`` and works out the live range (``live_range``), its chunk and the
number of live splits (``schedule``) and its own slice (``units``). Four
warps a block, each streaming its own 16-position units of K and V through
a ring of cp.async stages into tensor-core products (``mma.sync``). A row's
splits are one thread-block cluster: a row with one live split writes its
output from one block, otherwise the live blocks merge their fp32 partials
through distributed shared memory in split order (``split_merge`` is the
same arithmetic on the CPU). A call allocates its output and nothing else.
Each head dim of ``HEAD_DIMS`` runs the same body, compiled at that d, on a
head padded to 128 columns on the SM (zero columns past d add nothing and
are not stored); rows in device memory are d wide.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Iterator, List, NamedTuple, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

NAME = "decode_attention"
HEAD_DIMS = (64, 80, 120, 128)
G_MAX = 8
_C = "repro_decode_attention_bf16"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

WARPS = 4             # warps of a block
UNIT = 16             # cache positions a warp takes a ring stage
MAX_SPLIT = 16        # splits of a row: one thread-block cluster


def decode_attention_plain(q, k_cache, v_cache, index, *, window=0,
                           kv_block=256):
    """The plain PyTorch version (port of ``ref.decode_attention_ref``)."""
    return ref.decode_attention_ref(q, k_cache, v_cache, index,
                                    window=window, kv_block=kv_block)


# --------------------------------------------------------------------------
# the kernel's schedule, in Python (the tests hold it to its spec)
# --------------------------------------------------------------------------


class Plan(NamedTuple):
    """``min_chunk``: the least positions a split takes (a multiple of
    UNIT); ``stages``: the depth of each warp's ring (2 or 3); ``per_sm``:
    the blocks an SM the grid is sized for. The default was measured on
    the H100 (``tools/decode_bench.py --plans``)."""
    min_chunk: int = 64
    stages: int = 2
    per_sm: int = 1

    @property
    def word(self) -> int:
        """The kernel's part of the plan as its entry point takes it."""
        return self.min_chunk | self.stages << 16


PLAN = Plan()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_splits(rows: int, smax: int, sms: int, plan: Plan = PLAN) -> int:
    """Splits of each of the ``rows`` = B * Hkv rows in the grid, from
    static facts only: as many as keep the grid within ``plan.per_sm``
    blocks on each of the card's ``sms`` SMs (one wave: a block that waits
    for a second turn on an SM costs more than the splits it adds), no more
    than a cache of ``smax`` slots fills at ``plan.min_chunk`` positions a
    split, no more than a cluster holds (MAX_SPLIT), and at least 1."""
    want = plan.per_sm * sms // max(rows, 1)
    return max(1, min(want, -(-smax // plan.min_chunk), MAX_SPLIT))


def live_range(index: int, window: int, smax: int) -> Tuple[int, int]:
    """(start, length): the live positions are (start + j) % smax for j in
    [0, length): [0, index] with ``window == 0``, else the wrapped window
    of min(window, index + 1) slots ending at index."""
    n = min(window, index + 1) if window > 0 else index + 1
    n = max(0, min(n, smax))
    return ((index - n + 1) % smax if window > 0 else 0), n


def schedule(length: int, n_split: int, min_chunk: int) -> Tuple[int, int]:
    """(chunk, n_live): the positions a split takes (the live length over
    ``n_split``, rounded up to UNIT, at least ``min_chunk``) and the splits
    that hold any (at least 1: an empty range still writes its zeros)."""
    per = -(-length // n_split)
    chunk = max(min_chunk, -(-per // UNIT) * UNIT)
    return chunk, max(1, -(-length // chunk))


class Unit(NamedTuple):
    split: int
    warp: int
    stage: int            # the ring stage it lands in
    offsets: range        # logical offsets j (positions (start + j) % smax)


def units(length: int, n_split: int, plan: Plan = PLAN) -> Iterator[Unit]:
    """Every unit of a row's launch, as the kernel's blocks decode them:
    split s takes offsets [s * chunk, min(length, (s + 1) * chunk)), unit u
    of it (UNIT offsets) goes to warp u % WARPS, whose t-th unit lands in
    ring stage t % stages. Splits past the live ones yield nothing."""
    chunk, n_live = schedule(length, n_split, plan.min_chunk)
    for split in range(min(n_live, n_split)):
        c0 = split * chunk
        c1 = min(length, c0 + chunk)
        for u in range(-(-max(c1 - c0, 0) // UNIT)):
            j0 = c0 + u * UNIT
            yield Unit(split, u % WARPS, (u // WARPS) % plan.stages,
                       range(j0, min(j0 + UNIT, c1)))


def split_merge(q, k_cache, v_cache, index: int, *, window: int = 0,
                n_split: int, plan: Plan = PLAN):
    """The kernel's arithmetic in fp32 on the CPU, by the schedule above:
    each warp an online softmax over its units (scores in the log2
    domain), the warps of a block merged in warp order, a row's splits
    merged online in split order (or the single split written directly). q:
    (B, Hq, 1, d); caches: (B, Hkv, Smax, d). Returns (B, Hq, 1, d)
    fp32."""
    B, Hq, _, d = q.shape
    _, Hkv, smax, _ = k_cache.shape
    G = Hq // Hkv
    scale_log2 = d ** -0.5 * 1.4426950408889634
    start, length = live_range(index, window, smax)
    out = torch.zeros((B, Hkv, G, d), dtype=torch.float32)
    neg = torch.tensor(-1e30)

    def merge(states: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
        """A block's warps: the common max first, then the sums."""
        m = torch.stack([s[0] for s in states]).max(0).values
        f = [torch.exp2(s[0] - m) for s in states]
        den = sum(fi * s[1] for fi, s in zip(f, states))
        num = sum(fi[:, None] * s[2] for fi, s in zip(f, states))
        return m, den, num

    def merge_online(states):
        """A row's splits, online in split order, as the kernel's cluster
        does it."""
        m, den, num = neg.expand(G), torch.zeros(G), torch.zeros(G, d)
        for ms, ls, accs in states:
            mn = torch.maximum(m, ms)
            fo, fs = torch.exp2(m - mn), torch.exp2(ms - mn)
            m, den = mn, den * fo + ls * fs
            num = num * fo[:, None] + accs * fs[:, None]
        return m, den, num

    for b, h in itertools.product(range(B), range(Hkv)):
        qf = q[b, h * G:(h + 1) * G, 0].float()
        kf, vf = k_cache[b, h].float(), v_cache[b, h].float()
        warps = {}
        for u in units(length, n_split, plan):
            pos = torch.tensor([(start + j) % smax for j in u.offsets])
            s = (qf @ kf[pos].T) * scale_log2
            m, l, acc = warps.get((u.split, u.warp),
                                  (neg.expand(G), torch.zeros(G),
                                   torch.zeros(G, d)))
            m_new = torch.maximum(m, s.max(1).values)
            p = torch.exp2(s - m_new[:, None])
            corr = torch.exp2(m - m_new)
            warps[(u.split, u.warp)] = (m_new, l * corr + p.sum(1),
                                        acc * corr[:, None] + p @ vf[pos])
        n_live = schedule(length, n_split, plan.min_chunk)[1]
        empty = (neg.expand(G), torch.zeros(G), torch.zeros(G, d))
        blocks = [merge([warps.get((s, w), empty) for w in range(WARPS)])
                  for s in range(n_live)]
        _, den, num = blocks[0] if n_live == 1 else merge_online(blocks)
        out[b, h] = num / den.clamp_min(1e-30)[:, None]
    return out.reshape(B, Hq, 1, d)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _splits(rows: int, smax: int, device: torch.device, plan: Plan) -> int:
    return grid_splits(rows, smax, _sm_count(device), plan)


def decode_attention(q, k_cache, v_cache, index, *, window=0):
    """q: (B, Hq, 1, d); caches: (B, Hkv, Smax, d); bf16 contiguous CUDA
    tensors, d in ``HEAD_DIMS``, Hq / Hkv <= 8. ``index``: int32 CUDA
    tensor with one element (or an int, written to the device without a
    host sync).
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
    out = torch.empty_like(q)
    build.check(NAME, _launch(q, k_cache, v_cache, index, out, window, PLAN))
    compat.note_launch(NAME)
    return out


def _launch(q, k_cache, v_cache, index, out, window, plan: Plan) -> int:
    """One launch on checked inputs with ``plan``; its CUDA error code (0:
    launched)."""
    B, Hq, _, d = q.shape
    _, Hkv, Smax, _ = k_cache.shape
    return build.function(_C, _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        index.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, Smax, d,
        int(window), _splits(B * Hkv, Smax, q.device, plan), plan.word,
        torch.cuda.current_stream(q.device).cuda_stream)
