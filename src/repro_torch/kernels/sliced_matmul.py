"""WeightSlice matmul: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/sliced_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/sliced_matmul.py`` (``sliced_matmul``, ``_kernel``) and its
GPU-Pallas twin in ``repro/kernels/triton_kernels.py``:
``y = x[:, :active_in] @ w[:active_in, :active_out]`` with zeros past
``active_out``, bf16 in, fp32 accumulation, bf16 out. The widths are data:
ints, or int32 CUDA tensors of one element that the kernel reads from
device memory, so one launch serves every subnet.

``segments`` cuts K into equal segments, each with its own active prefix
of ``active_in`` (the GQA output projection, one segment per KV head).

What bounds it on the H100: the bytes of the active weight block at the
serving shapes (M <= 128 rows against the 1536 x 8960 FFN weights), the
tensor cores' operations at M = 2048 and beyond. The TPU kernel walks K
on a sequential grid axis into an accumulator; here the grid is one block
per SM, a static fact, and every block works out its share of the live
work on the card, from the widths it reads: the live output tiles times
the live K tiles of every segment, each tile cut into ``splits`` K ranges
so that the busiest block has the fewest K steps, counting each split's
fp32 partial as SPLIT_COST steps (as measured on the H100); a narrow
subnet, with fewer live tiles, takes more splits. A tile of one split is
written in bf16 directly; the splits of a tile write fp32 partials to a
workspace, and the last block to arrive on the tile (an integer counter
per tile) sums them in split order and writes bf16: no float atomics, so
the bits repeat from launch to launch. :func:`split_plan` is that
schedule written once in Python, the spec the CPU tests hold it to; the
wrapper does not call it (nothing on the host depends on a width). The
main loop is a TMA ring filled by one producer warp and drained by
``wgmma`` warpgroups (``csrc/sliced_matmul.cu`` has the design).

The wrapper takes 2-d operands with any row stride that keeps rows 16-byte
aligned, so per-group views need no copy; ``x`` of more dimensions is
flattened to rows. Given a stack of experts, ``w`` of shape (E, K, N) and
``x`` of shape (E, M, K), it computes every ``x[e] @ w[e]`` with the same
widths in one launch (MoE switch mode): the plan's live tiles are then
(expert, row tile, column tile), expert-major, E times as many.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _sm_count
from repro_torch.kernels.ref import acc

NAME = "sliced_matmul"
# the launch count of the form over a stack of experts
GROUPED = "sliced_matmul.experts"
_C = "repro_sliced_matmul_bf16"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p, ctypes.c_longlong] * 2
             + [ctypes.c_int, ctypes.c_void_p])
_C_WORKSPACE = "repro_sliced_matmul_workspace"
_WORKSPACE_ARGTYPES = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_longlong)]

# the kernel's plan, mirrored by split_plan (csrc/sliced_matmul.cu): BN
# output columns and BK deep K steps per block tile, block_rows(M) output
# rows; CTAS_PER_SM blocks of the grid per SM; at most WORKSPACE_TILES fp32
# partials per block; a split's partial costs about SPLIT_COST K steps.
# The scratch a launch needs is the kernel's to say (_workspace_size).
BN = 128
BK = 64
CTAS_PER_SM = 1
WORKSPACE_TILES = 1
SPLIT_COST = 4


def block_rows(M: int) -> int:
    """Output rows of one block tile for an M-row product: one warpgroup's
    64 up to M = 128 (where the weight bytes bound the product, and 64-row
    tiles double the output tiles that share the K steps), two
    warpgroups' 128 beyond."""
    return 64 if M <= 128 else 128


def sliced_matmul_plain(x, w, active_in, active_out, *, segments: int = 1):
    """The plain PyTorch version. x: (..., K) with w: (K, N), or x: (E, M,
    K) with a stack w: (E, K, N); widths None (the full width), ints or 0-d
    integer tensors (used as data). Channel k of x counts when ``k % (K //
    segments) < active_in``; output columns at or past ``active_out`` are
    0. fp32 accumulation (fp64 for fp64), output in x's dtype."""
    K, N = w.shape[-2:]
    if active_in is not None:
        keep = (torch.arange(K, device=x.device) % (K // segments)) < active_in
        x = x * keep.to(x.dtype)
    y = acc(x) @ acc(w)
    if active_out is not None:
        y = y * (torch.arange(N, device=x.device) < active_out).to(y.dtype)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# the schedule (mirror of the kernel's plan; a spec, not on the path)
# --------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_splits(live_tiles: int, k_tiles: int, grid: int) -> int:
    """K splits per live tile: the S that minimises the K steps of the
    busiest block, ``ceil(L * S / grid) * ceil(T / S)``, plus
    ``SPLIT_COST * S`` for the fp32 partials of a split tile (each written
    and read back at a cost the H100 measured at about SPLIT_COST K steps);
    the smallest S of equal cost. The workspace bounds S:
    ``L * S <= WORKSPACE_TILES * grid``."""
    if live_tiles == 0 or k_tiles == 0:
        return 1
    best, best_s = _cdiv(live_tiles, grid) * k_tiles, 1
    top = min(k_tiles, WORKSPACE_TILES * grid // live_tiles)
    for s in range(2, top + 1):
        cost = (_cdiv(live_tiles * s, grid) * _cdiv(k_tiles, s)
                + SPLIT_COST * s)
        if cost < best:
            best, best_s = cost, s
    return best_s


@dataclass(frozen=True)
class SplitPlan:
    """The kernel's division of one product among ``grid`` blocks.

    Live tile t has ``splits + 1`` K splits for t < ``extra`` and
    ``splits`` after: when the plan fits in one round (L * S < grid), the
    spare blocks each take one more split of a tile. Unit u, a (tile,
    split) pair numbered tile by tile, goes to block u mod grid and owns
    workspace slot u; the splits of a tile are summed in split order."""
    grid: int
    bm: int               # rows of a block tile: block_rows(M)
    experts: int          # E: products of the stack, 1 for a 2-d one
    m_tiles: int
    n_tiles: int
    live_n_tiles: int     # column tiles that start below active_out
    k_tiles: int          # live K tiles, all segments: T
    k_tiles_per_seg: int
    splits: int           # S
    extra: int            # tiles with S + 1 splits
    seg: int
    active_in: int

    @property
    def live_tiles(self) -> int:
        return self.experts * self.m_tiles * self.live_n_tiles

    @property
    def units(self) -> int:
        return self.live_tiles * self.splits + self.extra

    @property
    def dead_tiles(self) -> int:
        return self.experts * self.m_tiles * (self.n_tiles - self.live_n_tiles)

    def tile(self, t: int) -> Tuple[int, int, int]:
        """(expert, m tile, n tile) of live tile t; rows vary fastest, so
        the blocks of one weight column tile run side by side, then
        columns, then experts."""
        e, r = divmod(t, self.m_tiles * self.live_n_tiles)
        return e, r % self.m_tiles, r // self.m_tiles

    def unit(self, u: int) -> Tuple[int, int, int]:
        """(live tile, split, splits of that tile) of unit u."""
        S, e = self.splits, self.extra
        if u < e * (S + 1):
            return u // (S + 1), u % (S + 1), S + 1
        v = u - e * (S + 1)
        return e + v // S, v % S, S

    def first_slot(self, t: int) -> int:
        """Workspace slot (= unit) of split 0 of live tile t."""
        S, e = self.splits, self.extra
        return t * (S + 1) if t < e else e * (S + 1) + (t - e) * S

    def k_range(self, split: int, n: int) -> Tuple[int, int]:
        """[j0, j1): the live K tiles of split ``split`` of ``n``, in
        segment order."""
        T = self.k_tiles
        return split * T // n, (split + 1) * T // n

    def k_row(self, j: int) -> Tuple[int, int]:
        """(first row of w, live rows) of live K tile j."""
        s, i = divmod(j, self.k_tiles_per_seg)
        kb = i * BK
        return s * self.seg + kb, min(BK, self.active_in - kb)

    def units_of(self, cta: int) -> Iterator[Tuple[int, int, int]]:
        """(tile, split, splits) of each unit block ``cta`` computes, in
        order."""
        for u in range(cta, self.units, self.grid):
            yield self.unit(u)

    def dead_of(self, cta: int) -> Iterator[Tuple[int, int, int]]:
        """(expert, m tile, n tile) of each dead tile block ``cta``
        zero-writes."""
        per = self.m_tiles * (self.n_tiles - self.live_n_tiles)
        for d in range(cta, self.dead_tiles, self.grid):
            e, r = divmod(d, per)
            yield e, r % self.m_tiles, self.live_n_tiles + r // self.m_tiles


def split_plan(M: int, N: int, K: int, segments: int, active_in, active_out,
               grid: int, experts: int = 1) -> SplitPlan:
    """The schedule the kernel computes on the card, from the shapes (M, N
    and K of each of ``experts`` products), the widths (None: full) and
    the grid size alone."""
    seg = K // segments
    ai = seg if active_in is None else min(max(int(active_in), 0), seg)
    ao = N if active_out is None else min(max(int(active_out), 0), N)
    bm = block_rows(M)
    kl = _cdiv(ai, BK)
    T = kl * segments
    nl = _cdiv(ao, BN) if T else 0
    mt = _cdiv(M, bm)
    L = experts * mt * nl
    S = choose_splits(L, T, grid)
    extra = min(L, grid - L * S) if L * S < grid and S < T else 0
    return SplitPlan(grid=grid, bm=bm, experts=experts, m_tiles=mt,
                     n_tiles=_cdiv(N, BN), live_n_tiles=nl, k_tiles=T,
                     k_tiles_per_seg=kl, splits=S, extra=extra, seg=seg,
                     active_in=ai)


def grid_size(device: torch.device) -> int:
    """Blocks of every launch on ``device``: a static fact of the card."""
    return CTAS_PER_SM * _sm_count(device)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

_scratch_lock = threading.Lock()
_scratch = {}


@functools.lru_cache(maxsize=256)
def _workspace_size(M: int, grid: int) -> Tuple[int, int]:
    """(fp32 elements, int32 counters) of the scratch of an M-row launch on
    ``grid`` blocks, as the kernel's own source decides them. A stack of
    experts needs no more: the plan splits tiles only while all experts'
    units fit the same bound."""
    elems, counters = ctypes.c_longlong(), ctypes.c_longlong()
    build.check(NAME, build.function(_C_WORKSPACE, _WORKSPACE_ARGTYPES)(
        M, grid, ctypes.byref(elems), ctypes.byref(counters)))
    return elems.value, counters.value


def _scratch_for(device: torch.device, stream: int, M: int, grid: int):
    """(workspace, counters) of launches on one stream, at least the size
    the kernel asks for; the counters are zero between launches because
    the last block on a tile resets its own. Sized from static facts only
    and grown, never shrunk; launches on one stream run in order, so they
    may share them."""
    elems, n_counters = _workspace_size(M, grid)
    key = (device, stream)
    with _scratch_lock:
        got = _scratch.get(key)
        if got is None or got[0].numel() < elems \
                or got[1].numel() < n_counters:
            if got is not None:
                elems = max(elems, got[0].numel())
                n_counters = max(n_counters, got[1].numel())
            got = (torch.empty(elems, dtype=torch.float32, device=device),
                   torch.zeros(n_counters, dtype=torch.int32, device=device))
            _scratch[key] = got
        return got


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
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{NAME}: {name} needs contiguous, 16-byte aligned "
                         f"rows; got strides {t.stride()}")


def sliced_matmul(x, w, active_in, active_out, *, segments: int = 1):
    """x: (..., K) or a strided (M, K) view with w: (K, N), or x: (E, M, K)
    with a stack w: (E, K, N); bf16 CUDA tensors. Returns (..., N), or
    (E, M, N), bf16 (see :func:`sliced_matmul_plain`)."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{NAME}: {name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: {name} must be bfloat16, got {t.dtype}")
    stack = w.dim() == 3
    if w.dim() not in (2, 3) or x.shape[-1] != w.shape[-2] or (
            stack and (x.dim() != 3 or x.shape[0] != w.shape[0])):
        raise ValueError(f"{NAME}: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    K, N = w.shape[-2:]
    if segments < 1 or K % segments or (K // segments) % 8 or N % 8:
        raise ValueError(f"{NAME}: K={K} in {segments} segments and N={N} "
                         f"must be multiples of 8")
    lead = x.shape[:-1]
    x2 = x if x.dim() == 2 or stack else x.reshape(-1, K)
    _check_rows("x", x2)
    _check_rows("w", w)
    M = x2.shape[-2]
    y = torch.empty(x2.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.reshape(*lead, N)
    ai_ptr, ai = _width("active_in", active_in, K // segments, x.device)
    ao_ptr, ao = _width("active_out", active_out, N, x.device)
    grid = grid_size(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, counters = _scratch_for(x.device, stream, M, grid)
    build.check(NAME, _launch(x2, w, y, segments, ai_ptr, ai, ao_ptr, ao,
                              part, counters, grid, stream))
    compat.note_launch(GROUPED if stack else NAME)
    return y.reshape(*lead, N)


def _launch(x2, w, y, segments, ai_ptr, ai, ao_ptr, ao, part, counters,
            grid, stream) -> int:
    """One launch of the C entry point on 2-d operands or a stack of
    experts (3-d); its CUDA error code (0: launched). The kernel refuses
    scratch smaller than it needs."""
    E = x2.shape[0] if x2.dim() == 3 else 1
    M, K = x2.shape[-2:]
    N = w.shape[-1]

    def strides(t):
        """(row stride, matrix stride) in elements."""
        rs = t.stride(-2)
        return rs, (t.stride(0) if t.dim() == 3 else t.shape[-2] * rs)

    (xs, xes), (ws, wes), (ys, yes) = strides(x2), strides(w), strides(y)
    return build.function(_C, _ARGTYPES)(
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), E, M, N, K, segments,
        xs, ws, ys, xes, wes, yes, ai_ptr, ai, ao_ptr, ao,
        part.data_ptr(), part.numel(), counters.data_ptr(), counters.numel(),
        grid, stream)
