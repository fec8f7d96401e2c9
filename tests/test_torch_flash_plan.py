"""The schedule of the port's ``flash_attention`` kernel, held to its spec
on the CPU. The kernel decodes its block index into a kv head, a run of
query heads of that group and a run of positions, and works out its live
heads and its kv tiles from data it reads; ``blocks`` is the same decoding
written in Python, and ``pack_plan`` the packing the wrapper picks. For
every case below:

- ``pack_plan`` fills a block's rows with whole 8-row atoms: its
  positions cover the prompt (up to 64), its heads divide the group and
  fill at most half the 64 rows, and no larger divisor would fit; a prompt
  of up to 32 positions takes one tile of 32 keys;
- every (batch row, query head, position) output row belongs to exactly
  one block;
- a row is live exactly when its head is active (``ref.head_active``, the
  rule of ``models.attention.head_mask``), and a block with no live row
  loads no kv tile;
- a block's kv tiles hold every key a live row of it attends to (causal,
  window, ``kv_len``), and its first and last tile each hold one;
- blocks with longer kv loops come first in the grid (no window).
"""
import itertools

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# (B, Hkv, G, Sq, window, kv_len, head_width)
CASES = [
    # qwen2-1.5b: 12 query heads over 2 kv heads, served and long prompts
    (8, 2, 6, 16, 0, None, None),
    (8, 2, 6, 16, 0, None, 6),
    (2, 2, 6, 256, 0, None, None),
    (2, 2, 6, 256, 0, None, 6),
    (1, 2, 6, 2048, 0, None, None),
    # ragged prompts, a window and a short kv_len (the card tests' cases)
    (2, 2, 6, 1, 0, None, None),
    (2, 2, 6, 63, 0, None, 6),
    (2, 2, 6, 65, 0, None, None),
    (2, 2, 6, 200, 64, 150, None),
    (2, 2, 6, 200, 64, 150, 6),
    # MHA (a global prefix of heads) and a tiny GQA config
    (2, 4, 1, 12, 0, None, 2),
    (2, 2, 2, 12, 8, None, 2),
    (1, 2, 2, 12, 0, 5, None),
    # head widths of 0 and past the heads
    (1, 2, 6, 40, 0, None, 0),
    (1, 2, 6, 40, 0, None, 24),
    (1, 2, 4, 130, 16, 100, 4),
]


def _needs(pos, kvl, causal, window):
    """The keys position ``pos`` attends to."""
    hi = min(kvl, pos + 1) if causal else kvl
    lo = max(0, pos - window + 1) if window > 0 else 0
    return range(lo, hi)


@pytest.mark.parametrize("Sq", [1, 7, 8, 16, 32, 33, 64, 65, 256, 2048])
@pytest.mark.parametrize("G", [1, 2, 4, 5, 6, 8])
def test_pack_plan_fills_a_block_with_whole_atoms(Sq, G):
    plan = fa.pack_plan(Sq, G)
    assert plan.np % 8 == 0 and plan.np >= 8
    assert plan.np == min(-(-Sq // 8) * 8, fa.ROWS)
    assert G % plan.nh == 0 and plan.nh * plan.np <= fa.ROWS
    if plan.nh > 1:
        assert plan.nh * plan.np <= fa.ROWS // 2
    bigger = [d for d in range(plan.nh + 1, G + 1)
              if G % d == 0 and d * plan.np <= fa.ROWS // 2]
    assert not bigger
    # one tile of 32 keys covers a short prompt; longer ones take 64
    assert plan.kt == (32 if Sq <= 32 else 64)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_blocks_cover_rows_once_and_live_rows_their_keys(case):
    B, Hkv, G, Sq, window, kv_len, head_width = case
    Hq, Sk = Hkv * G, Sq
    kvl = Sk if kv_len is None else kv_len
    plan = fa.pack_plan(Sq, G)
    active = ([True] * Hq if head_width is None
              else ref.head_active(Hq, Hkv, head_width, "cpu").tolist())
    owner = {}
    for blk in fa.blocks(B, Hkv, G, Sq, Sk, plan, causal=True,
                         window=window, kv_len=kv_len,
                         head_width=head_width):
        tiles = set(range(blk.lo, blk.lo + blk.n))
        needed = set()
        for slot, p in itertools.product(range(plan.nh), range(plan.np)):
            h, pos = blk.h0 + slot, blk.q0 + p
            if h >= G or pos >= Sq:
                continue
            row = (blk.b, blk.j * G + h, pos)
            assert row not in owner, row
            owner[row] = blk
            live = slot < blk.nls
            assert live == active[blk.j * G + h], (row, blk)
            if live:
                needed |= {key // plan.kt
                           for key in _needs(pos, kvl, True, window)}
        assert needed <= tiles, (blk, needed - tiles)
        if blk.nls == 0:
            assert blk.n == 0, blk
        if not needed:
            continue
        assert min(needed) == blk.lo and max(needed) == blk.lo + blk.n - 1
    assert len(owner) == B * Hq * Sq


@pytest.mark.parametrize("Sq", [16, 100, 256, 2048])
def test_longer_kv_loops_come_first(Sq):
    ns = [blk.n for blk in fa.blocks(2, 2, 6, Sq, Sq, fa.pack_plan(Sq, 6))]
    assert ns == sorted(ns, reverse=True)


def test_active_in_group_is_the_head_mask_rule():
    for Hq, Hkv in ((12, 2), (4, 2), (4, 4), (8, 1)):
        G = Hq // Hkv
        for hw in range(0, Hq + 2):
            mask = ref.head_active(Hq, Hkv, torch.tensor(hw), "cpu").tolist()
            for j in range(Hkv):
                a = fa.active_in_group(j, G, Hkv, hw)
                assert mask[j * G:(j + 1) * G] == [h < a for h in range(G)]
