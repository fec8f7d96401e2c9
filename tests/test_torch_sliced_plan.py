"""The schedule of the port's ``sliced_matmul`` kernel, held to its spec on
the CPU. The kernel works out its share of the live work on the card from
the widths it reads; ``split_plan`` is the same plan written in Python.
For every (M, N, K, segments, active_in, active_out, grid) below:

- every live (row tile, column tile, K tile) is computed exactly once;
- every dead output tile is zero-written exactly once, and no tile is
  both live and dead;
- the splits of a tile cover its live K tiles in order, split 0 first,
  and own consecutive workspace slots, so the sums run in a fixed order;
- the number of splits is the cheapest the cost model allows, and a plan
  of one round leaves no block idle that one more split of a tile could
  use;
- the units fit the kernel's workspace (at most WORKSPACE_TILES fp32
  partials per block) and the split tiles its counters (one per block);
- the plan is a pure function of its arguments;
- over a stack of E experts (MoE switch mode) all of this holds for every
  expert's tiles, a stack of one is the 2-d plan, and once E times the
  live tiles fill the grid no tile is split.
"""
import numpy as np
import pytest

from repro_torch.kernels import sliced_matmul as sm

# (M, N, K, segments, active_in, active_out, grid)
CASES = [
    # qwen2-1.5b FFN up / gate, full and cut widths, prefill and decode
    (128, 8960, 1536, 1, None, None, 132),
    (128, 8960, 1536, 1, None, 4480, 132),
    (8, 8960, 1536, 1, None, 6656, 132),
    (2048, 8960, 1536, 1, None, None, 132),
    # FFN down (N = 1536): few column tiles, long K
    (128, 1536, 8960, 1, None, None, 132),
    (8, 1536, 8960, 1, 4480, None, 132),
    (2048, 1536, 8960, 1, 6656, None, 396),
    # the GQA output projection: 2 segments of 768, 3 or 6 heads of 128
    (128, 1536, 1536, 2, 384, None, 132),
    (8, 1536, 1536, 2, 768, None, 396),
    # widths of 0 and of 1, and the full width given as a number
    (16, 8960, 1536, 1, 0, None, 132),
    (16, 8960, 1536, 1, None, 0, 132),
    (16, 1536, 8960, 1, 1, 1, 132),
    (16, 1536, 8960, 1, 8960, 1536, 132),
    # partial tiles of the card tests: rows past M, a ragged K and N
    (65, 136, 264, 1, 9, 1, 132),
    (7, 192, 256, 1, 200, 100, 132),
    (3, 64, 64, 1, 0, 64, 132),
    (5, 256, 128, 1, 128, 0, 132),
    (129, 8960, 1536, 1, 1000, 4000, 132),
    # many segments, each split among blocks
    (16, 128, 8192, 4, 1000, None, 132),
    (1, 128, 8192, 4, 2048, None, 396),
    # a small card and a large grid
    (64, 1536, 8960, 1, None, None, 8),
    (1, 64, 64, 1, None, None, 528),
    # the executor's largest bucket (64 x 256 rows), 128-row tiles
    (16384, 8960, 1536, 1, None, 4480, 132),
    (16384, 1536, 8960, 1, 4480, None, 132),
    (256, 1536, 1536, 2, 384, None, 132),
    # one row past a 128-row tile, on the largest grid
    (129, 1536, 8960, 1, 8960, 1536, 528),
]
# stacks of experts, (..., grid, E): mixtral's experts (E = 8, d = 4096,
# f = 14336) at a decode step (C = 8) and a prefill of 8 x 16 tokens
# (C = 40), up and down at the half width; llama4's (E = 128, d = 5120,
# f = 8192) at C = 8; few live tiles (splits); dead tiles only; segments
GROUPED_CASES = [
    (8, 14336, 4096, 1, None, 7168, 132, 8),
    (8, 4096, 14336, 1, 7168, None, 132, 8),
    (40, 14336, 4096, 1, None, 14336, 132, 8),
    (40, 4096, 14336, 1, 10752, None, 132, 8),
    (8, 8192, 5120, 1, None, 4096, 132, 128),
    (8, 5120, 8192, 1, 4096, None, 132, 128),
    (7, 136, 264, 1, 9, 1, 132, 3),
    (65, 256, 128, 1, 128, 0, 132, 2),
    (130, 256, 512, 2, 100, 130, 132, 4),
]


def _ids(case):
    ids = "M{}-N{}-K{}-seg{}-ai{}-ao{}-grid{}".format(*case[:7])
    return ids + "".join(f"-E{e}" for e in case[7:])


def _walk(plan):
    """Marks of every (expert, row tile, column tile, K tile) computed, of
    every dead tile zero-written, and the (tile, split) -> (unit, splits,
    j0, j1) of each unit."""
    cover = np.zeros((plan.experts, plan.m_tiles, plan.live_n_tiles,
                      plan.k_tiles), int)
    dead = np.zeros((plan.experts, plan.m_tiles, plan.n_tiles), int)
    units = {}
    for cta in range(plan.grid):
        for u, (t, s, n) in zip(range(cta, plan.units, plan.grid),
                                plan.units_of(cta)):
            e, m, c = plan.tile(t)
            j0, j1 = plan.k_range(s, n)
            cover[e, m, c, j0:j1] += 1
            units[(t, s)] = (u, n, j0, j1)
        for e, m, c in plan.dead_of(cta):
            dead[e, m, c] += 1
    return cover, dead, units


@pytest.mark.parametrize("case", CASES + GROUPED_CASES, ids=_ids)
def test_split_plan_covers_live_work_once(case):
    M, N, K, nseg, ai, ao, grid = case[:7]
    plan = sm.split_plan(*case)
    cover, dead, _ = _walk(plan)
    seg = K // nseg
    ai_ = seg if ai is None else min(ai, seg)
    ao_ = N if ao is None else min(ao, N)
    live_cols = -(-ao_ // sm.BN) if ai_ else 0
    assert plan.bm == sm.block_rows(M)
    assert plan.m_tiles == -(-M // plan.bm)
    assert plan.live_n_tiles == live_cols
    assert plan.k_tiles == nseg * -(-ai_ // sm.BK)
    assert (cover == 1).all()
    # dead tiles: exactly the column tiles from live_n_tiles on, once each
    assert (dead[..., :live_cols] == 0).all()
    assert (dead[..., live_cols:] == 1).all()
    # each live K tile's rows lie in its segment, below active_in
    for j in range(plan.k_tiles):
        row, rows = plan.k_row(j)
        s = j // plan.k_tiles_per_seg
        assert rows >= 1 and s * seg <= row and row + rows <= s * seg + ai_


@pytest.mark.parametrize("case", CASES + GROUPED_CASES, ids=_ids)
def test_split_plan_sums_splits_in_order(case):
    plan = sm.split_plan(*case)
    _, _, units = _walk(plan)
    for t in range(plan.live_tiles):
        n = units[(t, 0)][1]
        assert n in (plan.splits, plan.splits + 1)
        assert (n == plan.splits + 1) == (t < plan.extra)
        end = 0
        for s in range(n):
            u, n_s, j0, j1 = units[(t, s)]
            assert n_s == n and j0 == end and j1 > j0
            assert u == plan.first_slot(t) + s      # slots in split order
            end = j1
        assert end == plan.k_tiles
    assert len(units) == plan.units


@pytest.mark.parametrize("case", CASES + GROUPED_CASES, ids=_ids)
def test_split_plan_is_a_pure_function(case):
    a = sm.split_plan(*case)
    b = sm.split_plan(*case)
    assert a == b
    assert [list(a.units_of(c)) for c in range(a.grid)] == \
        [list(b.units_of(c)) for c in range(b.grid)]
    # a width given as None is the full width given as a number
    M, N, K, nseg, ai, ao, grid = case[:7]
    full = sm.split_plan(M, N, K, nseg, K // nseg if ai is None else ai,
                         N if ao is None else ao, grid, *case[7:])
    assert full == a


@pytest.mark.parametrize("case", CASES + GROUPED_CASES, ids=_ids)
def test_split_plan_fits_its_scratch_and_grid(case):
    plan = sm.split_plan(*case)
    grid = plan.grid
    if plan.splits > 1 or plan.extra > 0:
        # one fp32 slot per unit, one counter per live tile
        assert plan.units <= sm.WORKSPACE_TILES * grid
        assert plan.live_tiles <= grid
    L, S, T = plan.live_tiles, plan.splits, plan.k_tiles
    if L and L * S < grid and S < T:
        assert plan.units == min(grid, L * (S + 1))
    # the chosen S costs least among all the workspace allows
    if L and T:
        def cost(s):
            return (-(-L * s // grid)) * (-(-T // s)) + \
                (sm.SPLIT_COST * s if s > 1 else 0)
        top = max(1, min(T, sm.WORKSPACE_TILES * grid // L))
        assert cost(S) == min(cost(s) for s in range(1, top + 1))
        assert all(cost(s) > cost(S) for s in range(1, S))


def test_narrow_subnets_take_more_splits():
    """Half the FFN columns dead: the live tiles take more K splits, so
    the busiest block's K steps fall with the width."""
    def steps(plan):
        return max(sum(j1 - j0 for j0, j1 in
                       (plan.k_range(s, n) for _, s, n in plan.units_of(c)))
                   for c in range(plan.grid))
    for M in (8, 128):
        full = sm.split_plan(M, 8960, 1536, 1, None, None, 132)
        half = sm.split_plan(M, 8960, 1536, 1, None, 4480, 132)
        assert half.splits + (half.extra > 0) > full.splits
        assert steps(half) < steps(full)


def test_block_rows_follow_m():
    assert [sm.block_rows(M) for M in (1, 64, 128, 129, 2048)] == \
        [64, 64, 64, 128, 128]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stack_of_one_is_the_2d_plan(case):
    """A 2-d product is a stack of one expert: the same plan, unit by
    unit, every tile in expert 0."""
    flat, one = sm.split_plan(*case), sm.split_plan(*case, experts=1)
    assert flat == one and flat.experts == 1
    assert all(flat.tile(t)[0] == 0 for t in range(flat.live_tiles))


@pytest.mark.parametrize("case", GROUPED_CASES, ids=_ids)
def test_stack_splits_no_tile_once_experts_fill_the_grid(case):
    """E times the live tiles of one expert: at or past the grid, each
    block takes whole tiles, no K split and no partial in the scratch;
    below it, the same plan as E times the live tiles in one product."""
    plan = sm.split_plan(*case)
    E = case[7]
    assert plan.live_tiles == E * plan.m_tiles * plan.live_n_tiles
    if plan.live_tiles >= plan.grid:
        assert plan.splits == 1 and plan.extra == 0
        assert plan.units == plan.live_tiles
    # the experts' tiles run expert-major, rows fastest
    per = plan.m_tiles * plan.live_n_tiles
    assert [plan.tile(t) for t in range(min(plan.live_tiles, 2 * per))] == [
        (t // per, t % per % plan.m_tiles, t % per // plan.m_tiles)
        for t in range(min(plan.live_tiles, 2 * per))]


def test_mixtral_and_llama4_stacks_split_nothing():
    """At the served expert shapes every product fills the grid with
    whole tiles: mixtral's up and down at decode and at prefill, llama4's
    at decode, at every width option."""
    for E, d, f, C in ((8, 4096, 14336, 8), (8, 4096, 14336, 40),
                       (128, 5120, 8192, 8)):
        for w in (f // 2, 3 * f // 4, f):
            up = sm.split_plan(C, f, d, 1, None, w, 132, E)
            down = sm.split_plan(C, d, f, 1, w, None, 132, E)
            assert up.splits == down.splits == 1
            assert up.extra == down.extra == 0
