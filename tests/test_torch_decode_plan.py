"""The schedule of the port's ``decode_attention`` kernel, held to its spec
on the CPU. The grid is B * Hkv rows times ``grid_splits`` blocks, fixed
from static facts; every block reads ``index`` and works out the live range
(``live_range``), the chunk and the live splits (``schedule``) and its own
units (``units``): the same decoding the kernel does, written in Python.
For every case below:

- every live position (``ref._decode_mask``, the plain version's mask)
  belongs to exactly one unit of one block, and no unit reaches past
  ``index`` or outside the wrapped window;
- the grid (a cluster of at most MAX_SPLIT blocks a row) holds every live
  split, and blocks past the live splits read nothing;
- a row's blocks merge through their cluster exactly when it has more
  than one live split, and the served decode (B = 8, two kv heads, caches
  of 16 to 64 slots) has one, so one block writes each row.

Then ``split_merge``, the kernel's arithmetic in fp32 by that schedule
(warps, then splits, merged in order), against the JAX package's Pallas
kernel in interpret mode and its dense oracle, at the fp32 tolerance of
tests/test_kernels.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ref

PLANS = [da.PLAN] + [da.Plan(c, s, p) for c in (16, 32, 128)
                     for s in (2, 3) for p in (1, 2)]


def _index_classes(smax):
    return sorted({0, 3, smax // 2, smax - 1})


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("smax", [16, 32, 96, 256, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 2, 16, 128])
def test_units_cover_the_live_range_once(rows, smax, sms):
    for plan, index, window in itertools.product(
            PLANS, _index_classes(smax), (0, 64)):
        n_split = da.grid_splits(rows, smax, sms, plan)
        assert 1 <= n_split <= min(-(-smax // plan.min_chunk), da.MAX_SPLIT)
        start, length = da.live_range(index, window, smax)
        live = ref._decode_mask(index, smax, window, "cpu")
        assert length == int(live.sum())
        chunk, n_live = da.schedule(length, n_split, plan.min_chunk)
        assert chunk % da.UNIT == 0 and chunk >= plan.min_chunk
        assert 1 <= n_live <= n_split            # the grid holds them
        seen = torch.zeros(smax, dtype=torch.int64)
        splits = set()
        for u in da.units(length, n_split, plan):
            assert u.split < n_live and 0 <= u.warp < da.WARPS
            assert 0 <= u.stage < plan.stages
            assert 0 < len(u.offsets) <= da.UNIT
            assert u.split * chunk <= u.offsets[0]
            assert u.offsets[-1] < min(length, (u.split + 1) * chunk)
            for j in u.offsets:
                seen[(start + j) % smax] += 1
            splits.add(u.split)
        # each live position once, nothing outside the mask
        assert torch.equal(seen, live.to(torch.int64))
        # blocks past the live splits read nothing; live ones all do
        assert splits == (set(range(n_live)) if length else set())


@pytest.mark.parametrize("rows", [1, 2, 16, 128])
def test_one_live_split_merges_nothing(rows):
    """A live range no longer than the least chunk has one live split:
    only split 0 of the row has units, so its block writes the output and
    the row's cluster never merges."""
    for sms, smax, plan in itertools.product((114, 132), (16, 32, 96, 256),
                                             PLANS):
        n_split = da.grid_splits(rows, smax, sms, plan)
        for index, window in itertools.product(_index_classes(smax), (0, 64)):
            _, length = da.live_range(index, window, smax)
            n_live = da.schedule(length, n_split, plan.min_chunk)[1]
            splits = {u.split for u in da.units(length, n_split, plan)}
            assert (n_live > 1) == (len(splits) > 1)
            if length <= plan.min_chunk:
                assert n_live == 1 and splits <= {0}
    # the served decode: B = 8 over two kv heads, caches of 16 to 64 slots
    for smax in (16, 32, 64):
        n_split = da.grid_splits(16, smax, 132)
        for index in range(smax):
            _, length = da.live_range(index, 0, smax)
            assert da.schedule(length, n_split, da.PLAN.min_chunk)[1] == 1


def test_grid_fills_the_card_from_static_facts():
    """One wave of about ``per_sm`` blocks an SM when the cache is long
    enough and a row's cluster can hold them, and the live splits of a full
    cache reach the grid's."""
    for sms, rows, plan in itertools.product((114, 132), (1, 2, 16, 128),
                                             PLANS):
        n_split = da.grid_splits(rows, 4096, sms, plan)
        assert rows * n_split <= plan.per_sm * sms or n_split == 1
        assert rows * (n_split + 1) > plan.per_sm * sms \
            or n_split == da.MAX_SPLIT
    assert da.grid_splits(16, 2048, 132) == 8
    assert da.schedule(2048, 8, 64) == (256, 8)
    assert da.schedule(1024, 8, 64) == (128, 8)
    assert da.grid_splits(16, 256, 132) == 4
    assert da.schedule(256, 4, 64) == (64, 4)
    assert da.grid_splits(2, 16384, 132) == da.MAX_SPLIT
    assert da.grid_splits(256, 2048, 132) == 1


def _pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("plan", [da.PLAN, da.Plan(16, 3), da.Plan(32, 2)],
                         ids=lambda p: f"{p.min_chunk}-{p.stages}")
@pytest.mark.parametrize("B,Hq,Hkv,Smax,n_split", [
    (1, 4, 2, 96, 3),       # three splits of 32 at a full cache
    (2, 6, 1, 64, 1),       # one split: written directly
    (1, 8, 1, 128, 8),      # more splits than the least chunk allows
])
def test_split_merge_matches_jax(B, Hq, Hkv, Smax, n_split, plan):
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng, (B, Hq, 1, 32))
    jk, tk = _pair(rng, (B, Hkv, Smax, 32))
    jv, tv = _pair(rng, (B, Hkv, Smax, 32))
    for idx in (0, 3, Smax // 2, Smax - 1):
        for window in (0, 16):
            got = da.split_merge(tq, tk, tv, idx, window=window,
                                 n_split=n_split, plan=plan)
            want_d = jref.decode_attention_dense_ref(jq, jk, jv, idx,
                                                     window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_d),
                                       rtol=2e-3, atol=2e-3)
            if plan == da.PLAN:
                want_k = jops.decode_attention(jq, jk, jv, jnp.int32(idx),
                                               window=window, kv_block=32,
                                               tier="interpret")
                np.testing.assert_allclose(got.numpy(), np.asarray(want_k),
                                           rtol=2e-3, atol=2e-3)
