"""The frozen trace generators against the program's, and the seeded
arrivals a cell runs."""
import numpy as np
import pytest

from repro_torch.serving import traces
from superbench.traffic import bursty
from superbench import tiny


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_frozen_copy_draws_the_programs_arrivals(seed):
    for args in ((300.0, 1200.0, 4.0, 3.0), (20.0, 80.0, 8.0, 5.0),
                 (0.0, 50.0, 1.0, 2.0)):
        np.testing.assert_array_equal(bursty.bursty_trace(*args, seed=seed),
                                      traces.bursty_trace(*args, seed=seed))


def test_every_seed_offers_the_same_gaps_in_another_order():
    params = tiny.cell()["trace"]
    a = bursty.arrivals(params, 500.0, 4.0, seed=1, stream=1)
    b = bursty.arrivals(params, 500.0, 4.0, seed=2**31 + 3, stream=1)
    again = bursty.arrivals(params, 500.0, 4.0, seed=1, stream=1)
    np.testing.assert_array_equal(a, again)
    assert len(a) == len(b) and not np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 4.0 and b.max() < 4.0
    # the rate holds: 500 q/s over 4 s, within the variant's burstiness
    assert 0.8 * 2000 < len(a) < 1.2 * 2000
    # the variant stream alone: the same gaps, shuffled
    var = dict(params, base_share=0.0)
    va = bursty.arrivals(var, 500.0, 4.0, seed=1, stream=1)
    vb = bursty.arrivals(var, 500.0, 4.0, seed=9, stream=1)
    np.testing.assert_allclose(np.sort(np.diff(va, prepend=0)),
                               np.sort(np.diff(vb, prepend=0)),
                               rtol=0, atol=1e-9)


def test_lead_in_and_window_draw_different_gaps():
    params = tiny.cell()["trace"]
    lead = bursty.arrivals(params, 500.0, 2.0, seed=5, stream=0)
    win = bursty.arrivals(params, 500.0, 2.0, seed=5, stream=1)
    assert not np.array_equal(lead, win)


def test_a_block_shuffle_offers_every_seed_the_same_stretches():
    params = dict(tiny.cell()["trace"], block_s=0.5)
    a = bursty.arrivals(params, 500.0, 4.2, seed=1, stream=1)
    b = bursty.arrivals(params, 500.0, 4.2, seed=2**31 + 3, stream=1)
    np.testing.assert_array_equal(
        a, bursty.arrivals(params, 500.0, 4.2, seed=1, stream=1))
    assert len(a) == len(b) and not np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 4.2 and b.max() < 4.2

    def stretches(t):
        # each whole stretch's arrivals, offset from its start; the last
        # 0.2 s, shorter than a stretch, stays where it was
        k = np.floor(t / 0.5).astype(int)
        whole = sorted(tuple(np.round(t[k == i] - i * 0.5, 9))
                       for i in range(8))
        return whole, np.round(t[k >= 8], 9)

    wa, ta = stretches(a)
    wb, tb = stretches(b)
    assert wa == wb
    np.testing.assert_array_equal(ta, tb)
