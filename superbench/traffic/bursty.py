"""Bursty open-loop arrivals (the paper's Fig. 12a construction).

``_gamma_interarrivals`` and ``bursty_trace`` are frozen copies of the
program's ``repro_torch/serving/traces.py`` generators (a test holds them
equal), so a later change to the program cannot move the yardstick.

:func:`arrivals` is what a cell runs. Its base stream is uniform at
``base_share * rate`` (CV^2 0); its variant stream has gamma
inter-arrivals at ``variant_share * rate`` with CV^2 ``variant_cv2``. The
variant's gaps are drawn once from the cell's fixed ``gap_seed``, and the
run's ``--seed`` only shuffles their order: every seed offers the same
number of queries, the same gaps and the same mean rate, with the bursts
in other places. With ``block_s`` in the cell's parameters the seed
shuffles whole stretches of that length in place of single gaps: every
seed then offers the same bursts, each whole, in another order.
"""
from __future__ import annotations

import numpy as np


def _gamma_interarrivals(rng, rate: float, cv2: float, t_end: float) -> np.ndarray:
    """Arrival times in [0, t_end) with gamma inter-arrivals of mean
    1/rate and squared coefficient of variation cv2 (cv2=0 -> uniform,
    cv2=1 -> Poisson)."""
    if rate <= 0:
        return np.empty(0)
    n_est = int(rate * t_end * 1.5) + 64
    if cv2 <= 1e-9:
        return np.arange(0, t_end, 1.0 / rate)
    shape = 1.0 / cv2
    scale = cv2 / rate
    gaps = rng.gamma(shape, scale, size=n_est)
    t = np.cumsum(gaps)
    while t[-1] < t_end:
        more = np.cumsum(rng.gamma(shape, scale, size=n_est)) + t[-1]
        t = np.concatenate([t, more])
    return t[t < t_end]


def bursty_trace(lambda_b: float, lambda_v: float, cv2: float,
                 duration: float, seed: int = 0) -> np.ndarray:
    """Base arrival at lambda_b (CV^2=0) + variant arrival at lambda_v
    with gamma inter-arrivals (paper Fig 12a construction)."""
    rng = np.random.default_rng(seed)
    base = _gamma_interarrivals(rng, lambda_b, 0.0, duration)
    var = _gamma_interarrivals(rng, lambda_v, cv2, duration)
    return np.sort(np.concatenate([base, var]))


def arrivals(params: dict, rate: float, seconds: float, seed: int,
             stream: int = 0) -> np.ndarray:
    """Sorted due times in [0, seconds) of one stretch of the cell's
    traffic at mean ``rate`` q/s. ``stream`` tells apart stretches of one
    run (the lead-in and the window) so they draw different gaps."""
    base = _gamma_interarrivals(np.random.default_rng(0),
                                params["base_share"] * rate,
                                params["base_cv2"], seconds)
    var = _gamma_interarrivals(
        np.random.default_rng([params["gap_seed"], stream]),
        params["variant_share"] * rate, params["variant_cv2"], seconds)
    rng = np.random.default_rng([seed, stream])
    block = params.get("block_s")
    if block:
        # whole stretches move; a last part shorter than a stretch stays
        n = int(seconds // block)
        idx = np.floor(var / block).astype(np.int64)
        slot = np.arange(n + 1)
        slot[rng.permutation(n)] = np.arange(n)
        var = var + (slot[np.minimum(idx, n)] - idx) * block
    else:
        gaps = np.diff(var, prepend=0.0)
        var = np.cumsum(gaps[rng.permutation(len(gaps))])
    return np.sort(np.concatenate([base, var]))
