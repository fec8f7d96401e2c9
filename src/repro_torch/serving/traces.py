"""Trace generators (paper §6.1): bursty (gamma inter-arrivals on top of
a steady base), time-varying (mean ingest accelerating lambda1 ->
lambda2 at tau q/s^2), and an MAF-like workload (superposition of many
periodic/bursty per-function streams, shape-preserving shrink of the
Microsoft Azure Functions trace). All seeded/deterministic.
"""
from __future__ import annotations

from typing import Tuple

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


def time_varying_trace(lambda1: float, lambda2: float, tau: float,
                       cv2: float, duration: float, seed: int = 0) -> np.ndarray:
    """Mean ingest accelerates from lambda1 to lambda2 at tau q/s^2,
    then holds; jitter at CV^2 = cv2 throughout (paper §6.2.2)."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / max(cv2, 1e-9)
    t, out = 0.0, []
    while t < duration:
        rate = min(lambda2, lambda1 + tau * t) if lambda2 >= lambda1 else \
            max(lambda2, lambda1 - tau * t)
        rate = max(rate, 1e-6)
        if cv2 <= 1e-9:
            gap = 1.0 / rate
        else:
            gap = rng.gamma(shape, (1.0 / shape) / rate)
        t += gap
        if t < duration:
            out.append(t)
    return np.asarray(out)


def maf_like_trace(mean_rate: float, duration: float, n_functions: int = 200,
                   seed: int = 0, peak_factor: float = 1.37) -> np.ndarray:
    """MAF-like workload (paper §6.3): a rate ENVELOPE built from many
    periodic per-function spike trains with heavy-tailed weights (the
    structure Shahrad et al. report), affinely normalized so the mean is
    ``mean_rate`` and the windowed peak ~ ``peak_factor * mean_rate`` —
    the paper's own shape-preserving shrink (their 6400-qps trace peaks
    at ~8750 ~= 1.37x); arrivals are Poisson within the envelope (the
    paper observes MAF is Poisson-like, CV^2 ~= 1)."""
    rng = np.random.default_rng(seed)
    dt = 0.1
    t_grid = np.arange(0.0, duration, dt)
    env = np.zeros_like(t_grid)
    for _ in range(n_functions):
        w = rng.pareto(1.5) + 0.1               # heavy-tailed function size
        period = rng.uniform(2.0, max(duration / 2, 4.0))
        phase = rng.uniform(0, period)
        width = rng.uniform(0.2, 1.5)           # short invocation bursts
        env += w * (((t_grid - phase) % period) < width)
    # slow diurnal-like modulation underneath
    env += env.mean() * (1.0 + 0.3 * np.sin(2 * np.pi * t_grid / duration))
    # affine normalize: mean -> mean_rate, max -> peak_factor * mean_rate
    a = mean_rate * (peak_factor - 1.0) / max(env.max() - env.mean(), 1e-9)
    b = mean_rate - a * env.mean()
    rate = np.maximum(a * env + b, 0.25 * mean_rate)
    counts = rng.poisson(rate * dt)
    arrivals = np.concatenate([
        t0 + rng.uniform(0, dt, size=c) for t0, c in zip(t_grid, counts) if c
    ]) if counts.sum() else np.empty(0)
    return np.sort(arrivals)


def trace_stats(arrivals: np.ndarray, window: float = 1.0) -> Tuple[float, float]:
    """(mean qps, CV^2 of inter-arrivals)."""
    if len(arrivals) < 2:
        return 0.0, 0.0
    gaps = np.diff(arrivals)
    mean_rate = len(arrivals) / (arrivals[-1] - arrivals[0] + 1e-9)
    cv2 = float(np.var(gaps) / (np.mean(gaps) ** 2 + 1e-12))
    return float(mean_rate), cv2
