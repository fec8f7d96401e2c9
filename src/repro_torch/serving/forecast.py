"""Short-horizon arrival-rate forecasting (ROADMAP "predictive scaling
policies" + "predictive join windows").

SuperServe's reactive policies act when load *has already* shifted; the
paper's claim that SubNetAct "unlocks the design space of fine-grained,
reactive scheduling policies" extends naturally to *predictive* ones —
but only if both transports can share one deterministic forecast. This
module is that shared capability: an ``ArrivalForecaster`` whose state
is a pure function of the observed arrival timestamps.

Design rules (the layering rule this PR adds to the ROADMAP):

  * **forecasting state lives here only** — the coordinator and the
    engine own a forecaster and feed it at admission; scaling policies
    (serving/autoscaler.py ``Predictive``) and the engine's predictive
    join windows *consume* it; transports never mutate it;
  * **clock-agnostic** — ``observe(t)`` takes the arrival timestamp
    (virtual or wall), never reads a clock of its own;
  * **deterministic + query-pure** — the same arrival sequence yields a
    byte-identical forecast series, and read methods (``rate`` /
    ``trend`` / ``forecast`` / ``eta`` / ``cv2`` / ``snapshot``) never
    mutate state, so *when* a transport happens to ask cannot perturb
    what a later query returns (property-tested in
    tests/test_forecast.py).

Estimator: a sliding-window rate (count of arrivals in the trailing
``window`` seconds — decays to exactly zero on an idle stream) plus a
Holt double-exponential (level + trend) smoother with time-aware gains
(irregular sampling: the gain compounds per elapsed window, so a gap of
k windows discounts history like k unit steps would), and a burst
detector estimating CV^2 over the recent inter-arrival gaps (the
paper's burstiness knob for its bursty traces).
"""
from __future__ import annotations

from bisect import bisect_right, insort
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ForecastConfig:
    """Knobs shared by every forecaster consumer (engine-level join
    windows, the coordinator-level scaling forecaster)."""

    window: float = 0.25        # sliding-window width (s)
    alpha: float = 0.5          # Holt level gain per elapsed window
    beta: float = 0.3           # Holt trend gain per elapsed window
    min_arrivals: int = 8       # observations before there is "signal"
    burst_cv2: float = 4.0      # CV^2 above which the burst detector fires
    cv2_gaps: int = 64          # inter-arrival gaps in the CV^2 estimate
    max_horizon: float = 1.0    # clamp on forecast extrapolation (s)

    def validate(self) -> "ForecastConfig":
        if self.window <= 0:
            raise ValueError("window must be > 0")
        if not (0.0 < self.alpha <= 1.0) or not (0.0 < self.beta <= 1.0):
            raise ValueError("alpha/beta must be in (0, 1]")
        if self.min_arrivals < 1:
            raise ValueError("min_arrivals must be >= 1")
        if self.cv2_gaps < 2:
            raise ValueError("cv2_gaps must be >= 2")
        if self.max_horizon < 0:
            raise ValueError("max_horizon must be >= 0")
        return self


class ArrivalForecaster:
    """Deterministic short-horizon arrival-rate estimator.

    ``observe(t)`` records one arrival (timestamps are expected
    near-monotone; slightly stale ones — a re-routed query carrying its
    original arrival — are merged in order and cannot corrupt the
    estimate). All other methods are read-only. History older than two
    windows behind the newest observation is pruned, so reads are exact
    for any ``now`` from one window behind the newest arrival onward —
    i.e. for every caller whose clock doesn't run *behind* the arrivals
    it already admitted.
    """

    def __init__(self, cfg: Optional[ForecastConfig] = None):
        self.cfg = (cfg or ForecastConfig()).validate()
        self._times: List[float] = []   # sorted, pruned to the last 2 windows
        self._epoch: Optional[float] = None     # first observed arrival
        self._latest: float = float("-inf")     # newest observed arrival
        self.n_observed: int = 0
        # Holt state, advanced only by observe()
        self._level: float = 0.0
        self._trend: float = 0.0
        self._t_holt: Optional[float] = None
        self._gaps: deque = deque(maxlen=self.cfg.cv2_gaps)

    # -- writes (admission path only) -----------------------------------

    def observe(self, t: float) -> None:
        """Record one arrival at timestamp ``t``."""
        t = float(t)
        if self._epoch is None:
            self._epoch = t
        else:
            self._gaps.append(max(t - self._latest, 0.0))
        if t >= self._latest:
            self._times.append(t)
            self._latest = t
        else:                           # stale (re-routed) arrival
            insort(self._times, t)
        lo = self._latest - 2.0 * self.cfg.window
        keep = bisect_right(self._times, lo)
        if keep:
            del self._times[:keep]
        self.n_observed += 1
        self._update_holt(t)

    def _update_holt(self, t: float) -> None:
        r = self.rate(max(t, self._latest))
        if self._t_holt is None:
            # initialize at the first NON-zero rate observation: seeding
            # the level at the degenerate single-arrival rate of 0 would
            # ramp the level through the whole warm-up and leave a large
            # phantom trend decaying for several windows after
            if r > 0.0:
                self._level, self._trend, self._t_holt = r, 0.0, t
            return
        dt = max(t - self._t_holt, 0.0)
        if dt <= 0.0:
            # simultaneous arrival: refresh the level, trend unchanged
            # (a zero-dt slope is undefined)
            self._level = ((1.0 - self.cfg.alpha) * self._level
                           + self.cfg.alpha * r)
            return
        steps = dt / self.cfg.window
        a = 1.0 - (1.0 - self.cfg.alpha) ** steps
        b = 1.0 - (1.0 - self.cfg.beta) ** steps
        pred = self._level + self._trend * dt
        level = (1.0 - a) * pred + a * r
        self._trend = (1.0 - b) * self._trend + b * (level - self._level) / dt
        self._level = level
        self._t_holt = t

    # -- reads (pure) ----------------------------------------------------

    def rate(self, now: float) -> float:
        """Arrivals/sec over ``(now - window, now]``. Before the first
        window has elapsed, k arrivals since the first span k-1 gaps,
        so the opening segment is normalized as ``(k-1)/elapsed`` — an
        opening burst reads at full rate (the reactive QueuePressure
        idea) without the division-by-~0 blowup at the very first
        arrival. Exactly 0.0 once the stream has been idle for a full
        window."""
        if self._epoch is None or now < self._epoch:
            return 0.0
        w = self.cfg.window
        lo = bisect_right(self._times, now - w)
        hi = bisect_right(self._times, now)
        n = hi - lo
        if n == 0:
            return 0.0
        elapsed = now - self._epoch
        if elapsed >= w:
            return n / w
        if n < 2:
            return 0.0
        return (n - 1) / max(elapsed, 1e-9)

    def prev_rate(self, now: float) -> float:
        """Arrivals/sec over the window before the current one,
        ``(now - 2*window, now - window]`` (the raw slope's baseline;
        0.0 before that window has fully elapsed)."""
        if self._epoch is None or now - self.cfg.window < self._epoch:
            return 0.0
        w = self.cfg.window
        lo = bisect_right(self._times, now - 2.0 * w)
        hi = bisect_right(self._times, now - w)
        return (hi - lo) / w

    def slope(self, now: float) -> float:
        """Raw windowed rate change (arrivals/sec^2): current window
        minus the previous one, over one window."""
        return (self.rate(now) - self.prev_rate(now)) / self.cfg.window

    def trend(self, now: float) -> float:
        """Holt-smoothed rate change (arrivals/sec^2). Gated to 0 when
        the current window is empty: a stale trend extrapolated from an
        idle stream would forecast arrivals out of nothing."""
        if self.rate(now) <= 0.0:
            return 0.0
        return self._trend

    def forecast(self, now: float, horizon: float = 0.0) -> float:
        """Forecast arrivals/sec at ``now + horizon``: the windowed rate
        extrapolated along the smoothed trend, clamped non-negative and
        to ``max_horizon``. Exactly 0.0 on an idle stream."""
        r = self.rate(now)
        if r <= 0.0:
            return 0.0
        h = min(max(float(horizon), 0.0), self.cfg.max_horizon)
        return max(0.0, r + self.trend(now) * h)

    def smoothed(self, now: float, horizon: float = 0.0) -> float:
        """Holt-smoothed forecast at ``now + horizon``: the smoothed
        level extrapolated along the smoothed trend from its last
        update. Less reactive than ``forecast`` (the raw windowed rate)
        but immune to single-window spikes — the right read for
        capacity decisions, where a spike is the backlog kicker's job
        and a phantom spawn costs a whole cold start + cooldown cycle.
        Exactly 0.0 on an idle stream, like ``forecast``."""
        if self.rate(now) <= 0.0 or self._t_holt is None:
            return 0.0
        h = min(max(float(horizon), 0.0), self.cfg.max_horizon)
        dt = max(now - self._t_holt, 0.0) + h
        return max(0.0, self._level + self._trend * dt)

    def eta(self, now: float) -> Optional[float]:
        """Expected seconds until the next arrival (1/rate), or None on
        an idle stream — the predictive join window's signal."""
        r = self.rate(now)
        return 1.0 / r if r > 0.0 else None

    def cv2(self, now: float) -> float:
        """Squared coefficient of variation of the recent inter-arrival
        gaps (cv2=0 uniform, ~1 Poisson, >1 bursty); 0.0 until two gaps
        have been seen."""
        if len(self._gaps) < 2:
            return 0.0
        gaps = list(self._gaps)
        mean = sum(gaps) / len(gaps)
        if mean <= 1e-12:
            return 0.0
        var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
        return var / (mean * mean)

    def bursty(self, now: float) -> bool:
        """Burst detector: enough signal and the gap CV^2 estimate above
        the configured threshold."""
        return self.has_signal(now) and self.cv2(now) >= self.cfg.burst_cv2

    def has_signal(self, now: float) -> bool:
        """Enough observations to act on, and the stream not idle —
        consumers (the ``predictive`` scaling policy, predictive join
        windows) must fall back to their reactive behavior otherwise."""
        return self.n_observed >= self.cfg.min_arrivals and self.rate(now) > 0

    def snapshot(self, now: float) -> Dict[str, Optional[float]]:
        """Introspection bundle (coordinator/serve.py surface). Every
        value is JSON-safe: an idle stream's undefined ETA is None
        (-> null), never inf (json.dumps would emit the non-RFC
        ``Infinity`` token and break strict parsers on the artifact)."""
        return {
            "t": float(now),
            "n_observed": float(self.n_observed),
            "rate": self.rate(now),
            "trend": self.trend(now),
            "slope": self.slope(now),
            "forecast_1w": self.forecast(now, self.cfg.window),
            "eta": self.eta(now),
            "cv2": self.cv2(now),
            "bursty": float(self.bursty(now)),
            "has_signal": float(self.has_signal(now)),
        }
