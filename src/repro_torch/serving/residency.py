"""Subnet residency and actuation-cost estimation — the single owner
of "which subnet is resident on which worker" (ROADMAP
"actuation-stationary serving").

SubNetAct's core asset (paper §5, Fig 5b) is that switching subnets on
a weight-shared supernet is a *control-tuple swap* (~50 µs), not a
model load; Clipper+/INFaaS-style serving pays a full weight page-in
per switch instead (Fig 1a). Both regimes are one cost model here:

  * ``ActuationModel`` — what a switch costs: the control-swap delay,
    plus (in the ``load_on_switch`` weight-loading regime) paging the
    target subnet's weights over the host->device link. Also prices a
    replica **cold start** as a full supernet weight-load, so the
    autoscaler's spawn actuation and the engine's per-batch actuation
    share one physical model.
  * ``ResidencyTracker`` — per-worker resident subnet, updated only at
    batch launch (``actuate``) and worker death (``forget``), with
    switch/actuation accounting (``n_switches``, ``actuation_seconds``)
    feeding the ``switch_rate`` metric.
  * ``ResidencyView`` — the read-only, per-worker slice handed to
    scheduling policies so residency-aware variants (e.g.
    ``slackfit_sticky``) can prefer the resident subnet when it meets
    the slack target.

Layering rule (the engine/coordinator pattern, extended): residency lives in
this module only. The engine owns one tracker per worker pool and is
the only writer; placement policies (``actuation_aware`` in
serving/cluster.py), scheduling policies, the autoscaler, and metrics
all *read* it through the engine's introspection surface. The
"subgraph stationary" direction of Behnam et al. 2023 and
CascadeServe's switch-cost-aware routing (PAPERS.md) both reduce to
keeping this state accurate and consulting it before actuating.

Replay guarantee: with residency-blind configuration (the default
policies and placements) the tracker reproduces the engine's
pre-refactor inlined actuation math bit-for-bit — ``penalized`` adds
the control-swap delay and the weight-load cost in the exact historical
operation order (guarded by tests/test_residency.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from repro_torch.serving.profiler import (RTX2080TI, SUBNETACT_ACTUATION_S,
                                    HardwareProfile, LatencyProfile,
                                    loading_latency)

# weight footprint assumed for profiles without Pareto points (measured
# profiles from profiler.measure_profile) — the engine's historical
# fallback, kept verbatim for bit-stable replay
DEFAULT_WEIGHT_BYTES = 100e6


@dataclass(frozen=True)
class ActuationModel:
    """What actuating a subnet costs, in both serving regimes.

    ``switch_cost`` prices moving a worker from its ``resident`` subnet
    to ``target``: zero when already resident, else the control-swap
    ``actuation_delay`` (SubNetAct), plus a full weight page-in of the
    target when ``load_on_switch`` models a non-weight-shared stack.
    ``cold_start`` prices bringing up a whole replica: loading the
    heaviest subnet's weights (the supernet superset) over the same
    host->device link — the autoscaler consumes this when
    ``AutoscaleConfig.cold_start`` is None."""

    actuation_delay: float = SUBNETACT_ACTUATION_S
    load_on_switch: bool = False
    hw: HardwareProfile = RTX2080TI

    def weight_bytes(self, profile: LatencyProfile, pi: int) -> float:
        return (profile.points[pi].weight_mb * 2**20
                if profile.points else DEFAULT_WEIGHT_BYTES)

    def load_cost(self, profile: LatencyProfile, pi: int) -> float:
        """Full weight page-in of subnet ``pi`` (what a model *switch*
        pays without weight sharing — paper Fig 1a)."""
        return loading_latency(self.hw, self.weight_bytes(profile, pi))

    def switch_cost(self, profile: LatencyProfile, resident: Optional[int],
                    target: int) -> float:
        if resident == target:
            return 0.0
        cost = self.actuation_delay
        if self.load_on_switch:
            cost += self.load_cost(profile, target)
        return cost

    def penalized(self, latency: float, profile: LatencyProfile,
                  resident: Optional[int], target: int) -> float:
        """Service ``latency`` plus the actuation penalty, accumulated
        in the engine's exact historical operation order (sequential
        ``+=``) so residency-blind schedules replay bit-for-bit."""
        if resident != target:
            latency += self.actuation_delay
            if self.load_on_switch:
                latency += self.load_cost(profile, target)
        return latency

    def cold_start(self, profile: LatencyProfile) -> float:
        """Replica spawn -> routable: a full weight-load of the
        heaviest subnet (the supernet's resident superset)."""
        wb = max((p.weight_mb * 2**20 for p in profile.points),
                 default=DEFAULT_WEIGHT_BYTES)
        return loading_latency(self.hw, wb)


class ResidencyView:
    """Read-only residency slice for ONE worker, handed to scheduling
    policies: the resident subnet and the projected cost of actuating
    any other. Policies must never mutate residency — they consume this
    view, the engine's ``launch`` commits the actual actuation."""

    __slots__ = ("_tracker", "wid")

    def __init__(self, tracker: "ResidencyTracker", wid: int):
        self._tracker = tracker
        self.wid = wid

    @property
    def resident(self) -> Optional[int]:
        return self._tracker.resident(self.wid)

    def switch_cost(self, pi: int) -> float:
        return self._tracker.switch_cost(self.wid, pi)


class ResidencyTracker:
    """Per-worker resident subnet for one worker pool (one engine).

    The engine is the single writer: ``actuate`` on batch launch,
    ``forget`` on worker death, ``register`` when a pool is built.
    Everything else — policies, placement, the autoscaler, metrics —
    reads. ``None`` means the worker has never actuated (a fresh pool),
    so its first dispatch always pays a switch, matching the engine's
    historical accounting."""

    def __init__(self, profile: LatencyProfile,
                 model: Optional[ActuationModel] = None,
                 worker_ids: Iterable[int] = ()):
        self.profile = profile
        self.model = model if model is not None else ActuationModel()
        self._resident: Dict[int, Optional[int]] = {
            int(w): None for w in worker_ids}
        self.n_switches = 0             # launches that changed subnet
        self.n_launches = 0             # all launches
        self.actuation_seconds = 0.0    # total switch cost paid

    # -- pool membership (engine-owned) ---------------------------------

    def register(self, wid: int) -> None:
        self._resident.setdefault(int(wid), None)

    def forget(self, wid: int) -> None:
        """Worker died: its residency is gone with it."""
        self._resident.pop(wid, None)

    def workers(self) -> List[int]:
        return list(self._resident)

    def __len__(self) -> int:
        return len(self._resident)

    def __contains__(self, wid: int) -> bool:
        return wid in self._resident

    # -- residency reads -------------------------------------------------

    def resident(self, wid: int) -> Optional[int]:
        return self._resident.get(wid)

    def residency(self) -> Dict[int, Optional[int]]:
        """Copy of the full worker -> resident-subnet map (placement
        and cluster introspection; mutating the copy changes nothing)."""
        return dict(self._resident)

    def resident_count(self, pi: int) -> int:
        """Workers currently resident on subnet ``pi``."""
        return sum(1 for r in self._resident.values() if r == pi)

    def view(self, wid: int) -> ResidencyView:
        return ResidencyView(self, wid)

    # -- cost projection --------------------------------------------------

    def switch_cost(self, wid: int, pi: int) -> float:
        """Projected cost of serving subnet ``pi`` on worker ``wid``
        (0.0 when already resident)."""
        return self.model.switch_cost(self.profile,
                                      self._resident.get(wid), pi)

    def min_switch_cost(self, pi: int) -> float:
        """Cheapest way this pool could serve subnet ``pi``: zero if
        any worker is already resident on it. An empty (dead) pool
        prices as a cold never-actuated worker — placement never offers
        dead replicas, so this is a defensive bound, not a route."""
        if not self._resident:
            return self.model.switch_cost(self.profile, None, pi)
        return min(self.model.switch_cost(self.profile, r, pi)
                   for r in self._resident.values())

    def penalized(self, latency: float, wid: int, pi: int) -> float:
        """Expected service latency including the actuation penalty
        against ``wid``'s resident subnet (bit-identical to the
        pre-refactor inlined engine math)."""
        return self.model.penalized(latency, self.profile,
                                    self._resident.get(wid), pi)

    # -- commit ------------------------------------------------------------

    def actuate(self, wid: int, pi: int) -> float:
        """Batch launch on ``wid`` with subnet ``pi``: commit the
        residency change and book the switch cost actually paid.
        Returns that cost (0.0 when the worker was already resident)."""
        prev = self._resident.get(wid)
        cost = self.model.switch_cost(self.profile, prev, pi)
        self.n_launches += 1
        if prev != pi:
            self.n_switches += 1
        self.actuation_seconds += cost
        self._resident[int(wid)] = int(pi)
        return cost

    # -- accounting ---------------------------------------------------------

    @property
    def switch_rate(self) -> float:
        """Fraction of launches that actuated a different subnet than
        the worker's resident one (0.0 with no launches)."""
        return self.n_switches / self.n_launches if self.n_launches else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Introspection bundle for stats/benchmarks (read-only)."""
        return {"n_workers": float(len(self._resident)),
                "n_launches": float(self.n_launches),
                "n_switches": float(self.n_switches),
                "switch_rate": self.switch_rate,
                "actuation_seconds": self.actuation_seconds}
