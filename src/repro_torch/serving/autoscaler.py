"""Reactive replica autoscaling on the cluster plane (ROADMAP "replica
autoscaling", the INFaaS direction).

SubNetAct's near-instantaneous actuation (paper §5) makes *reactive*
control viable: instead of provisioning the cluster for the bursty
trace's peak, a ``ClusterAutoscaler`` rides on the
``ClusterCoordinator`` and spawns / decommissions whole replica groups
from live load signals. The division of labor extends the base rule:
*scheduling* lives in the engine, *placement AND scaling* live in the
coordinator layer — transports (simulator / asyncio cluster router /
the proc transport's IPC front door, where ``engine_factory`` returns a
coordinator-side ``ReplicaProxy`` and spawn means forking a replica
process) stay thin and drive the same autoscaler through the same
coordinator, so autoscaled schedules remain transport-independent and
deterministic.

Lifecycle invariants (property-tested in tests/test_autoscaler.py):

  * **conservation** — scaling never loses or duplicates a query:
    decommission reuses the replica-death surrender/drain path (the
    queue is re-routed through placement, in EDF order; in-flight
    batches finish on the old replica — a scale-down never black-holes
    work);
  * **bounds** — the committed replica count (routable + warming)
    stays within ``[min_replicas, max_replicas]``;
  * **cooldown** — every decommission trails the previous scale event
    by at least ``cooldown`` (scale-up is deliberately undamped: the
    reactive story is spawning *into* a burst; hysteresis between the
    up/down thresholds plus the down-only cooldown damp flapping);
  * **cold start** — a spawned replica pays ``cold_start`` seconds of
    actuation before it becomes routable: capacity is committed (and
    billed in ``replica_seconds``) at spawn time but serves only after
    warm-up.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.cluster import ClusterCoordinator
from repro_torch.serving.engine import SchedulingEngine
from repro_torch.serving.forecast import ForecastConfig


# --------------------------------------------------------------------------
# Config + event log
# --------------------------------------------------------------------------


@dataclass
class AutoscaleConfig:
    """Knobs shared by both transports. Signal thresholds are expressed
    relative to the SLO so one config tracks any deadline regime."""

    min_replicas: int = 1
    max_replicas: int = 8
    policy: str = "queue_pressure"
    interval: float = 0.05          # control-loop period (s)
    # scale-DOWN damping: a decommission must trail the previous scale
    # event by at least this long. Scale-UP is deliberately undamped —
    # SubNetAct-style reactivity is the whole point — and over-spawning
    # is checked by counting warming capacity into the pressure signal.
    cooldown: float = 0.50
    # spawn -> routable actuation cost (s); None derives it from the
    # cluster's own ActuationModel (serving/residency.py) as a full
    # weight-load of the heaviest subnet — replica cold start and
    # per-batch switch cost then share one physical model
    cold_start: Optional[float] = 0.10
    # workers per spawned replica; None -> the transport's per-replica
    # worker count (heterogeneous clusters must set it explicitly)
    spawn_workers: Optional[int] = None
    # deadline regime the thresholds are relative to; None -> inherit
    # the transport's SLO (ClusterConfig.slo / serve --slo-ms)
    slo: Optional[float] = None
    # queue_pressure: a capacity controller on the observed arrival
    # rate (workers needed = rate / (util_target * profile max
    # throughput)) with a queue-backlog kicker for bursts faster than
    # the rate window. Scale up when needed workers exceed committed
    # ones or queued work per worker exceeds up_pressure SLOs; scale
    # down when utilization falls under down_util (hysteresis band =
    # the 1.0..down_util gap, plus the down-only cooldown).
    up_pressure: float = 1.5
    util_target: float = 0.55       # sustainable fraction of max tput
    down_util: float = 0.75
    rate_window: float = 0.25       # arrival-rate estimation window (s)
    # slo_headroom: sliding-window attainment target + slack headroom
    # (fraction of slo) that marks the cluster over-provisioned
    window: float = 1.0
    target_attainment: float = 0.985
    headroom: float = 0.5
    # predictive: how far ahead the coordinator forecaster is read when
    # sizing capacity; None -> cold_start + interval, i.e. exactly the
    # lead time a spawn decided now needs to turn routable before the
    # forecast load lands
    horizon: Optional[float] = None
    # scripted policy (tests): explicit (time, +1 | -1) events
    script: Sequence[Tuple[float, int]] = ()

    def validate(self) -> "AutoscaleConfig":
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.interval <= 0:
            raise ValueError("interval must be > 0")
        if ((self.cold_start is not None and self.cold_start < 0)
                or self.cooldown < 0):
            raise ValueError("cold_start/cooldown must be >= 0")
        if self.horizon is not None and self.horizon < 0:
            raise ValueError("horizon must be >= 0")
        return self


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler lifecycle event, logged for metrics/benchmarks
    and asserted over by the property tests."""

    t: float
    kind: str                       # spawn | ready | decommission | death
    rid: int
    n_routable: int                 # routable replicas after the event
    n_committed: int                # routable + warming after the event
    signal: float = 0.0             # policy signal at decision time
    drained: Tuple[int, ...] = ()   # qids re-routed off (decommission)
    ready_at: Optional[float] = None  # spawn only: when it turns routable


# --------------------------------------------------------------------------
# Scaling policies
# --------------------------------------------------------------------------


class ScalingPolicy:
    """Pluggable scale-decision API: ``decide`` sees the coordinator
    (read-only) and the routable replicas, returns ``(delta, signal)``
    with delta in {+1, 0, -1}. Bounds, cooldown, victim selection, and
    actuation belong to the ``ClusterAutoscaler``, not the policy.
    ``decide`` may be consulted several times within one control tick
    (the multi-spawn loop). ``epoch`` is stamped by the autoscaler on
    its first tick: the clock origin (0 under virtual time, the start
    timestamp under wall clock) for policies with time-anchored state.
    """

    name: str = "base"
    epoch: float = 0.0

    def reset(self) -> None:
        pass

    def decide(self, coord: ClusterCoordinator,
               routable: Sequence[Tuple[int, SchedulingEngine]],
               now: float, warming_workers: int = 0) -> Tuple[int, float]:
        """``warming_workers`` counts capacity already committed but
        still cold-starting, so a burst doesn't over-spawn while the
        first reinforcements warm up."""
        raise NotImplementedError


class QueuePressure(ScalingPolicy):
    """Scale on aggregate demand vs drain capacity, two signals:

    * **sustained** — workers needed for the observed arrival rate
      (last ``rate_window`` seconds of the master admission list) at a
      sustainable ``util_target`` fraction of the profile's best
      queries/sec/worker. More needed than committed (warming counts)
      -> spawn; utilization under ``down_util`` -> decommission.
    * **burst kicker** — aggregate queued work (every replica's
      ``queue_depth``, valued at the fastest control choice, per
      worker) above ``up_pressure`` SLOs means the backlog will
      outlive deadlines before the rate window even notices -> spawn
      now.

    The 1.0..``down_util`` gap is the hysteresis band; the autoscaler's
    down-only cooldown adds the damping."""

    name = "queue_pressure"

    def __init__(self, slo: float, up_pressure: float, util_target: float,
                 down_util: float, rate_window: float):
        self.slo = max(float(slo), 1e-9)
        self.up_pressure = float(up_pressure)
        self.util_target = float(util_target)
        self.down_util = float(down_util)
        self.rate_window = float(rate_window)
        self._tput: Optional[float] = None  # best q/s/worker, from profile

    def _max_tput(self, engine: SchedulingEngine) -> float:
        if self._tput is None:
            prof = engine.profile
            self._tput = max(
                prof.batches[bi] / float(prof.lat[pi, bi])
                for pi in range(prof.lat.shape[0])
                for bi in range(len(prof.batches)))
        return self._tput

    def _arrival_rate(self, coord, now: float) -> float:
        lo, n = now - self.rate_window, 0
        for q in reversed(coord.queries):   # admission(=arrival)-ordered
            if q.arrival <= lo:
                break
            n += 1
        # normalize by elapsed-since-epoch when the window hasn't
        # filled yet (epoch, not raw now: the wall clock's origin is
        # arbitrary) so an opening burst reads at full rate
        return n / max(min(self.rate_window, now - self.epoch), 1e-9)

    def _demand_rate(self, coord, now: float) -> float:
        """The arrivals/sec the capacity controller sizes for — the
        single hook ``Predictive`` overrides, so there is exactly ONE
        decide body to keep the hysteresis/kicker semantics in."""
        return self._arrival_rate(coord, now)

    def decide(self, coord, routable, now, warming_workers=0):
        workers = (sum(max(len(e.residency), 1) for _, e in routable)
                   + warming_workers)
        sustainable = self._max_tput(routable[0][1]) * self.util_target
        need = self._demand_rate(coord, now) / max(sustainable, 1e-9)
        usig = need / max(workers, 1)
        queued = sum(e.queue_depth() for _, e in routable)
        qsig = (queued * routable[0][1].min_service
                / max(workers, 1)) / self.slo
        if usig > 1.0 or qsig > self.up_pressure:
            return 1, max(usig, qsig)
        if usig < self.down_util and len(routable) > 1:
            return -1, usig
        return 0, usig


class Predictive(QueuePressure):
    """Forecast-led scaling (ROADMAP "predictive scaling policies"):
    read the coordinator's shared ``ArrivalForecaster`` ``horizon``
    seconds ahead — the cold start plus one control period, i.e. the
    lead time a spawn decided *now* needs before the forecast load
    lands — and size capacity for that forecast rate, so reinforcements
    finish warming as the burst arrives instead of after it.

    Inherits ``QueuePressure`` as its reactive floor: with no
    forecaster on the coordinator, or before the forecaster has signal
    (fewer than ``min_arrivals`` observations, or an idle window), it
    IS queue_pressure — a forecaster that never fires must replay the
    reactive schedule byte-identically (guarded in
    tests/test_autoscaler.py). The queued-work burst kicker stays
    active either way: a burst faster than any forecast window is a
    reactive problem, not a forecasting one.

    The utilization signal is ``max(rate_now, forecast_at_horizon)``,
    driving both directions: on a rising trend the forecast leads (the
    paper-story spawn-before-the-burst), on a falling or flat one it
    degrades to exactly the reactive signal — so an unforecastable
    trace costs nothing (the bench_predictive <= 1.0x replica-seconds
    gate) and a forecastable one is served ahead of time."""

    name = "predictive"

    def __init__(self, slo: float, up_pressure: float, util_target: float,
                 down_util: float, rate_window: float, horizon: float):
        super().__init__(slo, up_pressure, util_target, down_util,
                         rate_window)
        self.horizon = float(horizon)

    def _demand_rate(self, coord, now: float) -> float:
        # the demand signal is the WORSE of now and the forecast at the
        # actuation horizon: on a rising trend the forecast leads
        # (spawn before the load lands), on a falling one the current
        # rate still holds the floor (never trim into a burst that
        # hasn't finished draining) — so predictive is exactly reactive
        # plus lead time, and a flat forecast changes nothing. The
        # whole decide body (thresholds, hysteresis, burst kicker)
        # stays QueuePressure's.
        fc = getattr(coord, "forecaster", None)
        if fc is None or not fc.has_signal(now):
            return super()._demand_rate(coord, now)
        return max(fc.rate(now), fc.forecast(now, self.horizon))


class SLOHeadroom(ScalingPolicy):
    """Scale on *observed outcomes* over a sliding window: attainment
    under ``target`` means deadlines are already slipping — spawn;
    attainment at target with mean slack headroom above ``headroom`` of
    the SLO means the cluster is over-provisioned — decommission. A
    lagging signal compared to queue pressure (it waits for misses),
    kept as the observational alternative."""

    name = "slo_headroom"

    def __init__(self, slo: float, window: float, target: float,
                 headroom: float):
        self.slo = max(float(slo), 1e-9)
        self.window = float(window)
        self.target = float(target)
        self.headroom = float(headroom)

    def decide(self, coord, routable, now, warming_workers=0):
        if warming_workers:
            return 0, 1.0               # reinforcements already on the way
        lo = now - self.window
        ok = miss = 0
        slack_sum = 0.0
        # master list is admission(=arrival)-ordered: scan the tail
        for q in reversed(coord.queries):
            if q.arrival < lo:
                break
            if q.dropped or (q.finish is not None and q.finish > q.deadline):
                miss += 1
            elif q.finish is not None:
                ok += 1
                slack_sum += q.deadline - q.finish
            elif q.deadline < now:      # still unresolved but already late
                miss += 1
        resolved = ok + miss
        attainment = ok / resolved if resolved else 1.0
        if resolved and attainment < self.target:
            return 1, attainment
        mean_headroom = (slack_sum / ok) / self.slo if ok else 0.0
        if (resolved and attainment >= self.target
                and mean_headroom > self.headroom and len(routable) > 1):
            return -1, attainment
        return 0, attainment


class Scripted(ScalingPolicy):
    """Deterministic test harness: replay explicit (time, delta) scale
    events — times relative to the autoscaler's epoch — one per
    control tick once due (re-consults within the same tick return
    hold, so the multi-spawn loop can't double-consume). An event the
    autoscaler clamps away (bounds, cooldown) is dropped, not retried
    — scripts describe attempts, the clamps stay authoritative (the
    bounds property tests rely on exactly that). Lets the property
    tests drive arbitrary spawn/decommission sequences through the
    exact production actuation path."""

    name = "scripted"

    def __init__(self, script: Sequence[Tuple[float, int]]):
        self.script = sorted((float(t), int(d)) for t, d in script)

    def reset(self) -> None:
        self._pending = list(self.script)
        self._consumed_at: Optional[float] = None

    def decide(self, coord, routable, now, warming_workers=0):
        if (self._pending and self._pending[0][0] <= now - self.epoch
                and self._consumed_at != now):
            self._consumed_at = now
            _, delta = self._pending.pop(0)
            return (1 if delta > 0 else -1), float(delta)
        return 0, 0.0


SCALINGS: Dict[str, str] = {
    "queue_pressure": "aggregate backlog vs drain capacity (leading)",
    "predictive": "forecast crossing capacity, cold_start ahead "
                  "(queue_pressure fallback without signal)",
    "slo_headroom": "windowed attainment + slack headroom (lagging)",
    "scripted": "explicit (t, +1/-1) event list (tests)",
}


def make_scaling(cfg: AutoscaleConfig, slo: float,
                 cold_start: Optional[float] = None) -> ScalingPolicy:
    """``cold_start`` is the *resolved* spawn actuation (the
    ClusterAutoscaler passes its ActuationModel-derived value when
    ``cfg.cold_start`` is None) — the predictive horizon must match
    what a spawn actually pays."""
    if cold_start is None:
        cold_start = cfg.cold_start if cfg.cold_start is not None else 0.0
    if cfg.policy == "queue_pressure":
        return QueuePressure(slo, cfg.up_pressure, cfg.util_target,
                             cfg.down_util, cfg.rate_window)
    if cfg.policy == "predictive":
        horizon = (cfg.horizon if cfg.horizon is not None
                   else cold_start + cfg.interval)
        return Predictive(slo, cfg.up_pressure, cfg.util_target,
                          cfg.down_util, cfg.rate_window, horizon)
    if cfg.policy == "slo_headroom":
        return SLOHeadroom(slo, cfg.window, cfg.target_attainment,
                           cfg.headroom)
    if cfg.policy == "scripted":
        return Scripted(cfg.script)
    raise ValueError(f"unknown scaling policy {cfg.policy!r}; "
                     f"choose from {sorted(SCALINGS)}")


def coordinator_forecast(autoscale: Optional[AutoscaleConfig],
                         explicit: Optional[ForecastConfig]
                         ) -> Optional[ForecastConfig]:
    """THE defaulting rule for the coordinator-level ForecastConfig,
    stated once so both transports construct identical forecasters (a
    transport-local default would silently break schedule parity): an
    explicit config wins; otherwise a forecast-led scaling policy gets
    a default forecaster windowed at its own ``rate_window`` (forecast
    and reactive fallback then read comparable rates); otherwise no
    coordinator forecaster at all."""
    if explicit is not None:
        return explicit
    if autoscale is not None and autoscale.policy == "predictive":
        return ForecastConfig(window=autoscale.rate_window)
    return None


# --------------------------------------------------------------------------
# The autoscaler
# --------------------------------------------------------------------------


class ClusterAutoscaler:
    """Reactive replica lifecycle on top of a ``ClusterCoordinator``.

    The autoscaler owns the decision loop (policy + bounds + cooldown +
    victim selection), the lifecycle bookkeeping (warming replicas,
    per-replica active spans -> ``replica_seconds``), and the event
    log. Transports supply ``engine_factory(rid)`` (how a replica group
    is built: a bare engine in the simulator, a full ``Router`` in the
    asyncio plane) and call ``tick``/``activate`` from their own clocks
    — the shared virtual-time heap in ``drive_cluster`` or an asyncio
    task. ``migrate_fn(rid, moved)`` lets the asyncio transport move
    payloads/futures with a decommissioned replica's re-routed queue.
    """

    def __init__(self, coord: ClusterCoordinator, cfg: AutoscaleConfig,
                 engine_factory: Callable[[int], SchedulingEngine],
                 slo: float = 0.036,
                 migrate_fn: Optional[Callable] = None):
        self.coord = coord
        self.cfg = cfg.validate()
        self.engine_factory = engine_factory
        self.migrate_fn = migrate_fn
        # resolve the spawn actuation once, for both transports: an
        # explicit cold_start wins; None prices it through the cluster's
        # own ActuationModel as a full weight-load of the heaviest
        # subnet (serving/residency.py) — the same model the engines
        # charge per-batch switches against
        if cfg.cold_start is not None:
            self.cold_start = float(cfg.cold_start)
        else:
            e0 = coord.engines[0]
            self.cold_start = e0.residency.model.cold_start(e0.profile)
        self.policy = make_scaling(cfg, cfg.slo if cfg.slo is not None
                                   else slo, cold_start=self.cold_start)
        self.policy.reset()
        self.events: List[ScaleEvent] = []
        self._t0: Optional[float] = None        # clock origin (first tick)
        self._last_scale = float("-inf")
        self._warming: Dict[int, float] = {}        # rid -> ready_at
        # rid -> [start, end]; initial replicas are active from the
        # clock origin (0 under virtual time, the start stamp under
        # wall clock — stamped as the epoch on the first tick)
        self._spans: Dict[int, List[Optional[float]]] = {
            rid: [None, None] for rid in range(coord.n_replicas)}

    # -- views -----------------------------------------------------------

    def n_routable(self) -> int:
        return len(self.coord.alive_replicas())

    def n_committed(self) -> int:
        """Replicas the autoscaler is paying for: routable + warming."""
        return self.n_routable() + len(self._warming)

    def anchor(self, t0: float) -> None:
        """Stamp the clock origin: 0 under virtual time (drive_cluster),
        the start timestamp under wall clock (ClusterRouter.start).
        Initial replicas bill from here; idempotent."""
        if self._t0 is None:
            self._t0 = float(t0)
            self.policy.epoch = self._t0
            for span in self._spans.values():
                if span[0] is None:
                    span[0] = self._t0

    # -- control loop ----------------------------------------------------

    def tick(self, now: float) -> List[ScaleEvent]:
        """One control-loop step: consult the policy, clamp to bounds
        and (for scale-down) the cooldown, actuate. Scale-up spawns as
        many replicas as the policy keeps demanding in one tick — the
        policy sees the growing warming capacity between spawns, so a
        2x burst gets its reinforcements immediately instead of one
        per control period; scale-down trims at most one replica per
        tick. Returns the events actuated (transports schedule
        cold-start READY wake-ups for spawns and re-dispatch after
        decommissions)."""
        if self._t0 is None:
            # direct-use fallback: the first tick fires one interval
            # after the clock origin (transports normally anchor() it)
            self.anchor(now - self.cfg.interval)
        out: List[ScaleEvent] = []
        # the floor is an invariant, not a policy suggestion: a cluster
        # started below min_replicas — or wiped out by deaths — is
        # topped back up before the policy is even consulted (the
        # replacements pay the usual cold start before routing resumes)
        while self.n_committed() < self.cfg.min_replicas:
            out.append(self.spawn(now, 0.0))
        routable = self.coord.alive_replicas()
        if not routable:
            return out                  # dead / all-warming: nothing to read
        while True:
            warming_workers = sum(
                len(self.coord.engines[rid].residency)
                for rid in self._warming)
            delta, signal = self.policy.decide(
                self.coord, routable, now, warming_workers=warming_workers)
            committed = self.n_committed()
            if delta > 0:               # scale-up is undamped (reactive)
                if committed >= self.cfg.max_replicas:
                    return out
                out.append(self.spawn(now, signal))
                continue                # re-consult with the new warming
            if out or delta == 0:
                return out
            # scale-down waits out the cooldown after ANY scale event,
            # so a burst's reinforcements aren't torn down the moment
            # it ebbs — and trims one replica at a time
            if (committed <= self.cfg.min_replicas
                    or now - self._last_scale < self.cfg.cooldown):
                return out
            victim = self._pick_victim(routable)
            if victim is not None:
                out.append(self.decommission(victim, now, signal))
            return out

    def _pick_victim(self, routable) -> Optional[int]:
        """Cheapest replica to drain: least outstanding work; ties
        prefer the highest rid (latest spawned goes first)."""
        if len(routable) <= 1:
            return None                 # never decommission the last one
        return min(routable, key=lambda re: (re[1].outstanding(),
                                             -re[0]))[0]

    # -- actuation -------------------------------------------------------

    def spawn(self, now: float, signal: float = 0.0) -> ScaleEvent:
        """Commit a new replica group: the engine exists (and is billed)
        from now, but becomes routable only at ``now + cold_start`` —
        the transport calls ``activate`` then."""
        rid = len(self.coord.engines)
        self.coord.add_replica(self.engine_factory(rid), ready=False)
        ready_at = now + self.cold_start
        self._warming[rid] = ready_at
        self._spans[rid] = [now, None]
        self._last_scale = now
        ev = ScaleEvent(now, "spawn", rid, self.n_routable(),
                        self.n_committed(), signal, ready_at=ready_at)
        self.events.append(ev)
        return ev

    def activate(self, rid: int, now: float) -> List[int]:
        """Cold start paid: mark the replica routable. Returns its
        worker ids so the virtual-time event loop can register them."""
        self._warming.pop(rid, None)
        self.coord.mark_ready(rid)
        self.events.append(ScaleEvent(now, "ready", rid, self.n_routable(),
                                      self.n_committed()))
        return sorted(self.coord.engines[rid].residency.workers())

    def decommission(self, rid: int, now: float,
                     signal: float = 0.0) -> ScaleEvent:
        """Graceful scale-down through the surrender/drain path:
        the replica stops being routable, its queued work is re-routed
        through placement (EDF order), and in-flight batches finish on
        the old workers — a queue is never black-holed."""
        moved = self.coord.redistribute(rid, now)
        if self.migrate_fn is not None:
            self.migrate_fn(rid, moved)
        self._close_span(rid, now)
        self._last_scale = now
        ev = ScaleEvent(now, "decommission", rid, self.n_routable(),
                        self.n_committed(), signal,
                        drained=tuple(q.qid for q, _ in moved))
        self.events.append(ev)
        return ev

    def on_death(self, rid: int, now: float) -> None:
        """A replica died (fault injection) out from under the
        autoscaler: close its billing span and log it."""
        self._warming.pop(rid, None)
        self._close_span(rid, now)
        self.events.append(ScaleEvent(now, "death", rid, self.n_routable(),
                                      self.n_committed()))

    # -- accounting ------------------------------------------------------

    def _close_span(self, rid: int, now: float) -> None:
        span = self._spans.get(rid)
        if span is not None and span[1] is None:
            if span[0] is None:         # closed before the first tick
                span[0] = self._t0 if self._t0 is not None else 0.0
            span[1] = max(now, span[0])

    def finalize(self, t_end: float) -> None:
        """Close every open span at ``t_end`` (end of a run)."""
        for span in self._spans.values():
            if span[0] is None:         # never ticked: bill from origin
                span[0] = self._t0 if self._t0 is not None else 0.0
            if span[1] is None:
                span[1] = max(t_end, span[0])

    def replica_spans(self, t_end: Optional[float] = None
                      ) -> Dict[int, float]:
        """Per-replica active seconds. Open spans are valued up to
        ``t_end`` without being mutated (mid-run snapshots); call
        ``finalize`` for the terminal accounting instead."""
        out: Dict[int, float] = {}
        for rid, span in sorted(self._spans.items()):
            start = span[0] if span[0] is not None else self._t0
            if start is None:           # pre-anchor snapshot: key still
                out[rid] = 0.0          # present, nothing billed yet
                continue
            end = span[1] if span[1] is not None else \
                (t_end if t_end is not None else start)
            out[rid] = max(end - start, 0.0)
        return out

    def replica_seconds(self) -> float:
        return sum(self.replica_spans().values())
