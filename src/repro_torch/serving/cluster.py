"""Multi-replica serving plane: cluster coordinator + replica-aware
placement (ROADMAP "serving scale-out").

The paper's router (§5) schedules one worker pool; a datacenter runs
many. This module converts the serving stack from "the engine" to "a
set of engines behind a coordinator":

  * each **replica group** runs its own, unchanged ``SchedulingEngine``
    (EDF queue, policy invocation, continuous batching, fault
    re-enqueue — exactly the single-replica core, per replica);
  * a **ClusterCoordinator** owns global admission and routes every
    query to one replica via a pluggable ``PlacementPolicy``
    (round-robin, least-loaded, power-of-two-choices, slack-aware,
    actuation-aware);
  * replica death drains the dead replica's EDF queue — including the
    in-flight queries its worker faults re-enqueued — back through the
    coordinator, which re-routes the orphans to survivors.

Division of labor, extending the base rule: *scheduling* logic lives in
the engine only; *placement and scaling* logic live in the coordinator
layer only (placement here, the reactive replica lifecycle in
serving/autoscaler.py riding on this coordinator's ``add_replica`` /
``mark_ready`` / ``redistribute`` surface). Transports stay thin:
``drive_cluster`` below is the one discrete-event loop shared by the
``ClusterSimulator`` (serving/simulator.py) and the ``ClusterRouter``'s
parity mode (serving/runtime.py) — a single event heap across all
replicas (scale ticks included), so multi-replica schedules are exactly
as deterministic as single-replica ones.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import (EV_ARRIVAL, EV_FAULT, EV_FREE, EV_LAUNCH,
                                  CompletionRecord, Dispatch, EngineConfig,
                                  SchedulingEngine, VirtualClock,
                                  completion_records)
from repro_torch.serving.forecast import ArrivalForecaster, ForecastConfig
from repro_torch.serving.metrics import cluster_summarize
from repro_torch.serving.policies import Policy
from repro_torch.serving.profiler import LatencyProfile
from repro_torch.serving.queue import Query

# replica-death events carry this sentinel instead of a worker id
ALL_WORKERS = -1

# cluster-only event kinds, continuing engine.py's EV_* numbering so
# simultaneous events keep a deterministic total order: a replica
# becoming ready (cold start paid) processes before the scale tick
# that might read it, and both after all serving events at that time
EV_READY, EV_SCALE = 4, 5


# --------------------------------------------------------------------------
# Placement policies
# --------------------------------------------------------------------------


class PlacementPolicy:
    """Pluggable replica-selection API. ``choose`` sees the *alive*
    replicas as ``(rid, engine)`` pairs and must return one of the
    offered rids; engines are read-only here (introspection methods
    ``queue_depth`` / ``inflight_depth`` / ``work_ahead`` /
    ``projected_drain`` / ``resident_subnets`` /
    ``projected_switch_cost`` only — placement never touches a queue
    and never actuates a subnet)."""

    name: str = "base"

    def reset(self, n_replicas: int, seed: int = 0) -> None:
        pass

    def choose(self, replicas: Sequence[Tuple[int, SchedulingEngine]],
               q: Query, now: float) -> int:
        raise NotImplementedError


class RoundRobin(PlacementPolicy):
    """Cycle through alive replicas in rid order — the classic
    load-oblivious baseline."""

    name = "round_robin"

    def reset(self, n_replicas: int, seed: int = 0) -> None:
        self._i = 0

    def choose(self, replicas, q, now):
        rid = replicas[self._i % len(replicas)][0]
        self._i += 1
        return rid


class LeastLoaded(PlacementPolicy):
    """Join the replica with the smallest total outstanding load
    (queued + in-flight queries); ties break toward the lowest rid."""

    name = "least_loaded"

    def choose(self, replicas, q, now):
        return min(replicas, key=lambda re: (re[1].outstanding(), re[0]))[0]


class PowerOfTwo(PlacementPolicy):
    """Power-of-two-choices (Mitzenmacher): sample two replicas, join
    the less loaded — near-optimal balance at O(1) state. Seeded rng so
    cluster schedules stay deterministic and transport-independent."""

    name = "power_of_two"

    def reset(self, n_replicas: int, seed: int = 0) -> None:
        self._rng = np.random.default_rng(seed)

    def choose(self, replicas, q, now):
        if len(replicas) == 1:
            return replicas[0][0]
        i, j = self._rng.choice(len(replicas), size=2, replace=False)
        a, b = replicas[int(i)], replicas[int(j)]
        ka = (a[1].outstanding(), a[0])
        kb = (b[1].outstanding(), b[0])
        return a[0] if ka <= kb else b[0]


class SlackAware(PlacementPolicy):
    """Deadline-aware routing: a *tight* query goes to the replica that
    can *start it* soonest (``projected_start``: in-flight work plus
    only the EDF queue ahead of its deadline, weighted by pool capacity
    — queued later-deadline work doesn't repel a tight query, since EDF
    serves it first anyway); with generous slack the queue joined
    barely matters, so relaxed queries round-robin to keep load spread.

    What counts as *tight* is learned from the observed slack
    distribution (ROADMAP open item): the threshold is the midpoint of
    the rolling 25th/75th-percentile slacks over the last ``window``
    placements, so a bimodal trace splits between its own modes instead
    of on a fixed multiple of the fastest service time (which misroutes
    whenever both modes sit on the same side of it). A query at the
    threshold counts as tight (``<=``), so a degenerate uniform-slack
    trace — e.g. every query at the paper's 36 ms SLO — routes every
    query by earliest start; skewed mixes likewise err toward *tight*,
    which costs a start-estimate scan, never a misroute. Until
    ``min_history`` slacks are seen the fixed ``tight_mult`` x
    fastest-service fallback applies (and is the whole rule when
    ``adaptive=False``)."""

    name = "slack_aware"

    def __init__(self, tight_mult: float = 10.0, adaptive: bool = True,
                 window: int = 256, min_history: int = 32):
        self.tight_mult = tight_mult
        self.adaptive = adaptive
        self.window = int(window)
        self.min_history = int(min_history)

    def reset(self, n_replicas: int, seed: int = 0) -> None:
        self._i = 0
        self._slacks: deque = deque(maxlen=self.window)
        self._thr: Optional[float] = None   # cached learned threshold
        self._n_seen = 0

    def _threshold(self, min_service: float) -> float:
        if self.adaptive and self._thr is not None:
            return self._thr
        return self.tight_mult * min_service

    def _observe(self, slack: float) -> None:
        """Record a placement-time slack; refresh the learned threshold
        every ``min_history`` observations — the distribution moves
        slowly by construction, and a per-query percentile sort would
        put O(window log window) on the placement hot path."""
        self._slacks.append(slack)
        self._n_seen += 1
        if (self._n_seen >= self.min_history
                and self._n_seen % self.min_history == 0):
            lo, hi = np.percentile(self._slacks, (25, 75))
            self._thr = float(lo + hi) / 2.0

    def choose(self, replicas, q, now):
        slack = q.deadline - now
        thr = self._threshold(replicas[0][1].min_service)
        if self.adaptive:
            self._observe(slack)
        if slack <= thr:
            return min(replicas,
                       key=lambda re: (re[1].projected_start(q.deadline, now),
                                       re[0]))[0]
        rid = replicas[self._i % len(replicas)][0]
        self._i += 1
        return rid


class ActuationAware(PlacementPolicy):
    """Residency-aware routing (ROADMAP "actuation-stationary
    serving"): score every routable replica by when it could *start*
    the query (``projected_start`` — the slack_aware tight-path signal)
    plus ``blend`` times the projected *switch cost* of actuating the
    subnet the query would demand there (``likely_subnet`` x the
    replica's cheapest residency match, both from the engine's
    residency introspection). Route to the cheapest sum, ties toward
    the lowest rid.

    In the SubNetAct regime a switch is a ~50 µs control swap, so this
    degrades gracefully toward slack_aware's earliest-start rule; in
    the weight-loading regime (``load_on_switch``, the Clipper+/INFaaS
    cost model) a switch is a full page-in, and keeping queries on
    replicas already resident on their subnet is the difference between
    batches that meet their deadline and batches that burn it on PCIe.
    Placement stays read-only: residency is consulted, never mutated —
    only the chosen replica's engine actuates at launch."""

    name = "actuation_aware"

    def __init__(self, blend: float = 1.0):
        self.blend = float(blend)

    def choose(self, replicas, q, now):
        slack = max(q.deadline - now, 0.0)

        def score(re):
            rid, e = re
            pi = e.likely_subnet(slack)
            return (e.projected_start(q.deadline, now)
                    + self.blend * e.projected_switch_cost(pi), rid)

        return min(replicas, key=score)[0]


PLACEMENTS: Dict[str, type] = {
    "round_robin": RoundRobin,
    "least_loaded": LeastLoaded,
    "power_of_two": PowerOfTwo,
    "slack_aware": SlackAware,
    "actuation_aware": ActuationAware,
}


def make_placement(name: str) -> PlacementPolicy:
    try:
        return PLACEMENTS[name]()
    except KeyError:
        raise ValueError(f"unknown placement {name!r}; "
                         f"choose from {sorted(PLACEMENTS)}") from None


# --------------------------------------------------------------------------
# Coordinator
# --------------------------------------------------------------------------


class ClusterCoordinator:
    """Global admission + replica routing over N per-replica engines.

    The coordinator owns the master query list (each query admitted to
    the cluster exactly once, however many replicas it visits after
    deaths), the placement policy, and replica liveness. All scheduling
    *within* a replica stays in that replica's engine."""

    def __init__(self, engines: Sequence[SchedulingEngine],
                 placement: PlacementPolicy, placement_seed: int = 0,
                 forecast: Optional[ForecastConfig] = None):
        if not engines:
            raise ValueError("a cluster needs at least one replica")
        self.engines = list(engines)
        self.alive: List[bool] = [True] * len(self.engines)
        # routable = alive AND ready; a replica spawned by the
        # autoscaler is alive-but-warming (cold start) until mark_ready
        self.ready: List[bool] = [True] * len(self.engines)
        self.placement = placement
        placement.reset(len(self.engines), seed=placement_seed)
        self.queries: List[Query] = []      # master admission list
        # cluster-level arrival forecaster (serving/forecast.py): fed
        # once per cluster admission, consumed by forecast-led scaling
        # policies and surfaced through forecast_snapshot — forecasting
        # state lives in the forecaster only, transports never mutate it
        self.forecaster: Optional[ArrivalForecaster] = (
            ArrivalForecaster(forecast) if forecast is not None else None)

    # -- liveness / views ----------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def alive_replicas(self) -> List[Tuple[int, SchedulingEngine]]:
        """Routable replicas: alive and past their cold start."""
        return [(rid, e) for rid, e in enumerate(self.engines)
                if self.alive[rid] and self.ready[rid]]

    # -- replica lifecycle (the autoscaler's surface) -------------------

    def add_replica(self, engine: SchedulingEngine,
                    ready: bool = True) -> int:
        """Register a new replica group. ``ready=False`` keeps it
        unroutable until ``mark_ready`` (the cold-start window). The
        "engine" only needs the coordinator surface — the proc
        transport registers ``ReplicaProxy`` stand-ins here, both for
        autoscaler spawns and for replicas adopted from remote hosts,
        so placement and lifecycle never notice the process (or host)
        boundary."""
        rid = len(self.engines)
        self.engines.append(engine)
        self.alive.append(True)
        self.ready.append(bool(ready))
        return rid

    def mark_ready(self, rid: int) -> None:
        self.ready[rid] = True

    # -- admission -----------------------------------------------------

    def select(self, q: Query, now: float) -> int:
        """Placement decision only: which alive replica should take
        ``q``. The asyncio ClusterRouter admits through the chosen
        replica's own lock, so selection and admission are split."""
        replicas = self.alive_replicas()
        if not replicas:
            raise RuntimeError("no alive replicas left in the cluster")
        return int(self.placement.choose(replicas, q, now))

    def route(self, q: Query, now: float) -> int:
        """Place an existing query on an alive replica (no master-list
        append — the re-route path)."""
        rid = self.select(q, now)
        self.engines[rid].admit(q)          # stamps q.replica = rid
        return rid

    def observe(self, q: Query) -> None:
        """Feed the cluster-level forecaster one admission. Split from
        ``admit`` because the asyncio front door appends to the master
        list itself (its admission goes through the chosen replica's
        lock) — both paths must observe exactly once per arrival."""
        if self.forecaster is not None:
            self.forecaster.observe(q.arrival)

    def admit(self, q: Query, now: float) -> Optional[int]:
        """Cluster front door: record the query once and route it.
        With no routable replica (every one dead, or the survivors all
        still warming) there is nowhere to route — the query is dropped
        (recorded, never served) and None returned."""
        self.queries.append(q)
        self.observe(q)
        if not self.alive_replicas():
            q.dropped = True
            return None
        return self.route(q, now)

    # -- replica death -------------------------------------------------

    def should_decommission(self, rid: int) -> bool:
        """THE decommission rule, stated once for both transports: an
        alive replica whose worker pool is gone can never serve again —
        leave it routable and it black-holes every query placed on
        it."""
        return self.alive[rid] and not len(self.engines[rid].residency)

    def fail_replica(self, rid: int, now: float) -> List[Tuple[Query, int]]:
        """Replica ``rid`` died: fault every worker (re-enqueueing its
        in-flight queries through the engine's own fault path), then
        drain the replica's queue back through placement. Returns the
        re-routed ``(query, new_rid)`` pairs, in EDF order."""
        eng = self.engines[rid]
        for wid in eng.residency.workers():
            eng.fault(wid)
        return self.redistribute(rid, now)

    def redistribute(self, rid: int, now: float) -> List[Tuple[Query, int]]:
        """Drain-and-re-route the replica's queue back through
        placement: THE surrender/drain path, shared by replica death
        (workers already faulted, so the re-enqueued in-flight queries
        are surrendered too) and by the autoscaler's graceful
        decommission (workers untouched — their in-flight batches
        finish on the old replica). With no routable replica left the
        orphans are dropped instead of black-holed."""
        self.alive[rid] = False
        orphans = self.engines[rid].surrender_queue()
        if not self.alive_replicas():
            for q in orphans:
                q.dropped = True
            return []
        return [(q, self.route(q, now)) for q in orphans]

    # -- forecast introspection -----------------------------------------

    def forecast_snapshot(self, now: float
                          ) -> Optional[Dict[str, Optional[float]]]:
        """Read-only forecast bundle (rate / trend / ETA / CV^2 / burst
        flag) at ``now``; None when no forecaster is configured. Both
        transports surface this (ClusterResult.forecast,
        ClusterRouter.stats) — reading it never perturbs the state."""
        if self.forecaster is None:
            return None
        return self.forecaster.snapshot(now)

    # -- residency introspection ----------------------------------------

    def residency_snapshot(self) -> Dict[int, Dict[int, Optional[int]]]:
        """Cluster-wide residency map, rid -> (worker -> resident
        subnet), over alive replicas — read-only (per-replica copies),
        for benchmarks and operator introspection."""
        return {rid: e.resident_subnets()
                for rid, e in enumerate(self.engines) if self.alive[rid]}

    # -- accounting ----------------------------------------------------

    def abandon_pending(self) -> List[Query]:
        out: List[Query] = []
        for eng in self.engines:
            out.extend(eng.abandon_pending())
        return out

    def records(self) -> List[CompletionRecord]:
        return completion_records(self.queries)

    def stats(self) -> Dict[str, float]:
        return cluster_summarize(
            self.queries, n_replicas=self.n_replicas,
            n_joins=sum(e.n_joins for e in self.engines),
            n_switches=sum(e.residency.n_switches for e in self.engines),
            n_dispatches=sum(e.residency.n_launches for e in self.engines),
            actuation_seconds=sum(e.residency.actuation_seconds
                                  for e in self.engines))


# --------------------------------------------------------------------------
# Shared discrete-event loop (virtual time, all replicas on one heap)
# --------------------------------------------------------------------------


def drive_cluster(coord: ClusterCoordinator, queries: Sequence[Query],
                  worker_ids: Dict[int, Iterable[int]],
                  replica_deaths: Optional[Dict[int, float]] = None,
                  fault_times: Optional[Dict[Tuple[int, int], float]] = None,
                  clock: Optional[VirtualClock] = None,
                  service_fn=None, autoscaler=None) -> None:
    """Run the whole cluster to quiescence under one virtual clock.

    The multi-replica analogue of ``engine.drive``: ONE event heap
    ordered ``(t, kind, rid, ident)`` spans every replica, so
    simultaneous events across replicas resolve deterministically and a
    1-replica cluster replays the single-engine loop event-for-event.
    ``service_fn(rid, dispatch, now) -> latency`` optionally perturbs
    the engine's expected service time (simulator stragglers).
    Replica deaths enter as FAULT events with the ``ALL_WORKERS``
    sentinel; per-worker faults as ``(rid, wid)``.

    With a ``ClusterAutoscaler`` (serving/autoscaler.py), periodic
    SCALE ticks run its control loop on this same heap: a spawn
    schedules a READY event after the cold start (only then do the new
    workers join the idle pool), a decommission re-routes the victim's
    queue through placement and wakes the survivors — while the
    victim's in-flight batches still complete (graceful drain). Ticks
    stop once arrivals are exhausted and all work has drained, so the
    loop still quiesces.
    """
    events: List = [(q.arrival, EV_ARRIVAL, 0, q.qid) for q in queries]
    for rid, t in (replica_deaths or {}).items():
        events.append((float(t), EV_FAULT, int(rid), ALL_WORKERS))
    for (rid, wid), t in (fault_times or {}).items():
        events.append((float(t), EV_FAULT, int(rid), int(wid)))
    t_last_arrival = max((q.arrival for q in queries), default=0.0)
    if autoscaler is not None:
        autoscaler.anchor(0.0)          # virtual time starts at 0
        events.append((autoscaler.cfg.interval, EV_SCALE, -1, 0))
    heapq.heapify(events)
    idle: Dict[int, List[int]] = {rid: list(wids)
                                  for rid, wids in worker_ids.items()}
    dead_workers: set = set()               # (rid, wid)
    qmap = {q.qid: q for q in queries}

    def push(t: float, kind: int, rid: int, ident: int) -> None:
        heapq.heappush(events, (t, kind, rid, ident))

    def start(rid: int, d: Dispatch, now: float) -> None:
        eng = coord.engines[rid]
        eng.launch(d, now)
        lat = d.service if service_fn is None else service_fn(rid, d, now)
        d.t_finish = now + lat
        push(d.t_finish, EV_FREE, rid, d.wid)

    def dispatch_all(rid: int, now: float) -> None:
        eng = coord.engines[rid]
        free = idle[rid]
        while free and len(eng.edf):
            wid = free.pop(0)
            d = eng.next_dispatch(wid, now)
            if d is None:
                free.insert(0, wid)
                break
            if d.open:
                push(d.launch_at, EV_LAUNCH, rid, wid)
            else:
                start(rid, d, now)
        for d in eng.try_join(now):
            start(rid, d, now)

    while events:
        now, kind, rid, ident = heapq.heappop(events)
        if clock is not None:
            clock.advance_to(now)
        if kind == EV_ARRIVAL:
            target = coord.admit(qmap[ident], now)
            if target is not None:      # None: whole cluster dead, dropped
                dispatch_all(target, now)
        elif kind == EV_FREE:
            # dead workers (their replica died) discard the batch; a
            # merely-decommissioned replica's workers are NOT dead —
            # their in-flight batches complete (graceful scale-down
            # drain), so only the per-worker death set gates here
            if (rid, ident) in dead_workers:
                continue
            eng = coord.engines[rid]
            d = eng.inflight.get(ident)
            if d is not None and d.launched:
                eng.complete(d, d.t_finish)
            elif d is not None and not d.queries:
                eng.inflight.pop(ident, None)
            idle[rid].append(ident)
            dispatch_all(rid, now)
        elif kind == EV_LAUNCH:
            d = coord.engines[rid].open_batches.get(ident)
            if (d is not None and not d.launched and not d.faulted
                    and d.launch_at == now):
                start(rid, d, now)
        elif kind == EV_FAULT:
            if rid >= len(coord.engines):   # fault injected for a rid
                continue                    # the autoscaler never spawned
            if ident == ALL_WORKERS:        # whole replica dies
                for wid in list(idle.get(rid, [])) + \
                        coord.engines[rid].residency.workers():
                    dead_workers.add((rid, wid))
                idle.get(rid, []).clear()
                was_alive = coord.alive[rid]
                coord.fail_replica(rid, now)
                if autoscaler is not None and was_alive:
                    autoscaler.on_death(rid, now)
                # orphans were re-routed through placement: wake every
                # surviving replica, in rid order, deterministically
                for other, _ in coord.alive_replicas():
                    dispatch_all(other, now)
            else:
                dead_workers.add((rid, ident))
                if ident in idle.get(rid, []):
                    idle[rid].remove(ident)
                coord.engines[rid].fault(ident)
                if coord.should_decommission(rid):
                    # last worker gone: re-route the queue (incl. the
                    # just-re-enqueued batch) to survivors
                    coord.redistribute(rid, now)
                    if autoscaler is not None:
                        autoscaler.on_death(rid, now)
                    for other, _ in coord.alive_replicas():
                        dispatch_all(other, now)
                elif coord.alive[rid]:
                    dispatch_all(rid, now)
                elif len(coord.engines[rid].edf):
                    # the fault re-enqueued an in-flight batch onto an
                    # already-decommissioned replica (scale-down racing
                    # a worker death): surrender it again — the queue
                    # must never silently strand
                    coord.redistribute(rid, now)
                    for other, _ in coord.alive_replicas():
                        dispatch_all(other, now)
        elif kind == EV_READY:              # cold start paid: join the pool
            if not coord.alive[rid]:
                continue                    # died while still warming
            idle[rid] = autoscaler.activate(rid, now)
            dispatch_all(rid, now)
        elif kind == EV_SCALE:
            for ev in autoscaler.tick(now):
                if ev.kind == "spawn":
                    idle[ev.rid] = []       # workers join at READY
                    push(ev.ready_at, EV_READY, ev.rid, 0)
                else:                       # decommission: queue re-routed —
                    for other, _ in coord.alive_replicas():
                        dispatch_all(other, now)   # wake the survivors
            if now <= t_last_arrival or any(
                    len(e.edf) or e.inflight for e in coord.engines):
                push(now + autoscaler.cfg.interval, EV_SCALE, -1, 0)


# --------------------------------------------------------------------------
# Construction helpers
# --------------------------------------------------------------------------


def replica_worker_counts(n_replicas: int,
                          workers_per_replica) -> List[int]:
    """Normalize an int (homogeneous) or per-replica sequence
    (heterogeneous pools — where load-aware placement earns its keep)
    into one worker count per replica."""
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if isinstance(workers_per_replica, int):
        counts = [workers_per_replica] * n_replicas
    else:
        counts = [int(w) for w in workers_per_replica]
        if len(counts) != n_replicas:
            raise ValueError(f"{len(counts)} worker counts for "
                             f"{n_replicas} replicas")
    if any(c < 1 for c in counts):
        raise ValueError("every replica needs at least one worker")
    return counts


def build_engines(profile: LatencyProfile, policy: Policy,
                  n_replicas: int, workers_per_replica,
                  cfg: Optional[EngineConfig] = None
                  ) -> List[SchedulingEngine]:
    """One engine per replica group, each with a *cloned* policy (per-
    replica policy state never couples replicas) and its own worker-id
    space 0..k-1. ``workers_per_replica`` is an int or a per-replica
    sequence."""
    counts = replica_worker_counts(n_replicas, workers_per_replica)
    return [SchedulingEngine(profile, policy.clone(),
                             cfg or EngineConfig(),
                             worker_ids=range(counts[rid]),
                             replica_id=rid)
            for rid in range(n_replicas)]
