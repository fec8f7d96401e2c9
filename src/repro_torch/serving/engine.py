"""Transport-agnostic scheduling core (paper §5) shared by the asyncio
``Router`` and the discrete-event ``Simulator``.

The paper describes ONE router architecture — global EDF queue, policy
invocation on worker availability, SubNetAct actuation — and this module
is its single implementation: admission + infeasible-query drop, EDF
ordering, policy invocation, batch formation, actuation-cost accounting
(control-swap vs weight-loading), fault handling with in-flight
re-enqueue, and per-query completion records. Time is injected (a
``Clock``), so the same core runs under wall clock with real JAX
workers (serving/runtime.py) and under virtual time (serving/
simulator.py and the parity tests).

Continuous batching (ROADMAP "in-flight joins"): when a dispatch drains
the queue below the policy's chosen batch size, the batch stays *open*
for a policy-chosen join window; queries arriving inside the window
join the forming batch (up to the profile's largest realizable batch
size), and the policy is re-consulted on every join so the subnet
choice can ride the batch up the Pareto frontier. A join is admitted
only if the batch still meets its earliest member deadline at launch.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.serving.forecast import ArrivalForecaster, ForecastConfig
from repro_torch.serving.metrics import summarize
from repro_torch.serving.policies import Policy
from repro_torch.serving.profiler import (RTX2080TI, SUBNETACT_ACTUATION_S,
                                    HardwareProfile, LatencyProfile)
from repro_torch.serving.queue import EDFQueue, Query
from repro_torch.serving.residency import ActuationModel, ResidencyTracker


# --------------------------------------------------------------------------
# Clocks
# --------------------------------------------------------------------------


class WallClock:
    """Monotonic wall clock — the asyncio router's default."""

    def now(self) -> float:
        return time.perf_counter()


class VirtualClock:
    """Manually-advanced clock — the simulator's and the parity tests'."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = float(t)


# --------------------------------------------------------------------------
# Engine state
# --------------------------------------------------------------------------


@dataclass
class EngineConfig:
    actuation_delay: float = SUBNETACT_ACTUATION_S
    load_on_switch: bool = False        # pay weight-loading on model change
    hw: HardwareProfile = RTX2080TI
    drop_infeasible: bool = True
    continuous_batching: bool = False
    max_join_window: float = 0.25       # hard cap (s) on batch-forming time
    # predictive join windows (ROADMAP "joins at saturation"): hold a
    # forming batch open — even on the pool's LAST free worker — when
    # the engine's arrival forecaster says a joinable arrival lands
    # within the batch's slack budget. Implies in-flight joins; with
    # predictive_joins=False the spare-capacity-only join gate is the
    # whole rule (pinned in tests/test_engine.py).
    predictive_joins: bool = False
    join_eta_factor: float = 2.0        # window = eta_factor * forecast ETA
    # overload guard: no predictive window within this many forecast
    # windows of an infeasible-drop (drops = the engine's own overload
    # signal; holding the last worker while shedding load turns every
    # held capacity-second into misses behind it)
    drop_guard: float = 1.0
    forecast: Optional[ForecastConfig] = None   # None -> defaults


@dataclass
class Dispatch:
    """One batch bound to one worker, from formation to completion."""

    wid: int
    queries: List[Query]
    pareto_idx: int
    batch_deadline: float = float("inf")  # earliest member deadline
    open: bool = False                  # still admitting in-flight joins
    launch_at: Optional[float] = None   # when an open batch must launch
    joined: int = 0                     # queries admitted after formation
    # filled by SchedulingEngine.launch()
    launched: bool = False
    t_launch: Optional[float] = None
    service: Optional[float] = None     # expected service latency (s)
    acc: Optional[float] = None
    # transport-owned actual finish time (may differ from t_launch +
    # service under stragglers)
    t_finish: Optional[float] = None
    faulted: bool = False


@dataclass
class DispatchRecord:
    t: float
    worker: int
    batch: int
    pareto_idx: int
    acc: float
    latency: float
    queue_len: int
    replica: int = 0
    # continuous-batching introspection: members admitted after batch
    # formation, and the earliest member deadline the launch was checked
    # against — the deadline-soundness property (tests/test_engine.py)
    # asserts t + latency <= batch_deadline whenever joined > 0
    joined: int = 0
    batch_deadline: float = float("inf")


@dataclass(frozen=True)
class CompletionRecord:
    """Per-query outcome — the parity unit between router and simulator."""

    qid: int
    arrival: float
    deadline: float
    finish: Optional[float]
    served_acc: Optional[float]
    dropped: bool
    replica: int = 0


def completion_records(queries: Iterable[Query]) -> List[CompletionRecord]:
    return [CompletionRecord(q.qid, q.arrival, q.deadline, q.finish,
                             q.served_acc, q.dropped, q.replica)
            for q in sorted(queries, key=lambda q: q.qid)]


class SchedulingEngine:
    """The shared scheduling state machine. Callers (transports) own
    time and execution; the engine owns every scheduling decision."""

    def __init__(self, profile: LatencyProfile, policy: Policy,
                 cfg: Optional[EngineConfig] = None,
                 worker_ids: Iterable[int] = (),
                 on_drop: Optional[Callable[[Query], None]] = None,
                 replica_id: int = 0):
        self.profile = profile
        self.policy = policy
        self.cfg = cfg or EngineConfig()
        self.on_drop = on_drop
        self.replica_id = int(replica_id)
        policy.reset()
        self.min_service = float(profile.lat.min())
        self.edf = EDFQueue()
        self.queries: List[Query] = []          # every admitted query
        # single owner of per-worker subnet residency and switch-cost
        # estimation (serving/residency.py); the engine is the only
        # writer — everything else (placement, policies, autoscaler)
        # reads through it
        self.residency = ResidencyTracker(
            profile,
            ActuationModel(actuation_delay=self.cfg.actuation_delay,
                           load_on_switch=self.cfg.load_on_switch,
                           hw=self.cfg.hw),
            worker_ids=worker_ids)
        self.inflight: Dict[int, Dispatch] = {}   # forming or executing
        self.open_batches: Dict[int, Dispatch] = {}
        self.dispatches: List[DispatchRecord] = []
        self.n_joins = 0                        # queries joined in flight
        self.n_open_batches = 0                 # batches that opened a window
        self.n_predictive_windows = 0           # opened with no spare worker
        # in-flight joins are live if either flavor is on; the engine's
        # own forecaster exists only for predictive windows (fed at
        # admission — transports never touch it)
        self._batching = bool(self.cfg.continuous_batching
                              or self.cfg.predictive_joins)
        self.forecaster: Optional[ArrivalForecaster] = (
            ArrivalForecaster(self.cfg.forecast)
            if self.cfg.predictive_joins else None)
        self._last_drop_t = float("-inf")   # predictive-window overload gate

    # -- admission -----------------------------------------------------

    def admit(self, q: Query) -> None:
        q.replica = self.replica_id
        self.queries.append(q)
        self.edf.push(q)
        if self.forecaster is not None:
            self.forecaster.observe(q.arrival)

    def drop_expired(self, now: float) -> List[Query]:
        """Drop queries that cannot meet their deadline even at the
        fastest control choice (the paper's infeasible-query drop)."""
        if not self.cfg.drop_infeasible:
            return []
        dropped = self.edf.drop_expired(now, self.min_service)
        if dropped:
            self._last_drop_t = now
        if self.on_drop is not None:
            for q in dropped:
                self.on_drop(q)
        return dropped

    # -- batch formation -----------------------------------------------

    def next_dispatch(self, wid: int, now: float) -> Optional[Dispatch]:
        """Worker ``wid`` is available: drop infeasible queries, consult
        the policy, and form a batch. The returned dispatch is either
        closed (caller launches it immediately) or open to in-flight
        joins until ``launch_at``. Returns None when nothing remains."""
        self.drop_expired(now)
        if not len(self.edf):
            return None
        slack = self.edf.head_slack(now)
        dec = self.policy.choose(self.profile, slack, len(self.edf),
                                 residency=self.residency.view(wid))
        if dec is None:
            return None
        batch = self.edf.pop_batch(dec.batch_size)
        d = Dispatch(wid=wid, queries=batch, pareto_idx=dec.pareto_idx,
                     batch_deadline=min(q.deadline for q in batch))
        self.inflight[wid] = d
        # Open a join window with spare capacity (the base rule: holding
        # the pool's LAST free worker would delay the very queries a
        # window is meant to batch) — or, with predictive joins, even on
        # the last worker when the forecast says a joinable arrival
        # lands within the slack budget (the saturation case where
        # spare-capacity-only joins stall: waiting one forecast ETA
        # grows the batch instead of burning a dispatch on it).
        if (self._batching and not len(self.edf)
                and len(batch) < self.profile.batches[-1]):
            # Size the budget for the batch's *next realizable size at
            # its current subnet*: waiting longer than (slack − that
            # grown batch's service time) would endanger the deadline.
            est = self._service_estimate(wid, d.pareto_idx,
                                         self._next_batch(len(batch)))
            budget = min(d.batch_deadline - now - est,
                         dec.join_window, self.cfg.max_join_window)
            window, predicted = 0.0, False
            if len(self.residency) > len(self.inflight):
                window = budget
            elif (self.forecaster is not None
                    # never hold the last worker while shedding load: a
                    # recent infeasible-drop means the pool is in
                    # overload, where every held capacity-second turns
                    # into deadline misses behind it (the deep-overload
                    # regression guard, see tests/test_engine.py)
                    and now - self._last_drop_t
                    >= self.cfg.drop_guard * self.forecaster.cfg.window):
                eta = self.forecaster.eta(now)
                if (self.forecaster.has_signal(now) and eta is not None
                        and eta <= budget):
                    window = min(self.cfg.join_eta_factor * eta, budget)
                    predicted = True
            if window > 1e-9:
                d.open = True
                d.launch_at = now + window
                self.open_batches[wid] = d
                self.n_open_batches += 1
                if predicted:
                    self.n_predictive_windows += 1
        return d

    def _next_batch(self, size: int) -> int:
        """Smallest profiled batch size strictly above ``size``."""
        for b in self.profile.batches:
            if b > size:
                return b
        return self.profile.batches[-1]

    def try_join(self, now: float) -> List[Dispatch]:
        """Continuous batching: admit queued queries into open batches.
        Each join re-consults the policy (the subnet choice rides the
        batch up the Pareto frontier) and is accepted only if the batch
        still meets its earliest deadline at launch. Returns batches
        that filled up (or turned urgent) and must launch *now*."""
        if not self._batching or not self.open_batches:
            return []
        ready: List[Dispatch] = []
        max_b = self.profile.batches[-1]
        for wid, d in list(self.open_batches.items()):
            if d.launched or d.faulted:
                continue
            while len(self.edf) and len(d.queries) < max_b:
                head = self.edf.peek()
                bd = min(d.batch_deadline, head.deadline)
                size = len(d.queries) + 1
                # keep waiting until launch_at if the grown batch still
                # fits: prefer the re-consulted (load-adaptive) policy
                # choice, else keep the batch's current subnet. Under
                # wall clock the window may have already expired (the
                # launch timer not yet fired) — never assess feasibility
                # at a launch time in the past.
                pi = self._feasible_pi(wid, d, size, bd,
                                       max(d.launch_at, now))
                if pi is not None:
                    self._join(d, pi, bd)
                    continue
                # grown batch too slow to keep waiting — join only if
                # launching immediately still meets the deadline
                pi = self._feasible_pi(wid, d, size, bd, now)
                if pi is not None:
                    self._join(d, pi, bd)
                # joined or not, stop holding the worker: launch immediately
                # so capacity frees earliest (degrades to decision-time)
                d.launch_at = now
                ready.append(d)
                break
            if len(d.queries) >= max_b and not any(r is d for r in ready):
                d.launch_at = now
                ready.append(d)
        return ready

    def _feasible_pi(self, wid: int, d: Dispatch, size: int, bd: float,
                     t_launch: float) -> Optional[int]:
        """Subnet for the grown batch launching at ``t_launch``: the
        re-consulted policy choice if deadline-feasible (the batch rides
        the Pareto frontier with the policy — up in light moments, down
        under pressure), else the batch's current subnet if *it* still
        fits; None when the join is infeasible either way."""
        dec = self.policy.choose(self.profile, bd - t_launch, size,
                                 residency=self.residency.view(wid))
        if dec is not None and t_launch + self._service_estimate(
                wid, dec.pareto_idx, size) <= bd:
            return dec.pareto_idx
        if t_launch + self._service_estimate(
                wid, d.pareto_idx, size) <= bd:
            return d.pareto_idx
        return None

    def hold(self, wid: int) -> Dispatch:
        """Mark a worker busy without a real batch (the simulator's
        backup-batch hedging) so the spare-capacity gate and fault
        handling see it; released when its FREE event fires."""
        d = Dispatch(wid=wid, queries=[], pareto_idx=-1)
        self.inflight[wid] = d
        return d

    def _join(self, d: Dispatch, pareto_idx: int, batch_deadline: float) -> None:
        q = self.edf.pop()
        d.queries.append(q)
        d.batch_deadline = batch_deadline
        d.pareto_idx = pareto_idx
        d.joined += 1
        self.n_joins += 1

    def _service_estimate(self, wid: int, pi: int, batch_size: int) -> float:
        lat = self.profile.latency(pi, max(batch_size, 1))
        return self.residency.penalized(lat, wid, pi)

    # -- actuation + completion ----------------------------------------

    def launch(self, d: Dispatch, now: float) -> Dispatch:
        """Close batch formation: compute expected service latency and
        account actuation cost (SubNetAct control-swap vs model-switch
        weight loading) against the worker's resident subnet."""
        eff_b = len(d.queries)
        lat = self._service_estimate(d.wid, d.pareto_idx, eff_b)
        self.residency.actuate(d.wid, d.pareto_idx)
        d.t_launch = now
        d.service = lat
        d.acc = float(self.profile.accs[d.pareto_idx])
        d.open = False
        d.launched = True
        self.open_batches.pop(d.wid, None)
        self.dispatches.append(DispatchRecord(now, d.wid, eff_b, d.pareto_idx,
                                              d.acc, lat, len(self.edf),
                                              replica=self.replica_id,
                                              joined=d.joined,
                                              batch_deadline=d.batch_deadline))
        return d

    def complete(self, d: Dispatch, finish: float) -> List[Query]:
        """Stamp per-query completion records for a finished batch."""
        if d.faulted:
            return []
        for q in d.queries:
            q.finish = finish
            q.served_acc = d.acc
        if self.inflight.get(d.wid) is d:
            del self.inflight[d.wid]
        return d.queries

    # -- faults --------------------------------------------------------

    def fault(self, wid: int) -> List[Query]:
        """Worker died: transparently re-enqueue its in-flight (forming
        or executing) queries so survivors re-serve them (Fig 11a)."""
        self.open_batches.pop(wid, None)
        self.residency.forget(wid)
        d = self.inflight.pop(wid, None)
        if d is None:
            return []
        d.faulted = True
        for q in d.queries:
            q.finish = None
            q.served_acc = None
            self.edf.push(q)
        return d.queries

    def surrender_queue(self) -> List[Query]:
        """Hand every queued query back, most urgent first, without
        marking anything dropped (replica-death path: the coordinator
        re-routes the orphans to surviving replicas). Call after
        ``fault()`` has pushed in-flight queries back into the queue so
        they are surrendered too."""
        return self.edf.drain()

    # -- placement introspection ---------------------------------------
    # Read-only views the cluster coordinator's placement policies use;
    # never consulted by the engine's own scheduling path.

    def queue_depth(self) -> int:
        return len(self.edf)

    def inflight_depth(self) -> int:
        """Queries currently bound to workers (forming or executing)."""
        return sum(len(d.queries) for d in self.inflight.values())

    def outstanding(self) -> int:
        """Total unfinished load: queued + in-flight queries (the
        load-aware placement and autoscaler victim-selection signal)."""
        return len(self.edf) + self.inflight_depth()

    def work_ahead(self, deadline: float) -> int:
        """Queued queries that EDF would serve before an arrival with
        ``deadline``."""
        return self.edf.count_more_urgent(deadline)

    def projected_start(self, deadline: float, now: float) -> float:
        """Deterministic estimate (s) of when an arrival with
        ``deadline`` could start on this replica: remaining in-flight
        service plus the EDF work *ahead of it* (queued queries with
        later deadlines would be served after it, so they don't delay
        it) at the fastest control choice, spread over the worker pool.
        An optimistic lower bound — placement only needs a consistent
        relative ordering across replicas, not truth."""
        busy = 0.0
        for d in self.inflight.values():
            if d.t_finish is not None:
                busy += max(0.0, d.t_finish - now)
            elif d.service is not None:
                busy += d.service
            else:
                busy += self.min_service
        ahead = self.work_ahead(deadline) * self.min_service
        return (busy + ahead) / max(len(self.residency), 1)

    def resident_subnets(self) -> Dict[int, Optional[int]]:
        """Worker -> resident subnet map (read-only copy), alongside
        ``queue_depth``/``work_ahead`` in the placement surface."""
        return self.residency.residency()

    def likely_subnet(self, slack: float) -> int:
        """Subnet the policy would pick for an arrival with ``slack``
        joining this replica's queue — the placement-side estimate of
        what routing a query here would actuate. Read-only and
        worker-independent (no residency bias), so it prices the
        *demand*, not a particular worker."""
        dec = self.policy.choose(self.profile, slack,
                                 self.queue_depth() + 1)
        if dec is not None:
            return dec.pareto_idx
        return int(self.profile.lat[:, 0].argmin())

    def projected_switch_cost(self, pi: int) -> float:
        """Cheapest actuation cost any of this replica's workers would
        pay to serve subnet ``pi`` (0.0 when one is already resident)."""
        return self.residency.min_switch_cost(pi)

    def projected_drain(self, now: float) -> float:
        """Estimate (s) of when this replica would drain ALL queued +
        in-flight work (the start estimate for an arrival behind
        everything)."""
        return self.projected_start(float("inf"), now)

    # -- accounting ----------------------------------------------------

    def abandon_pending(self) -> List[Query]:
        """Mark still-queued queries dropped (router drain path)."""
        out = self.edf.drain()
        for q in out:
            q.dropped = True
        return out

    def records(self) -> List[CompletionRecord]:
        return completion_records(self.queries)

    def stats(self) -> Dict[str, float]:
        return summarize(self.queries, n_joins=self.n_joins,
                         n_switches=self.residency.n_switches,
                         n_dispatches=self.residency.n_launches,
                         actuation_seconds=self.residency.actuation_seconds)


# --------------------------------------------------------------------------
# Deterministic event-driven driver (virtual time)
# --------------------------------------------------------------------------

# event kinds, ordered so simultaneous events process deterministically
EV_ARRIVAL, EV_FAULT, EV_FREE, EV_LAUNCH = 0, 1, 2, 3

# service_fn(dispatch, now, idle_worker_ids, push_event) -> actual latency
ServiceFn = Callable[[Dispatch, float, List[int], Callable], float]


def drive(engine: SchedulingEngine, queries: Sequence[Query],
          worker_ids: Iterable[int],
          fault_times: Optional[Dict[int, float]] = None,
          service_fn: Optional[ServiceFn] = None,
          clock: Optional[VirtualClock] = None) -> None:
    """Run the engine to quiescence under virtual time.

    This is the one discrete-event loop behind both the Simulator and
    the Router's parity mode. ``service_fn`` lets the simulator perturb
    the engine's expected latency (stragglers, backup-batch hedging);
    the default is the engine's own estimate. ``push_event`` hands the
    hook ``(t, kind, ident)`` insertion for backup-batch FREE events.
    """
    events: List = [(q.arrival, EV_ARRIVAL, q.qid) for q in queries]
    for wid, t in (fault_times or {}).items():
        events.append((float(t), EV_FAULT, int(wid)))
    heapq.heapify(events)
    idle: List[int] = list(worker_ids)
    dead: set = set()
    qmap = {q.qid: q for q in queries}

    def push(t: float, kind: int, ident: int) -> None:
        heapq.heappush(events, (t, kind, ident))

    def start(d: Dispatch, now: float) -> None:
        engine.launch(d, now)
        lat = d.service if service_fn is None else service_fn(d, now, idle, push)
        d.t_finish = now + lat
        push(d.t_finish, EV_FREE, d.wid)

    def dispatch_all(now: float) -> None:
        while idle and len(engine.edf):
            wid = idle.pop(0)
            d = engine.next_dispatch(wid, now)
            if d is None:
                idle.insert(0, wid)
                break
            if d.open:
                push(d.launch_at, EV_LAUNCH, wid)
            else:
                start(d, now)
        for d in engine.try_join(now):
            start(d, now)

    while events:
        now, kind, ident = heapq.heappop(events)
        if clock is not None:
            clock.advance_to(now)
        if kind == EV_ARRIVAL:
            engine.admit(qmap[ident])
            dispatch_all(now)
        elif kind == EV_FREE:
            if ident in dead:
                continue
            d = engine.inflight.get(ident)
            if d is not None and d.launched:
                engine.complete(d, d.t_finish)
            elif d is not None and not d.queries:
                engine.inflight.pop(ident, None)   # held hedge backup
            idle.append(ident)
            dispatch_all(now)
        elif kind == EV_LAUNCH:
            d = engine.open_batches.get(ident)
            # launch_at must match the event time: a stale event (its
            # batch already launched early) must not fire a *newer* open
            # batch that happens to occupy the same worker
            if (d is not None and not d.launched and not d.faulted
                    and d.launch_at == now):
                start(d, now)
        elif kind == EV_FAULT:
            dead.add(ident)
            if ident in idle:
                idle.remove(ident)
            engine.fault(ident)
            dispatch_all(now)
