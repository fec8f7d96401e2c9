"""Discrete-event transport for the shared scheduling engine (paper §5
architecture, §6 experiments).

All scheduling decisions — admission + infeasible-drop, EDF ordering,
policy invocation, batch formation (incl. continuous-batching joins),
actuation-cost accounting, fault re-enqueue — live in
``serving/engine.py``; this module only supplies virtual time and the
simulation-specific service model: per-batch latency from the profiler,
stragglers with optional backup-batch hedging, and worker fault events.
The asyncio runtime (serving/runtime.py) drives the *same* engine under
wall clock with real PyTorch workers.

Multi-replica: ``simulate_cluster`` runs N replica groups (one engine
each) behind a ``ClusterCoordinator`` on the single shared event loop
in ``serving/cluster.py`` — placement decisions live in the
coordinator, scheduling stays per-replica, and the whole cluster is as
deterministic as one engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.autoscaler import (AutoscaleConfig, ClusterAutoscaler,
                                      ScaleEvent, coordinator_forecast)
from repro_torch.serving.forecast import ForecastConfig
from repro_torch.serving.cluster import (ClusterCoordinator, build_engines,
                                   drive_cluster, make_placement,
                                   replica_worker_counts)
from repro_torch.serving.engine import (EV_FREE, CompletionRecord, DispatchRecord,
                                  Dispatch, EngineConfig, SchedulingEngine,
                                  completion_records, drive)
from repro_torch.serving.metrics import (cluster_summarize, latency_percentiles,
                                   mean_serving_accuracy, slo_attainment,
                                   summarize)
from repro_torch.serving.profiler import (SUBNETACT_ACTUATION_S, HardwareProfile,
                                    LatencyProfile, RTX2080TI)
from repro_torch.serving.policies import Policy
from repro_torch.serving.queue import Query


@dataclass
class SimConfig:
    n_workers: int = 8
    slo: float = 0.036                      # paper's 36ms default
    actuation_delay: float = SUBNETACT_ACTUATION_S
    load_on_switch: bool = False            # pay weight-loading on model change
    hw: HardwareProfile = RTX2080TI
    straggler_prob: float = 0.0
    straggler_factor: float = 3.0
    hedging: bool = False                   # backup-batch straggler mitigation
    hedge_trigger: float = 2.0              # x expected latency
    fault_times: Dict[int, float] = field(default_factory=dict)
    drop_infeasible: bool = True
    continuous_batching: bool = False       # in-flight joins (paper §5)
    max_join_window: float = 0.25           # cap (s) on batch-forming time
    predictive_joins: bool = False          # forecast-led windows at saturation
    forecast: Optional[ForecastConfig] = None   # None -> defaults
    seed: int = 0

    def engine_config(self) -> EngineConfig:
        return EngineConfig(actuation_delay=self.actuation_delay,
                            load_on_switch=self.load_on_switch, hw=self.hw,
                            drop_infeasible=self.drop_infeasible,
                            continuous_batching=self.continuous_batching,
                            max_join_window=self.max_join_window,
                            predictive_joins=self.predictive_joins,
                            forecast=self.forecast)


@dataclass
class SimResult:
    queries: List[Query]
    dispatches: List[DispatchRecord]
    duration: float
    n_joins: int = 0                        # queries joined in flight
    n_open_batches: int = 0                 # batches that opened a window
    n_predictive_windows: int = 0           # opened with no spare worker
    # residency accounting (serving/residency.py tracker counters)
    n_switches: int = 0                     # launches that changed subnet
    actuation_seconds: float = 0.0          # total switch cost paid

    @property
    def slo_attainment(self) -> float:
        return slo_attainment(self.queries)

    @property
    def mean_acc(self) -> float:
        return mean_serving_accuracy(self.queries)

    @property
    def latency_p50(self) -> float:
        return latency_percentiles(self.queries)[0]

    @property
    def latency_p99(self) -> float:
        return latency_percentiles(self.queries)[1]

    @property
    def records(self) -> List[CompletionRecord]:
        return completion_records(self.queries)

    def stats(self) -> Dict[str, float]:
        return summarize(self.queries, n_joins=self.n_joins,
                         n_switches=self.n_switches,
                         n_dispatches=len(self.dispatches),
                         actuation_seconds=self.actuation_seconds)

    def series(self, window: float = 1.0):
        """Per-window (t, qps, mean batch, mean acc) system dynamics."""
        if not self.queries:
            return np.zeros((0, 4))
        t_end = self.duration
        edges = np.arange(0.0, t_end + window, window)
        arr = np.array([q.arrival for q in self.queries])
        qps, _ = np.histogram(arr, edges)
        rows = []
        for i in range(len(edges) - 1):
            lo, hi = edges[i], edges[i + 1]
            ds = [d for d in self.dispatches if lo <= d.t < hi]
            rows.append((lo, qps[i] / window,
                         float(np.mean([d.batch for d in ds])) if ds else 0.0,
                         float(np.mean([d.acc for d in ds])) if ds else 0.0))
        return np.asarray(rows)


def simulate(arrivals: Sequence[float], profile: LatencyProfile,
             policy: Policy, cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)

    queries = [Query(deadline=float(t) + cfg.slo, seq=i, arrival=float(t), qid=i)
               for i, t in enumerate(arrivals)]
    duration = (float(arrivals[-1]) if len(arrivals) else 0.0) + 4 * cfg.slo

    engine = SchedulingEngine(profile, policy, cfg.engine_config(),
                              worker_ids=range(cfg.n_workers))

    def service(d: Dispatch, now: float, idle: List[int], push) -> float:
        """Simulation-owned service model: the engine's expectation,
        perturbed by stragglers, mitigated by backup-batch hedging."""
        lat = d.service
        if cfg.straggler_prob and rng.random() < cfg.straggler_prob:
            lat *= cfg.straggler_factor
            if cfg.hedging and idle:
                # backup batch on a spare worker after the trigger
                bwid = idle.pop(0)
                engine.hold(bwid)       # busy for the spare-capacity gate
                backup_fin = now + cfg.hedge_trigger * d.service + d.service
                lat = min(lat, backup_fin - now)
                push(backup_fin, EV_FREE, bwid)
        return lat

    drive(engine, queries, range(cfg.n_workers),
          fault_times=cfg.fault_times, service_fn=service)

    return SimResult(queries=queries, dispatches=engine.dispatches,
                     duration=duration, n_joins=engine.n_joins,
                     n_open_batches=engine.n_open_batches,
                     n_predictive_windows=engine.n_predictive_windows,
                     n_switches=engine.residency.n_switches,
                     actuation_seconds=engine.residency.actuation_seconds)


# --------------------------------------------------------------------------
# Cluster simulation (N replica groups behind one coordinator)
# --------------------------------------------------------------------------


@dataclass
class ClusterConfig:
    """Knobs for the multi-replica plane; per-replica scheduling knobs
    mirror ``SimConfig`` (stragglers/hedging stay single-replica sim
    features for now — the cluster service model is the engine's)."""

    n_replicas: int = 2
    # int (homogeneous) or per-replica sequence (heterogeneous pools)
    workers_per_replica: object = 4
    placement: str = "round_robin"
    placement_seed: int = 0
    slo: float = 0.036
    actuation_delay: float = SUBNETACT_ACTUATION_S
    load_on_switch: bool = False
    hw: HardwareProfile = RTX2080TI
    drop_infeasible: bool = True
    continuous_batching: bool = False
    max_join_window: float = 0.25
    predictive_joins: bool = False          # forecast-led windows at saturation
    # shared ForecastConfig: engine-level (predictive joins) AND
    # coordinator-level (predictive scaling / introspection). None ->
    # engine defaults; the coordinator forecaster then exists only when
    # the scaling policy is forecast-led (coordinator_forecast rule)
    forecast: Optional[ForecastConfig] = None
    # fault injection: whole replicas and/or single workers
    replica_deaths: Dict[int, float] = field(default_factory=dict)
    fault_times: Dict[Tuple[int, int], float] = field(default_factory=dict)
    # reactive replica autoscaling (serving/autoscaler.py); None keeps
    # the replica count static (byte-identical to the pre-autoscaler
    # cluster plane — guarded in tests/test_autoscaler.py)
    autoscale: Optional[AutoscaleConfig] = None

    def engine_config(self) -> EngineConfig:
        return EngineConfig(actuation_delay=self.actuation_delay,
                            load_on_switch=self.load_on_switch, hw=self.hw,
                            drop_infeasible=self.drop_infeasible,
                            continuous_batching=self.continuous_batching,
                            max_join_window=self.max_join_window,
                            predictive_joins=self.predictive_joins,
                            forecast=self.forecast)


@dataclass
class ClusterResult:
    queries: List[Query]                    # master list, cluster order
    dispatches: List[DispatchRecord]        # all replicas, time order
    duration: float
    n_replicas: int                         # replicas that ever existed
    n_joins: int = 0
    n_predictive_windows: int = 0           # windows opened with no spare
    # residency accounting, aggregated across every replica's tracker
    n_switches: int = 0
    actuation_seconds: float = 0.0
    # autoscaling accounting: per-replica active seconds (static runs
    # bill every replica for the whole duration) + the scale-event log
    replica_spans: Dict[int, float] = field(default_factory=dict)
    scale_events: List[ScaleEvent] = field(default_factory=list)
    # coordinator forecast snapshot at the end of the run (None when no
    # coordinator forecaster was configured)
    forecast: Optional[Dict[str, float]] = None

    @property
    def replica_seconds(self) -> float:
        """Total provisioned capacity-time — the denominator of the
        goodput-per-replica-second efficiency figure."""
        return sum(self.replica_spans.values())

    @property
    def slo_attainment(self) -> float:
        return slo_attainment(self.queries)

    @property
    def mean_acc(self) -> float:
        return mean_serving_accuracy(self.queries)

    @property
    def latency_p50(self) -> float:
        return latency_percentiles(self.queries)[0]

    @property
    def latency_p99(self) -> float:
        return latency_percentiles(self.queries)[1]

    @property
    def records(self) -> List[CompletionRecord]:
        return completion_records(self.queries)

    def stats(self) -> Dict[str, float]:
        return cluster_summarize(self.queries, n_replicas=self.n_replicas,
                                 n_joins=self.n_joins,
                                 replica_spans=self.replica_spans,
                                 n_switches=self.n_switches,
                                 n_dispatches=len(self.dispatches),
                                 actuation_seconds=self.actuation_seconds)


def simulate_cluster(arrivals: Sequence[float], profile: LatencyProfile,
                     policy: Policy, ccfg: ClusterConfig) -> ClusterResult:
    """Virtual-clock cluster simulation: one coordinator, N per-replica
    engines (the prototype ``policy`` is cloned per replica), a single
    shared event heap. A 1-replica cluster replays ``simulate``'s
    schedule record-for-record (guarded by tests/test_cluster.py).

    With ``ccfg.autoscale``, a ``ClusterAutoscaler`` runs its control
    loop on the same heap: spawned replicas get ``spawn_workers``
    workers (default: the static per-replica count) after paying the
    cold start; decommissions re-route the victim's queue through
    placement while its in-flight batches drain."""
    queries = [Query(deadline=float(t) + ccfg.slo, seq=i,
                     arrival=float(t), qid=i)
               for i, t in enumerate(arrivals)]
    # max(), not arrivals[-1]: arrivals need not be pre-sorted, and the
    # router parity path bills replica spans to this same horizon
    duration = (float(max(arrivals)) if len(arrivals) else 0.0) + 4 * ccfg.slo

    counts = replica_worker_counts(ccfg.n_replicas, ccfg.workers_per_replica)
    engines = build_engines(profile, policy, ccfg.n_replicas, counts,
                            ccfg.engine_config())
    coord = ClusterCoordinator(engines, make_placement(ccfg.placement),
                               placement_seed=ccfg.placement_seed,
                               forecast=coordinator_forecast(ccfg.autoscale,
                                                             ccfg.forecast))

    autoscaler = None
    if ccfg.autoscale is not None:
        acfg = ccfg.autoscale
        if ccfg.n_replicas > acfg.max_replicas:
            raise ValueError(
                f"{ccfg.n_replicas} initial replicas exceed "
                f"max_replicas={acfg.max_replicas}")
        if acfg.spawn_workers is None and len(set(counts)) > 1:
            raise ValueError(
                "heterogeneous worker pools need an explicit "
                "AutoscaleConfig.spawn_workers (no sane default size "
                "for spawned replicas)")
        spawn_workers = (acfg.spawn_workers if acfg.spawn_workers
                         else counts[0])
        ecfg = ccfg.engine_config()

        def engine_factory(rid: int) -> SchedulingEngine:
            return SchedulingEngine(profile, policy.clone(), ecfg,
                                    worker_ids=range(spawn_workers),
                                    replica_id=rid)

        autoscaler = ClusterAutoscaler(coord, acfg, engine_factory,
                                       slo=ccfg.slo)

    drive_cluster(coord, queries,
                  {rid: range(counts[rid])
                   for rid in range(ccfg.n_replicas)},
                  replica_deaths=ccfg.replica_deaths,
                  fault_times=ccfg.fault_times,
                  autoscaler=autoscaler)

    if autoscaler is not None:
        autoscaler.finalize(duration)
        spans = autoscaler.replica_spans()
        scale_events = list(autoscaler.events)
    else:
        spans = {rid: duration for rid in range(coord.n_replicas)}
        scale_events = []
    dispatches = sorted((d for e in coord.engines for d in e.dispatches),
                        key=lambda d: (d.t, d.replica, d.worker))
    return ClusterResult(queries=coord.queries, dispatches=dispatches,
                         duration=duration, n_replicas=coord.n_replicas,
                         n_joins=sum(e.n_joins for e in coord.engines),
                         n_predictive_windows=sum(e.n_predictive_windows
                                                  for e in coord.engines),
                         replica_spans=spans, scale_events=scale_events,
                         forecast=coord.forecast_snapshot(duration),
                         n_switches=sum(e.residency.n_switches
                                        for e in coord.engines),
                         actuation_seconds=sum(e.residency.actuation_seconds
                                               for e in coord.engines))
