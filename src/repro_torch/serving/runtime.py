"""Asyncio transport for the shared scheduling engine (paper §5),
hosting a *real* PyTorch supernet via SubNetAct.

All scheduling decisions live in ``serving/engine.py``; this module
supplies wall-clock time, real worker execution (``asyncio.to_thread``
so the event loop keeps routing), and async plumbing: event-driven
scheduling (an ``asyncio.Condition`` signaled on submit/completion —
no sleep-polling), continuous-batching join windows, and transparent
fault handling (a worker killed mid-batch has its in-flight queries
re-enqueued and re-served by survivors, mirroring the simulator).

For deterministic tests, ``Router.run_virtual`` drives the *same*
engine on a ``VirtualClock`` through the shared event loop — the
parity path proving router and simulator schedule identically.

Scale-out: a ``Router`` is the single-replica transport; the
``ClusterRouter`` below composes N of them behind one asyncio front
door, with placement delegated to ``serving/cluster.py``'s coordinator
(and a matching ``run_virtual`` cluster parity path).
``ClusterRouter(transport="proc")`` is ``serving/ipc.py``'s
``ProcClusterRouter``: one OS process per replica group.

A copy of ``repro/serving/runtime.py`` but for the imports, this
docstring, one comment's wording, ``make_supernet_workers``' docstring and
the spans (``repro_torch/tracing.py``): the single-replica ``Router``
opens ``query``, ``router.admit``, ``router.schedule``,
``engine.dispatch``, ``router.launch`` and ``router.complete``, and the
workers of ``make_supernet_workers`` ``worker.run`` and ``worker.pad``.
The router numbers its dispatches (the spans' ``step``); the engine,
shared with the simulator, records nothing.
"""
from __future__ import annotations

import asyncio
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.serving.autoscaler import (AutoscaleConfig, ClusterAutoscaler,
                                      coordinator_forecast)
from repro_torch.serving.cluster import (ClusterCoordinator, drive_cluster,
                                   make_placement)
from repro_torch.serving.forecast import ForecastConfig
from repro_torch.serving.engine import (CompletionRecord, Dispatch, EngineConfig,
                                  SchedulingEngine, VirtualClock, WallClock,
                                  drive)
from repro_torch.serving.metrics import cluster_summarize
from repro_torch.serving.policies import Policy
from repro_torch.serving.profiler import LatencyProfile
from repro_torch.serving.queue import Query


@dataclass
class ServedQuery:
    query: Query
    payload: Any                       # model input (e.g. token array row)
    # resolves to (prediction, acc); created by the running loop in
    # submit() — a Future is not a valid dataclass default value.
    done: Optional[asyncio.Future] = field(default=None)
    # the query's span from admission to its outcome (tracing.NULL when
    # tracing is off)
    span: Any = tracing.NULL


@dataclass
class WorkerHandle:
    """One worker hosting the supernet. ``run(subnet_idx, payloads)``
    executes the actuated subnet on a batch and returns predictions.

    The worker's *resident subnet* is deliberately NOT stored here: the
    engine's ``ResidencyTracker`` (serving/residency.py) is the single
    owner of that state, committed at ``engine.launch`` — a transport
    copy could disagree with the scheduler's accounting (the historical
    ``current_subnet`` duplication, regression-tested in
    tests/test_residency.py). Read ``Router.resident_subnet(wid)``."""

    wid: int
    run: Callable[[int, List[Any]], Any]
    alive: bool = True


class Router:
    """Asynchronous router: enqueue -> schedule -> dispatch -> respond.

    The engine owns every scheduling decision; the router owns time
    (injected clock), futures, and execution."""

    def __init__(self, profile: LatencyProfile, policy: Policy,
                 workers: Sequence[WorkerHandle],
                 clock=None, engine_cfg: Optional[EngineConfig] = None,
                 replica_id: int = 0, executor=None):
        self.profile = profile
        self.policy = policy
        self.workers = list(workers)
        # optional serving/executor.py SubnetExecutor backing the
        # workers: pure execution — the engine never consults it, the
        # router only surfaces its counters through stats()
        self.executor = executor
        self.clock = clock if clock is not None else WallClock()
        self.engine = SchedulingEngine(
            profile, policy, engine_cfg or EngineConfig(),
            worker_ids=[w.wid for w in self.workers], on_drop=self._on_drop,
            replica_id=replica_id)
        self._payloads: Dict[int, ServedQuery] = {}
        self._idle: List[WorkerHandle] = []
        self._open_events: Dict[int, asyncio.Event] = {}
        self._work = asyncio.Condition()
        self._task: Optional[asyncio.Task] = None
        self._qid = 0
        self._closed = False
        self._step = 0                  # dispatches so far: a span's step

    # -- legacy surface -------------------------------------------------

    @property
    def edf(self):
        return self.engine.edf

    @property
    def completed(self) -> List[Query]:
        """Queries with a resolved outcome (served or dropped)."""
        return [q for q in self.engine.queries
                if q.finish is not None or q.dropped]

    # -- async serving path ---------------------------------------------

    async def start(self):
        self._idle = [w for w in self.workers if w.alive]
        self._task = asyncio.create_task(self._schedule_loop())

    async def submit(self, payload: Any, slo_s: float,
                     qid: Optional[int] = None) -> asyncio.Future:
        """Enqueue one query. ``qid`` lets a cluster front door assign
        globally-unique ids; standalone routers number locally."""
        now = self.clock.now()
        if qid is None:
            qid = self._qid
            self._qid += 1
        q = Query(deadline=now + slo_s, seq=0, arrival=now, qid=qid)
        return await self.submit_query(q, payload)

    async def submit_query(self, q: Query, payload: Any) -> asyncio.Future:
        """Admit a pre-built query to *this* replica (the ClusterRouter
        places the query first, then hands it to the chosen replica)."""
        now = self.clock.now()
        sq = ServedQuery(q, payload, asyncio.get_running_loop().create_future(),
                         tracing.span("query", parent=None, qid=q.qid))
        self._payloads[q.qid] = sq
        async with self._work:
            with tracing.span("router.admit", parent=sq.span, qid=q.qid):
                self.engine.admit(q)
                if not self._idle:
                    # no idle capacity: the query may join a forming batch
                    self.offer_joins()
                self._work.notify_all()
        return sq.done

    def offer_joins(self):
        """Offer queued queries to open forming batches (continuous
        batching), launching any batch that fills or turns urgent. Also
        called after a cluster migration lands queries in this
        replica's queue."""
        for d in self.engine.try_join(self.clock.now()):
            ev = self._open_events.get(d.wid)
            if ev is not None:
                ev.set()                # batch filled/urgent: launch now

    def kill_worker(self, wid: int):
        """Fault injection: worker stops accepting batches (heartbeat
        loss). Its in-flight queries are transparently re-enqueued so
        survivors re-serve them; SlackFit absorbs the capacity loss by
        actuating down."""
        for w in self.workers:
            if w.wid == wid:
                w.alive = False
        self._idle = [w for w in self._idle if w.wid != wid]
        requeued = self.engine.fault(wid)
        ev = self._open_events.get(wid)
        if ev is not None:
            ev.set()                    # abort a forming batch's window
        if requeued:
            try:
                asyncio.get_running_loop().create_task(self._notify())
            except RuntimeError:
                pass                    # no loop: nothing to wake

    async def _notify(self):
        async with self._work:
            self._work.notify_all()

    def _on_drop(self, q: Query):
        sq = self._payloads.pop(q.qid, None)
        if sq is not None and not sq.done.done():
            sq.span.end(outcome="dropped")
            sq.done.set_result((None, 0.0))
        if sq is not None and not self._payloads:
            # a drop may be the event that resolves the last outstanding
            # query (e.g. the whole queue expired): wake an event-driven
            # drain() waiting on the _work condition
            try:
                asyncio.get_running_loop().create_task(self._notify())
            except RuntimeError:
                pass                    # no loop: nothing waits

    async def _schedule_loop(self):
        while True:
            async with self._work:
                await self._work.wait_for(
                    lambda: self._closed
                    or (bool(self._idle) and len(self.engine.edf) > 0))
                if self._closed:
                    return
                sched = tracing.span("router.schedule", parent=None)
                worker = self._idle.pop(0)
            if not worker.alive:
                sched.end()
                continue
            with tracing.span("engine.dispatch", parent=sched) as sp:
                d = self.engine.next_dispatch(worker.wid, self.clock.now())
                if sp and d is not None:
                    sp.set(step=self._step, subnet=d.pareto_idx,
                           rows=len(d.queries), queued=len(self.engine.edf))
            if d is None:
                sched.end()
                # drops emptied the queue, or the policy declined to
                # schedule: park until new work/capacity arrives rather
                # than spinning on an unchanged queue
                async with self._work:
                    self._idle.append(worker)
                    if len(self.engine.edf) > 0 and not self._closed:
                        await self._work.wait()
                continue
            step, self._step = self._step, self._step + 1
            if d.open:
                asyncio.create_task(self._form_and_run(worker, d, step))
            else:
                asyncio.create_task(self._run_batch(worker, d, step))
            sched.end(step=step)

    async def _form_and_run(self, worker: WorkerHandle, d: Dispatch,
                            step: int):
        """Hold an open batch for its join window (continuous batching):
        launch early if joins fill it, on fault, or at window expiry."""
        ev = asyncio.Event()
        self._open_events[d.wid] = ev
        try:
            while not ev.is_set() and not d.faulted:
                delay = d.launch_at - self.clock.now()
                if delay <= 0:
                    break
                try:
                    await asyncio.wait_for(ev.wait(), timeout=delay)
                except asyncio.TimeoutError:
                    break
        finally:
            self._open_events.pop(d.wid, None)
        if d.faulted:
            return                      # queries already re-enqueued
        await self._run_batch(worker, d, step)

    async def _run_batch(self, worker: WorkerHandle, d: Dispatch,
                         step: int):
        if d.faulted:                   # killed between formation and start
            await self._notify()
            return
        # the launch ends at the hand-off to the worker thread; inside the
        # block it stays the parent of the thread's spans
        with tracing.span("router.launch", parent=None, step=step) as sp:
            if not d.launched:
                self.engine.launch(d, self.clock.now())
            # payloads may be gone for queries resolved by an early drain()
            pairs = [(q, self._payloads.get(q.qid)) for q in d.queries]
            payloads = [sq.payload for _, sq in pairs if sq is not None]
            sp.end()
            if payloads:
                # SubNetAct actuation == a different control tuple; executed
                # in a thread so the event loop keeps routing.
                preds = await asyncio.to_thread(worker.run, d.pareto_idx,
                                                payloads)
            else:
                preds = []
        fin = self.clock.now()
        if d.faulted:
            # worker died mid-batch: the engine already re-enqueued the
            # queries — discard the (lost) result and wake the scheduler
            await self._notify()
            return
        with tracing.span("router.complete", parent=None, step=step) as sp:
            self.engine.complete(d, fin)
            arr = np.asarray(preds)
            i = 0
            for q, sq in pairs:
                if sq is None:
                    continue
                self._payloads.pop(q.qid, None)
                if not sq.done.done():
                    sq.span.end(outcome="served", step=step)
                    sq.done.set_result((arr[i], d.acc))
                i += 1
            async with self._work:
                if worker.alive:
                    self._idle.append(worker)
                self._work.notify_all()
            if sp:
                sp.set(queued=len(self.engine.edf))

    async def drain(self, timeout: float = 10.0):
        """Wait for every outstanding query to resolve, then shut the
        schedule loop down. Event-driven: waits on the ``_work``
        condition (notified at batch completion and at emptying drops),
        so the drain wakes the instant the last query resolves instead
        of sleep-polling up to 10 ms past it. Queries still unresolved
        when ``timeout`` expires are resolved as dropped AND marked
        ``timed_out`` — the shutdown-loss path, distinct from the
        policy's infeasible drops."""
        deadline = time.perf_counter() + timeout
        async with self._work:
            while self._payloads:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._work.wait(),
                                           timeout=remaining)
                except asyncio.TimeoutError:
                    break
        expired = bool(self._payloads)
        self._closed = True
        async with self._work:
            self._work.notify_all()
        if self._task is not None:
            self._task.cancel()
        # account dropped-but-unresolved queries (still queued, forming,
        # or lost to a dead worker)
        self.engine.abandon_pending()
        for sq in self._payloads.values():
            sq.query.dropped = True
            sq.query.timed_out = expired
            if not sq.done.done():
                sq.span.end(outcome="timed_out" if expired else "dropped")
                sq.done.set_result((None, 0.0))
        self._payloads.clear()

    def resident_subnet(self, wid: int) -> Optional[int]:
        """The subnet resident on worker ``wid`` per the engine's
        residency tracker — the transport's single source of truth for
        'what is loaded where' (the engine actuates at launch, before
        the batch executes)."""
        return self.engine.residency.resident(wid)

    def stats(self) -> Dict[str, float]:
        st = self.engine.stats()
        st["timed_out"] = float(sum(1 for q in self.engine.queries
                                    if q.timed_out))
        if self.executor is not None:
            st["executor"] = self.executor.counters()
        return st

    def records(self) -> List[CompletionRecord]:
        return self.engine.records()

    # -- deterministic parity path --------------------------------------

    def run_virtual(self, arrivals: Sequence[float], slo_s: float,
                    fault_times: Optional[Dict[int, float]] = None
                    ) -> List[CompletionRecord]:
        """Drive this router's engine to quiescence on its VirtualClock:
        the same shared event loop as the simulator, with service times
        from the engine (no real execution). Used by parity tests to
        prove router and simulator produce identical per-query
        schedules through the shared core."""
        if not isinstance(self.clock, VirtualClock):
            raise TypeError("run_virtual requires a VirtualClock router")
        queries = [Query(deadline=float(t) + slo_s, seq=i,
                         arrival=float(t), qid=i)
                   for i, t in enumerate(arrivals)]
        drive(self.engine, queries,
              [w.wid for w in self.workers if w.alive],
              fault_times=fault_times, clock=self.clock)
        return self.engine.records()


# --------------------------------------------------------------------------
# Cluster front door: N single-replica Routers behind one coordinator
# --------------------------------------------------------------------------


class ClusterRouter:
    """Asyncio multi-replica serving plane.

    Each replica group is a full ``Router`` (one engine, its own worker
    pool, its own schedule loop); this class is the single front door
    that places every incoming query on one replica via the cluster
    coordinator's ``PlacementPolicy`` and fans ``submit`` out to the
    chosen replica. Placement logic lives in the coordinator only;
    scheduling stays inside each replica's engine (the base rule,
    extended).

    Replica death (``kill_replica``) kills every worker in the group —
    re-enqueueing its in-flight queries through the engine's own fault
    path — then drains the dead replica's queue back through the
    coordinator, which re-routes the orphans (payloads and futures
    travel with them) to surviving replicas.

    With an ``AutoscaleConfig`` the cluster additionally runs a
    ``ClusterAutoscaler`` (serving/autoscaler.py): a live asyncio
    control loop spawns whole Router replicas (cold start before they
    turn routable) and gracefully decommissions them — queued work
    re-routes with its payloads/futures, in-flight batches finish on
    the old workers. ``run_virtual`` drives the same autoscaler on the
    shared virtual heap for parity with ``simulate_cluster``.
    """

    # consecutive live-autoscale tick failures tolerated before the
    # control loop re-raises (scaling dead, not unlucky)
    AUTOSCALE_MAX_CONSEC = 3

    def __new__(cls, *args, **kwargs):
        # transport switch: "inproc" (default) keeps every replica in
        # this process; "proc" dispatches to serving/ipc.py's
        # ProcClusterRouter — one OS process per replica group behind
        # the IPC front door (socketpair locally, or TCP with
        # listen=/token= for remote replicas), same public surface,
        # same coordinator ownership of admission/placement/lifecycle,
        # including the live autoscaler.
        transport = kwargs.get("transport", "inproc")
        if transport not in ("inproc", "proc"):
            raise ValueError(f"unknown transport {transport!r}; "
                             f"choose from ['inproc', 'proc']")
        if cls is ClusterRouter and transport == "proc":
            from repro_torch.serving.ipc import ProcClusterRouter
            return object.__new__(ProcClusterRouter)
        return object.__new__(cls)

    def __init__(self, profile: LatencyProfile, policy: Policy,
                 replicas: Sequence[Sequence[WorkerHandle]],
                 clock=None, engine_cfg: Optional[EngineConfig] = None,
                 placement: str = "round_robin", placement_seed: int = 0,
                 autoscale: Optional[AutoscaleConfig] = None,
                 worker_factory: Optional[Callable[[int],
                                          List[WorkerHandle]]] = None,
                 slo: float = 0.036,
                 forecast: Optional[ForecastConfig] = None,
                 transport: str = "inproc", **_proc_only):
        if _proc_only:
            raise TypeError("arguments only valid with transport='proc': "
                            f"{sorted(_proc_only)}")
        # ``slo`` is the deadline regime the autoscaler's thresholds
        # normalize to (when AutoscaleConfig.slo is None) — match the
        # slo_s you submit/run_virtual with, as simulate_cluster's
        # autoscaler inherits ClusterConfig.slo the same way
        self.profile = profile
        self.clock = clock if clock is not None else WallClock()
        self._policy_proto = policy
        self._engine_cfg = engine_cfg
        self.routers = [
            Router(profile, policy.clone(), group, clock=self.clock,
                   engine_cfg=engine_cfg, replica_id=rid)
            for rid, group in enumerate(replicas)]
        # the coordinator-level forecaster must be constructed by the
        # SAME defaulting rule as simulate_cluster (coordinator_forecast)
        # or forecast-led schedules would diverge between transports
        self.coord = ClusterCoordinator(
            [r.engine for r in self.routers], make_placement(placement),
            placement_seed=placement_seed,
            forecast=coordinator_forecast(autoscale, forecast))
        self._qid = 0
        self._started = False
        self._scale_task: Optional[asyncio.Task] = None
        self._autoscale_errors = 0
        # autoscaling: spawned replica groups come from worker_factory
        # (default: spawn_workers clones of the first group's run fn,
        # wids 0..k-1 to mirror the simulator's spawned pools)
        self._worker_factory = worker_factory
        if worker_factory is None and replicas and replicas[0]:
            run0 = replicas[0][0].run
            k = (autoscale.spawn_workers if autoscale
                 and autoscale.spawn_workers else len(replicas[0]))
            self._worker_factory = lambda rid: [
                WorkerHandle(wid=i, run=run0) for i in range(k)]
        self.autoscaler = None
        if autoscale is not None:
            if self._worker_factory is None:
                raise ValueError(
                    "autoscaling needs a worker_factory (none given and "
                    "no first replica group to clone one from)")
            if len(self.routers) > autoscale.max_replicas:
                raise ValueError(
                    f"{len(self.routers)} initial replicas exceed "
                    f"max_replicas={autoscale.max_replicas}")
            if (autoscale.spawn_workers is None and worker_factory is None
                    and len({len(g) for g in replicas}) > 1):
                raise ValueError(
                    "heterogeneous worker pools need an explicit "
                    "AutoscaleConfig.spawn_workers or a worker_factory")
            self.autoscaler = ClusterAutoscaler(
                self.coord, autoscale, self._spawn_replica_engine,
                slo=slo, migrate_fn=self._migrate)

    def _spawn_replica_engine(self, rid: int):
        """Autoscaler hook: a spawned replica group is a full Router
        (its engine registers with the coordinator). In the live plane
        the autoscale loop starts it; in the virtual parity path
        drive_cluster drives the engine directly."""
        r = Router(self.profile, self._policy_proto.clone(),
                   self._worker_factory(rid), clock=self.clock,
                   engine_cfg=self._engine_cfg, replica_id=rid)
        assert len(self.routers) == rid
        self.routers.append(r)
        return r.engine

    # -- async serving path ---------------------------------------------

    async def start(self):
        for r in self.routers:
            await r.start()
        self._started = True
        if self.autoscaler is not None:
            self.autoscaler.anchor(self.clock.now())
            self._scale_task = asyncio.create_task(self._autoscale_loop())

    async def _autoscale_loop(self):
        """Live control loop (wall clock): the asyncio twin of the
        SCALE/READY events drive_cluster puts on the virtual heap. A
        failing tick must not silently end autoscaling for the rest of
        the run, so single errors are counted
        (``stats()['autoscale_errors']``), reported, and the loop keeps
        going — but ``AUTOSCALE_MAX_CONSEC`` consecutive failures mean
        the control loop is dead, not unlucky, and the exception is
        re-raised instead of scaling silently going dark."""
        cfg = self.autoscaler.cfg
        loop = asyncio.get_running_loop()
        consecutive = 0
        while True:
            await asyncio.sleep(cfg.interval)
            try:
                for ev in self.autoscaler.tick(self.clock.now()):
                    if ev.kind == "spawn":
                        await self.routers[ev.rid].start()
                        loop.call_later(
                            max(ev.ready_at - self.clock.now(), 0.0),
                            self._activate, ev.rid)
                    # decommission: tick already re-routed the queue
                    # and migrated payloads/futures via _migrate
                consecutive = 0
            except Exception:           # noqa: BLE001 — keep scaling alive
                traceback.print_exc()
                self._autoscale_errors += 1
                consecutive += 1
                if consecutive >= self.AUTOSCALE_MAX_CONSEC:
                    raise

    def _activate(self, rid: int):
        """Cold start paid: the spawned replica becomes routable (a
        replica killed mid-warm-up stays down)."""
        if self.coord.alive[rid]:
            self.autoscaler.activate(rid, self.clock.now())

    async def submit(self, payload: Any, slo_s: float) -> asyncio.Future:
        now = self.clock.now()
        q = Query(deadline=now + slo_s, seq=0, arrival=now, qid=self._qid)
        self._qid += 1
        self.coord.queries.append(q)
        self.coord.observe(q)           # one forecast observation per arrival
        if not self.coord.alive_replicas():
            # coordinator semantics (cluster.py admit): nowhere to
            # route — record the query and resolve it as dropped
            q.dropped = True
            fut = asyncio.get_running_loop().create_future()
            fut.set_result((None, 0.0))
            return fut
        rid = self.coord.select(q, now)
        fut = await self.routers[rid].submit_query(q, payload)
        if not self.coord.alive[rid]:
            # the replica died between placement and admission (the
            # await may suspend on the replica's lock): pull the
            # just-admitted query back out and re-route it
            self._rescue(rid)
        return fut

    def kill_worker(self, rid: int, wid: int):
        self.routers[rid].kill_worker(wid)
        if self.coord.should_decommission(rid):
            self._rescue(rid)
            self._book_death(rid)
        elif (not self.coord.alive[rid]
                and len(self.routers[rid].engine.edf)):
            # fault re-enqueued onto an already-decommissioned replica:
            # surrender the queue again (payloads travel with it)
            self._rescue(rid)

    def kill_replica(self, rid: int):
        """Whole replica group dies: fault every worker, then re-route
        its queued + re-enqueued queries (with their payloads/futures)
        to survivors through the placement policy."""
        was_alive = self.coord.alive[rid]
        r = self.routers[rid]
        for w in list(r.workers):
            r.kill_worker(w.wid)        # may already _rescue on the last
        if self.coord.alive[rid]:
            self._rescue(rid)
        if was_alive:
            self._book_death(rid)

    def _book_death(self, rid: int):
        """Mirror drive_cluster's EV_FAULT bookkeeping on the live
        path: the autoscaler must close the dead replica's billing
        span (and forget it if it was still warming), or
        replica_seconds overstates and a dead warming replica would
        inflate n_committed forever."""
        if self.autoscaler is not None:
            self.autoscaler.on_death(rid, self.clock.now())

    def _rescue(self, rid: int):
        """Drain replica ``rid``'s queue back through the coordinator
        (marking it dead), migrating payloads and futures to the
        re-routed replicas. Safe to call again on an already-dead
        replica — the late-admission race in ``submit`` needs exactly
        that to re-route a query that landed after the death."""
        self._migrate(rid, self.coord.redistribute(rid, self.clock.now()))

    def _migrate(self, rid: int, moved):
        """Move the payloads/futures of re-routed queries to their new
        replicas and wake those schedulers. Shared by the death path
        (``_rescue``) and the autoscaler's graceful decommission (its
        ``migrate_fn`` hook). A no-op before ``start`` — the virtual
        parity path drives bare engines and owns dispatch itself."""
        if not self._started:
            return
        r = self.routers[rid]
        woken = set()
        for q, target in moved:
            sq = r._payloads.pop(q.qid, None)
            if sq is not None:
                self.routers[target]._payloads[q.qid] = sq
            woken.add(target)
        # total-cluster death: redistribute dropped the orphans — their
        # futures must still resolve
        for q in list(r.engine.queries):
            if q.dropped:
                sq = r._payloads.pop(q.qid, None)
                if sq is not None and not sq.done.done():
                    sq.done.set_result((None, 0.0))
        for target in woken:
            tr = self.routers[target]
            if not tr._idle:
                # migrated queries may join a survivor's forming batch
                # (mirrors submit_query and drive_cluster's
                # dispatch-after-redistribute)
                tr.offer_joins()
        try:
            loop = asyncio.get_running_loop()
            for target in woken:
                loop.create_task(self.routers[target]._notify())
        except RuntimeError:
            pass                        # no loop: nothing to wake

    async def drain(self, timeout: float = 10.0):
        if self._scale_task is not None:
            self._scale_task.cancel()
            self._scale_task = None
        await asyncio.gather(*(r.drain(timeout) for r in self.routers))

    def stats(self) -> Dict[str, float]:
        if self.autoscaler is not None:
            st = cluster_summarize(
                self.coord.queries, n_replicas=self.coord.n_replicas,
                n_joins=sum(e.n_joins for e in self.coord.engines),
                replica_spans=self.autoscaler.replica_spans(
                    self.clock.now()),
                n_switches=sum(e.residency.n_switches
                               for e in self.coord.engines),
                n_dispatches=sum(e.residency.n_launches
                                 for e in self.coord.engines),
                actuation_seconds=sum(e.residency.actuation_seconds
                                      for e in self.coord.engines))
        else:
            st = self.coord.stats()
        if self.autoscaler is not None:
            st["autoscale_errors"] = float(self._autoscale_errors)
        snap = self.coord.forecast_snapshot(self.clock.now())
        if snap is not None:
            st["forecast"] = snap
        return st

    def records(self) -> List[CompletionRecord]:
        return self.coord.records()

    # -- deterministic parity path --------------------------------------

    def run_virtual(self, arrivals: Sequence[float], slo_s: float,
                    replica_deaths: Optional[Dict[int, float]] = None,
                    fault_times: Optional[Dict[tuple, float]] = None
                    ) -> List[CompletionRecord]:
        """Drive the whole cluster to quiescence on its VirtualClock
        through the shared event loop in serving/cluster.py — the
        parity path proving ClusterRouter and ClusterSimulator place
        and schedule identically, autoscaling included (scale ticks
        ride the same virtual heap; spawned Routers contribute their
        engines without ever starting an asyncio loop)."""
        if not isinstance(self.clock, VirtualClock):
            raise TypeError("run_virtual requires a VirtualClock cluster")
        queries = [Query(deadline=float(t) + slo_s, seq=i,
                         arrival=float(t), qid=i)
                   for i, t in enumerate(arrivals)]
        drive_cluster(
            self.coord, queries,
            {rid: [w.wid for w in r.workers if w.alive]
             for rid, r in enumerate(self.routers)},
            replica_deaths=replica_deaths, fault_times=fault_times,
            clock=self.clock, autoscaler=self.autoscaler)
        if self.autoscaler is not None:
            # close open spans at the same nominal horizon the
            # simulator bills to (last arrival + drain margin), so both
            # transports report identical replica_seconds for
            # identical schedules
            t_end = (max(arrivals) if len(arrivals) else 0.0) + 4 * slo_s
            self.autoscaler.finalize(float(t_end))
        return self.coord.records()


def make_supernet_workers(n: int, step_fn: Callable[[int, Any], Any],
                          pad_batch: Callable[[List[Any]], Any]) -> List[WorkerHandle]:
    """Workers sharing one supernet step. ``step_fn(subnet_idx,
    batch_array)`` takes the control tuple as data (the executor's warmed
    entries and CUDA graphs), so actuating another subnet builds nothing."""
    def run(subnet_idx: int, payloads: List[Any]):
        with tracing.span("worker.run"):
            with tracing.span("worker.pad"):
                batch = pad_batch(payloads)
            return step_fn(subnet_idx, batch)
    return [WorkerHandle(wid=i, run=run) for i in range(n)]
