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

Copy of ``repro/serving/runtime.py`` trimmed to the single-replica
transport (``ServedQuery``, ``WorkerHandle``, ``Router``,
``make_supernet_workers``); the cluster front door is not ported yet.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import (CompletionRecord, Dispatch, EngineConfig,
                                  SchedulingEngine, VirtualClock, WallClock,
                                  drive)
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
        sq = ServedQuery(q, payload, asyncio.get_running_loop().create_future())
        self._payloads[q.qid] = sq
        async with self._work:
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
                worker = self._idle.pop(0)
            if not worker.alive:
                continue
            d = self.engine.next_dispatch(worker.wid, self.clock.now())
            if d is None:
                # drops emptied the queue, or the policy declined to
                # schedule: park until new work/capacity arrives rather
                # than spinning on an unchanged queue
                async with self._work:
                    self._idle.append(worker)
                    if len(self.engine.edf) > 0 and not self._closed:
                        await self._work.wait()
                continue
            if d.open:
                asyncio.create_task(self._form_and_run(worker, d))
            else:
                asyncio.create_task(self._run_batch(worker, d))

    async def _form_and_run(self, worker: WorkerHandle, d: Dispatch):
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
        await self._run_batch(worker, d)

    async def _run_batch(self, worker: WorkerHandle, d: Dispatch):
        if d.faulted:                   # killed between formation and start
            await self._notify()
            return
        if not d.launched:
            self.engine.launch(d, self.clock.now())
        # payloads may be gone for queries resolved by an early drain()
        pairs = [(q, self._payloads.get(q.qid)) for q in d.queries]
        payloads = [sq.payload for _, sq in pairs if sq is not None]
        if payloads:
            # SubNetAct actuation == a different control tuple; executed
            # in a thread so the event loop keeps routing.
            preds = await asyncio.to_thread(worker.run, d.pareto_idx, payloads)
        else:
            preds = []
        fin = self.clock.now()
        if d.faulted:
            # worker died mid-batch: the engine already re-enqueued the
            # queries — discard the (lost) result and wake the scheduler
            await self._notify()
            return
        self.engine.complete(d, fin)
        arr = np.asarray(preds)
        i = 0
        for q, sq in pairs:
            if sq is None:
                continue
            self._payloads.pop(q.qid, None)
            if not sq.done.done():
                sq.done.set_result((arr[i], d.acc))
            i += 1
        async with self._work:
            if worker.alive:
                self._idle.append(worker)
            self._work.notify_all()

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


def make_supernet_workers(n: int, step_fn: Callable[[int, Any], Any],
                          pad_batch: Callable[[List[Any]], Any]) -> List[WorkerHandle]:
    """Workers sharing one jitted supernet step. ``step_fn(subnet_idx,
    batch_array)`` must be jit-compiled with the control tuple as data
    so actuation never recompiles."""
    def run(subnet_idx: int, payloads: List[Any]):
        return step_fn(subnet_idx, pad_batch(payloads))
    return [WorkerHandle(wid=i, run=run) for i in range(n)]
