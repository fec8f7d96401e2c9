"""One measured window of a cell: the program's serving stack driven by an
open loop from the seed, and what the benchmark records around it.

The stack is the one users run: ``Router`` with ``SlackFit`` over the
executor's measured profile, one worker from ``make_supernet_workers``
whose step is ``SubnetExecutor.run_prefill``. The benchmark passes its own
``pad_batch`` (it notes each batch's query ids) and wraps the step (it
times it, keeps a seeded sample of the window's steps for the judge, and
opens and closes the trace sub-window at step boundaries). On the card, a
pair of CUDA events on the current stream brackets each call, so every
step of the window has its time on the card's clock.

Each query goes to ``Router.submit_query`` with ``arrival`` set to its due
time on the router's clock (``time.perf_counter``) and its deadline due
time + SLO, so a late generator counts in latency and attainment. The
queries due in the window are waited for, then the router drains; the
drain is not part of the window. A traced run goes on offering the same
traffic for a tail after the window, and traces steps of the tail.
"""
from __future__ import annotations

import asyncio
import gc
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from superbench import trace as trace_mod

# seconds the window's queries may take to resolve after it closes
DRAIN_S = 60.0
# the trace opens this long after the window closes, when the window's
# queries have been served: stopping the profiler stalls the host, and
# the stall must not land on a measured query
TRACE_AFTER_S = 0.5


@dataclass
class Step:
    t0: float                      # host clock at the call of run_prefill
    t1: float                      # and at its return
    subnet: int                    # index into the frozen Pareto table
    qids: List[int]
    rows: int
    traced: int = 0                # the trace that counted it (1, 2, ..)
    events: Any = None             # CUDA events before and after the call
    device_ms: Optional[float] = None  # the card's time between them


@dataclass
class QueryRec:
    qid: int
    due: float
    deadline: float
    submitted: Optional[float] = None
    finish: Optional[float] = None
    dropped: bool = False
    timed_out: bool = False
    step: Optional[int] = None     # index into Window.steps


@dataclass
class Window:
    """What one window recorded; the metric readers read it."""
    start: float                   # host clock: the window opens
    seconds: float
    queries: List[QueryRec]        # the queries due in the window
    steps: List[Step]              # every step of the run, lead-in included
    samples: List[Dict[str, Any]]  # the judge's sample of window steps
    builds: int                    # kernel builds while serving
    captures: int                  # graph captures while serving
    errors: List[str] = field(default_factory=list)
    trace: Optional[trace_mod.Trace] = None

    @property
    def end(self) -> float:
        return self.start + self.seconds

    def in_window(self, t: float) -> bool:
        return self.start <= t < self.end

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if self.in_window(s.t0)]


class Recorder:
    """The worker's ``pad_batch`` and step: times each call of
    ``run_prefill`` (host clock, and on the card CUDA events), notes the
    batch's query ids, keeps a sample of the window's steps drawn from the
    seed (tokens and the logits the router hands back): a reservoir of
    ``sample_k`` steps and one more of each subnet served, so that the
    judge sees every subnet the window ran. It drives the tracer."""

    def __init__(self, run_prefill, window_start: float, window_end: float,
                 sample_k: int, seed: int,
                 tracer: Optional[trace_mod.Tracer] = None,
                 cuda: bool = False):
        self.run_prefill = run_prefill
        self.lo, self.hi = window_start, window_end
        self.k = sample_k
        self.rng = np.random.default_rng([int(seed), 7])
        self.tracer = tracer
        self.cuda = cuda
        self.steps: List[Step] = []
        self.reservoir: List[Dict[str, Any]] = []
        self.seen = 0
        self.of_subnet: Dict[int, List] = {}   # subnet -> [seen, item]
        self.errors: List[str] = []

    @staticmethod
    def pad_batch(payloads):
        return ([p[0] for p in payloads],
                np.stack([p[1] for p in payloads]))

    def step(self, subnet_idx: int, batch):
        qids, tokens = batch
        tr = self.tracer
        traced = tr.before_step() if tr is not None else 0
        events = None
        if self.cuda:
            import torch
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            if traced:
                with tr.span():
                    out = self.run_prefill(subnet_idx, tokens)
            else:
                out = self.run_prefill(subnet_idx, tokens)
        except Exception as exc:
            self.errors.append(f"step of {len(qids)} rows, subnet "
                               f"{subnet_idx}: {exc!r}")
            raise
        t1 = time.perf_counter()
        if events is not None:
            events[1].record()
        self.steps.append(Step(t0, t1, int(subnet_idx), list(qids),
                               len(qids), traced, events))
        if tr is not None:
            tr.after_step(t1)
        if self.lo <= t0 < self.hi:
            self._sample(len(self.steps) - 1, int(subnet_idx), tokens, out)
        return out

    def _sample(self, idx, subnet_idx, tokens, out):
        if self.k <= 0:
            return
        self.seen += 1
        item = {"step": idx, "subnet": subnet_idx, "tokens": tokens,
                "logits": out}
        if len(self.reservoir) < self.k:
            self.reservoir.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.reservoir[j] = item
        one = self.of_subnet.setdefault(subnet_idx, [0, None])
        one[0] += 1
        if int(self.rng.integers(0, one[0])) == 0:
            one[1] = item

    @property
    def samples(self) -> List[Dict[str, Any]]:
        """The reservoir and each subnet's own pick, each step once, in
        the order the window ran them."""
        items = {it["step"]: it for it in self.reservoir}
        for _, it in self.of_subnet.values():
            items.setdefault(it["step"], it)
        return [items[k] for k in sorted(items)]

    def settle(self) -> None:
        """Read each step's time on the card once every call has ended."""
        if not self.cuda:
            return
        import torch
        torch.cuda.synchronize()
        for s in self.steps:
            if s.events is not None:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None


async def _serve(router, dues, tokens, slo_s, recs, sub, window_lo,
                 window_hi, tracer):
    """Offer every query at its due time (the tail's until the trace is
    taken); then wait for the window's."""
    from repro_torch.serving.queue import Query
    # the worker's steps run on one thread: the profiler records the host
    # events of the thread that started it
    asyncio.get_running_loop().set_default_executor(
        ThreadPoolExecutor(max_workers=1, thread_name_prefix="worker"))
    await router.start()
    futs = []
    for i, due in enumerate(dues):
        if due >= window_hi and (tracer is None or tracer.state == "done"):
            break
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        q = Query(deadline=due + slo_s, seq=0, arrival=due, qid=i)
        fut = await router.submit_query(q, (i, tokens[i]))
        recs[i].submitted = time.perf_counter()
        sub[i] = q
        if window_lo <= due < window_hi:
            futs.append(fut)
    if futs:
        await asyncio.wait(futs, timeout=DRAIN_S)
    await router.drain(timeout=5.0)


def run_window(executor, profile, cell: Dict, arrivals: Dict[str, np.ndarray],
               tokens: np.ndarray, seed: int, sample_k: int,
               tracer: Optional[trace_mod.Tracer] = None,
               lead: float = 0.05) -> Window:
    """Serve the lead-in and the window of ``arrivals`` (offsets in
    seconds, ``{"lead_in": ..., "window": ...}``) through a fresh router
    over ``executor``; ``tokens`` holds one row a query, lead-in first."""
    from repro_torch import compat
    from repro_torch.serving import runtime
    from repro_torch.serving.policies import SlackFit

    lead_in = float(cell["lead_in_s"])
    seconds = float(arrivals["seconds"])
    tail = arrivals.get("tail", np.empty(0))
    slo_s = float(cell["slo_ms"]) / 1e3
    # what set-up left behind is not collected inside the window
    gc.collect()
    gc.freeze()
    base = time.perf_counter() + lead
    start = base + lead_in
    offsets = np.concatenate([arrivals["lead_in"],
                              lead_in + arrivals["window"],
                              lead_in + seconds + tail])
    dues = base + offsets
    recs = [QueryRec(i, float(d), float(d) + slo_s)
            for i, d in enumerate(dues)]
    rec = Recorder(executor.run_prefill, start, start + seconds, sample_k,
                   seed, tracer, cuda=executor.device.type == "cuda")
    if tracer is not None:
        tracer.arm(start + seconds + TRACE_AFTER_S)
        tracer.traces.clear()
    router = runtime.Router(profile, SlackFit(),
                            runtime.make_supernet_workers(
                                1, rec.step, rec.pad_batch),
                            executor=executor)
    sub: Dict[int, Any] = {}
    try:
        with compat.BuildCounter() as bc, compat.CaptureCounter() as cc:
            asyncio.run(_serve(router, dues, tokens, slo_s, recs, sub,
                               start, start + seconds, tracer))
    finally:
        gc.unfreeze()
    rec.settle()
    step_of = {}
    for n, s in enumerate(rec.steps):
        for q in s.qids:
            step_of[q] = n
    for r in recs:
        q = sub.get(r.qid)
        if q is not None:
            r.finish, r.dropped, r.timed_out = q.finish, q.dropped, q.timed_out
        r.step = step_of.get(r.qid)
    window = [r for r in recs if start <= r.due < start + seconds]
    return Window(start=start, seconds=seconds, queries=window,
                  steps=rec.steps, samples=rec.samples, builds=bc.count,
                  captures=cc.count, errors=rec.errors,
                  trace=tracer.result() if tracer is not None else None)
