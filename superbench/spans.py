"""The program's spans (``repro_torch/tracing.py``) read against a traced run:
per-step host times of the router, the worker and the executor, the spans
placed on the profiler's clock, and the card's idle gaps put down to them.

    python3 superbench/spans.py --workload <name> --seed <n> --seconds <s>

runs one ``--trace 1`` run of the cell (``run.run_cell``) with the
program's tracing on over the served traffic (lead-in, window and the
tail that holds the trace), keeps the profiler's events of each trace it
reads, and prints one JSON line: the run's result, then under ``spans``
the numbers below, ``trace_clock_residual_us``, the idle gaps by
label, the count of spans and a span's cost on this host with tracing on
and off. The harness's ``serve.run_window`` and ``trace.analyse`` are
wrapped in this process only: the benchmark's own runs record no span.

Numbers (ms, over the window): ``admit_to_launch_ms.p99``, a served query's
admission (its ``query`` span's start) to its step's ``router.launch``;
``dispatch_gap_ms.mean``, from the later of the previous step's end and the
batch's first admission to the step's ``executor.replay``;
``router_self_ms.mean``, a step's ``router.schedule``, ``router.launch``
and ``router.complete`` less their children; ``step_load_ms.mean`` and
``graph_launch_ms.mean``, ``executor.load`` and ``executor.replay``; and
over the traced sub-window ``device_idle_ready_share``, the share in which
the card runs nothing while a query lies between its admission and its
step's launch.

Mapping. Each traced step's ``executor.step`` exists twice: in the
program's buffer (``perf_counter_ns``) and, through
``torch.profiler.record_function``, among the profiler's host events.
The profiled steps are found in the buffer by the pattern of their start
times and their lengths; each gives an offset between the two clocks (the
mean of its start's and its end's), and every span is placed with the
offset of the anchor nearest in time, so drift between steps does not add
up. The residual is the largest of half an anchor's start-to-end
disagreement and half the change of offset between neighbouring anchors.

Labels. An idle gap on the card is named by the innermost program span
open at its middle, from any thread (``query`` spans, which only wait,
aside); where none is open, "thread hand-off" between a step's
``router.launch`` end and its ``worker.run`` start, "no query waiting"
where no query lies between its admission and its step's launch, and
"asyncio between router spans" where one does. Gaps under
``trace.SHORT_GAP_US`` stay "between kernels (launch gaps)".
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

import numpy as np  # noqa: E402

from superbench import trace as trace_mod  # noqa: E402
from superbench.stats import percentile  # noqa: E402

SID, PARENT, NAME, T0, T1, TID, ATTRS = range(7)
ANCHOR = "executor.step"
ROUTER = ("router.schedule", "router.launch", "router.complete")
# an alignment whose start pattern strays further than this (us, mean
# over anchors) from the profiler's is taken as no alignment
MATCH_US = 500.0
HANDOFF = "thread hand-off"
NO_QUERY = "no query waiting"
ASYNCIO = "asyncio between router spans"


@dataclass
class Index:
    """The spans of one run, looked up the ways the readers need."""
    spans: List[Tuple]
    by_sid: Dict[int, Tuple]
    children: Dict[int, List[Tuple]]
    of_step: Dict[int, Dict[str, Tuple]]     # step -> name -> span
    queries: Dict[int, Tuple]                # qid -> its query span
    batch: Dict[int, List[Tuple]]            # step -> its query spans

    @classmethod
    def of(cls, spans: Sequence[Tuple]) -> "Index":
        spans = list(spans)
        by_sid = {s[SID]: s for s in spans}
        children, of_step = defaultdict(list), defaultdict(dict)
        queries, batch = {}, defaultdict(list)
        for s in spans:
            if s[PARENT] is not None:
                children[s[PARENT]].append(s)
            if s[NAME] == "query":
                queries[s[ATTRS]["qid"]] = s
                if s[ATTRS].get("outcome") == "served":
                    batch[s[ATTRS]["step"]].append(s)
            elif "step" in s[ATTRS]:
                of_step[s[ATTRS]["step"]][s[NAME]] = s
        return cls(spans, by_sid, children, of_step, queries, batch)

    def depth(self, s: Tuple) -> int:
        n = 0
        while s[PARENT] is not None and s[PARENT] in self.by_sid:
            s, n = self.by_sid[s[PARENT]], n + 1
        return n

    def launch_ns(self, q: Tuple) -> Optional[int]:
        """Start of the launch of the step that served query span ``q``."""
        if q[ATTRS].get("outcome") != "served":
            return None
        launch = self.of_step.get(q[ATTRS]["step"], {}).get("router.launch")
        return launch[T0] if launch else None

    def waiting(self) -> List[Tuple[int, int]]:
        """Each query's wait in the router (ns): admission to its step's
        launch, or to its end where it was not served."""
        out = []
        for q in self.queries.values():
            end = self.launch_ns(q)
            out.append((q[T0], q[T1] if end is None else end))
        return out

    def window_steps(self, lo_ns: int, hi_ns: int) -> List[int]:
        """The steps whose ``executor.step`` started in ``[lo, hi)``."""
        return sorted(n for n, got in self.of_step.items()
                      if ANCHOR in got and lo_ns <= got[ANCHOR][T0] < hi_ns)


def host_metrics(idx: Index, window) -> Dict[str, Optional[float]]:
    """The five host numbers of a window (``serve.Window``) in ms."""
    from repro_torch.tracing import self_ns
    lo, hi = int(window.start * 1e9), int(window.end * 1e9)
    steps = idx.window_steps(lo, hi)
    # the same queries as queue_wait_ms.p99: the window's, with a step
    waits = []
    for q in window.queries:
        span = idx.queries.get(q.qid)
        launch = idx.launch_ns(span) if span and q.step is not None else None
        if launch is not None:
            waits.append((launch - span[T0]) / 1e6)
    ends = sorted((got[ANCHOR][T0], got[ANCHOR][T1])
                  for got in idx.of_step.values() if ANCHOR in got)
    starts = [a for a, _ in ends]
    gaps, selfs, loads, replays = [], [], [], []
    for n in steps:
        got = idx.of_step[n]
        replay = got.get("executor.replay")
        admits = [q[T0] for q in idx.batch.get(n, [])]
        i = bisect.bisect_left(starts, got[ANCHOR][T0])
        if replay and admits:
            ready = max([min(admits)] + ([ends[i - 1][1]] if i else []))
            gaps.append((replay[T0] - ready) / 1e6)
        if all(r in got for r in ROUTER):
            selfs.append(sum(self_ns(got[r], idx.children[got[r][SID]])
                             for r in ROUTER) / 1e6)
        if "executor.load" in got:
            loads.append((got["executor.load"][T1]
                          - got["executor.load"][T0]) / 1e6)
        if replay:
            replays.append((replay[T1] - replay[T0]) / 1e6)

    def mean(v):
        return sum(v) / len(v) if v else None

    return {"admit_to_launch_ms.p99": percentile(waits, 99),
            "dispatch_gap_ms.mean": mean(gaps),
            "router_self_ms.mean": mean(selfs),
            "step_load_ms.mean": mean(loads),
            "graph_launch_ms.mean": mean(replays)}


@dataclass
class Clock:
    """Offsets (ns) that place the buffer's times on the profiler's."""
    at_ns: np.ndarray                        # each anchor's buffer time
    offset_ns: np.ndarray
    residual_us: float

    def place(self, t_ns: float) -> float:
        """``t_ns`` of the buffer in the profiler's microseconds."""
        i = int(np.argmin(np.abs(self.at_ns - t_ns)))
        return (t_ns + self.offset_ns[i]) / 1e3


def anchor(idx: Index, host: Sequence[Tuple[str, float, float]]
           ) -> Optional[Clock]:
    """The clock mapping from the traced steps' ``executor.step``, in the
    buffer and among the profiler's host events ``(name, start_us,
    end_us)``; None where they cannot be matched."""
    prof = sorted((a, b) for name, a, b in host if name == ANCHOR)
    buf = sorted((s[T0], s[T1]) for s in idx.spans if s[NAME] == ANCHOR)
    n, m = len(prof), len(buf)
    if n < 2 or m < n:
        return None
    p0, p1 = (np.array(v) * 1e3 for v in zip(*prof))
    b0, b1 = (np.array(v, dtype=np.float64) for v in zip(*buf))
    rel, dur = p0 - p0[0], p1 - p0
    # the starts' pattern and the steps' lengths, buffer against profiler
    cost = [np.abs((b0[k:k + n] - b0[k]) - rel).mean()
            + np.abs((b1 - b0)[k:k + n] - dur).mean()
            for k in range(m - n + 1)]
    k = int(np.argmin(cost))
    if cost[k] / 1e3 > MATCH_US:
        return None
    on_start = p0 - b0[k:k + n]
    on_end = p1 - b1[k:k + n]
    offset = (on_start + on_end) / 2
    resid = max(np.abs(on_start - on_end).max() / 2,
                np.abs(np.diff(offset)).max() / 2)
    return Clock(b0[k:k + n], offset, float(resid / 1e3))


def _intervals_at(iv: List[Tuple[float, float]], t: float) -> bool:
    return any(a <= t < b for a, b in iv)


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
             ) -> float:
    """Length of the intersection of two unions of intervals."""
    a, b = trace_mod._union(a), trace_mod._union(b)
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(idx: Index, events, intact: bool) -> Dict:
    """The traced sub-window's idle gaps by label, the share of it idle
    while a query waits, and the mapping's residual; ``events`` are the
    trace's ``(name, start_us, end_us, on_device)`` as the harness read
    them (``trace.analyse``: its steps, its sub-window)."""
    dev = [(a, b, n) for n, a, b, d in events if d]
    host = [(n, a, b) for n, a, b, d in events if not d and b > a]
    groups = trace_mod._steps(dev)
    middle = groups[1:-1]
    if not middle:
        return {}
    lo, hi = middle[0][0][0], groups[-1][0][0]
    busy = trace_mod._union([(a, b) for a, b, _ in dev if lo <= a < hi])
    edges = [lo] + [v for iv in busy for v in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    clock = anchor(idx, host)
    out = {"trace_clock_residual_us": clock and clock.residual_us}
    if clock is None:
        return out
    # only what overlaps the traced steps, give or take a second
    near = (clock.at_ns[0] - 1e9, clock.at_ns[-1] + 1e9)

    def around(a, b):
        return b >= near[0] and a <= near[1]

    placed = [(clock.place(s[T0]), clock.place(s[T1]), s)
              for s in idx.spans
              if s[NAME] != "query" and around(s[T0], s[T1])]
    waiting = [(clock.place(a), clock.place(b))
               for a, b in idx.waiting() if around(a, b)]
    handoff = []
    for got in idx.of_step.values():
        if "router.launch" in got and "worker.run" in got \
                and around(got["router.launch"][T1], got["worker.run"][T0]):
            handoff.append((clock.place(got["router.launch"][T1]),
                            clock.place(got["worker.run"][T0])))
    labels: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        labels[label(idx, placed, handoff, waiting, a, b)] += (b - a) / 1e6
    out["idle_gaps"] = sorted(labels.items(), key=lambda kv: -kv[1])
    # the replay's host time in the profiled steps, against the window's
    at = set(clock.at_ns.astype(np.int64).tolist())
    traced = [got["executor.replay"] for got in idx.of_step.values()
              if ANCHOR in got and "executor.replay" in got
              and got[ANCHOR][T0] in at]
    if traced:
        out["graph_launch_ms.traced"] = sum(
            s[T1] - s[T0] for s in traced) / len(traced) / 1e6
    if intact and hi > lo:
        out["device_idle_ready_share"] = 100.0 * _overlap(gaps, waiting) \
            / (hi - lo)
    return out


def label(idx: Index, placed, handoff, waiting, a: float, b: float) -> str:
    """The name of the idle gap ``[a, b)`` (profiler microseconds)."""
    if b - a < trace_mod.SHORT_GAP_US:
        return "between kernels (launch gaps)"
    mid = (a + b) / 2
    open_ = [s for x, y, s in placed if x <= mid < y]
    if open_:
        return max(open_, key=lambda s: (idx.depth(s), s[T0]))[NAME]
    if _intervals_at(handoff, mid):
        return HANDOFF
    return ASYNCIO if _intervals_at(waiting, mid) else NO_QUERY


def span_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns of one ``with tracing.span(...)`` (a name and a ``step``),
    tracing off and on."""
    from repro_torch import tracing
    out = {}
    for on in (False, True):
        if on:
            tracing.enable(n)
        t0 = time.perf_counter_ns()
        for i in range(n):
            with tracing.span("x", step=i):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        tracing.disable()
        tracing.drain()
    return out


def traced_run(name: str, seed: int, seconds: float,
               capacity: int = 1 << 22, **run_kw) -> Dict:
    """``run.run_cell(name, seed, seconds, trace=True, **run_kw)`` with the
    program's spans recorded over the served traffic: the run's
    ``result`` and ``info``, and under ``spans`` what this module reads
    (the window and the spans themselves under ``window``, ``raw``)."""
    from repro_torch import tracing
    from superbench import run, serve
    kept: Dict = {}
    run_window, analyse = serve.run_window, trace_mod.analyse

    def window(*a, **k):
        tracing.drain()
        tracing.enable(capacity)
        try:
            kept["window"] = run_window(*a, **k)
        finally:
            tracing.disable()
            kept["dropped"] = tracing.dropped()
            kept["spans"] = tracing.drain()
        return kept["window"]

    def read_trace(torch, events, *a, **k):
        evs = [(e.name, e.time_range.start, e.time_range.end,
                trace_mod._on_device(torch, e)) for e in events]
        tr = analyse(torch, events, *a, **k)
        kept["events"], kept["intact"] = evs, tr.intact
        return tr

    serve.run_window, trace_mod.analyse = window, read_trace
    try:
        res = run.run_cell(name, seed, seconds, True, **run_kw)
    finally:
        serve.run_window, trace_mod.analyse = run_window, analyse
    idx = Index.of(kept["spans"])
    w = kept["window"]
    steps = len(idx.of_step)
    rep = {**host_metrics(idx, w),
           **idle(idx, kept.get("events", []), kept.get("intact", False)),
           "spans": len(idx.spans), "dropped": kept["dropped"],
           "spans_per_step": (sum(s[NAME] not in ("query", "router.admit")
                                  for s in idx.spans) / steps
                              if steps else None),
           "queries": len(idx.queries), "steps": steps}
    return {**res, "spans": rep, "window": w, "raw": kept["spans"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from superbench.run import RunError
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    try:
        out = traced_run(args.workload, args.seed, args.seconds)
    except RunError as exc:
        print(str(exc), file=sys.stderr)
        return exc.code
    out["spans"]["span_cost_ns"] = span_cost_ns()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "result": out["result"], "spans": out["spans"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
