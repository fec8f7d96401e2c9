"""The traced sub-window of a ``--trace 1`` run, and what is read from it.

``torch.profiler`` (CPU and CUDA activity) runs over a few whole steps of
the same traffic right after the window (``serve.py``): the worker starts it
before a step and stops it after one, when the device is idle
(``run_prefill`` synchronizes). The first step runs in the profiler's
warm-up phase and is dropped, and each phase's edge is ``GUARD_S`` clear
of the card's work, since the tracer can drop the first events of a
session and those it dates before its window opens. The trace is kept
only if every port kernel's count in it equals the launches the program
counted (``compat.launch_counts``) over the recorded steps; a trace that
lost events gives no number, and the tracer tries again (``TRIES``).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# host seconds kept between an edge of the trace and the card's work
GUARD_S = 0.005
# the port's kernels as the profiler names them -> the names the
# program's launch counter uses for them
SYMBOLS = {"subnet_rmsnorm_kernel": ("subnet_rmsnorm",),
           "flash_fwd_kernel": ("flash_attention",),
           "decode_attention_kernel": ("decode_attention",),
           "sliced_matmul_kernel": ("sliced_matmul", "sliced_matmul.experts")}
STEP = "superbench.step"
# an idle gap on the card longer than this (us) parts two steps' kernels
STEP_GAP_US = 300.0
COPIES = ("Memcpy", "Memset")
# traces taken before a run gives up on one that kept every event, and the
# seconds between them (the host stalls while a trace is read)
TRIES, RETRY_AFTER_S = 5, 0.5
# idle gaps shorter than this (us) are the launch gaps inside a replay
SHORT_GAP_US = 20.0


def _on_device(torch, ev) -> bool:
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("ProfilerStep"))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _doing(host, starts, a: float, b: float) -> str:
    """What the host was doing while the device idled over ``[a, b)``
    (microseconds): the innermost host event open at its middle."""
    if b - a < SHORT_GAP_US:
        return "between kernels (launch gaps)"
    mid = (a + b) / 2
    i = bisect.bisect_right(starts, mid)
    for x, y, name in reversed(host[max(0, i - 4096):i]):
        if y > mid:
            return name[:96]
    return "between steps (router, engine, asyncio)"


@dataclass
class Trace:
    """Seconds and counts read from one trace (times in seconds)."""
    intact: bool
    lost: List[Tuple]                         # (symbol, counted, traced)
    window_s: float
    busy_s: float
    steps: int                                # whole steps traced
    kernel_s: Dict[str, float]                # symbol -> device seconds
    launches: Dict[str, int]                  # counted over the trace
    device_ops: List[Tuple[str, float]]       # top device ops by seconds
    idle_gaps: List[Tuple[str, float]]        # idle seconds by host activity
    stop_s: float = 0.0                       # host seconds the stop took
    attempt: int = 0                          # the how-manieth trace


class Tracer:
    """Opens the profiler before the first step at or after ``arm``'s
    time. That step runs in the profiler's warm-up phase, whose events are
    dropped (the tracer can miss the first events of a session); the
    profiler then records the next ``steps`` steps and stops after them."""

    def __init__(self, steps: int, tries: int = TRIES):
        import torch
        self.torch = torch
        self.steps = int(steps)
        self.tries = tries
        self.traces: List[Trace] = []
        self.start_at = float("inf")
        self.state = "idle"              # idle, warming, counting, done
        self.prof = None
        self.pre: Dict[str, int] = {}
        self.step_launches: List[Dict[str, int]] = []

    def arm(self, start_at: float) -> None:
        self.start_at = start_at
        self.state = "idle"
        self.step_launches = []

    def warm(self, fn) -> None:
        """Start and stop the profiler around one call of ``fn`` (set-up),
        so the first trace of the window does not pay its initialisation."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            self.torch.cuda.synchronize()

    def before_step(self) -> int:
        """The number of the trace that counts the step about to run (the
        first is 1), 0 if none does."""
        if self.state == "idle" and time.perf_counter() >= self.start_at:
            from torch.profiler import ProfilerActivity, profile, schedule
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
            self.prof.start()
            time.sleep(GUARD_S)
            self.state = "warming"
        if self.state == "counting":
            from repro_torch import compat
            self.pre = compat.launch_counts()
            return len(self.traces) + 1
        return 0

    def span(self):
        return self.torch.profiler.record_function(STEP)

    def after_step(self, t1: float) -> None:
        from repro_torch import compat
        if self.state == "warming":
            time.sleep(GUARD_S)
            self.prof.step()             # warm-up over: record from here
            time.sleep(GUARD_S)
            self.state = "counting"
        elif self.state == "counting":
            now = compat.launch_counts()
            self.step_launches.append({k: v - self.pre.get(k, 0)
                                       for k, v in now.items()})
            if len(self.step_launches) >= self.steps:
                self._close()

    def _close(self) -> None:
        time.sleep(GUARD_S)
        t0 = time.perf_counter()
        self.prof.stop()
        stop_s = time.perf_counter() - t0
        tr = analyse(self.torch, self.prof.events(), self.step_launches,
                     stop_s)
        self.traces.append(tr)
        tr.attempt = len(self.traces)
        self.prof = None
        if tr.intact or len(self.traces) >= self.tries:
            self.state = "done"
        else:                            # lost events: trace again shortly
            self.arm(time.perf_counter() + RETRY_AFTER_S)

    def result(self) -> Optional[Trace]:
        """The last trace taken (None if none closed)."""
        if self.state in ("warming", "counting"):
            self.prof.stop()             # the tail ran out
            self.state = "done"
        return self.traces[-1] if self.traces else None


def _steps(dev) -> List[List[Tuple[float, float, str]]]:
    """The kernels of the device events split into steps at idle gaps over
    ``STEP_GAP_US`` (between two steps the card waits for the host's
    synchronize and its next launch; inside one, a graph's kernels follow
    each other within microseconds). Copies are left out: a step's input
    copy lands before its graph launch, milliseconds ahead of its kernels.
    Splitting on the card's own timeline needs no mapping of its clock
    onto the host's, which drifts by milliseconds."""
    out: List[List[Tuple[float, float, str]]] = []
    end = float("-inf")
    for e in sorted(dev):
        if e[2].startswith(COPIES):
            continue
        if e[0] - end > STEP_GAP_US:
            out.append([])
        out[-1].append(e)
        end = max(end, e[1])
    return out


def analyse(torch, events, step_launches: List[Dict[str, int]],
            stop_s: float = 0.0) -> Trace:
    """Read a trace whose recorded phase held only counted steps, whose
    launches by the program's counter are ``step_launches``. The device
    events split into one group a step (:func:`_steps`); the first and
    the last step are dropped (the tracer can lose events at a phase's
    edges) and the steps between are read, each of their port kernels
    counted against the launches of its step."""
    dev, host = [], []
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if _on_device(torch, ev):
            dev.append((a, b, ev.name))
        elif b > a and not ev.name.startswith("ProfilerStep"):
            host.append((a, b, ev.name))
    groups = _steps(dev)
    lost: List[Tuple] = []
    if len(groups) != len(step_launches) or len(groups) < 3:
        lost.append(("steps on the card, counted", len(groups),
                     len(step_launches)))
        groups, step_launches = groups[:0], step_launches[:0]
    middle = groups[1:-1]
    kernel_s: Dict[str, float] = defaultdict(float)
    for g, counted in zip(middle, step_launches[1:-1]):
        for sym, names in SYMBOLS.items():
            traced = [b - a for a, b, n in g if sym in n]
            kernel_s[sym] += sum(traced) / 1e6
            want = sum(counted.get(n, 0) for n in names)
            if want != len(traced):
                lost.append((sym, want, len(traced)))
    lo = middle[0][0][0] if middle else 0.0
    hi = groups[-1][0][0] if middle else 0.0
    mid = [e for e in dev if lo <= e[0] < hi]
    merged = _union([(a, b) for a, b, _ in mid])
    ops: Dict[str, float] = defaultdict(float)
    for a, b, n in mid:
        ops[n[:96]] += (b - a) / 1e6
    host.sort()
    starts = [x for x, _, _ in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [v for iv in merged for v in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_doing(host, starts, a, b)] += (b - a) / 1e6
    launches: Dict[str, int] = defaultdict(int)
    for counted in step_launches[1:-1]:
        for k, v in counted.items():
            launches[k] += v
    return Trace(
        intact=not lost, lost=lost[:8], window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in merged) / 1e6, steps=len(middle),
        kernel_s=dict(kernel_s), launches=dict(launches),
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        stop_s=stop_s)
