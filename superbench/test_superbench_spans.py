"""The program's spans read against a run (``spans.py``): a traced CPU window
of the tiny cell gives the host numbers and agrees with what the harness
records; spans map onto a made-up profiler clock within their residual;
idle gaps take their labels; an untraced run records nothing."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from superbench import run, spans, spec, tiny, trace
from superbench.test_superbench_trace import STEP_LAUNCHES, _events

HOST = ("admit_to_launch_ms.p99", "dispatch_gap_ms.mean",
        "router_self_ms.mean", "step_load_ms.mean", "graph_launch_ms.mean")


@pytest.fixture
def traced():
    return spans.traced_run("tiny", 9, 1.0, device="cpu",
                            bench=tiny.bench(), cell=tiny.cell(),
                            arch=tiny.arch("qwen2-1.5b"))


def test_traced_cpu_window(traced):
    from repro_torch import tracing
    rep, window = traced["spans"], traced["window"]
    assert not tracing.enabled() and tracing.drain() == []
    assert rep["dropped"] == 0 and rep["spans_per_step"] == 10
    for name in HOST:
        assert isinstance(rep[name], float) and rep[name] >= 0, name
    # no card: the trace holds no device events to map onto
    assert "device_idle_ready_share" not in rep
    read = SimpleNamespace(window=window)
    queue_wait = spec.reader("queue_wait_ms.p99").read(read)
    # admitted at or after due, launched before the step's call
    assert rep["admit_to_launch_ms.p99"] <= queue_wait
    assert rep["router_self_ms.mean"] <= rep["dispatch_gap_ms.mean"]
    # the router's step numbers are the harness's steps, query for query
    idx = spans.Index.of(traced["raw"])
    assert len(idx.of_step) == len(window.steps)
    for n, step in enumerate(window.steps):
        assert sorted(q[spans.ATTRS]["qid"] for q in idx.batch[n]) == \
            sorted(step.qids)
        assert idx.of_step[n]["executor.step"][spans.ATTRS]["Bb"] >= step.rows


def test_untraced_run_records_nothing():
    from repro_torch import tracing
    run.run_cell("tiny", 9, 0.5, False, device="cpu", bench=tiny.bench(),
                 cell=tiny.cell(), arch=tiny.arch("qwen2-1.5b"))
    assert not tracing.enabled() and tracing.drain() == []


def _ring(n_steps=40, profiled=range(20, 32), offset_us=5e6, drift=2e-3):
    """A run's spans and the profiler's events of its traced steps: steps
    10-13 ms apart (buffer ns), the profiler's clock ``offset_us`` ahead
    and gaining ``drift`` s a second. Each step: its query admitted 500 us
    before its step, schedule, launch, the worker and the executor."""
    out, sid, host = [], 0, []
    base = 1_000_000_000
    apart = np.random.default_rng(5).integers(10_000_000, 13_000_000,
                                              n_steps)

    def rec(name, a, b, parent=None, tid=1, **attrs):
        nonlocal sid
        sid += 1
        out.append((sid, parent, name, int(a), int(b), tid, attrs))
        return sid

    def prof(t_ns):
        return (t_ns + offset_us * 1e3 + drift * (t_ns - base)) / 1e3

    t = base
    for k in range(n_steps):
        t += int(apart[k])
        q = rec("query", t - 500e3, t + 1500e3, qid=k, outcome="served",
                step=k)
        rec("router.admit", t - 500e3, t - 480e3, q, qid=k)
        s = rec("router.schedule", t - 250e3, t - 220e3, step=k)
        rec("engine.dispatch", t - 240e3, t - 230e3, s, step=k)
        launch = rec("router.launch", t - 200e3, t - 180e3, step=k)
        w = rec("worker.run", t - 100e3, t + 1400e3, launch, tid=2, step=k)
        e = rec("executor.step", t, t + 1300e3, w, tid=2, step=k, Bb=1)
        rec("executor.load", t, t + 50e3, e, tid=2, step=k)
        rec("executor.replay", t + 50e3, t + 100e3, e, tid=2, step=k)
        rec("executor.fetch", t + 100e3, t + 1300e3, e, tid=2, step=k)
        rec("router.complete", t + 1450e3, t + 1480e3, step=k)
        if k in profiled:
            host.append(("executor.step", prof(t), prof(t + 1300e3)))
    return out, host, prof


def test_spans_map_within_their_residual():
    ring, host, prof = _ring()
    idx = spans.Index.of(ring)
    clock = spans.anchor(idx, host)
    assert clock is not None and len(clock.at_ns) == len(host)
    # drift 2 us a ms over 10-13 ms between anchors: 10-13 us apart
    assert 9.0 < clock.residual_us < 14.0
    lo, hi = clock.at_ns[0], clock.at_ns[-1]
    for s in ring:
        for t in (s[spans.T0], s[spans.T1]):
            if lo <= t <= hi:
                assert abs(clock.place(t) - prof(t)) <= clock.residual_us
    # the steps before and after the profiled ones are not anchors
    assert spans.anchor(idx, host[:1]) is None
    assert spans.anchor(spans.Index.of(ring[:50]), host) is None


def test_idle_gaps_take_their_labels():
    idx = spans.Index.of([
        (1, None, "query", 0, 900, 1, {"qid": 0, "outcome": "served",
                                       "step": 0}),
        (2, None, "router.launch", 1000, 1100, 1, {"step": 0}),
        (3, None, "worker.run", 1300, 2000, 2, {"step": 0}),
        (4, 3, "executor.step", 1400, 1900, 2, {"step": 0}),
        (5, None, "router.complete", 2100, 2200, 1, {"step": 0}),
    ])
    # times in the profiler's microseconds
    placed = [(s[3], s[4], s) for s in idx.spans if s[2] != "query"]
    handoff = [(1100, 1300)]
    waiting = [(0, 1000)]

    def name(a, b):
        return spans.label(idx, placed, handoff, waiting, a, b)

    assert name(1450, 1460) == "between kernels (launch gaps)"
    assert name(1400, 1800) == "executor.step"        # innermost
    assert name(1310, 1390) == "worker.run"
    assert name(2100, 2190) == "router.complete"      # the loop's thread
    assert name(1150, 1250) == spans.HANDOFF
    assert name(400, 600) == spans.ASYNCIO            # a query waits
    assert name(2300, 2500) == spans.NO_QUERY


def _with_anchors(events, shift_us=0.0):
    """``test_superbench_trace``'s made-up events with the program's spans
    of the same steps; the buffer's clock ``shift_us`` behind."""
    ring = []
    out = [(e.name, e.time_range.start, e.time_range.end,
            trace._on_device(torch, e)) for e in events]
    for k in range(4):
        t, sid = 1000.0 * k - shift_us, 3 * k
        ns = [int(x * 1e3) for x in (t - 300, t - 280, t - 200, t + 650, t,
                                     t + 600)]
        ring += [(sid + 1, None, "router.launch", ns[0], ns[1], 1,
                  {"step": k}),
                 (sid + 2, sid + 1, "worker.run", ns[2], ns[3], 2,
                  {"step": k}),
                 (sid + 3, sid + 2, "executor.step", ns[4], ns[5], 2,
                  {"step": k})]
        out.append(("executor.step", 1000.0 * k, 1000.0 * k + 600, False))
    return ring, out


def test_idle_split_keeps_the_harness_idle_share():
    events = _events()
    tr = trace.analyse(torch, events, [STEP_LAUNCHES] * 4)
    share = 100.0 * (1.0 - tr.busy_s / tr.window_s)
    assert share == pytest.approx(spec.reader("device_idle_share").read(
        SimpleNamespace(window=SimpleNamespace(trace=tr))))
    ring, evs = _with_anchors(events, shift_us=123456.0)
    got = spans.idle(spans.Index.of(ring), evs, tr.intact)
    assert got["trace_clock_residual_us"] == pytest.approx(0.0, abs=1e-3)
    # every idle microsecond labelled, none by the old catch-all
    assert sum(v for _, v in got["idle_gaps"]) == pytest.approx(
        tr.window_s - tr.busy_s)
    labels = dict(got["idle_gaps"])
    assert "between steps (router, engine, asyncio)" not in labels
    assert set(labels) <= {"executor.step", "worker.run", spans.HANDOFF,
                           spans.NO_QUERY}
    # no query span: no query ever waits
    assert got["device_idle_ready_share"] == 0.0
    assert got["device_idle_ready_share"] <= share
