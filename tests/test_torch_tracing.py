"""The port's spans (``repro_torch/tracing.py``): nothing runs while tracing
is off; with it on, a tiny CPU executor behind a ``Router`` gives every
served query its ``query`` span and every step the router's, the worker's
and the executor's spans, linked across the hop to the worker thread."""
import asyncio
import json
import threading
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.serving import engine, policies, profiler, runtime, traces
from repro_torch.serving.executor import (ExecutorConfig, build_executor,
                                          serving_config)
from repro_torch.serving.queue import Query

SEQ = 16
STEP_TREE = {"engine.dispatch": "router.schedule",
             "worker.run": "router.launch", "worker.pad": "worker.run",
             "executor.step": "worker.run", "executor.load": "executor.step",
             "executor.replay": "executor.step",
             "executor.fetch": "executor.step"}
ROOTS = ("router.schedule", "router.launch", "router.complete")


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def served():
    cfg = serving_config("qwen2-1.5b", "cpu", "reduced")
    ex = build_executor(cfg, seed=0, device="cpu", exec_cfg=ExecutorConfig(
        batch_buckets=(1, 2, 4, 8), seq_buckets=(SEQ,)))
    ex.warmup(batches=(1, 2, 4, 8), seqs=(SEQ,))
    return cfg, ex


def _window(cfg, ex, n=24, gap_s=0.002):
    """Serve ``n`` queries ``gap_s`` apart through a fresh router over
    ``ex``; each step's query ids in the order the worker ran them."""
    steps = []

    def pad(payloads):
        steps.append([qid for qid, _ in payloads])
        return np.stack([row for _, row in payloads])

    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n, SEQ), dtype=np.int32)

    async def go():
        router = runtime.Router(
            profiler.build_profile(cfg, batches=(1, 2, 4, 8)),
            policies.SlackFit(),
            runtime.make_supernet_workers(1, ex.run_prefill, pad),
            executor=ex)
        await router.start()
        futs = []
        for i in range(n):
            now = router.clock.now()
            q = Query(deadline=now + 5.0, seq=0, arrival=now, qid=i)
            futs.append(await router.submit_query(q, (i, rows[i])))
            await asyncio.sleep(gap_s)
        await asyncio.wait(futs, timeout=60)
        await router.drain(timeout=5.0)
        return router

    router = asyncio.run(go())
    assert all(q.finish is not None for q in router.completed)
    return steps


def _boom(*a, **k):
    raise AssertionError("called while tracing is off")


def test_off_returns_the_null_span_and_times_nothing(served, monkeypatch):
    assert tracing.span("executor.step", Bb=4) is tracing.NULL
    with tracing.span("x") as sp:
        assert sp is tracing.NULL and not sp
    monkeypatch.setattr(tracing, "time",
                        SimpleNamespace(perf_counter_ns=_boom))
    monkeypatch.setattr(tracing, "_record_function", _boom)
    monkeypatch.setattr(tracing, "_profiling", _boom)
    monkeypatch.setattr(tracing, "_current",
                        SimpleNamespace(get=_boom, set=_boom, reset=_boom))
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    steps = _window(*served, n=8)
    assert steps and tracing.drain() == []


def test_on_gives_each_query_and_step_its_spans(served):
    tracing.enable()
    steps = _window(*served)
    tracing.disable()
    spans = tracing.drain()
    assert tracing.dropped() == 0
    by_sid = {s[0]: s for s in spans}
    name = {s[0]: s[2] for s in spans}
    # one query span a query, served, and the step that served it
    queries = {s[6]["qid"]: s for s in spans if s[2] == "query"}
    assert sorted(queries) == list(range(24))
    step_of = {q: n for n, qids in enumerate(steps) for q in qids}
    for qid, s in queries.items():
        assert s[1] is None and s[6]["outcome"] == "served"
        assert s[6]["step"] == step_of[qid]
    admits = [s for s in spans if s[2] == "router.admit"]
    assert sorted(by_sid[s[1]][6]["qid"] for s in admits) == list(range(24))
    assert all(s[6]["qid"] == by_sid[s[1]][6]["qid"] for s in admits)
    # every step: the roots on the loop's thread, their children linked
    # across the hop to the worker thread, all with the step's number
    of_step = defaultdict(lambda: defaultdict(list))
    for s in spans:
        if "step" in s[6] and s[2] not in ("query",):
            of_step[s[6]["step"]][s[2]].append(s)
    assert sorted(of_step) == list(range(len(steps)))
    loop_tid = admits[0][5]
    for n, got in of_step.items():
        assert {k: len(v) for k, v in got.items()} == dict.fromkeys(
            list(STEP_TREE) + list(ROOTS), 1), n
        for child, parent in STEP_TREE.items():
            assert name[got[child][0][1]] == parent
        for root in ROOTS:
            assert got[root][0][1] is None and got[root][0][5] == loop_tid
        assert got["worker.run"][0][5] != loop_tid
        assert got["executor.step"][0][6]["Bb"] >= len(steps[n])
        assert got["engine.dispatch"][0][6]["rows"] >= 1
        launch, run = got["router.launch"][0], got["worker.run"][0]
        # the launch ends at the hand-off, before the thread starts
        assert launch[4] <= run[3] <= run[4] <= got["router.complete"][0][3]
        step = got["executor.step"][0]
        for phase in ("executor.load", "executor.replay", "executor.fetch"):
            assert step[3] <= got[phase][0][3] <= got[phase][0][4] <= step[4]


def test_parent_survives_to_thread():
    tracing.enable()

    async def go():
        with tracing.span("outer", step=7) as outer:
            inner = await asyncio.to_thread(
                lambda: (tracing.span("inner").__enter__(),
                         threading.get_ident()))
            return outer, inner

    outer, (inner, tid) = asyncio.run(go())
    assert inner.parent == outer.sid and inner.attrs["step"] == 7
    assert inner.tid == tid != outer.tid


def test_explicit_roots_and_early_end():
    tracing.enable()
    with tracing.span("a") as a:
        root = tracing.span("b", parent=None)
        with tracing.span("c") as c:
            c.end(rows=3)
            assert tracing.span("d").parent == c.sid   # still current
        root.end(outcome="served")
    spans = {s[2]: s for s in tracing.drain()}
    assert spans["b"][1] is None and spans["b"][6] == {"outcome": "served"}
    assert spans["c"][1] == a.sid and spans["c"][6] == {"rows": 3}
    assert "d" not in spans                            # never ended


def test_self_time_is_a_span_less_its_children():
    rec = (1, None, "router.schedule", 100, 200, 0, {})
    kids = [(2, 1, "engine.dispatch", 110, 130, 0, {}),
            (3, 1, "x", 120, 150, 0, {}),      # overlaps the first
            (4, 1, "y", 190, 260, 0, {}),      # runs past the end
            (5, 1, "z", 40, 60, 0, {})]        # wholly outside
    assert tracing.self_ns(rec, kids) == 100 - 40 - 10
    assert tracing.self_ns(rec, []) == 100


def test_full_buffer_counts_dropped():
    tracing.enable(capacity=3)
    for i in range(5):
        with tracing.span("s", i=i):
            pass
    assert tracing.dropped() == 2
    kept = tracing.drain()
    assert [s[6]["i"] for s in kept] == [0, 1, 2]
    assert tracing.dropped() == 0 and tracing.drain() == []
    with pytest.raises(ValueError):
        tracing.enable(capacity=0)


def test_spans_enter_the_profiler_on_its_thread_only():
    from torch.profiler import ProfilerActivity, profile
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("executor.step"):
            pass
        def other():
            with tracing.span("worker.run"):
                pass

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    names = [e.name for e in prof.events()]
    assert "executor.step" in names and "worker.run" not in names
    assert {s[2] for s in tracing.drain()} == {"executor.step", "worker.run"}


def test_virtual_router_records_no_spans():
    """The parity path drives the engine alone: no span, so its records
    stay the simulator's whatever tracing does."""
    cfg = serving_config("qwen2-1.5b", "cpu", "reduced")
    arr = traces.bursty_trace(80.0, 320.0, 4.0, 1.0, 7)

    def records():
        router = runtime.Router(
            profiler.build_profile(cfg), policies.SlackFit(),
            runtime.make_supernet_workers(2, lambda i, b: b, lambda p: p),
            clock=engine.VirtualClock())
        return router.run_virtual(arr, 0.05)

    off = records()
    tracing.enable()
    assert records() == off and tracing.drain() == []


def test_chrome_export(tmp_path):
    from repro_torch.launch import serve
    path = tmp_path / "spans.json"
    out = serve.run(["--device", "cpu", "--queries", "6", "--seq-len", "8",
                     "--spans", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    assert out["spans"] == {"path": str(path), "count": len(events),
                            "dropped": 0}
    assert sum(e["name"] == "query" for e in events) == 6
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert not tracing.enabled()
    with pytest.raises(SystemExit):
        serve.run(["--execute", "sim", "--spans", str(path)])
