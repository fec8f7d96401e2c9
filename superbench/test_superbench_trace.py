"""Reading a trace: the per-name check against the launch counter, busy
time and idle gaps, on made-up events; and a traced run on the CPU that
tries again after a trace that lost events."""
from types import SimpleNamespace

import pytest
import torch

from superbench import run, tiny, trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


GRAPH = ["void sliced_matmul_kernel<128>(x)", "nvjet_gemm",
         "void flash_fwd_kernel<64, 128>(y)"]
STEP_LAUNCHES = {"sliced_matmul": 1, "flash_attention": 1}


def _events(steps=4, lose=()):
    """``steps`` steps 1000 us apart: a host span, a graph launch, three
    kernels of 100 us back to back, a synchronize; ``lose`` names the
    (step, kernel) events the tracer dropped."""
    out = []
    for k in range(steps):
        t = 1000.0 * k
        out += [ev(trace.STEP, t, t + 600, CPU),
                ev("cudaGraphLaunch", t + 10, t + 20, CPU),
                ev("cudaStreamSynchronize", t + 200, t + 590, CPU)]
        out += [ev(name, t + 50 + 100 * i, t + 150 + 100 * i)
                for i, name in enumerate(GRAPH) if (k, i) not in lose]
        # the input's copy lands before the graph, the logits' after it
        out += [ev("Memcpy HtoD (Pinned -> Device)", t - 400, t - 399),
                ev("Memcpy DtoH (Device -> Pinned)", t + 350, t + 360)]
    return out


def test_intact_trace():
    tr = trace.analyse(torch, _events(), [STEP_LAUNCHES] * 4)
    assert tr.intact and tr.steps == 2
    # from the second step's first kernel to the last step's
    assert tr.window_s == pytest.approx(2000e-6)
    assert tr.busy_s == pytest.approx(600e-6 + 2 * 10e-6 + 2 * 1e-6)
    assert tr.kernel_s["sliced_matmul_kernel"] == pytest.approx(200e-6)
    assert tr.launches == {"sliced_matmul": 2, "flash_attention": 2}
    # the card idles after each middle step's logits copy and before and
    # after the next input copy; each gap is named by what the host did at
    # its middle (here nothing the trace saw)
    assert dict(tr.idle_gaps) == {
        "cudaStreamSynchronize": pytest.approx(2 * 240e-6),
        "between steps (router, engine, asyncio)": pytest.approx(
            2 * 449e-6)}


def test_edge_losses_are_dropped_a_middle_loss_is_caught():
    edges = trace.analyse(torch, _events(lose={(0, 0), (3, 2)}),
                          [STEP_LAUNCHES] * 4)
    assert edges.intact
    middle = trace.analyse(torch, _events(lose={(1, 0)}),
                           [STEP_LAUNCHES] * 4)
    assert not middle.intact
    assert ("sliced_matmul_kernel", 1, 0) in middle.lost
    whole = trace.analyse(torch, _events(steps=3), [STEP_LAUNCHES] * 4)
    assert not whole.intact


def test_traced_run_tries_again(monkeypatch):
    seen = []
    analyse = trace.analyse

    def flaky(*a, **k):
        tr = analyse(*a, **k)            # on the CPU: no device events
        seen.append(tr)
        tr.intact = len(seen) > 1
        return tr

    monkeypatch.setattr(trace, "analyse", flaky)
    names = ("generator_lag_ms.p99", "batch_size.mean", "step_host_ms.mean")
    bench = dict(tiny.bench(), per_layer=[{"name": n, "unit": "u"}
                                          for n in names])
    res = run.run_cell("tiny", 9, 1.0, True, device="cpu", bench=bench,
                       cell=tiny.cell(), arch=tiny.arch("qwen2-1.5b"))
    assert res["info"]["trace_tries"] == 2 and len(seen) == 2
    assert set(res["result"]["metrics"]) == set(names)
    assert "busy_s" in res["result"]["device"]
