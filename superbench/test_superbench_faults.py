"""A whole run on the CPU (the look for a card skipped) at the reduced
size: sound, it comes out correct; with the served step broken
underneath, it does not. The faults a serving cell can have: a step that
hands back its previous answer unchanged, half of the batch left out
(those rows take the mean of the rest), and an answer altered where it is
produced."""
import numpy as np
import pytest

from superbench import run, tiny


def stale(step):
    last = {}

    def wrapped(subnet_idx, tokens):
        out = step(subnet_idx, tokens)
        prev = last.get("out")
        last["out"] = out
        if prev is None or len(prev) != len(out):
            return out
        return prev.copy()
    return wrapped


def half_batch(step):
    def wrapped(subnet_idx, tokens):
        out = step(subnet_idx, tokens)
        n = len(out) // 2
        if n:
            out[n:] = out[:n].mean(0)
        return out
    return wrapped


def altered(step):
    def wrapped(subnet_idx, tokens):
        out = step(subnet_idx, tokens)
        out[0, out[0].argmin()] = out[0].max() + 1.0
        return out
    return wrapped


def _run(wrap=None, mode="switch", seed=2**31 + 17):
    cell = dict(tiny.cell(mode), rate_qps=600.0)
    return run.run_cell("tiny", seed, 1.0, False, device="cpu",
                        bench=tiny.bench(), cell=cell,
                        arch=tiny.arch("qwen2-1.5b"), wrap_step=wrap)


def test_sound_run_is_correct():
    res = _run()["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 100
    assert set(res["metrics"]) == {"slo_attainment", "mean_accuracy",
                                   "p99_latency_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["builds_after_warmup"]["value"] == 0


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
def test_broken_step_is_not_correct(fault):
    res = _run(fault)["result"]
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > \
        res["checks"]["token_gap"]["limit"]


MOE_LIMITS = {"unrouted": 0.0, "logit_err_routed": 1e-3,
              "route_margin": 1e-3}


def _moe_run(**kw):
    cell = dict(tiny.cell("switch"), rate_qps=300.0, limits=MOE_LIMITS)
    return run.run_cell("tiny", 5, 1.0, False, device="cpu",
                        bench=tiny.bench(), cell=cell,
                        arch=tiny.arch("mixtral-8x7b"), **kw)["result"]


def test_moe_run_is_correct():
    res = _moe_run()
    assert res["correct"], res["checks"]
    assert res["checks"]["route_margin"]["value"] == 0.0


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
def test_moe_broken_step_is_not_correct(fault):
    res = _moe_run(wrap_step=fault)
    assert not res["correct"], res["checks"]


def test_moe_run_with_experts_swapped_is_not_correct(monkeypatch):
    """A token's experts altered where they are chosen: the second best
    taken first. The reference takes the same experts, so the logits
    agree; the routing's own check does not."""
    from repro_torch.models import moe
    route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda logits, cfg: route(logits, cfg).flip(-1))
    res = _moe_run()
    assert not res["correct"]
    assert res["checks"]["route_margin"]["value"] > MOE_LIMITS["route_margin"]
