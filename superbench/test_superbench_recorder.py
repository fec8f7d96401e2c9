"""What the benchmark records around each served step: the judge's sample
covers every subnet the window served, each step's time on the card is
read into ``step_device_ms.mean``, and a run's verdict holds every number
to its limit."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from superbench import run, serve, spec


def _recorder(k, seed=3):
    def step(subnet_idx, tokens):
        return np.full((len(tokens), 4), float(subnet_idx), np.float32)
    return serve.Recorder(step, 0.0, float("inf"), k, seed)


@pytest.mark.parametrize("k", [0, 2, 8])
def test_sample_covers_every_served_subnet(k):
    rec = _recorder(k)
    subnets = [17] * 40 + [3, 9, 17, 9] + [17] * 40
    for i, sub in enumerate(subnets):
        rec.step(sub, ([i], np.zeros((1, 4), np.int32)))
    got = rec.samples
    steps = [s["step"] for s in got]
    assert steps == sorted(set(steps))
    if k == 0:
        assert got == []
        return
    assert {s["subnet"] for s in got} == {3, 9, 17}
    assert len(got) <= k + 3
    for s in got:
        assert np.all(s["logits"] == s["subnet"])


def test_sample_is_drawn_from_the_seed():
    def draw(seed):
        rec = _recorder(4, seed)
        for i in range(200):
            rec.step(i % 5, ([i], np.zeros((1, 4), np.int32)))
        return [s["step"] for s in rec.samples]
    assert draw(11) == draw(11)
    assert draw(11) != draw(12)


def test_step_device_ms_reads_the_windows_steps():
    steps = [serve.Step(t0, t0 + 0.01, 0, [0], 1, device_ms=ms)
             for t0, ms in [(0.5, 99.0), (1.0, 4.0), (1.5, 6.0),
                            (2.0, None), (3.5, 99.0)]]
    window = serve.Window(start=1.0, seconds=2.0, queries=[], steps=steps,
                          samples=[], builds=0, captures=0)
    read = spec.reader("step_device_ms.mean").read
    assert read(SimpleNamespace(window=window)) == pytest.approx(5.0)
    for s in steps:
        s.device_ms = None
    assert read(SimpleNamespace(window=window)) is None


def test_verdict_holds_each_number_to_its_limit():
    cell = {"limits": {"token_gap": 0.3, "logit_err_median": 0.09}}
    ok, checks = run.verdict(cell, {"token_gap": 0.1,
                                    "logit_err_median": 0.02}, 0, 0)
    assert ok and list(checks) == ["token_gap", "logit_err_median",
                                   "builds_after_warmup",
                                   "captures_after_warmup"]
    for bad, builds, captures in [({"token_gap": 0.4}, 0, 0),
                                  ({}, 1, 0), ({}, 0, 2),
                                  ({"logit_err_median": math.nan}, 0, 0)]:
        got = dict({"token_gap": 0.1, "logit_err_median": 0.02}, **bad)
        ok, checks = run.verdict(cell, got, builds, captures)
        assert not ok
    assert checks["logit_err_median"]["value"] is None


def test_moe_readings_keep_the_routed_rows():
    from superbench import judge
    rng = np.random.default_rng(0)
    want = rng.normal(size=(4, 32)).astype(np.float32)
    got = want + 1e-3
    got[3] = rng.normal(size=32)                 # a row that took other experts
    routed = np.array([True, True, True, False])
    r = judge.readings(got, want, routed)
    assert r["unrouted"] == 0.25
    assert r["logit_err_routed"] < 1e-2 < r["logit_err_max"]
    assert r["token_gap_routed"] < 1e-2
    none = judge.readings(got, want, np.zeros(4, bool))
    assert none["unrouted"] == 1.0
    assert none["logit_err_routed"] == none["logit_err_median"]
    assert "unrouted" not in judge.readings(got, want)
