"""Scheduling-copy parity: the port keeps its own copies of the jax-free
scheduling modules (queue, forecast, residency, profiler, policies,
metrics, engine, traces, runtime). Driven on a VirtualClock over the same
seeded bursty trace, the port's Router and repro's must produce identical
CompletionRecords — this guards the copies against drift."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving import engine as jengine
from repro.serving import policies as jpolicies
from repro.serving import profiler as jprofiler
from repro.serving import runtime as jruntime
from repro.serving import traces as jtraces
from repro_torch.configs import get_config as tget_config
from repro_torch.serving import engine as tengine
from repro_torch.serving import policies as tpolicies
from repro_torch.serving import profiler as tprofiler
from repro_torch.serving import runtime as truntime
from repro_torch.serving import traces as ttraces

SLO = 0.05


def _records(mods, policy, arrivals, engine_kw, fault_times):
    cfg_mod, prof_mod, pol_mod, eng_mod, rt_mod = mods
    prof = prof_mod.build_profile(cfg_mod("qwen2-1.5b"))
    workers = rt_mod.make_supernet_workers(4, lambda i, b: b, lambda p: p)
    router = rt_mod.Router(prof, pol_mod.ALL_POLICIES[policy](), workers,
                           clock=eng_mod.VirtualClock(),
                           engine_cfg=eng_mod.EngineConfig(**engine_kw))
    recs = router.run_virtual(arrivals, SLO, fault_times=fault_times)
    return [dataclasses.astuple(r) for r in recs], router.stats()


@pytest.mark.parametrize("policy,engine_kw,fault_times", [
    ("slackfit", {}, None),
    ("maxbatch", {}, None),
    ("slackfit_sticky", {}, None),
    ("slackfit", {"continuous_batching": True}, {1: 0.4}),
])
def test_router_run_virtual_matches_repro(policy, engine_kw, fault_times):
    jarr = jtraces.bursty_trace(80.0, 320.0, 4.0, 2.0, 7)
    tarr = ttraces.bursty_trace(80.0, 320.0, 4.0, 2.0, 7)
    np.testing.assert_array_equal(jarr, tarr)
    assert len(tarr) > 100
    jrecs, jst = _records((jget_config, jprofiler, jpolicies, jengine,
                           jruntime), policy, jarr, engine_kw, fault_times)
    trecs, tst = _records((tget_config, tprofiler, tpolicies, tengine,
                           truntime), policy, tarr, engine_kw, fault_times)
    assert trecs == jrecs
    assert tst == jst
