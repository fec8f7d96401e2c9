"""Cluster-plane parity: the port's ``ClusterRouter`` (its copy of
``runtime.py``'s cluster front door over the copied coordinator and
autoscaler) against the JAX package's. Driven to quiescence on a
``VirtualClock`` over the same seeded trace, both give identical
completion records and stats for every placement, with replica deaths,
worker faults, continuous batching and each autoscale policy. Then the
port's launcher serves two in-process replicas of one executor for real
on the CPU."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving import autoscaler as jautoscaler
from repro.serving import engine as jengine
from repro.serving import forecast as jforecast
from repro.serving import policies as jpolicies
from repro.serving import profiler as jprofiler
from repro.serving import runtime as jruntime
from repro.serving import traces as jtraces
from repro_torch.configs import get_config as tget_config
from repro_torch.serving import autoscaler as tautoscaler
from repro_torch.serving import cluster as tcluster
from repro_torch.serving import engine as tengine
from repro_torch.serving import forecast as tforecast
from repro_torch.serving import policies as tpolicies
from repro_torch.serving import profiler as tprofiler
from repro_torch.serving import runtime as truntime
from repro_torch.serving import traces as ttraces

JAX = (jget_config, jprofiler, jpolicies, jengine, jruntime, jautoscaler,
       jforecast, jtraces)
TORCH = (tget_config, tprofiler, tpolicies, tengine, truntime, tautoscaler,
         tforecast, ttraces)
SLO = 0.036


def _records(mods, placement, n_replicas, workers, engine_kw,
             autoscale_kw, forecast_kw, deaths, faults):
    (get_config, profiler, policies, engine, runtime, autoscaler, forecast,
     traces) = mods
    prof = profiler.build_profile(get_config("ofa_resnet"))
    arr = traces.bursty_trace(100.0, 400.0, 4.0, 1.5, 23)
    groups = [[runtime.WorkerHandle(wid=i, run=lambda idx, p: p)
               for i in range(workers)] for _ in range(n_replicas)]
    router = runtime.ClusterRouter(
        prof, policies.SlackFit(), groups, clock=engine.VirtualClock(),
        engine_cfg=engine.EngineConfig(**engine_kw), placement=placement,
        placement_seed=3, slo=SLO,
        autoscale=(autoscaler.AutoscaleConfig(**autoscale_kw)
                   if autoscale_kw else None),
        forecast=(forecast.ForecastConfig(**forecast_kw)
                  if forecast_kw else None))
    recs = router.run_virtual(arr, SLO, replica_deaths=deaths,
                              fault_times=faults)
    events = ([dataclasses.astuple(e) for e in router.autoscaler.events]
              if router.autoscaler else [])
    return [dataclasses.astuple(r) for r in recs], router.stats(), events


CASES = [(p, 3, 2, {}, None, None, {1: 0.6}, {(0, 1): 0.3})
         for p in sorted(tcluster.PLACEMENTS)] + [
    ("least_loaded", 2, 2, {"continuous_batching": True}, None, None,
     None, {(1, 0): 0.5}),
    ("round_robin", 1, 1, {}, dict(min_replicas=1, max_replicas=4,
                                   policy="queue_pressure"), None, None,
     None),
    ("slack_aware", 1, 1, {"continuous_batching": True,
                           "predictive_joins": True},
     dict(min_replicas=1, max_replicas=4, policy="predictive",
          rate_window=0.2), {"window": 0.2}, None, None),
]


@pytest.mark.parametrize(
    "placement,n_replicas,workers,engine_kw,autoscale_kw,forecast_kw,"
    "deaths,faults", CASES,
    ids=[f"{p}_deaths" for p in sorted(tcluster.PLACEMENTS)]
    + ["continuous_batching", "autoscale_queue_pressure",
       "autoscale_predictive"])
def test_cluster_run_virtual_matches_repro(placement, n_replicas, workers,
                                           engine_kw, autoscale_kw,
                                           forecast_kw, deaths, faults):
    args = (placement, n_replicas, workers, engine_kw, autoscale_kw,
            forecast_kw, deaths, faults)
    jrecs, jst, jev = _records(JAX, *args)
    trecs, tst, tev = _records(TORCH, *args)
    assert len(trecs) > 200
    if autoscale_kw:
        assert {e[1] for e in tev} >= {"spawn", "ready"}
    assert trecs == jrecs
    assert tev == jev
    assert tst == jst


def test_launcher_serves_two_inproc_replicas_on_cpu():
    """``--replicas 2``: one executor, two worker groups behind the
    port's ClusterRouter, in switch mode; each replica serves, nothing is
    built while serving."""
    from repro_torch.launch import serve
    out = serve.run(["--device", "cpu", "--queries", "16", "--replicas",
                     "2", "--placement", "slack_aware", "--slice-mode",
                     "switch", "--seq-len", "8"])
    assert out["replicas"] == 2 and out["placement"] == "slack_aware"
    assert out["served"] == out["queries"] == 16
    assert set(out["per_replica_served"]) == {0, 1}
    assert all(v >= 1 for v in out["per_replica_served"].values())
    assert out["serve_phase_builds"] == 0
    assert out["slice_mode"] == "switch" and out["device"] == "cpu"
    assert out["serve_phase_compiles"] is None
    assert 0.0 <= out["slo_attainment"] <= 1.0
    assert np.isfinite(out["p99_latency_ms"])
