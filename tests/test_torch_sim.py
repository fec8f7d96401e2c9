"""Simulator and launcher parity: the port's copies of
``serving/simulator.py`` (with ``cluster.py`` and ``autoscaler.py`` under
it) and the port's ``launch/serve.py --execute sim`` against the JAX
package's. Driven on the same seeded traces and configs, both packages
must give identical completion records, dispatch records, scale events
and stats, and the launcher's JSON must equal the reference launcher's
key for key (the port adds only its own keys)."""
import dataclasses
import json
import sys

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.serving import autoscaler as jautoscaler
from repro.serving import forecast as jforecast
from repro.serving import policies as jpolicies
from repro.serving import profiler as jprofiler
from repro.serving import simulator as jsimulator
from repro.serving import traces as jtraces
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.serving import autoscaler as tautoscaler
from repro_torch.serving import forecast as tforecast
from repro_torch.serving import policies as tpolicies
from repro_torch.serving import profiler as tprofiler
from repro_torch.serving import simulator as tsimulator
from repro_torch.serving import traces as ttraces

JAX = (jget_config, jprofiler, jpolicies, jsimulator, jautoscaler, jforecast,
       jtraces)
TORCH = (tget_config, tprofiler, tpolicies, tsimulator, tautoscaler,
         tforecast, ttraces)
# the keys the port's launcher adds to the reference's JSON
PORT_KEYS = {"device", "size", "units", "slice_mode", "serve_phase_builds",
             "kernel_launches"}


def _astuples(xs):
    return [dataclasses.astuple(x) for x in xs]


def _run(mods, arch, cluster, cfg_kw, autoscale_kw=None, forecast_kw=None):
    get_config, profiler, policies, simulator, autoscaler, forecast, traces \
        = mods
    prof = profiler.build_profile(get_config(arch))
    arr = traces.bursty_trace(100.0, 400.0, 4.0, 1.5, 11)
    kw = dict(cfg_kw)
    if forecast_kw is not None:
        kw["forecast"] = forecast.ForecastConfig(**forecast_kw)
    if cluster:
        if autoscale_kw is not None:
            kw["autoscale"] = autoscaler.AutoscaleConfig(**autoscale_kw)
        res = simulator.simulate_cluster(arr, prof, policies.SlackFit(),
                                         simulator.ClusterConfig(**kw))
        extra = (_astuples(res.scale_events), res.replica_spans,
                 res.n_replicas, res.forecast, res.n_predictive_windows)
    else:
        res = simulator.simulate(arr, prof, policies.SlackFit(),
                                 simulator.SimConfig(**kw))
        extra = (res.n_open_batches, res.n_predictive_windows)
    return (_astuples(res.records), _astuples(res.dispatches), res.stats(),
            res.n_joins, res.n_switches, res.actuation_seconds, extra)


@pytest.mark.parametrize("arch,cluster,cfg_kw,autoscale_kw,forecast_kw", [
    ("ofa_resnet", False, dict(n_workers=4, fault_times={1: 0.4, 3: 0.9}),
     None, None),
    ("qwen2-1.5b", False, dict(n_workers=3, load_on_switch=True,
                               continuous_batching=True), None, None),
    ("ofa_resnet", False, dict(n_workers=2, continuous_batching=True,
                               predictive_joins=True), None, {"window": 0.2}),
    ("ofa_resnet", True, dict(n_replicas=3, workers_per_replica=2,
                              placement="slack_aware",
                              replica_deaths={1: 0.6},
                              fault_times={(0, 1): 0.3}), None, None),
    ("qwen2-1.5b", True, dict(n_replicas=2, workers_per_replica=2,
                              placement="actuation_aware",
                              load_on_switch=True), None, None),
    ("ofa_resnet", True, dict(n_replicas=1, workers_per_replica=1),
     dict(min_replicas=1, max_replicas=4, policy="queue_pressure"), None),
    ("ofa_resnet", True, dict(n_replicas=1, workers_per_replica=1,
                              predictive_joins=True,
                              continuous_batching=True),
     dict(min_replicas=1, max_replicas=4, policy="predictive",
          rate_window=0.2), {"window": 0.2}),
    ("ofa_resnet", True, dict(n_replicas=1, workers_per_replica=1,
                              placement="power_of_two"),
     dict(min_replicas=1, max_replicas=3, policy="slo_headroom",
          cold_start=None), None),
    ("ofa_resnet", True, dict(n_replicas=2, workers_per_replica=2),
     dict(min_replicas=1, max_replicas=3, policy="scripted",
          script=((0.2, +1), (0.9, -1), (1.1, -1))), None),
], ids=["faults", "load_on_switch_cb", "predictive_joins", "deaths_faults",
        "actuation_aware", "queue_pressure", "predictive", "slo_headroom",
        "scripted"])
def test_simulators_match_repro(arch, cluster, cfg_kw, autoscale_kw,
                                forecast_kw):
    want = _run(JAX, arch, cluster, cfg_kw, autoscale_kw, forecast_kw)
    got = _run(TORCH, arch, cluster, cfg_kw, autoscale_kw, forecast_kw)
    assert len(got[0]) > 200
    if autoscale_kw is not None:
        # each autoscale case scales at this load
        assert {"spawn", "ready"} <= {e[1] for e in got[-1][0]}
    assert got == want


def test_analytic_profiles_match_repro():
    """The profile the sim path schedules from: the paper's OFA-ResNet
    and the reduced qwen2-1.5b."""
    for name, reduce in (("ofa_resnet", False), ("qwen2-1.5b", True)):
        jc, tc = jget_config(name), tget_config(name)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        jp, tp = jprofiler.build_profile(jc), tprofiler.build_profile(tc)
        assert tp.arch == jp.arch and tp.batches == jp.batches
        assert tp.n_buckets == jp.n_buckets
        np.testing.assert_array_equal(tp.lat, jp.lat)
        np.testing.assert_array_equal(tp.accs, jp.accs)
        assert [dataclasses.astuple(p) for p in tp.points] == \
            [dataclasses.astuple(p) for p in jp.points]


def _jax_launcher(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    capsys.readouterr()
    jserve.main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("argv", [
    ["--arch", "ofa_resnet", "--policy", "clipper", "--rate", "400"],
    ["--arch", "ofa_resnet", "--policy", "clipper", "--clipper-idx", "2",
     "--rate", "300", "--faults", "3:0.4,5:0.8"],
    ["--arch", "ofa_resnet", "--trace", "time_varying", "--tau", "150",
     "--cv2", "2", "--rate", "450"],
    ["--arch", "qwen2-1.5b", "--trace", "maf", "--rate", "300",
     "--continuous-batching", "--load-on-switch"],
    ["--arch", "ofa_resnet", "--replicas", "3", "--placement", "round_robin",
     "--rate", "450", "--faults", "0.1:0.5", "--replica-deaths", "2:0.9"],
    ["--arch", "ofa_resnet", "--replicas", "3", "--placement",
     "least_loaded", "--rate", "450", "--predictive-joins"],
    ["--arch", "ofa_resnet", "--replicas", "3", "--placement",
     "power_of_two", "--rate", "450", "--cv2", "8"],
    ["--arch", "ofa_resnet", "--replicas", "3", "--placement",
     "slack_aware", "--rate", "450", "--slo-ms", "30"],
    ["--arch", "qwen2-1.5b", "--replicas", "3", "--placement",
     "actuation_aware", "--rate", "400", "--load-on-switch"],
    ["--arch", "ofa_resnet", "--autoscale", "--scale-policy", "predictive",
     "--replicas", "1", "--min-replicas", "1", "--max-replicas", "4",
     "--workers", "1", "--rate", "450", "--cold-start", "auto",
     "--forecast-window", "0.3"],
], ids=["clipper", "clipper_idx_faults", "time_varying", "maf_cb_los",
        "round_robin_deaths", "least_loaded_pj", "power_of_two",
        "slack_aware", "actuation_aware", "autoscale_predictive"])
def test_sim_launcher_json_matches_repro(argv, capsys, monkeypatch):
    argv = ["--execute", "sim", "--duration", "1.5"] + argv
    want = _jax_launcher(argv, capsys, monkeypatch)
    got = json.loads(json.dumps(tserve.run(argv)))
    assert want["queries"] > 200
    assert want.get("scale_events", [None])
    assert set(got) - set(want) == PORT_KEYS
    assert {k: got[k] for k in want} == want
    # the simulator runs on no device and launches nothing
    assert got["device"] is None and got["kernel_launches"] == {}
    assert got["serve_phase_builds"] == 0


def test_launcher_defaults_and_refusals():
    """The port's defaults (real execution of qwen2-1.5b, 8 workers under
    sim and 1 under real, a measured profile in-process) and the
    reference's refusals."""
    sim = tserve.parse_args(["--execute", "sim"])
    assert (sim.workers, sim.profile_mode) == (8, "analytic")
    real = tserve.parse_args(["--device", "cpu"])
    assert (real.execute, real.arch, real.workers, real.profile_mode) == \
        ("real", "qwen2-1.5b", 1, "measured")
    assert tserve.parse_args(["--device", "cpu", "--transport", "proc"]
                             ).profile_mode == "analytic"
    for argv in (["--execute", "sim", "--host-devices", "2"],
                 ["--device", "cpu", "--arch", "ofa_resnet"],
                 ["--device", "cpu", "--autoscale"],
                 ["--device", "cpu", "--transport", "proc", "--profile",
                  "measured"],
                 ["--execute", "sim", "--listen", "127.0.0.1:0"],
                 ["--execute", "sim", "--cold-start", "soon"],
                 ["--execute", "sim", "--autoscale", "--replicas", "9"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(argv)
