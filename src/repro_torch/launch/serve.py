"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --execute real \
        --arch qwen2-1.5b --queries 64 --seq-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --execute sim \
        --arch ofa_resnet --trace bursty --rate 7000 --cv2 8 --duration 10

A port of ``repro/launch/serve.py``: every flag and branch of the
reference's ``main``, over the port's copies of the scheduling stack.

``--execute real`` (the port's default) runs real subnet forward passes.
It builds the supernet executor from a seeded ``torch.Generator`` on
``--device`` (the GPU unless ``--device cpu``), warms every bucket the
policy can choose, and serves a trace through the in-process asyncio
``Router``, or with ``--replicas N`` (N > 1) through a ``ClusterRouter``
over N worker groups of one executor, placed by ``--placement``. The
profile it schedules from is measured on the device unless ``--profile
analytic`` (the port's rule: the analytic roofline models the paper's
2080 Ti, not this device). Rate and SLO default to the reference's
device-safe rule: 0.25 / the smallest subnet's B = 1 latency, and 25x
the largest's.

``--transport proc`` serves the trace live through ``--procs`` replica
child processes (``serving/ipc.py``): socketpairs, or TCP with
``--listen HOST:PORT`` and an HMAC token, the front door a remote
``--connect HOST:PORT --token T`` child dials. With ``--execute real``
each child builds its own executor at the same config (20 q/s and a
4000 ms SLO unless set); echo workers (``--work-ms`` of CPU spin per
batch) stand in otherwise. ``--autoscale`` runs the live autoscaler over
it.

``--execute sim`` (the reference's default mode) runs the discrete-event
simulator (``simulate``, or ``simulate_cluster`` with ``--replicas`` > 1
or ``--autoscale``) at 7000 q/s and a 36 ms SLO unless set, with the
analytic profile, on no device at all; ``--profile measured`` builds and
times the executor on ``--device`` first.

``--arch`` names any registered config (``repro_torch.configs``).
``--size full`` (the default on ``cuda``) keeps the published widths and
depth; ``--units N`` keeps the first N repeat units of each stage, and a
depth whose weights exceed the device's free memory is refused before
anything is allocated. ``--size reduced`` is the small fp32 twin of the
JAX launcher's executor and runs with ``--device cpu`` (the default
there). ``--slice-mode switch`` serves with WeightSlice switch mode (the
``sliced_matmul`` kernel over the active widths). Every JSON reports
``device``, ``size``, ``units``, ``slice_mode``, the kernel builds while
serving (``serve_phase_builds``, 0 after warmup) and the kernel
launches; under ``--transport proc`` they are summed over the children
and each child's are listed under ``children``.

``--spans PATH`` (``--execute real``, in process) records the serving
phase's spans (``repro_torch/tracing.py``: the router's, the worker's and
the executor's) and writes them to PATH as Chrome trace-event JSON, for
``chrome://tracing`` or Perfetto; the report gives their count.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import compat, tracing
from repro_torch.configs import get_config
from repro_torch.serving import cluster, policies, profiler, simulator, traces
from repro_torch.serving.autoscaler import SCALINGS, AutoscaleConfig
from repro_torch.serving.executor import (check_fits, cut_units,  # noqa: F401
                                          free_bytes, serving_config)
from repro_torch.serving.forecast import ForecastConfig

PROFILE_BATCHES = (1, 2, 4, 8)


def _host_latency(executor, subnet_idx: int, seq_len: int,
                  iters: int = 3) -> float:
    """Best-of-k wall clock for a warmed B=1 prefill on this device."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        executor.run_prefill(subnet_idx, np.ones((1, seq_len), np.int32))
        best = min(best, time.perf_counter() - t0)
    return best


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _serve_real(args, cfg, prof, pol, executor, arr, slo_s) -> Dict:
    """Serve ``arr`` with real forward passes through the asyncio
    router(s); scheduling stays entirely inside the engine. As in the
    reference, no ``EngineConfig`` reaches the routers."""
    from repro_torch.serving import runtime

    async def go():
        rng = np.random.default_rng(args.seed)
        payloads = rng.integers(0, cfg.vocab_size,
                                (len(arr), args.seq_len)).astype(np.int32)
        if args.replicas > 1:
            router = runtime.ClusterRouter(
                prof, pol,
                [executor.make_workers(args.workers)
                 for _ in range(args.replicas)],
                placement=args.placement, placement_seed=args.seed,
                slo=slo_s)
        else:
            router = runtime.Router(prof, pol,
                                    executor.make_workers(args.workers),
                                    executor=executor)
        await router.start()
        t0 = time.perf_counter()
        futs = []
        for i, t in enumerate(arr):
            now = time.perf_counter() - t0
            if t > now:
                await asyncio.sleep(t - now)
            futs.append(await router.submit(payloads[i], slo_s=slo_s))
        await asyncio.gather(*futs)
        await router.drain()
        return router

    launches0 = compat.launch_counts()
    with compat.BuildCounter() as builds, compat.CaptureCounter() as caps:
        router = asyncio.run(go())
    launches = {k: v - launches0.get(k, 0)
                for k, v in compat.launch_counts().items()}
    st = router.stats()
    recs = router.records()
    lats = sorted(r.finish - r.arrival for r in recs if r.finish is not None)

    def pct(q: float):
        return (lats[min(int(q * len(lats)), len(lats) - 1)] * 1e3
                if lats else None)

    out = {"queries": len(recs), "served": len(lats),
           "replicas": args.replicas, "workers": args.workers,
           "slo_attainment": st["slo_attainment"],
           "mean_acc": st["mean_acc"],
           "p50_latency_ms": pct(0.50), "p99_latency_ms": pct(0.99),
           "switch_rate": st["switch_rate"],
           "actuation_seconds": st["actuation_seconds"],
           # no XLA here: the port's warm-serving gate is
           # serve_phase_builds, its kernel builds while serving (0)
           "serve_phase_compiles": None,
           "serve_phase_builds": builds.count,
           # and its CUDA-graph captures while serving (0)
           "serve_phase_captures": caps.count,
           "kernel_launches": launches}
    if args.replicas > 1:
        out["placement"] = args.placement
        out["per_replica_served"] = {r: v["served"]
                                     for r, v in st["replicas"].items()}
    return out


def _serve_proc(args, cfg, prof, pol, arr, slo_s, rate,
                autoscale=None) -> Dict:
    """Serve ``arr`` live through one OS process per replica group
    (serving/ipc.py): socketpair children, or TCP with ``--listen``. The
    coordinator in THIS process still owns admission/placement/lifecycle
    (autoscaling included); the children own scheduling."""
    from repro_torch.serving import runtime

    real = args.execute == "real"

    async def go():
        router = runtime.ClusterRouter(
            prof, pol, [args.workers] * args.procs,
            placement=args.placement, placement_seed=args.seed,
            transport="proc", work_ms=args.work_ms,
            host_devices=args.host_devices,
            listen=args.listen, token=args.token,
            execute="real" if real else "echo",
            arch=args.arch if real else None,
            seq_len=args.seq_len, seed=args.seed,
            device=args.device, size=args.size, units=args.units,
            slice_mode=args.slice_mode,
            autoscale=autoscale, slo=slo_s,
            spawn_timeout=300.0 if real else 60.0,
            engine_cfg=(runtime.EngineConfig(
                continuous_batching=args.continuous_batching
                or args.predictive_joins,
                predictive_joins=args.predictive_joins,
                forecast=(ForecastConfig(window=args.forecast_window)
                          if args.predictive_joins else None))
                if args.continuous_batching or args.predictive_joins
                else None))
        await router.start()
        payloads = None
        if real:
            rng = np.random.default_rng(args.seed)
            payloads = rng.integers(
                0, cfg.vocab_size,
                (len(arr), args.seq_len)).astype(np.int32)
        t0 = time.perf_counter()
        futs = []
        for i, t in enumerate(arr):
            now = time.perf_counter() - t0
            if t > now:
                await asyncio.sleep(t - now)
            p = (payloads[i].tolist() if payloads is not None
                 else [float(i)])
            futs.append(await router.submit(p, slo_s=slo_s))
        await asyncio.gather(*futs)
        await router.drain(60.0)
        return router, time.perf_counter() - t0

    router, makespan = asyncio.run(go())
    st = router.stats()
    recs = router.records()
    children = [child_report(ch, proxy)
                for ch, proxy in zip(router._chans, router.proxies)]
    launches: Dict[str, int] = {}
    for c in children:
        for k, v in (c["kernel_launches"] or {}).items():
            launches[k] = launches.get(k, 0) + v
    out = {"arch": args.arch, "mode": "proc", "execute": args.execute,
           "policy": pol.name,
           "queries": len(recs), "procs": args.procs,
           "workers_per_proc": args.workers, "work_ms": args.work_ms,
           "rate_qps": round(rate, 1),
           "slo_ms": round(slo_s * 1e3, 3),
           "slo_attainment": st["slo_attainment"],
           "mean_acc": st["mean_acc"],
           "p50_latency_ms": st["p50_latency_s"] * 1e3,
           "p99_latency_ms": st["p99_latency_s"] * 1e3,
           "load_imbalance": st["load_imbalance"],
           "per_replica_served": {r: v["served"]
                                  for r, v in st["replicas"].items()},
           "makespan_s": round(makespan, 4),
           # adopted/remote replicas have no local pid
           "replica_pids": [None if ch.proc is None else ch.proc.pid
                            for ch in router._chans],
           "served": sum(1 for r in recs
                         if r.finish is not None and not r.dropped),
           "dropped": sum(1 for r in recs if r.dropped),
           # summed over the children that reported (None if none did)
           "serve_phase_builds": (
               sum(c["kernel_builds"] for c in children
                   if c["kernel_builds"] is not None)
               if any(c["kernel_builds"] is not None for c in children)
               else None),
           "kernel_launches": launches, "children": children,
           **_port_keys(args, cfg, (
               None if not real else
               next((c["device_name"] for c in children
                     if c["device_name"]), "cpu")))}
    if args.listen:
        out["listen"] = list(router.listen_addr)
        out["handshake_rejects"] = router.handshake_rejects
    if autoscale is not None:
        router.autoscaler.finalize(router.clock.now())
        out.update({
            "autoscale_policy": autoscale.policy,
            "replicas_total": router.coord.n_replicas,   # ever existed
            "replica_seconds": round(router.autoscaler.replica_seconds(),
                                     4),
            "scale_events": [
                {"t": round(e.t, 4), "kind": e.kind, "rid": e.rid,
                 "committed": e.n_committed, "signal": round(e.signal, 3)}
                for e in router.autoscaler.events]})
    return out


def child_report(ch, proxy) -> Dict:
    """One replica child as the coordinator last heard it: its hello
    (card, init seconds), spawn-to-hello seconds, and the counters of its
    last ``stats`` or ``drained`` frame (builds and graph captures after
    warmup, launches,
    completion frames and the seconds spent sending them, worker steps
    and their wall seconds)."""
    c = proxy.child_stats or {}
    return {"rid": ch.rid, "pid": ch.hello.get("pid"),
            "device_name": ch.hello.get("device_name"),
            "devices": ch.hello.get("devices"),
            "init_s": ch.hello.get("init_s"), "spawn_s": ch.spawn_s,
            "served": (c.get("stats") or {}).get("served"),
            "kernel_builds": c.get("kernel_builds"),
            "graph_captures": c.get("graph_captures"),
            "kernel_launches": c.get("kernel_launches"),
            "completion_frames": c.get("completion_frames"),
            "completion_send_s": c.get("completion_send_s"),
            "steps": c.get("steps"), "step_s": c.get("step_s")}


def _port_keys(args, cfg, device: Optional[str]) -> Dict:
    """The keys the port adds to every branch's JSON. Without an executor
    (the analytic profile, echo children) the config is the published
    one, whatever ``--size`` says."""
    executes = args.execute == "real" or args.profile_mode == "measured"
    return {"device": device, "size": args.size if executes else "full",
            "units": sum(s.repeat for s in cfg.stages),
            "slice_mode": args.slice_mode}


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--policy", default="slackfit",
                    choices=sorted(policies.ALL_POLICIES) + ["clipper"])
    ap.add_argument("--clipper-idx", type=int, default=-1)
    ap.add_argument("--trace", default="bursty",
                    choices=("bursty", "time_varying", "maf"))
    ap.add_argument("--rate", type=float, default=None,
                    help="mean arrival rate q/s (default 7000 under sim; "
                         "in-process --execute real derives a device-safe "
                         "rate from the B=1 latencies; 20 with --transport "
                         "proc --execute real)")
    ap.add_argument("--cv2", type=float, default=4)
    ap.add_argument("--tau", type=float, default=500)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--execute", default="real", choices=("sim", "real"),
                    help="real: actual subnet forward passes on --device "
                         "(the port's default). sim: discrete-event "
                         "simulation with profile service times (the "
                         "reference's default)")
    ap.add_argument("--profile", dest="profile_mode", default=None,
                    choices=("analytic", "measured"),
                    help="latency profile the engine schedules from. "
                         "analytic: the hardware-roofline model "
                         "(profiler.build_profile). measured: wall clock "
                         "per (subnet, batch bucket) through the warmed "
                         "executor on --device. Default: measured under "
                         "in-process --execute real, analytic otherwise")
    ap.add_argument("--queries", type=int, default=64,
                    help="--execute real / --transport proc: trace "
                         "arrivals to serve")
    ap.add_argument("--seq-len", type=int, default=16,
                    help="prompt tokens per query (right-padded to the "
                         "executor's seq bucket)")
    ap.add_argument("--workers", type=int, default=None,
                    help="workers per replica group (default 8 under "
                         "--execute sim, as in the reference; 1 under "
                         "--execute real: threads on one device share its "
                         "stream and the GIL, so one device is one worker)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica groups; >1 serves through the cluster "
                         "coordinator (one engine per replica; in-process "
                         "--execute real: worker groups of one executor)")
    ap.add_argument("--placement", default="round_robin",
                    choices=sorted(cluster.PLACEMENTS),
                    help="replica placement policy (cluster mode only)")
    ap.add_argument("--transport", default="inproc",
                    choices=("inproc", "proc"),
                    help="proc: serve live through one OS process per "
                         "replica group over the IPC front door "
                         "(serving/ipc.py); inproc keeps every replica in "
                         "this process (default)")
    ap.add_argument("--procs", type=int, default=2,
                    help="--transport proc: replica processes (each gets "
                         "--workers workers)")
    ap.add_argument("--work-ms", type=float, default=0.0,
                    help="--transport proc: real CPU busy-spin per batch "
                         "in echo children (0 = pure echo)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="the reference's fake XLA host devices; no torch "
                         "meaning: only 0 is accepted (each child takes "
                         "one visible card)")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="--transport proc: open a TCP listener and run "
                         "children through it (port 0 picks a free one); "
                         "remote replicas dial the same address with "
                         "--connect and pass the HMAC handshake")
    ap.add_argument("--token", default=None,
                    help="shared HMAC handshake token for --listen/"
                         "--connect (listener auto-generates one when "
                         "unset; --connect falls back to $REPRO_IPC_TOKEN)")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="run as a REMOTE replica child: dial a "
                         "coordinator started with --listen and serve one "
                         "replica group for it (every other flag is "
                         "ignored: the coordinator's ReplicaSpec "
                         "configures this process)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="query SLO (default 36.0 under sim; in-process "
                         "--execute real derives 25x the largest subnet's "
                         "B=1 latency; 4000 with --transport proc "
                         "--execute real)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default="",
                    help="--execute sim: comma list wid:t, e.g. 7:12,6:24 "
                         "(cluster mode: rid.wid:t)")
    ap.add_argument("--replica-deaths", default="",
                    help="--execute sim: comma list rid:t — whole replica "
                         "groups dying (cluster mode only)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="keep forming batches open to in-flight joins "
                         "within the policy's latency budget (paper §5). "
                         "Acts under sim and --transport proc only: as in "
                         "the reference, the in-process real routers get "
                         "no EngineConfig")
    ap.add_argument("--predictive-joins", action="store_true",
                    help="forecast-led join windows: hold a forming batch "
                         "even on the last free worker when the arrival "
                         "forecast says a joinable query lands within "
                         "slack (implies in-flight joins)")
    ap.add_argument("--forecast-window", type=float, default=0.25,
                    help="arrival-forecaster sliding window (s), shared "
                         "by predictive joins and predictive scaling")
    ap.add_argument("--autoscale", action="store_true",
                    help="replica autoscaling: spawn/decommission replica "
                         "groups from load signals (sim: forces cluster "
                         "mode, --replicas is the initial count; proc: "
                         "--procs is)")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--scale-policy", default="queue_pressure",
                    choices=sorted(k for k in SCALINGS if k != "scripted"),
                    help="autoscaling signal (see serving/autoscaler.py)")
    ap.add_argument("--cold-start", default="0.1",
                    help="spawn -> routable actuation cost (s), or 'auto' "
                         "to derive it from the ActuationModel as a full "
                         "weight-load of the heaviest subnet")
    ap.add_argument("--scale-cooldown", type=float, default=0.5,
                    help="min gap before a scale-down (s)")
    ap.add_argument("--load-on-switch", action="store_true",
                    help="charge a full weight page-in per subnet switch "
                         "(the non-weight-shared Clipper+/INFaaS cost "
                         "model) instead of the SubNetAct control swap")
    ap.add_argument("--slice-mode", default="mask", choices=("mask", "switch"),
                    help="WeightSlice mode of the executor: mask (full "
                         "FLOPs, inactive channels zeroed) or switch (the "
                         "sliced_matmul kernel over the active widths)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default=None, choices=("full", "reduced"),
                    help="full: published widths and depth (default on "
                         "cuda); reduced: the small fp32 twin (default on "
                         "cpu)")
    ap.add_argument("--units", type=int, default=None,
                    help="with --size full: serve the first N repeat units "
                         "of each stage (default: all)")
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="record the serving phase's spans and write them "
                         "to PATH as Chrome trace-event JSON (--execute "
                         "real, in process)")
    args = ap.parse_args(argv)
    if args.connect:
        return args
    if args.host_devices != 0:
        ap.error("--host-devices counts the reference's fake XLA host "
                 "devices and has no torch meaning: each replica child "
                 "takes one visible card (CUDA_VISIBLE_DEVICES); pass 0")
    if args.workers is None:
        args.workers = 8 if args.execute == "sim" else 1
    if args.profile_mode is None:
        args.profile_mode = ("measured" if args.execute == "real"
                             and args.transport == "inproc" else "analytic")
    if args.size is None:
        args.size = "full" if args.device == "cuda" else "reduced"
    if args.units is not None and (args.size != "full" or args.units < 1):
        ap.error("--units takes a positive count, with --size full")
    if args.device == "cuda" and args.size == "reduced":
        ap.error("--size reduced has head_dim 32 in fp32; the CUDA kernels "
                 "take bf16 with head_dim 80, 120 or 128: use --device cpu")
    try:
        args.cold_start_s = (None if args.cold_start == "auto"
                             else float(args.cold_start))
    except ValueError:
        ap.error(f"--cold-start must be a number or 'auto', "
                 f"got {args.cold_start!r}")
    if args.transport == "proc" and (
            args.profile_mode == "measured"
            or args.faults or args.replica_deaths):
        ap.error("--transport proc does not combine with --profile "
                 "measured, --faults or --replica-deaths (fault scripts "
                 "and device-measured profiles stay inproc/simulated)")
    if args.spans and (args.execute != "real" or args.transport != "inproc"):
        ap.error("--spans records the in-process router's spans: it needs "
                 "--execute real and --transport inproc")
    if args.listen and args.transport != "proc":
        ap.error("--listen is the proc transport's TCP front door; "
                 "add --transport proc")
    if args.execute == "real" or args.profile_mode == "measured":
        cfg = get_config(args.arch)
        if cfg.family == "conv" or cfg.frontend != "token":
            ap.error(f"--execute real / --profile measured execute the "
                     f"LM path and need a token-frontend arch (try "
                     f"--arch qwen2-1.5b); {args.arch} is "
                     f"family={cfg.family}, frontend={cfg.frontend}")
        if (args.execute == "real" and args.transport != "proc"
                and (args.autoscale or args.faults
                     or args.replica_deaths)):
            ap.error("--execute real does not support --autoscale/"
                     "--faults/--replica-deaths inproc; --transport "
                     "proc runs autoscaled real execution, and the "
                     "simulator covers fault studies")
    lo_hi = (args.min_replicas, args.max_replicas)
    start = args.procs if args.transport == "proc" else args.replicas
    if args.autoscale and not lo_hi[0] <= start <= lo_hi[1]:
        flag = "--procs" if args.transport == "proc" else "--replicas"
        ap.error(f"{flag} {start} must start within "
                 f"[--min-replicas {lo_hi[0]}, --max-replicas {lo_hi[1]}]")
    return args


def _trace(args, rate: float, duration: float) -> np.ndarray:
    """The arrival times of ``--trace`` at mean ``rate`` over
    ``duration`` seconds (the reference's construction)."""
    if args.trace == "bursty":
        return traces.bursty_trace(rate * 0.2, rate * 0.8, args.cv2,
                                   duration, args.seed)
    if args.trace == "time_varying":
        return traces.time_varying_trace(rate * 0.4, rate, args.tau,
                                         args.cv2, duration, args.seed)
    return traces.maf_like_trace(rate, duration, seed=args.seed)


def _autoscale_cfg(args) -> Optional[AutoscaleConfig]:
    if not args.autoscale:
        return None
    return AutoscaleConfig(
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        policy=args.scale_policy, cold_start=args.cold_start_s,
        cooldown=args.scale_cooldown,
        # the shared estimator window tunes the FORECAST-led policy only
        # (its reactive fallback stays comparable); a plain reactive run
        # keeps its own default window
        **({"rate_window": args.forecast_window}
           if args.scale_policy == "predictive" else {}))


def run(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, build, warm, profile and serve (or simulate);
    returns the report."""
    args = parse_args(argv)
    if args.connect:
        # remote-replica child mode: this process serves frames for a
        # coordinator elsewhere; its ReplicaSpec arrives over the wire
        from repro_torch.serving.replica_proc import main as replica_main
        replica_main(["--connect", args.connect]
                     + (["--token", args.token] if args.token else []))
        return {}

    cfg = get_config(args.arch)
    executor, warm, device, init_s = None, None, None, None
    if args.execute == "real" or args.profile_mode == "measured":
        cfg = serving_config(args.arch, args.device, args.size, args.units)
        if args.transport != "proc":
            # proc + real builds executors inside the children (from the
            # same config); the parent only profiles it
            from repro_torch.serving.executor import (ExecutorConfig,
                                                      build_executor)
            device = compat.resolve_device(args.device)
            check_fits(cfg, free_bytes(device))
            t0 = time.perf_counter()
            executor = build_executor(
                cfg, seed=args.seed, device=device,
                exec_cfg=ExecutorConfig(slice_mode=args.slice_mode))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            init_s = time.perf_counter() - t0

    if args.profile_mode == "measured":
        # warm first so measurement never times a build
        warm = executor.warmup(batches=PROFILE_BATCHES, seqs=(args.seq_len,))
        prof = executor.measured_profile(batches=PROFILE_BATCHES,
                                         seq_len=args.seq_len)
    else:
        prof = profiler.build_profile(cfg)
        if executor is not None:
            # warm every bucket the analytic profile lets the policy
            # choose, so serving builds nothing
            warm = executor.warmup(batches=prof.batches,
                                   seqs=(args.seq_len,))

    if args.policy == "clipper":
        idx = args.clipper_idx if args.clipper_idx >= 0 else prof.n_pareto - 1
        pol = policies.ClipperFixed(idx)
    else:
        pol = policies.ALL_POLICIES[args.policy]()

    rate = args.rate if args.rate is not None else 7000.0
    slo_ms = args.slo_ms if args.slo_ms is not None else 36.0
    duration = args.duration
    lat_fast = lat_slow = None
    if args.execute == "real" and args.transport == "proc":
        # the children execute; the parent has no executor to time
        if args.rate is None:
            rate = 20.0
        if args.slo_ms is None:
            slo_ms = 4000.0
        duration = args.queries / max(rate, 1e-9)
    elif args.execute == "real":
        # device-safe pacing (examples/serve_bursty.py sizing): SLO ~= 25x
        # the max-subnet B=1 latency, rate leaves 4x headroom on the
        # min-subnet latency
        lat_fast = _host_latency(executor, 0, args.seq_len)
        lat_slow = _host_latency(executor, executor.n_subnets - 1,
                                 args.seq_len)
        if args.rate is None:
            rate = 0.25 / lat_fast
        if args.slo_ms is None:
            slo_ms = lat_slow * 25 * 1e3
        duration = args.queries / max(rate, 1e-9)

    arr = _trace(args, rate, duration)
    if args.execute == "real":
        # the port serves --queries arrivals: a trace that ends short of
        # them (a bursty one often does) is drawn again over twice the span
        for _ in range(16):
            if len(arr) >= args.queries:
                break
            duration *= 2
            arr = _trace(args, rate, duration)

    if args.transport == "proc":
        arr = np.asarray(arr, dtype=float)[: args.queries]
        return _serve_proc(args, cfg, prof, pol, arr, slo_ms / 1e3, rate,
                           _autoscale_cfg(args))

    if args.execute == "real":
        arr = np.asarray(arr, dtype=float)[: args.queries]
        out = {"arch": args.arch, "mode": "real",
               "profile": args.profile_mode, "policy": pol.name,
               "seq_len": args.seq_len, "init_seconds": init_s,
               "lat_fast_ms": lat_fast * 1e3, "lat_slow_ms": lat_slow * 1e3,
               "rate_qps": round(rate, 1), "slo_ms": round(slo_ms, 3),
               **_port_keys(args, cfg, _device_name(device))}
        if args.spans:
            tracing.enable()
        try:
            out.update(_serve_real(args, cfg, prof, pol, executor, arr,
                                   slo_ms / 1e3))
        finally:
            if args.spans:
                tracing.disable()
                lost = tracing.dropped()
                spans = tracing.drain()
                Path(args.spans).write_text(
                    json.dumps(tracing.to_chrome(spans)))
                out["spans"] = {"path": args.spans, "count": len(spans),
                                "dropped": lost}
        out.update(warmup=warm, executor=executor.counters())
        return out

    # --execute sim: the simulator launches nothing, measured or not
    sim_device = (None if executor is None
                  else _device_name(executor.device))
    if args.replicas > 1 or args.autoscale:
        faults = {}
        if args.faults:
            for part in args.faults.split(","):
                rw, t = part.split(":")
                rid, wid = rw.split(".")
                faults[(int(rid), int(wid))] = float(t)
        deaths = {}
        if args.replica_deaths:
            for part in args.replica_deaths.split(","):
                rid, t = part.split(":")
                deaths[int(rid)] = float(t)
        autoscale = _autoscale_cfg(args)
        # one shared ForecastConfig for the engines' predictive join
        # windows and (via the coordinator_forecast rule) the
        # coordinator-level forecaster behind --scale-policy predictive
        forecast = (ForecastConfig(window=args.forecast_window)
                    if args.predictive_joins
                    or (autoscale and autoscale.policy == "predictive")
                    else None)
        ccfg = simulator.ClusterConfig(
            n_replicas=args.replicas, workers_per_replica=args.workers,
            placement=args.placement, placement_seed=args.seed,
            slo=slo_ms / 1e3, fault_times=faults, replica_deaths=deaths,
            load_on_switch=args.load_on_switch,
            continuous_batching=args.continuous_batching,
            predictive_joins=args.predictive_joins, forecast=forecast,
            autoscale=autoscale)
        with compat.BuildCounter() as builds:
            res = simulator.simulate_cluster(arr, prof, pol, ccfg)
        st = res.stats()
        extra = {"replicas": args.replicas, "placement": args.placement,
                 "load_imbalance": st["load_imbalance"],
                 "per_replica_served": {r: v["served"]
                                        for r, v in st["replicas"].items()}}
        if res.forecast is not None:
            extra["forecast"] = {k: None if v is None else round(v, 4)
                                 for k, v in res.forecast.items()}
            extra["predictive_windows"] = res.n_predictive_windows
        if args.autoscale:
            extra.update({
                "autoscale_policy": args.scale_policy,
                "replicas_total": res.n_replicas,   # ever existed
                "replica_seconds": res.replica_seconds,
                "goodput_per_replica_second":
                    st.get("goodput_per_replica_second", 0.0),
                "scale_events": [
                    {"t": round(e.t, 4), "kind": e.kind, "rid": e.rid,
                     "committed": e.n_committed, "signal": round(e.signal, 3)}
                    for e in res.scale_events]})
    else:
        faults = {}
        if args.faults:
            for part in args.faults.split(","):
                wid, t = part.split(":")
                faults[int(wid)] = float(t)
        scfg = simulator.SimConfig(n_workers=args.workers,
                                   slo=slo_ms / 1e3,
                                   load_on_switch=args.load_on_switch,
                                   fault_times=faults, seed=args.seed,
                                   continuous_batching=args.continuous_batching,
                                   predictive_joins=args.predictive_joins,
                                   forecast=(ForecastConfig(
                                       window=args.forecast_window)
                                       if args.predictive_joins else None))
        with compat.BuildCounter() as builds:
            res = simulator.simulate(arr, prof, pol, scfg)
        extra = ({"predictive_windows": res.n_predictive_windows}
                 if args.predictive_joins else {})
    st = res.stats()
    if args.profile_mode == "measured":
        # the device's own latencies the simulation ran on
        extra.update(profile_batches=list(prof.batches),
                     measured_lat_ms=(np.asarray(prof.lat) * 1e3).tolist())
    return {"arch": args.arch, "policy": pol.name, "queries": len(arr),
            "continuous_batching": args.continuous_batching,
            "slo_attainment": res.slo_attainment, "mean_acc": res.mean_acc,
            "p50_latency_ms": res.latency_p50 * 1e3,
            "p99_latency_ms": res.latency_p99 * 1e3,
            "join_rate": res.n_joins / max(len(arr), 1),
            "switch_rate": st["switch_rate"],
            "actuation_seconds": st["actuation_seconds"], **extra,
            **_port_keys(args, cfg, sim_device),
            "serve_phase_builds": builds.count, "kernel_launches": {}}


def main(argv: Optional[List[str]] = None) -> None:
    out = run(argv)
    if out:
        print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
