"""Serving launcher of the port: real subnet forward passes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --execute real \
        --arch qwen2-1.5b --queries 64 --seq-len 16

A trimmed twin of ``repro/launch/serve.py`` (``--execute real``, one
replica, the in-process asyncio ``Router``): it builds the supernet
executor from a seeded ``torch.Generator``, warms every bucket the policy
can choose, profiles the warmed executor on this device (wall clock per
subnet and batch), derives the arrival rate and SLO from the device's own
latencies, and serves a trace through the unchanged scheduling stack.

``--arch`` names any registered config (``repro_torch.configs``):
qwen2-1.5b, qwen2.5-14b, stablelm-3b, h2o-danube-3-4b, mixtral-8x7b,
llama4-maverick-400b-a17b, or the SSM family's zamba2-2.7b and
xlstm-125m. ``--size full`` (the default on ``--device
cuda``) keeps the published widths and depth; ``--units N`` keeps the
first N repeat units of each stage (mixtral's 32 layers hold 93 GB of
bf16 weights, more than one card), and a depth whose weights exceed the
device's free memory is refused before anything is allocated.
``--size reduced`` is the small fp32 twin of the JAX launcher and runs
with ``--device cpu`` (the default there), since the CUDA kernels take
bf16 with head_dim 80, 120 or 128. ``--slice-mode switch`` serves
with WeightSlice switch mode (the ``sliced_matmul`` kernel computes only
the active FFN and head widths) instead of the default mask mode. The
output JSON reports the slice mode, the kernel builds seen while serving
(``serve_phase_builds``, 0 after warmup) and the kernel launches of the
serve phase.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, Stage
from repro_torch.models import lm
from repro_torch.serving import policies, traces

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


def cut_units(cfg: ArchConfig, units: Optional[int]) -> ArchConfig:
    """``cfg`` with the first ``units`` repeat units of each stage (all of
    them for None)."""
    if units is None:
        return cfg
    return cfg.replace(stages=tuple(Stage(s.pattern, min(units, s.repeat))
                                    for s in cfg.stages))


def free_bytes(device: torch.device) -> int:
    """Memory free on ``device``: the card's, with what PyTorch's allocator
    holds cached but no tensor uses, or the host's for the CPU."""
    if device.type == "cuda":
        return (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_fits(cfg: ArchConfig, available: float) -> None:
    """Refuse (MemoryError) a model whose weights exceed ``available``
    bytes."""
    need = lm.param_bytes(cfg)
    if need > available:
        raise MemoryError(
            f"{cfg.name} at {sum(s.repeat for s in cfg.stages)} repeat "
            f"units holds {need / 1e9:.1f} GB of {cfg.dtype} weights, more "
            f"than the {available / 1e9:.1f} GB free on the device; cut "
            f"the depth with --units")


def _serve_real(args, cfg, prof, pol, executor, arr, slo_s) -> Dict:
    """Serve ``arr`` with real forward passes through the asyncio router;
    scheduling stays entirely inside the engine."""
    from repro_torch.serving import runtime

    async def go():
        rng = np.random.default_rng(args.seed)
        payloads = rng.integers(0, cfg.vocab_size,
                                (len(arr), args.seq_len)).astype(np.int32)
        router = runtime.Router(prof, pol, executor.make_workers(args.workers),
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
    with compat.BuildCounter() as builds:
        router = asyncio.run(go())
    launches = {k: v - launches0.get(k, 0)
                for k, v in compat.launch_counts().items()}
    st = router.stats()
    recs = router.records()
    lats = sorted(r.finish - r.arrival for r in recs if r.finish is not None)

    def pct(q: float):
        return (lats[min(int(q * len(lats)), len(lats) - 1)] * 1e3
                if lats else None)

    return {"queries": len(recs), "served": len(lats),
            "slo_attainment": st["slo_attainment"],
            "mean_acc": st["mean_acc"],
            "p50_latency_ms": pct(0.50), "p99_latency_ms": pct(0.99),
            "switch_rate": st["switch_rate"],
            "actuation_seconds": st["actuation_seconds"],
            # kernel builds while serving: a warmed executor reports 0
            "serve_phase_builds": builds.count,
            "kernel_launches": launches}


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--execute", default="real", choices=("real",),
                    help="real subnet forward passes (the only mode of the "
                         "port; the simulator stays in the JAX package)")
    ap.add_argument("--policy", default="slackfit",
                    choices=sorted(policies.ALL_POLICIES))
    ap.add_argument("--trace", default="bursty",
                    choices=("bursty", "time_varying", "maf"))
    ap.add_argument("--queries", type=int, default=64,
                    help="trace arrivals to serve")
    ap.add_argument("--seq-len", type=int, default=16,
                    help="prompt tokens per query (right-padded to the "
                         "executor's seq bucket)")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker threads sharing the executor. The engine "
                         "treats each worker as a server of its own, but "
                         "threads on one device share its stream (and the "
                         "GIL), so one device is one worker")
    ap.add_argument("--slice-mode", default="mask", choices=("mask", "switch"),
                    help="WeightSlice mode of the executor: mask (full "
                         "FLOPs, inactive channels zeroed) or switch (the "
                         "sliced_matmul kernel over the active widths)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default=None, choices=("full", "reduced"),
                    help="full: published widths and depth (default on "
                         "cuda); reduced: the small fp32 twin (default on "
                         "cpu)")
    ap.add_argument("--units", type=int, default=None,
                    help="with --size full: serve the first N repeat units "
                         "of each stage (default: all)")
    args = ap.parse_args(argv)
    if args.size is None:
        args.size = "full" if args.device == "cuda" else "reduced"
    if args.units is not None and (args.size != "full" or args.units < 1):
        ap.error("--units takes a positive count, with --size full")
    if args.device == "cuda" and args.size == "reduced":
        ap.error("--size reduced has head_dim 32 in fp32; the CUDA kernels "
                 "take bf16 with head_dim 80, 120 or 128: use --device cpu")
    return args


def run(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv``, build, warm, profile and serve; returns the report."""
    args = parse_args(argv)
    device = compat.resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.family == "conv" or cfg.frontend != "token":
        raise ValueError(f"{args.arch}: the port serves token-frontend LMs")
    cfg = cfg.reduced() if args.size == "reduced" \
        else cut_units(cfg, args.units)
    check_fits(cfg, free_bytes(device))
    from repro_torch.serving.executor import ExecutorConfig, build_executor
    t0 = time.perf_counter()
    executor = build_executor(
        cfg, seed=args.seed, device=device,
        exec_cfg=ExecutorConfig(slice_mode=args.slice_mode))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0

    warm = executor.warmup(batches=PROFILE_BATCHES, seqs=(args.seq_len,))
    prof = executor.measured_profile(batches=PROFILE_BATCHES,
                                     seq_len=args.seq_len)
    pol = policies.ALL_POLICIES[args.policy]()

    # device-safe pacing (examples/serve_bursty.py sizing): SLO ~= 25x the
    # max-subnet B=1 latency, rate leaves 4x headroom on the min subnet
    lat_fast = _host_latency(executor, 0, args.seq_len)
    lat_slow = _host_latency(executor, executor.n_subnets - 1, args.seq_len)
    rate = 0.25 / lat_fast
    slo_ms = lat_slow * 25 * 1e3
    duration = args.queries / max(rate, 1e-9)
    if args.trace == "bursty":
        arr = traces.bursty_trace(rate * 0.2, rate * 0.8, 4.0, duration,
                                  args.seed)
    elif args.trace == "time_varying":
        arr = traces.time_varying_trace(rate * 0.4, rate, 500.0, 4.0,
                                        duration, args.seed)
    else:
        arr = traces.maf_like_trace(rate, duration, seed=args.seed)
    arr = np.asarray(arr, dtype=float)[: args.queries]

    out = {"arch": args.arch, "size": args.size,
           "units": sum(s.repeat for s in cfg.stages), "mode": "real",
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "slice_mode": executor.xcfg.slice_mode,
           "profile": "measured", "policy": pol.name,
           "workers": args.workers, "seq_len": args.seq_len,
           "init_seconds": init_s,
           "lat_fast_ms": lat_fast * 1e3, "lat_slow_ms": lat_slow * 1e3,
           "rate_qps": rate, "slo_ms": slo_ms}
    out.update(_serve_real(args, cfg, prof, pol, executor, arr, slo_ms / 1e3))
    out.update(warmup=warm, executor=executor.counters())
    return out


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(run(argv), indent=1))


if __name__ == "__main__":
    main()
