"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 superbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``): the program's serving config, weights
drawn from the seed on the card (``weights.py``), the executor with its
CUDA graphs warmed over the cell's batch buckets at its prompt length,
the measured profile SlackFit schedules on, and a lead-in of the cell's
traffic. Then ``--seconds`` of the cell's open-loop traffic through the
program's ``Router`` (``serve.py``); the end-to-end metrics untraced, or
the per-layer ones with ``--trace 1``. Once the window has closed and the
program is freed, a seeded sample of the served logits is judged against
the plain reference (``judge.py``).

The last line of standard output is the result, one JSON object; the
last lines of standard error are the compared numbers beside their
limits. Without a card the run prints no result and exits 2; with JAX or
the JAX package loaded, 3; with a trace that lost events, 4.
"""
from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

from superbench import judge, serve, spec, subnet, weights  # noqa: E402
from superbench import trace as trace_mod  # noqa: E402

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(Exception):
    """A run that prints no result: ``code`` is its exit code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose whole top-level name is
    forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def check_arch(arch: Dict, cfg) -> None:
    """The configuration file holds the config as the program runs it."""
    units = sum(s.repeat for s in cfg.stages)
    have = {
        "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "num_hidden_layers": units,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.qkv_bias,
        "sliding_window": cfg.sliding_window or None,
        "torch_dtype": cfg.dtype,
        "pattern": list(cfg.stages[0].pattern),
        "num_local_experts": cfg.n_experts or None,
        "num_experts_per_tok": cfg.top_k or None,
        "topk_options": list(cfg.elastic.topk_options) or None,
        "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
        "moe_intermediate_size": (
            cfg.resolved_moe_d_ff
            if cfg.n_experts and cfg.resolved_moe_d_ff != cfg.d_ff else None),
    }
    bad = {k: (arch.get(k), v) for k, v in have.items() if arch.get(k) != v}
    if len(cfg.stages) != 1 or cfg.norm != "rmsnorm" \
            or cfg.ffn_act != "swiglu" or cfg.shared_expert \
            or cfg.pos_embed != "rope" \
            or cfg.rotary_pct != 1.0 or cfg.frontend != "token":
        bad["form"] = ("one stage of rmsnorm, rope and swiglu blocks",
                       cfg.name)
    if bad:
        raise RunError(2, f"{arch['name']}: the configuration file differs "
                          f"from the program's config: {bad}")


def check_points(points, table) -> None:
    """The executor's Pareto set is the frozen table, point for point."""
    got = [(p.sub.depth_frac, p.sub.ffn_frac, p.sub.head_frac, p.sub.topk,
            p.sub.subnet_id, p.acc) for p in points]
    want = [(t["depth_frac"], t["ffn_frac"], t["head_frac"], t["topk"],
             t["subnet_id"], t["acc"]) for t in table]
    if len(got) != len(want) or any(
            g[:5] != w[:5] or abs(g[5] - w[5]) > 1e-9
            for g, w in zip(got, want)):
        raise RunError(2, f"the executor's Pareto set differs from the "
                          f"frozen table:\n  program {got}\n  frozen  {want}")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def traffic(cell: Dict, seconds: float, seed: int, vocab: int,
            trace: bool = False) -> Dict:
    """The due offsets of the lead-in, the window and, traced, a tail that
    holds the trace; one token row a query; all from ``seed``."""
    gen = spec.traffic(cell["trace"]["kind"])
    rate = float(cell["rate_qps"])
    parts = {"lead_in": float(cell["lead_in_s"]), "window": seconds}
    if trace:
        parts["tail"] = trace_mod.TRIES * (
            serve.TRACE_AFTER_S + trace_mod.RETRY_AFTER_S + 6.0)
    out = {k: gen.arrivals(cell["trace"], rate, s, seed, stream=i)
           for i, (k, s) in enumerate(parts.items())}
    n = sum(len(v) for v in out.values())
    out["tokens"] = np.random.default_rng([int(seed), 3]).integers(
        0, vocab, (n, cell["prompt_tokens"]), dtype=np.int32)
    out["seconds"] = seconds
    return out


def build(arch: Dict, cell: Dict, seed: int, device):
    """Weights from the seed, the executor warmed over the cell's buckets
    and its measured profile: ``(params, executor, profile)``."""
    from repro_torch.models import lm
    from repro_torch.serving.executor import (ExecutorConfig, SubnetExecutor,
                                              serving_config)
    prog = arch["program"]
    cfg = serving_config(prog["arch"], device, prog.get("size"),
                         prog.get("units"))
    check_arch(arch, cfg)
    params = weights.make(lm.init_model(cfg, device="meta"), seed, device)
    batches = tuple(cell["batches"])
    seq = (cell["prompt_tokens"],)
    ex = SubnetExecutor(params, cfg, exec_cfg=ExecutorConfig(
        batch_buckets=batches, seq_buckets=seq,
        slice_mode=cell["slice_mode"]))
    check_points(ex.points, arch["pareto"])
    ex.warmup(batches=batches, seqs=seq)
    profile = ex.measured_profile(batches=batches,
                                  seq_len=cell["prompt_tokens"])
    return params, ex, profile


def verdict(cell: Dict, readings: Dict, builds: int, captures: int):
    """``(correct, checks)``: each number the cell compares beside its
    limit, and the kernel builds and graph captures while serving (limit
    0); correct where none is over its limit (NaN is)."""
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in cell["limits"].items()}
    checks["builds_after_warmup"] = {"value": builds, "limit": 0}
    checks["captures_after_warmup"] = {"value": captures, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for c in checks.values():              # NaN or inf is no JSON number
        if not math.isfinite(c["value"]):
            c["value"] = None
    return correct, checks


def load_kernels() -> Dict:
    """Load the program's kernel library, building it first where the
    checkout has none (``build/``): its seconds and nvcc compiles, which
    ``setup_s`` includes and the result also gives apart."""
    from repro_torch import compat
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    with compat.BuildCounter() as bc:
        kbuild.library()
    return {"seconds": time.perf_counter() - t0, "builds": bc.count}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, bench: Optional[Dict] = None,
             cell: Optional[Dict] = None, arch: Optional[Dict] = None,
             wrap_step: Optional[Callable] = None) -> Dict:
    """One run of cell ``name``: the result's fields and the checks. The
    cell's and its configuration's files are found by name unless passed;
    ``wrap_step`` wraps the executor's step (tests plant faults with
    it)."""
    import torch
    bench = bench or spec.benchmark()
    cell = cell or spec.cell(name)
    arch = arch or spec.config(cell["config"], bench)
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    kernels = load_kernels() if cuda else {"seconds": 0.0, "builds": 0}
    params, ex, profile = build(arch, cell, seed, dev)
    tracer = trace_mod.Tracer(cell["trace_steps"]) if trace else None
    if tracer is not None and cuda:
        probe = np.zeros((1, cell["prompt_tokens"]), np.int32)
        tracer.warm(lambda: ex.run_prefill(0, probe))
    tr = traffic(cell, seconds, seed, arch["vocab_size"], trace)
    if wrap_step is not None:
        ex.run_prefill = wrap_step(ex.run_prefill)
    window = serve.run_window(ex, profile, cell, tr, tr["tokens"], seed,
                              cell["judge_steps"], tracer)
    # (a CPU run is a test's, whose process loads JAX for other tests)
    loaded = forbidden_modules() if cuda else []
    if loaded:
        raise RunError(3, f"loaded in the benchmark's process: {loaded}")
    if trace and window.trace is None:
        last = window.steps[-1].t0 - window.end if window.steps else None
        raise RunError(4, f"the tail after the window ended before the "
                          f"trace closed (tracer {tracer.state}, armed "
                          f"{tracer.start_at - window.end:.3f} s after the "
                          f"window, last step {last} s after it)")
    if trace and cuda and not window.trace.intact:
        raise RunError(4, f"{len(tracer.traces)} traces lost events "
                          f"(symbol, counted, traced): "
                          f"{[t.lost for t in tracer.traces]}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = SimpleNamespace(window=window, cell=cell, arch=arch,
                          points=arch["pareto"], peaks=spec.peaks(),
                          setup_s=window.start - PROCESS_T0, notes={})
    metrics = {}
    for m in spec.metrics_of(name, trace, bench):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the program's state goes before the reference runs
    samples = window.samples
    if subnet.is_moe(arch):
        judge.program_routes(ex, samples)
    del ex, profile
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = judge.judge(arch, cell, arch["pareto"], params, samples, dev)
    ref_s = time.perf_counter() - t0
    correct, checks = verdict(cell, got, window.builds, window.captures)
    out = {"correct": correct, "attempted": len(window.queries),
           "failed": sum(q.timed_out for q in window.queries),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak),
                      "power_limit": power_limit() if cuda else "none"}}
    tr_res = window.trace
    if tr_res is not None:
        out["device"]["busy_s"] = tr_res.busy_s
        out["device"]["window_s"] = tr_res.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr_res.device_ops],
                            "idle_gaps": [list(x) for x in tr_res.idle_gaps]}
    # the kernels' load, and in a checkout's first run their build
    out["build_s"] = kernels["seconds"]
    out["build_compiles"] = kernels["builds"]
    out["checks"] = checks
    info = {"readings": got, "reference_s": ref_s, "errors": window.errors,
            "subnets_served": sorted({s.subnet
                                      for s in window.window_steps()}),
            "subnets_judged": sorted({s["subnet"] for s in samples}),
            **run.notes}
    if tr_res is not None:
        info.update(trace_steps=tr_res.steps, trace_stop_s=tr_res.stop_s,
                    trace_tries=len(tracer.traces),
                    trace_lost=[t.lost for t in tracer.traces[:-1]])
    return {"result": out, "info": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except RunError as exc:
        print(str(exc), file=sys.stderr)
        return exc.code
    out = res["result"]
    print(json.dumps(res["info"]), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
