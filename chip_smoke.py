#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --dist     # build + phase 15 only
    python3 chip_smoke.py --graphs [ARCH ...]  # build + phase 5b only

Phases, one result line each:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together), each kernel's registers and
   spills from ``ptxas`` (for ``subnet_rmsnorm`` its main-path
   instantiation and the worst of its buckets), and launch the copy probe
   (host-rate and device ms beside ``clone``).
2. Every kernel of the main path against its plain PyTorch version on the
   card, in bf16, at main-path shapes: max |error| (tolerance 2e-2 abs +
   2e-2 rel, the bf16 tolerance of the JAX package's kernel tests),
   kernel, plain and library (``scaled_dot_product_attention`` /
   ``rms_norm`` / ``torch.matmul`` on the active block, timed as a
   yardstick only) times, and the bound: the larger of bytes over the
   card's memory rate and FLOPs over its peak. ``subnet_rmsnorm`` runs
   both forms (standalone, and with the residual add fused in: its sum
   must equal ``x + delta`` bit for bit) at 8, 128 and 2048 rows with
   bitwise repeats, then each form's device ms against the bound,
   ``rms_norm`` (after ``torch.add`` for the fused form) and host us.
   ``flash_attention`` runs
   every case of the card tests (ragged prompts, a window, ``kv_len`` and
   the head width read on the card, (B, S, H, d) views) with two launches
   bitwise equal and inactive heads exactly 0, then device ms at S = 16,
   256 and 2048 at full and half head width against SDPA and the bound,
   and the wrapper's host us at S = 16. ``decode_attention`` runs 256
   cases (G = 1, 5, 6, 7, 8; B = 1, 8; Smax = 16, 32, 256, 2048; every index
   class; window 0 and 64) with two launches bitwise equal, must be one
   device kernel a call allocating nothing but its output, then device ms
   at Smax 16, 256 and 2048 against masked SDPA and the bound, and host
   us at Smax 256. ``sliced_matmul`` is timed
   over weight copies that exceed the L2 cache, as each layer finds its
   weights cold, its columns past ``active_out`` must be exactly 0, and
   two launches must give the same bits; the bits of fixed cases must
   equal those recorded before its PTX helpers moved to
   ``csrc/hopper.cuh`` (on a card with the recorded SM count). Both
   attention kernels also run at the heads of the other configs
   (``CONFIG_HEADS``: head_dim 80 under MHA, 120 with G = 4, 128 with
   G = 5, 4 and 7, 64 under MHA; decode's cases at d = 64, 80 and 120
   over G = 1, 4, 5, 7): the same case checks, and device ms beside SDPA
   and the bound counted at the real head_dim. ``sliced_matmul`` over a stack
   of experts (``EXPERT_STACKS``: mixtral's 8 experts of 4096 x 14336 at
   C = 8 and 40 rows and at its burst steps' C = 320 and 640, which run
   the 128 x 256 tile, llama4's 128 of 5120 x 8192 at C = 8; up and down
   at each width): against the plain version, zeros past active_out,
   bitwise repeats, one device kernel a call, the tile the case is meant
   to run, device ms beside ``torch.bmm`` on the active block and the
   bound.
3. Serve: ``repro_torch.launch.serve`` at the full width and depth of
   qwen2-1.5b (random weights from a seeded ``torch.Generator``), SlackFit
   through the port's Router and the executor's CUDA graphs; every query
   must be answered, the warmup must have captured graphs, the serve phase
   must build no kernel and capture no graph, and every kernel must have
   launched (a replay counts the launches its capture recorded).
4. Decode: 8 greedy ``SubnetExecutor.decode_step`` steps for the smallest
   and the largest Pareto subnet; finite logits, decode kernel launched.
5. Switch: WeightSlice switch mode on the same full-width weights as a
   mask-mode executor: prefill logits (B=8, S=16) of all 18 Pareto
   subnets against mask mode, 8 decode steps of the smallest and largest
   subnet against mask mode, then ``launch.serve --slice-mode switch``
   (32 queries, SlackFit): every query answered, no build, and
   ``sliced_matmul`` launched.
5b. Graphs: the compiled executor (one CUDA graph per warmed entry and
   depth pattern, ``ExecutorConfig(use_graphs=True)``, the default)
   against the eager one (``use_graphs=False``) over one parameter tree,
   for qwen2-1.5b in mask and switch mode, zamba2-2.7b and xlstm-125m at
   full depth and mixtral-8x7b at 16 layers (``GRAPH_CONFIGS``): every
   Pareto subnet's prefill logits (B = 8, S = 16) and 4 greedy decode
   steps, graph against eager (within 2e-2 of max |logit|; the bitwise
   count reported); 0 builds, 0 captures and no entry built over a pass of
   every subnet and bucket after warmup; the widest subnet's prefill and
   decode step through graphs traced (host wall, device ms, idle share,
   device kernels; phases 6, 9 and 10 trace the eager steps), their
   launches equal to the eager step's, the graph's replay timed by CUDA
   events, a decode step's cache copies, the capture seconds and
   graph pool bytes. ``--graphs [ARCH ...]`` runs it alone.
6. Trace: where a warmed full-width prefill and decode step spend their
   time (host wall clock, device kernel time from ``torch.profiler``, the
   device's idle share, the device kernels and ``aten::add`` calls a
   step, the top kernels, the launches of each kernel; eager steps, as
   phases 8-10 and 14 trace them),
   and a switch-mode prefill of the widest and the narrowest full-depth
   subnet, with the flash kernel's device ms in each.
7. Reference: the full-width model cut to 2 layers, kernels in bf16 on the
   card against the plain fp32 path on the CPU, prefill and decode logits,
   in mask and in switch mode.
8. Configs: qwen2.5-14b, stablelm-3b and h2o-danube-3-4b in turn, each at
   its published widths and full depth (random weights from a seeded
   generator, freed before the next): serve 32 queries with SlackFit
   (every query answered, no build), switch against mask for every
   Pareto subnet and 8 decode steps, the trace of a mask prefill and
   decode step at B = 8, the 2-layer reference in both modes, and for
   h2o-danube-3-4b a prefill past its 4096-token window and decode steps
   that wrap the rolling cache, against the plain path on the CPU.
9. MoE: mixtral-8x7b (16 of its 32 layers) and llama4-maverick (1 of
   its 24 units) at their published widths, in turn, as phase 8 runs a
   dense config: serve 32 queries in mask and in switch mode (the grouped
   ``sliced_matmul`` launched in switch mode), switch against mask and
   both against the fp32 oracle, whose MoE blocks route as the walk they
   check did and count the tokens their own top-k would send elsewhere
   (each a near-tie within bf16's reach), each block against its switch
   twin, the trace with a MoE layer's dispatch kernels and the step's
   bytes bound, and for mixtral the 2-layer reference, its CPU walk
   routed as the card's. The switch walks are held to the oracle per
   walk where their routing equals the mask walk's, and on the mean of
   every walk within ``MOE_MEAN_MARGIN``.
10. SSM: zamba2-2.7b (54 Mamba2 units and the weight-shared attention +
   MLP block after every 6th, head_dim 80 over 32 heads) and xlstm-125m
   (3 units of mLSTM x 3 + sLSTM) at their published widths and full
   depth, in turn, as phase 8 runs a dense config: serve 32 queries in
   mask and in switch mode (zamba2's shared block through flash, decode
   and, in switch mode, ``sliced_matmul``), switch against mask and both
   against the fp32 oracle (xlstm slices nothing: its switch logits equal
   its mask logits bit for bit), the shared block's attention and MLP
   against their switch twins, the trace with one Mamba2, mLSTM and sLSTM
   layer alone, and the reference of a cut on the CPU: zamba2 at 6 units
   (one shared invocation), xlstm at 1 unit.
11. Serving plane: full-width qwen2-1.5b at the rate and SLO that phase
   3's B = 1 latencies give by the launcher's rule, passed as ``--rate``
   and ``--slo-ms`` and echoed back: (a) ``launch.serve`` in process on
   a bursty trace at CV² 8, then a time-varying one at tau 500, every
   query served with no build or capture; (b) two in-process replicas of
   one executor (``--replicas 2 --placement slack_aware``) in switch
   mode, each replica serving, ``sliced_matmul`` launched; (c) 32
   queries through two replica child processes over socketpairs
   (``ClusterRouter(transport="proc", execute="real")``), each building
   the model on the card and serving through its graphs, paced by the
   same rule for two replicas on the latency through the wire (the step,
   then the completion frame's encode and decode ms, measured first):
   each hello names the card, every query served, each child warm (0
   builds, 0 captures) with flash and the norm launched in it, 4
   completions bit for bit an in-process executor's from the same seed
   at the subnet each reports, spawn-to-hello seconds and each child's
   step ms beside the in-process one; (d)
   ``--transport proc --listen 127.0.0.1:0 --autoscale`` (1 to 2
   children over TCP, paced as (c)): every query accounted for, every
   child warm, the scale events printed; (e) ``--execute sim --profile measured
   --replicas 4``: the profile measured on the card, positive and not
   falling with batch. The profile is measured once, by (a)'s first run,
   and reused by the other runs that schedule from one ((b)'s switch
   replicas included).
12. Training: sandwich-rule supernet training through the kernels under
   autograd, at launch/train's shape (B = 8, S = 64, one sampled subnet,
   lr 3e-3, the order-1 synthetic task): (a) full-width, full-depth
   qwen2-1.5b, 4 steps in mask mode and 2 in switch mode, each step's host
   wall, device ms and idle share (torch.profiler), peak memory, tokens a
   second, loss, grad norm and launches; no build after the first step,
   every loss and grad norm finite, flash and the norm launched in every
   step and ``sliced_matmul`` in the switch steps, and no leaf left
   without a gradient; (b) the loss and every leaf's gradient of a 2-unit
   cut (B = 2, S = 32) on the card against the CPU's fp32 walk, max and
   min subnet in mask mode and max in switch mode, each leaf within 2e-2
   of its max |g| (else no further than the CPU's bf16 walk plus 0.02);
   (c) each Function's backward at the full-width shapes against
   torch.autograd of its plain version (bf16 tolerance), with both
   backwards' device ms; (d) crash and resume of the 2-unit cut through
   ``Trainer``: a checkpoint at step 2, a crash after step 3, the restored
   leaves bit for bit the saved ones, steps 3-4 within 1e-2 of an
   uninterrupted run's losses, save and restore seconds and bytes; (e)
   ``python -m repro_torch.launch.train --units 2 --steps 4 --ckpt-every
   2`` in a subprocess prints "done: step 4".
13. Conv: the paper's own OFA-ResNet supernet at full width (widths
   256-2048, 4 units a stage, 224 x 224, 1000 classes, fp32 with TF32
   off; no kernel of the port is on its path): all 27 subnets calibrated
   on one batch X of 32 images, each one's calibrated walk on X equal to
   its batch-statistics walk (1e-3 of max |logit|), the smallest, a
   middle and the largest subnet at B = 2 equal to the CPU's fp32 walk,
   every subnet at B = 32 with host wall, device ms and images a second
   (no parameter moves, no memory growth after the first walk, the
   shallowest subnet's conv calls fewer than the deepest's by the
   profiler), the norm tables' bytes against the shared weights', and
   the analytic profile's latency beside the card's.
14. Frontends: musicgen-medium (48 layers, MHA at head_dim 64,
   sinusoidal positions, layernorm, GELU) and qwen2-vl-7b (28 layers,
   G = 7, M-RoPE over three distinct position streams) at full width and
   depth, in turn, through ``lm.prefill`` / ``lm.decode_step``: the
   prefill from ``embeds`` (B = 8, S = 16) and 8 greedy decode steps on
   tokens of each Pareto subnet (16 of musicgen's, 18 of qwen2-vl's) in
   mask and in switch mode,
   no build after warmup, each walk held to the fp32 oracle as phase 8
   holds its configs, flash and decode attention, ``sliced_matmul`` and
   (qwen2-vl) the norm launched; each block against its switch twin; the
   trace of a prefill and a decode step; the 2-layer reference.
15. Distribution and int8 weights: (a) full-width, full-depth qwen2-1.5b
   in bf16: ``quantize_tree`` on the card (device ms), the int8 tree and
   scales against the bf16 bytes, every leaf's dequantization within
   amax/254; a 2-unit cut whose int8 tree and scales equal the CPU's bit
   for bit and whose int8 walk is within 2e-2 of max |logit| of the CPU's
   fp32 walk on the same dequantized weights; then prefill (B = 8, S =
   16) and 8 greedy decode steps of the widest and the narrowest Pareto
   subnet in mask mode with int8 weights (``dequantize_tree`` each step,
   then ``lm.decode_step``) against bf16: host and device ms a step, the
   dequantization's share, the logit gap and the greedy tokens that
   differ, no build, the three kernels launched; (b) NCCL at world size 1
   on a (1, 1) mesh: a 2-unit cut placed with ``plan.params``,
   ``seq_sharded_decode`` (B = 8, 12 / 2 heads, d = 128, Smax 2048,
   index 1500) against the ``decode_attention`` kernel within 2e-2, the
   int8 all-reduce equal to ``ef_quantize``'s dequantization, a checkpoint
   restored onto the plan's placements bit for bit; (c) the dry-run of
   qwen2-1.5b at train_4k and at decode_32k with int8 weights on the
   256-rank single mesh, started in subprocesses at the phase's start:
   each must end ``status: ok``; its roofline terms over H100 data-sheet
   peaks, per-device GB against 80 and collectives.

Each phase prints its seconds. Then one JSON line with every kernel's
numbers (the attention kernels' also at each head_dim of phases 8-10 and
14; the launches include phase 12's training steps and phase 14's walks),
and last the device line.
Exits non-zero, with no result line, when CUDA is unavailable, the port is
missing, or any phase fails.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# (name substring, memory bytes/s, dense bf16 tensor FLOP/s, fp32 FLOP/s)
# from NVIDIA's data sheets; the first match wins, SXM parts last
PEAKS = (("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12),
         ("H200", 4.8e12, 989e12, 67e12),
         ("H100", 3.35e12, 989e12, 67e12))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def rotating(fn, operands):
    """``fn`` called on the next operand tuple of ``operands`` each time
    (copies that together exceed the L2 cache keep every call cold)."""
    it = itertools.cycle(operands)
    return lambda: fn(*next(it))


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trace_intact(one, many, n: int) -> bool:
    """Whether a trace of ``n`` calls kept every event: ``one`` and
    ``many`` count the device kernels by name in a trace of one call and
    of ``n`` calls, and each name must come ``n`` times as often in the
    second (a name missing from either, or short, is a lost event)."""
    return bool(one) and set(one) == set(many) \
        and all(many[name] == n * c for name, c in one.items())


# traces taken of one measurement before it reads "not measured"
TRACE_TRIES = 3


def lost_events(one, many, n: int, top: int = 4):
    """The names whose counts break :func:`trace_intact`: (name, n times
    the one-call count, the n-call count), the largest gaps first."""
    gaps = [(name[:60], n * one.get(name, 0), many.get(name, 0))
            for name in set(one) | set(many)
            if many.get(name, 0) != n * one.get(name, 0)]
    return sorted(gaps, key=lambda g: -abs(g[1] - g[2]))[:top]


# host seconds kept between a profiler window's edge and the card's work
TRACE_GUARD_S = 0.002


def profiled(torch, fn, n: int):
    """The torch.profiler events (host and device) of ``n`` calls of
    ``fn``, after one call traced and dropped, each call TRACE_GUARD_S
    clear of the window's edges: the tracer drops the device events it
    dates before its window opens, and the card's clock, mapped onto the
    host's, can date the first kernel after an edge before it."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for _ in range(n + 1):
            time.sleep(TRACE_GUARD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_GUARD_S)
            prof.step()
    return prof.events()


def on_device(torch, ev) -> bool:
    """Whether a profiler event is the card's work (a kernel or a copy),
    not a host op or the span the profiler's step annotation draws over
    the device."""
    return ev.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(ev, "is_user_annotation", False) \
        and not ev.name.startswith("ProfilerStep")


def kernel_trace(torch, fn, n: int):
    """(kernel names counted, device us summed) of ``n`` calls of ``fn``
    under torch.profiler (:func:`profiled`)."""
    from collections import Counter
    us, names = 0.0, Counter()
    for ev in profiled(torch, fn, n):
        if on_device(torch, ev):
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
            names[ev.name] += 1
    return names, us


def intact_trace(torch, fn, n: int):
    """(names, device us) of ``n`` calls of ``fn`` from a trace that kept
    every event, checked against a trace of one call (the warm call first,
    then a fresh one each try, :func:`trace_intact`); None, with the last
    try's lost events printed, after TRACE_TRIES traces that lost
    events."""
    for _ in range(TRACE_TRIES):
        one, _ = kernel_trace(torch, fn, 1)
        names, us = kernel_trace(torch, fn, n)
        if us > 0 and trace_intact(one, names, n):
            return names, us
    say("trace-lost-events", calls=n, lost=lost_events(one, names, n))
    return None


def device_ms(torch, fn, n: int = 20):
    """The device's own kernel time per call of ``fn``, from
    torch.profiler (for the small kernels the CUDA-event time of
    :func:`time_ms` is the host's launch rate), from a trace that kept
    every event (:func:`intact_trace`); else "not measured"."""
    got = intact_trace(torch, fn, n)
    return "not measured" if got is None else got[1] / n / 1e3


def device_kernels(torch, fn, n: int = 3):
    """The names of the device kernels that ``n`` calls of ``fn`` run, from
    torch.profiler, from a trace that kept every event
    (:func:`intact_trace`); fails after three that lost events."""
    got = intact_trace(torch, fn, n)
    if got is None:
        fail(f"{TRACE_TRIES} traces lost device events")
    return list(got[0].elements())


_NORM_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def ptxas_entries(log: str):
    """Each kernel of an ``nvcc -Xptxas -v`` log: its name (the norm's
    instantiations as ``subnet_rmsnorm_kernel<type, vectors a thread,
    delta>``), registers and spilled bytes."""
    import re
    entries, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"subnet_rmsnorm_kernelI(\w+?)Li(\d+)ELb(\d)E",
                          name)
            if t:
                name = (f"subnet_rmsnorm_kernel<{_NORM_TYPES.get(t[1], t[1])}"
                        f", {t[2]}, {'delta' if t[3] == '1' else 'no delta'}>")
            cur = dict(kernel=name, registers=None, spill_stores=0,
                       spill_loads=0)
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return entries


class Card:
    def __init__(self, torch):
        self.name = torch.cuda.get_device_name(0)
        for sub, bw, bf16, fp32 in PEAKS:
            if sub in self.name:
                self.peak = sub
                self.bw, self.bf16, self.fp32 = bw, bf16, fp32
                break
        else:
            fail(f"no peak rates known for {self.name!r}")

    def bound(self, nbytes: float, flops: float, fp32: bool = False):
        t_mem = nbytes / self.bw * 1e3
        t_op = flops / (self.fp32 if fp32 else self.bf16) * 1e3
        return (t_mem, "bytes") if t_mem >= t_op else (t_op, "operations")


# --------------------------------------------------------------------------
# phase 1: card, build, probe
# --------------------------------------------------------------------------


def phase_build(torch, card):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch import compat
    from repro_torch.kernels import build
    with compat.BuildCounter() as bc:
        t0 = time.perf_counter()
        build.library()
        build_s = time.perf_counter() - t0
    x = torch.randn((8, 128), device="cuda")
    y = build.copy_probe(x)
    torch.cuda.synchronize()
    if not torch.equal(x, y):
        fail("copy probe returned different data")
    probe_ms = time_ms(torch, lambda: build.copy_probe(x))
    probe_plain_ms = time_ms(torch, lambda: x.clone())
    probe_bound_ms, _ = card.bound(2 * x.numel() * 4, 0)
    entries = ptxas_entries(build.ptxas_log())
    norm = [e for e in entries if e["kernel"].startswith("subnet_rmsnorm")]
    say("build", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        nvcc_builds=bc.count, build_seconds=round(build_s, 3),
        probe_ok=True, probe_ms=probe_ms, probe_plain_ms=probe_plain_ms,
        probe_bound_ms=probe_bound_ms,
        probe_device_ms=device_ms(torch, lambda: build.copy_probe(x)),
        probe_plain_device_ms=device_ms(torch, lambda: x.clone()),
        ptxas=[f"{e['kernel']}: {e['registers']} registers, "
               f"{e['spill_stores']}+{e['spill_loads']} bytes spilled"
               for e in entries if e not in norm])
    # the norm's main-path instantiations (bf16 at d = 1536: 2 vectors a
    # thread) and the worst of its buckets
    say("build-subnet_rmsnorm", instantiations=len(norm),
        main_path=[e for e in norm if e["kernel"].startswith(
            "subnet_rmsnorm_kernel<bf16, 2,")],
        max_registers=max((e["registers"] for e in norm), default=None),
        max_spill_bytes=max((e["spill_stores"] + e["spill_loads"]
                             for e in norm), default=None),
        spilling=[e["kernel"] for e in norm
                  if e["spill_stores"] + e["spill_loads"]])
    if not norm:
        fail("no subnet_rmsnorm kernel in the ptxas log")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _compare(torch, name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **BF16_TOL):
        fail(f"{name}: kernel disagrees with its plain version, "
             f"max |err| {err}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    return err


def phase_kernels(torch, card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    results = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- subnet_rmsnorm: x (B*S, 1536) at prefill, (B, 1536) at decode ----
    results["subnet_rmsnorm"] = _norm_cases(torch, card, randn)

    # -- flash_attention: q (B,12,S,128), k/v (B,2,S,128) ------------------
    results["flash_attention"] = _flash_cases(torch, card, randn)

    # -- decode_attention: q (B,12,1,128), cache (B,2,Smax,128) ------------
    results["decode_attention"] = _decode_cases(torch, card, randn)

    # -- both attention kernels at the other configs' heads ---------------
    results["flash_attention"]["head_dims"] = {
        key: _flash_cases(torch, card, randn, heads, key)
        for key, heads in CONFIG_HEADS.items()}
    errs = _decode_checks(torch, randn, (64, 80, 120), (1, 4, 5, 7),
                          (16, 256, 4096))
    results["decode_attention"]["head_dims"] = {
        key: dict(_decode_rows(torch, card, randn, heads, key,
                               ((16, 3), (256, 255), (4096, 4095))),
                  max_abs_err=max(errs), cases=len(errs))
        for key, heads in CONFIG_HEADS.items()}
    results["sliced_matmul"] = _sliced_cases(torch, card, randn)
    results["sliced_matmul"]["experts"] = _grouped_cases(torch, card, randn)
    return results


# the heads of the configs beside qwen2-1.5b: (head_dim, query heads, kv
# heads), keyed as the kernels line reports them
CONFIG_HEADS = {"80": (80, 32, 32),         # stablelm-3b, MHA
                "120": (120, 32, 8),        # h2o-danube-3-4b, G = 4
                "128-G5": (128, 40, 8),     # qwen2.5-14b, llama4, G = 5
                "128-G4": (128, 32, 8),     # mixtral-8x7b, G = 4
                "64": (64, 24, 24),         # musicgen-medium, MHA
                "128-G7": (128, 28, 4)}     # qwen2-vl-7b, G = 7


def flash_bound(card, B: int, Hq: int, Hkv: int, S: int, hd: int):
    """The bound of one causal flash call with no window at the real
    head_dim: q, k, v and o moved once, 4 * hd FLOPs for each of the
    S (S + 1) / 2 live (query, key) pairs of each query head."""
    return card.bound(2 * (2 * B * Hq + 2 * B * Hkv) * S * hd,
                      4 * hd * S * (S + 1) // 2 * B * Hq)


def decode_bound(card, B: int, Hq: int, Hkv: int, live: int, hd: int):
    """The bound of one decode call at the real head_dim: q and the
    output, and ``live`` positions of K and V of each kv head, moved once;
    4 * hd FLOPs a live position and query head."""
    return card.bound(2 * (2 * B * Hq + 2 * B * Hkv * live) * hd,
                      4 * hd * live * B * Hq)


def norm_bound(card, rows: int, d: int, fused: bool):
    """The bound of one SubnetNorm call on (rows, d) bf16: x (and delta)
    read, h (and s) written, the gain row and subnet_id read once; about 4
    FLOPs an element (5 with the add) at the fp32 rate."""
    tensors = 4 if fused else 2
    return card.bound(tensors * rows * d * 2 + d * 4 + 4,
                      (5 if fused else 4) * rows * d, fp32=True)


def _norm_cases(torch, card, randn):
    """subnet_rmsnorm in both forms at qwen2-1.5b's width (d = 1536, 18
    subnets, bf16) at 8 rows (a decode step), 128 (a B=8, S=16 prefill)
    and 2048 (B=8, S=256), for the first and the last subnet: h against
    the plain version, the fused form's s equal to ``x + delta`` bit for
    bit, two launches bitwise equal. Then at each row count the device ms
    of each form beside the bound and the library yardsticks (``rms_norm``
    with the gain row for the standalone form, ``torch.add`` then
    ``rms_norm`` for the fused one), and the wrapper's host us (least mean
    of 10 rounds). Returns the standalone form at 128 rows (the
    headline)."""
    import torch.nn.functional as F
    from repro_torch.kernels import subnet_rmsnorm as rn
    d, n_sub, dev = 1536, 18, "cuda"
    gamma = 1 + 0.1 * randn(n_sub, d, dtype=torch.float32)
    errs, rows_out = [], {}
    for rows in (8, 128, 2048):
        x, delta = randn(rows, d), randn(rows, d)
        for sid_v in (0, n_sub - 1):
            sid = torch.full((), sid_v, dtype=torch.int32, device=dev)
            label = f"subnet_rmsnorm rows={rows} sid={sid_v}"
            h = rn.subnet_rmsnorm(x, gamma, sid)
            errs.append(_compare(torch, label, h,
                                 rn.subnet_rmsnorm_plain(x, gamma, sid)))
            s, hf = rn.add_subnet_rmsnorm(x, delta, gamma, sid)
            if not torch.equal(s, x + delta):
                fail(f"{label} fused: s differs from x + delta")
            errs.append(_compare(torch, label + " fused", hf,
                                 rn.subnet_rmsnorm_plain(x + delta, gamma,
                                                         sid)))
            again = rn.add_subnet_rmsnorm(x, delta, gamma, sid)
            if not (torch.equal(h, rn.subnet_rmsnorm(x, gamma, sid))
                    and torch.equal(s, again[0]) and torch.equal(hf, again[1])):
                fail(f"{label}: two launches gave different bits")
        w_row = gamma[n_sub - 1].to(x.dtype)

        def alone():
            return rn.subnet_rmsnorm(x, gamma, sid)

        def fused():
            return rn.add_subnet_rmsnorm(x, delta, gamma, sid)
        row = {}
        for form, fn, lib in (
                ("standalone", alone,
                 lambda: F.rms_norm(x, (d,), w_row, 1e-5)),
                ("fused", fused,
                 lambda: F.rms_norm(torch.add(x, delta), (d,), w_row, 1e-5))):
            bound, by = norm_bound(card, rows, d, form == "fused")
            r = dict(device_ms=device_ms(torch, fn),
                     library_device_ms=device_ms(torch, lib),
                     bound_ms=bound, bound_by=by,
                     host_us=host_us(torch, fn, rounds=10))
            r["bound_share"] = (bound / r["device_ms"]
                                if isinstance(r["device_ms"], float)
                                else "not measured")
            if rows == 128:
                r.update(ms=time_ms(torch, fn), library_ms=time_ms(torch, lib))
            row[form] = r
        if rows == 128:
            row["standalone"]["plain_ms"] = time_ms(
                torch, lambda: rn.subnet_rmsnorm_plain(x, gamma, sid))
            row["fused"]["plain_ms"] = time_ms(
                torch, lambda: rn.add_subnet_rmsnorm_plain(x, delta, gamma,
                                                           sid))
        rows_out[rows] = row
        say("kernel", name="subnet_rmsnorm", shape=[rows, d], **row)
    say("kernel-case", name="subnet_rmsnorm", cases=len(errs),
        max_abs_err=max(errs), checked="BF16_TOL against the plain version, "
        "s == x + delta bit for bit, two launches bitwise equal")
    return dict(rows_out[128]["standalone"], shape=[128, d],
                max_abs_err=max(errs), cases=len(errs), rows=rows_out)


def _flash_cases(torch, card, randn, heads=(128, 12, 2), key=None):
    """flash_attention at ``heads`` (head_dim, query heads, kv heads;
    qwen2-1.5b's by default), B = 8. Every case of the card tests (S = 1,
    16, 63, 64, 65 with kv_len 40, 200 with window 64 and kv_len 150, 256;
    kv_len read on the card), on contiguous (B, H, S, d) tensors and on
    views of one (B, S, Hq + 2 Hkv, d) projection, at head width None, half
    (a device tensor, as switch mode passes it) and full, held against the
    plain version; two launches must give the same bits and inactive
    heads exactly 0. Then at S = 16, 256 and 2048 the device ms at full
    and half head width beside SDPA's (on k/v repeated per query head) and
    the bound at the real head_dim (the kernel pads the head to 128
    columns on the SM), and the wrapper's host us at S = 16 (least mean of
    5 rounds). Returns the S = 256 row (the headline)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = "cuda"
    hd, Hq, Hkv = heads
    B, G = 8, Hq // Hkv
    tag = {} if key is None else {"heads": key}

    def i32(n):
        return torch.full((), n, dtype=torch.int32, device=dev)

    errs = []
    cases = ((1, 0, None), (16, 0, None), (63, 0, None), (64, 0, None),
             (65, 0, 40), (200, 64, 150), (256, 0, None))
    for (S, window, kv_len), layout, hw in itertools.product(
            cases, ("bhsd", "bshd-view"), (None, Hq // 2, Hq)):
        if layout == "bhsd":
            q, k, v = randn(B, Hq, S, hd), randn(B, Hkv, S, hd), \
                randn(B, Hkv, S, hd)
        else:
            qkv = randn(B, S, Hq + 2 * Hkv, hd)
            q, k, v = (t.transpose(1, 2)
                       for t in qkv.split([Hq, Hkv, Hkv], dim=2))
        kw = dict(window=window,
                  kv_len=None if kv_len is None else i32(kv_len),
                  head_width=i32(hw) if hw == Hq // 2 else hw)
        label = (f"flash_attention heads={heads} S={S} window={window} "
                 f"kv_len={kv_len} {layout} head_width={hw}")
        got = fa.flash_attention(q, k, v, **kw)
        errs.append(_compare(torch, label, got,
                             fa.flash_attention_plain(q, k, v, **kw)))
        if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
            fail(f"{label}: two launches gave different bits")
        if hw is not None and got[:, ~ref.head_active(Hq, Hkv, hw, dev)].any():
            fail(f"{label}: nonzero outputs of inactive heads")
    say("kernel-case", name="flash_attention", **tag, cases=len(errs),
        max_abs_err=max(errs), checked="BF16_TOL against the plain version, "
        "two launches bitwise equal, inactive heads exactly 0")

    rows = {}
    half = i32(Hq // 2)
    for S in (16, 256, 2048):
        q, k, v = randn(B, Hq, S, hd), randn(B, Hkv, S, hd), \
            randn(B, Hkv, S, hd)
        kx, vx = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        bound, by = flash_bound(card, B, Hq, Hkv, S, hd)
        row = dict(
            shape=[B, Hq, Hkv, S, hd], plan=list(fa.pack_plan(S, G)),
            device_ms=device_ms(torch, lambda: fa.flash_attention(q, k, v)),
            half_heads_device_ms=device_ms(
                torch, lambda: fa.flash_attention(q, k, v, head_width=half)),
            library_device_ms=device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, is_causal=True)),
            bound_ms=bound, bound_by=by)
        if S == 16:
            row["host_us"] = host_us(
                torch, lambda: fa.flash_attention(q, k, v), rounds=5)
        if S == 256:
            row.update(
                ms=time_ms(torch, lambda: fa.flash_attention(q, k, v)),
                plain_ms=time_ms(
                    torch, lambda: fa.flash_attention_plain(q, k, v),
                    iters=10),
                library_ms=time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, kx, vx, is_causal=True)))
        rows[S] = row
        say("kernel", name="flash_attention", **tag, S=S, **row)
        del q, k, v, kx, vx
    return dict(rows[256], max_abs_err=max(errs), cases=len(errs),
                s16=rows[16], s2048=rows[2048])


def _decode_checks(torch, randn, head_dims, Gs, smaxes):
    """decode_attention at each of ``head_dims`` over G in ``Gs`` query
    heads per kv head (2 kv heads), B = 1 and 8, each Smax of ``smaxes``,
    every index class (0, 3, Smax / 2, Smax - 1) and window 0 and 64, held
    against the plain version; two launches must give the same bits.
    Returns the max |error| of each case."""
    from repro_torch.kernels import decode_attention as da
    errs = []
    for hd, G, B, Smax in itertools.product(head_dims, Gs, (1, 8), smaxes):
        q, kc, vc = randn(B, 2 * G, 1, hd), randn(B, 2, Smax, hd), \
            randn(B, 2, Smax, hd)
        for index, window in itertools.product(
                sorted({0, 3, Smax // 2, Smax - 1}), (0, 64)):
            idx = torch.full((), index, dtype=torch.int32, device="cuda")
            label = (f"decode_attention d={hd} G={G} B={B} Smax={Smax} "
                     f"index={index} window={window}")
            got = da.decode_attention(q, kc, vc, idx, window=window)
            errs.append(_compare(torch, label, got, da.decode_attention_plain(
                q, kc, vc, idx, window=window)))
            if not torch.equal(got, da.decode_attention(q, kc, vc, idx,
                                                        window=window)):
                fail(f"{label}: two launches gave different bits")
    say("kernel-case", name="decode_attention", head_dims=list(head_dims),
        cases=len(errs), max_abs_err=max(errs),
        checked="BF16_TOL against the plain version, two launches bitwise "
        "equal")
    return errs


def _decode_cases(torch, card, randn):
    """decode_attention at d = 128 over G = 1, 5, 6, 7, 8 (2 kv heads),
    Smax = 16, 32, 256 and 2048 (:func:`_decode_checks`), then at
    qwen2-1.5b's heads (12 over 2), B = 8, :func:`_decode_rows` at Smax 16
    (index 3, the trace's decode step), 256 (index 255) and 2048 (index
    2047 and 1023). Returns the Smax = 256 row (the headline)."""
    errs = _decode_checks(torch, randn, (128,), (1, 5, 6, 7, 8),
                          (16, 32, 256, 2048))
    return dict(_decode_rows(torch, card, randn, (128, 12, 2), None,
                             ((16, 3), (256, 255), (2048, 2047),
                              (2048, 1023))),
                max_abs_err=max(errs), cases=len(errs))


def _decode_rows(torch, card, randn, heads, key, shapes):
    """decode_attention at ``heads`` (head_dim, query heads, kv heads),
    B = 8, for each (Smax, index) of ``shapes``: one device kernel a call
    and no allocation but the output, then device ms beside masked SDPA
    (on k/v repeated per query head) and the bound at the real head_dim,
    and at Smax 256 the wrapper's host us (least mean of 10 rounds).
    Returns the Smax = 256 row with the others under ``smax<Smax>`` (and
    ``_index<index>`` for a second index)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    dev = "cuda"
    hd, Hq, Hkv = heads
    B, G = 8, Hq // Hkv
    tag = {} if key is None else {"heads": key}
    q = randn(B, Hq, 1, hd)
    sms = da._sm_count(q.device)
    out, seen = {}, set()
    for Smax, index in shapes:
        kc, vc = randn(B, Hkv, Smax, hd), randn(B, Hkv, Smax, hd)
        kcx, vcx = kc.repeat_interleave(G, dim=1), vc.repeat_interleave(G, dim=1)
        idx = torch.full((), index, dtype=torch.int32, device=dev)
        mask = (torch.arange(Smax, device=dev) <= index)[None, None, None, :]
        n_split = da.grid_splits(B * Hkv, Smax, sms)
        _, length = da.live_range(index, 0, Smax)
        chunk, n_live = da.schedule(length, n_split, da.PLAN.min_chunk)

        def run():
            return da.decode_attention(q, kc, vc, idx)
        # one device kernel a call, and no allocation but the output
        names = device_kernels(torch, run)
        if len(names) != 3 or not all("decode_attention_kernel" in n
                                       for n in names):
            fail(f"decode_attention Smax={Smax}: not one kernel a call: "
                 f"{names}")
        before = torch.cuda.memory_allocated()
        kept = run()
        grew = torch.cuda.memory_allocated() - before
        if grew != kept.untyped_storage().nbytes():
            fail(f"decode_attention Smax={Smax}: a call allocated {grew} "
                 f"bytes, its output {kept.untyped_storage().nbytes()}")
        del kept
        bound, by = decode_bound(card, B, Hq, Hkv, length, hd)
        row = dict(
            shape=[B, Hq, Hkv, Smax, hd], index=index, plan=list(da.PLAN),
            grid=[B * Hkv, n_split], chunk=chunk, live_splits=n_live,
            device_ms=device_ms(torch, run),
            library_device_ms=device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kcx, vcx, attn_mask=mask)),
            bound_ms=bound, bound_by=by)
        row["bound_share"] = (bound / row["device_ms"]
                              if isinstance(row["device_ms"], float)
                              else "not measured")
        if Smax == 256:
            row.update(
                host_us=host_us(torch, run, rounds=10),
                ms=time_ms(torch, run),
                plain_ms=time_ms(torch, lambda: da.decode_attention_plain(
                    q, kc, vc, idx)),
                library_ms=time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, kcx, vcx, attn_mask=mask)))
        name = f"smax{Smax}" + (f"_index{index}" if Smax in seen else "")
        seen.add(Smax)
        out[name] = row
        say("kernel", name="decode_attention", **tag, Smax=Smax, **row)
        del kc, vc, kcx, vcx
    return dict(out.pop("smax256"), **out)


def host_us(torch, fn, n: int = 200, rounds: int = 1) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's own cost: the
    calls are enqueued without a synchronize in between); with ``rounds``
    > 1 the least of that many means, the one the shared host disturbed
    least."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


# sliced_matmul's output bits on the inputs of sliced_digest, as the
# build before its PTX helpers moved into csrc/hopper.cuh gave them on an
# H100 with 132 SMs (tools/flash_bench.py on both builds in one call; the
# grid, so the split plan, follows the SM count)
SLICED_DIGEST = {
    "sms": 132,
    "sha256": "b3a3696d70f9b1511e6958cfae7f36c0f81d0e23dbee50836c24f25b10afa25b"}


def sliced_digest(torch):
    """sha256 of ``sliced_matmul``'s output bits over fixed cases (inputs
    from a numpy seed, widths in device memory), with the card's SM
    count."""
    import hashlib
    import numpy as np
    from repro_torch.kernels import sliced_matmul as sm
    rng = np.random.default_rng(11)
    h = hashlib.sha256()

    def dev(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to("cuda").bfloat16()

    def width(n):
        return None if n is None else torch.full((), n, dtype=torch.int32,
                                                 device="cuda")

    for M, K, N, ai, ao, nseg in ((128, 1536, 8960, None, 4480, 1),
                                  (8, 8960, 1536, 6656, None, 1),
                                  (128, 1536, 1536, 384, None, 2),
                                  (2048, 1536, 8960, None, None, 1)):
        y = sm.sliced_matmul(dev((M, K)), dev((K, N)), width(ai), width(ao),
                             segments=nseg)
        h.update(y.view(torch.int16).cpu().numpy().tobytes())
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "sha256": h.hexdigest()}


# rows of the 2-d cases that run the 128 x 256 tile (qwen2-1.5b's FFN at a
# burst step); the others run the 64- and 128-row tiles of 128 columns
WIDE_ROWS = (2048, 4096)


def _sliced_cases(torch, card, randn):
    """sliced_matmul at the switch path's shapes (qwen2-1.5b: FFN gate/up
    (M,1536)x(1536,8960), FFN down (M,8960)x(8960,1536), wo as 2 K
    segments of 768, M = 128 prefill rows and 8 decode rows; M = 2048 and
    4096, the burst steps of B = 16 and 32 queries of 128 tokens, which
    run the 128 x 256 tile) and at awkward ones: 7 rows, a partial K
    tile, a partial N tile, and per-group strided views. Widths are int32
    tensors in device memory. Each case reports the blocks and splits of
    the kernel's plan (``split_plan``, the Python mirror of what the
    kernel works out on the card) and the wrapper's host microseconds per
    call; two launches must give the same bits, and the plan the tile
    the case is meant to run (``WIDE_ROWS``: one device kernel a call
    there). Returns the FFN-up case at M=128, full width (the
    headline)."""
    from repro_torch.kernels import sliced_matmul as sm
    dev = "cuda"
    # (label, M, K, N, active_in, active_out, segments)
    cases = []
    for M in (128, 8):
        cases += [(f"ffn_up M={M} ao={ao}", M, 1536, 8960, None, ao, 1)
                  for ao in (8960, 6656, 4480)]
        cases += [(f"ffn_down M={M} ai={ai}", M, 8960, 1536, ai, None, 1)
                  for ai in (8960, 6656, 4480)]
        cases += [(f"wo M={M} ai={ai}x2", M, 1536, 1536, ai, None, 2)
                  for ai in (768, 384)]
    cases += [("awkward M=7 ai=200 ao=100", 7, 1536, 8960, 200, 100, 1),
              ("ffn_up M=2048 ao=8960", 2048, 1536, 8960, None, 8960, 1),
              ("ffn_down M=2048 ai=8960", 2048, 8960, 1536, 8960, None, 1),
              ("ffn_up M=4096 ao=8960", 4096, 1536, 8960, None, 8960, 1),
              ("ffn_down M=4096 ai=8960", 4096, 8960, 1536, 8960, None, 1)]
    copies = 4        # 4 x 27.5 MB of weights: more than the 50 MB L2
    headline, errs = None, []
    for label, M, K, N, ai, ao, nseg in cases:
        x = randn(M, K)
        ws = [randn(K, N) for _ in range(copies)]
        a = None if ai is None else torch.full((), ai, dtype=torch.int32,
                                              device=dev)
        b = None if ao is None else torch.full((), ao, dtype=torch.int32,
                                              device=dev)
        got = sm.sliced_matmul(x, ws[0], a, b, segments=nseg)
        want = sm.sliced_matmul_plain(x, ws[0], a, b, segments=nseg)
        err = _compare(torch, f"sliced_matmul {label}", got, want)
        if ao is not None and got[:, ao:].any():
            fail(f"sliced_matmul {label}: nonzero columns past active_out")
        if not torch.equal(got, sm.sliced_matmul(x, ws[0], a, b,
                                                 segments=nseg)):
            fail(f"sliced_matmul {label}: two launches gave different bits")
        errs.append(err)
        plan = sm.split_plan(M, N, K, nseg, ai, ao, sm.grid_size(x.device))
        want_bn = sm.BN_WIDE if M in WIDE_ROWS else sm.BN
        if plan.bn != want_bn:
            fail(f"sliced_matmul {label}: the plan takes {plan.bn} columns "
                 f"a tile, not {want_bn}")
        if M in WIDE_ROWS:
            names = device_kernels(torch, lambda: sm.sliced_matmul(
                x, ws[0], a, b, segments=nseg), n=1)
            if len(names) != 1 or "sliced_matmul_kernel" not in names[0]:
                fail(f"sliced_matmul {label}: device kernels {names} a "
                     f"call, not one")
        kin = (K // nseg if ai is None else ai) * nseg
        kout = N if ao is None else ao
        bound, by = card.bound(2 * (M * kin + kin * kout + M * N),
                               2 * M * kin * kout)
        ops = [(x, w) for w in ws]
        row = dict(
            shape=[M, K, N], active_in=ai, active_out=ao, segments=nseg,
            max_abs_err=err, ctas=plan.grid,
            busy_ctas=min(plan.grid, plan.units), tile=[plan.bm, plan.bn],
            splits=plan.splits, tiles_with_one_more_split=plan.extra,
            host_us=host_us(torch, lambda: sm.sliced_matmul(
                x, ws[0], a, b, segments=nseg)),
            ms=time_ms(torch, rotating(lambda xx, ww: sm.sliced_matmul(
                xx, ww, a, b, segments=nseg), ops)),
            plain_ms=time_ms(torch, rotating(
                lambda xx, ww: sm.sliced_matmul_plain(
                    xx, ww, a, b, segments=nseg), ops), iters=10),
            # one cuBLAS call on the active block; a segmented product has
            # no single library call
            library_ms=(time_ms(torch, rotating(
                lambda xx, ww: torch.matmul(xx[:, :kin], ww[:kin, :kout]),
                ops)) if nseg == 1 else None),
            bound_ms=bound, bound_by=by,
            device_ms=device_ms(torch, rotating(
                lambda xx, ww: sm.sliced_matmul(xx, ww, a, b,
                                                segments=nseg), ops)),
            library_device_ms=(device_ms(torch, rotating(
                lambda xx, ww: torch.matmul(xx[:, :kin], ww[:kin, :kout]),
                ops)) if nseg == 1 else None))
        say("kernel-case", name="sliced_matmul", case=label, **row)
        if headline is None:
            headline = row
        del ws, ops
    # per-group strided views: the wo of each KV group read in place
    buf = randn(128, 1536 + 64)
    o, wo = buf[:, 64:], randn(1536, 1536)
    for heads, g in itertools.product((3, 6), (0, 1)):
        act = torch.full((), heads * 128, dtype=torch.int32, device=dev)
        og, wg = o[:, g * 768:(g + 1) * 768], wo[g * 768:(g + 1) * 768]
        errs.append(_compare(
            torch, f"sliced_matmul per-group views heads={heads} group={g}",
            sm.sliced_matmul(og, wg, act, None),
            sm.sliced_matmul_plain(og, wg, act, None)))
    say("kernel-case", name="sliced_matmul", case="per-group strided views",
        max_abs_err=errs[-1])
    digest = sliced_digest(torch)
    same = digest == SLICED_DIGEST
    if digest["sms"] == SLICED_DIGEST["sms"] and not same:
        fail("sliced_matmul: output bits differ from the build before the "
             "helper move")
    say("kernel-case", name="sliced_matmul", case="bits of fixed cases",
        sms=digest["sms"], same_as_before_helper_move=(
            same if digest["sms"] == SLICED_DIGEST["sms"]
            else "not compared: another SM count"))
    return dict(headline, max_abs_err=max(errs), cases=len(errs))


# the expert stacks of MoE switch mode: (config, E, d, f, capacities,
# capacities that run the 128 x 256 tile) with C = 8 at a decode step of
# B = 8 (the least capacity), C = 40 at a mixtral prefill of B = 8, S = 16
# (8 * 16 * 2 * 1.25 / 8), and C = 320 and 640 at mixtral's burst steps,
# prefills of B = 8 and 16 queries of 128 tokens
EXPERT_STACKS = (("mixtral-8x7b", 8, 4096, 14336, (8, 40), (320, 640)),
                 ("llama4-maverick-400b-a17b", 128, 5120, 8192, (8,), ()))


def _grouped_cases(torch, card, randn):
    """``sliced_matmul`` over a stack of experts (x (E, C, K), w (E, K, N),
    one launch for all experts) at the expert shapes of mixtral-8x7b and
    llama4-maverick, for the up (gate) product (K = d, N = f, active_out =
    the width) and the down product (K = f, N = d, active_in = the width)
    at each ``moe_ffn`` width. Each case: against the plain version
    (BF16_TOL), columns past active_out exactly 0, two launches bitwise
    equal, one device kernel a call, the plan's tile the one the case is
    meant to run; device ms against ``torch.bmm`` on the active block and
    against the bound (bytes: the active weight block, x and y once).
    Returns the rows keyed by case."""
    from repro_torch.configs import get_config
    from repro_torch.core import subnet as sn
    from repro_torch.kernels import sliced_matmul as sm
    dev = "cuda"
    rows = {}
    for name, E, d, f, caps, wide_caps in EXPERT_STACKS:
        widths = sn.width_options(get_config(name))["moe_ffn"]
        for kind, K, N in (("up", d, f), ("down", f, d)):
            w = randn(E, K, N)
            for C, width in itertools.product(caps + wide_caps, widths):
                label = f"{name} {kind} C={C} width={width}"
                x = randn(E, C, K)
                wid = torch.full((), width, dtype=torch.int32, device=dev)
                ai, ao = (None, wid) if kind == "up" else (wid, None)
                kin, kout = (K, width) if kind == "up" else (width, N)

                def call():
                    return sm.sliced_matmul(x, w, ai, ao)
                got = call()
                err = _compare(torch, f"sliced_matmul experts {label}", got,
                               sm.sliced_matmul_plain(x, w, ai, ao))
                if kind == "up" and got[..., width:].any():
                    fail(f"sliced_matmul experts {label}: nonzero columns "
                         f"past active_out")
                if not torch.equal(got, call()):
                    fail(f"sliced_matmul experts {label}: two launches gave "
                         f"different bits")
                names = device_kernels(torch, call, n=1)
                if len(names) != 1 or "sliced_matmul_kernel" not in names[0]:
                    fail(f"sliced_matmul experts {label}: device kernels "
                         f"{names} a call, not one")
                plan = sm.split_plan(C, N, K, 1, None if ai is None else width,
                                     None if ao is None else width,
                                     sm.grid_size(x.device), E)
                want_bn = sm.BN_WIDE if C in wide_caps else sm.BN
                if plan.bn != want_bn:
                    fail(f"sliced_matmul experts {label}: the plan takes "
                         f"{plan.bn} columns a tile, not {want_bn}")
                bound, by = card.bound(2 * E * (C * kin + kin * kout + C * N),
                                       2 * E * C * kin * kout)

                def library():
                    return torch.bmm(x[:, :, :kin], w[:, :kin, :kout])
                row = dict(
                    shape=[E, C, K, N], width=width, max_abs_err=err,
                    tile=[plan.bm, plan.bn], live_tiles=plan.live_tiles,
                    splits=plan.splits, ms=time_ms(torch, call, iters=20),
                    plain_ms=time_ms(torch, lambda: sm.sliced_matmul_plain(
                        x, w, ai, ao), iters=3, warmup=1),
                    library_ms=time_ms(torch, library, iters=20),
                    bound_ms=bound, bound_by=by,
                    device_ms=device_ms(torch, call, n=10),
                    library_device_ms=device_ms(torch, library, n=10),
                    host_us=host_us(torch, call, n=20))
                row["bound_share"] = (bound / row["device_ms"]
                                      if isinstance(row["device_ms"], float)
                                      else "not measured")
                say("kernel-case", name="sliced_matmul", case=label, **row)
                rows[label] = row
                del x, got
            del w
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phases 3-5: the main path
# --------------------------------------------------------------------------

PATH_KERNELS = ("subnet_rmsnorm", "flash_attention", "decode_attention",
                "sliced_matmul")
# device symbols of the port's kernels, as the profiler names them
PORT_KERNEL_SYMBOLS = ("subnet_rmsnorm_kernel", "flash_fwd_kernel",
                       "decode_attention_kernel", "sliced_matmul_kernel")


def phase_serve(torch):
    from repro_torch import compat
    from repro_torch.launch import serve
    compat.reset_launch_counts()
    out = serve.run(["--execute", "real", "--arch", "qwen2-1.5b",
                     "--queries", "32", "--seq-len", "16"])
    launches = compat.launch_counts()
    say("serve", arch=out["arch"], size=out["size"],
        queries=out["queries"], served=out["served"],
        slo_attainment=out["slo_attainment"],
        p50_latency_ms=out["p50_latency_ms"],
        p99_latency_ms=out["p99_latency_ms"], rate_qps=out["rate_qps"],
        slo_ms=out["slo_ms"], lat_fast_ms=out["lat_fast_ms"],
        lat_slow_ms=out["lat_slow_ms"], init_seconds=out["init_seconds"],
        warmup=out["warmup"], executor=out["executor"],
        serve_phase_launches=out["kernel_launches"], launches=launches,
        serve_phase_builds=out["serve_phase_builds"],
        serve_phase_captures=out["serve_phase_captures"])
    if out["size"] != "full":
        fail("serve did not run the full-width model")
    if out["queries"] < 1 or out["served"] != out["queries"]:
        fail(f"served {out['served']} of {out['queries']} queries")
    if out["serve_phase_builds"] != 0 or out["serve_phase_captures"] != 0:
        fail(f"serve phase built {out['serve_phase_builds']} kernels and "
             f"captured {out['serve_phase_captures']} graphs")
    if not out["executor"]["graph_captures"]:
        fail("serve: the executor captured no graph at warmup")
    for name in ("subnet_rmsnorm", "flash_attention"):
        if out["kernel_launches"].get(name, 0) <= 0:
            fail(f"{name} never launched while serving")
    # phase 11 paces the serving plane from these B = 1 latencies
    return launches, (out["lat_fast_ms"], out["lat_slow_ms"])


def phase_decode(torch):
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import build_executor
    cfg = get_config("qwen2-1.5b")
    ex = build_executor(cfg, seed=1, device="cuda")
    compat.reset_launch_counts()
    B, steps = 8, 8
    rng = np.random.default_rng(0)
    report = {}
    for idx in (0, ex.n_subnets - 1):
        cache = ex.init_cache(B, 32)
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = ex.decode_step(idx, tok, cache, i)
            if logits.shape != (B, cfg.vocab_size) \
                    or not np.isfinite(logits).all():
                fail(f"decode subnet {idx} step {i}: bad logits "
                     f"{logits.shape}")
            tok = logits.argmax(-1).astype(np.int32)[:, None]
        report[f"subnet_{idx}_ms_per_step"] = \
            (time.perf_counter() - t0) / steps * 1e3
    launches = compat.launch_counts()
    say("decode", batch=B, steps=steps, subnets=[0, ex.n_subnets - 1],
        launches=launches, **report)
    if launches.get("decode_attention", 0) <= 0:
        fail("decode_attention never launched while decoding")
    return launches


def phase_switch(torch):
    """WeightSlice switch mode at full width and depth: parity with mask
    mode over one parameter tree, decode, and the launcher serving with
    ``--slice-mode switch``. Returns the kernel launches of the phase."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
    cfg = get_config("qwen2-1.5b")
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(4),
                           "cuda")
    mask = SubnetExecutor(params, cfg)
    switch = SubnetExecutor(params, cfg,
                            exec_cfg=ExecutorConfig(slice_mode="switch"))
    compat.reset_launch_counts()
    B, S, steps = 8, 16, 8
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    prefill_errs = [rel_err(switch.prefill(idx, toks), mask.prefill(idx, toks),
                            f"switch prefill subnet {idx}")
                    for idx in range(switch.n_subnets)]
    decode_errs, decode = [], {}
    for idx in (0, switch.n_subnets - 1):
        cs, cm = switch.init_cache(B, 32), mask.init_cache(B, 32)
        tok = toks[:, :1]
        t0 = time.perf_counter()
        for i in range(steps):
            got, cs = switch.decode_step(idx, tok, cs, i)
            want, cm = mask.decode_step(idx, tok, cm, i)
            decode_errs.append(rel_err(got, want,
                                       f"switch decode {idx} step {i}"))
            tok = want.argmax(-1).astype(np.int32)[:, None]
        decode[f"subnet_{idx}_ms_per_step_both_modes"] = \
            (time.perf_counter() - t0) / steps * 1e3
    parity_launches = compat.launch_counts()
    n_sub = switch.n_subnets
    del mask, switch, params
    torch.cuda.empty_cache()
    compat.reset_launch_counts()
    out = serve.run(["--execute", "real", "--arch", "qwen2-1.5b",
                     "--queries", "32", "--seq-len", "16",
                     "--slice-mode", "switch"])
    serve_launches = compat.launch_counts()
    say("switch", subnets=n_sub, batch=B, seq=S,
        decode_steps=steps, prefill_rel_err_vs_mask=prefill_errs,
        decode_rel_err_vs_mask=decode_errs,
        max_rel_err_vs_mask=max(prefill_errs + decode_errs),
        tol="2e-2 of max|mask logit|", parity_launches=parity_launches,
        slice_mode=out["slice_mode"], queries=out["queries"],
        served=out["served"], slo_attainment=out["slo_attainment"],
        p50_latency_ms=out["p50_latency_ms"],
        p99_latency_ms=out["p99_latency_ms"], rate_qps=out["rate_qps"],
        slo_ms=out["slo_ms"], lat_fast_ms=out["lat_fast_ms"],
        lat_slow_ms=out["lat_slow_ms"], warmup=out["warmup"],
        serve_phase_launches=out["kernel_launches"],
        serve_phase_builds=out["serve_phase_builds"],
        serve_phase_captures=out["serve_phase_captures"], **decode)
    if out["slice_mode"] != "switch" or out["size"] != "full":
        fail("switch serve did not run full-width switch mode")
    if out["queries"] < 1 or out["served"] != out["queries"]:
        fail(f"switch served {out['served']} of {out['queries']} queries")
    if out["serve_phase_builds"] != 0 or out["serve_phase_captures"] != 0:
        fail(f"switch serve phase built {out['serve_phase_builds']} kernels "
             f"and captured {out['serve_phase_captures']} graphs")
    if out["kernel_launches"].get("sliced_matmul", 0) <= 0:
        fail("sliced_matmul never launched while serving in switch mode")
    return {k: parity_launches.get(k, 0) + serve_launches.get(k, 0)
            for k in set(parity_launches) | set(serve_launches)}


# the compiled executor's configs: (config, repeat units on the card, slice
# modes) -- the main path in both modes, the SSM family at full depth and
# mixtral at phase 9's cut
GRAPH_CONFIGS = (("qwen2-1.5b", None, ("mask", "switch")),
                 ("zamba2-2.7b", None, ("mask",)),
                 ("xlstm-125m", None, ("mask",)),
                 ("mixtral-8x7b", 16, ("mask",)))
# greedy decode steps of every subnet, graph against eager
GRAPH_DECODE_STEPS = 4


def phase_graphs(torch, card, names=()):
    """Phase 5b: the compiled executor (one CUDA graph per warmed entry and
    depth pattern) against the eager one (``use_graphs=False``) over one
    parameter tree, for each config of GRAPH_CONFIGS, or those of them
    ``names`` names (:func:`graph_run`). Returns the kernel launches of
    each run."""
    launches = []
    for name, units, modes in GRAPH_CONFIGS:
        if not names or name in names:
            launches += graph_run(torch, card, name, units, modes)
    return launches


def graph_run(torch, card, name: str, units, modes):
    """One config at its published widths: for each slice mode, a graph
    executor and an eager one over the same weights, each warmed at
    batches 1 and 8, seq 16, prefill and decode. Every Pareto subnet's
    prefill logits (B = 8, S = 16) and GRAPH_DECODE_STEPS greedy decode
    steps, graph against eager (max |diff| within 2e-2 of max |logit|, the
    bitwise count reported), then a pass over every subnet and bucket: no
    build and no capture after warmup, and no entry built. The warmup
    captures one graph per entry and depth pattern; its seconds and pool
    bytes. Then the widest subnet's prefill and decode step through
    graphs (:func:`trace_steps`): host wall, device ms, idle share, device
    kernels, and launches, which must equal the eager step's (a replay
    counts the launches its capture recorded); the eager steps are traced
    by phases 6, 9 and 10. Returns the launches of each mode."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.executor import (ExecutorConfig, SubnetExecutor,
                                              cut_units)
    cfg = cut_units(get_config(name), units)
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(11),
                           "cuda")
    kinds = {k for st in cfg.stages for k in st.pattern}
    attn = "attn" in kinds or bool(cfg.shared_attn_period)
    B, S = 8, 16
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = []
    for mode in modes:
        exs, warm = {}, {}
        for graphs in (False, True):
            ex = SubnetExecutor(params, cfg, exec_cfg=ExecutorConfig(
                slice_mode=mode, use_graphs=graphs))
            warm[graphs] = ex.warmup(batches=(1, B), seqs=(S,), decode=True)
            exs[graphs] = ex
        eager, graph = exs[False], exs[True]
        n = graph.n_subnets
        n_patterns = len(graph.patterns)
        if warm[True]["graph_captures"] != 4 * n_patterns \
                or warm[False]["graph_captures"] != 0:
            fail(f"graphs {name} {mode}: warmup captured "
                 f"{warm[True]['graph_captures']} graphs (eager "
                 f"{warm[False]['graph_captures']}), not 4 entries x "
                 f"{n_patterns} depth patterns")
        compiles = graph.counters()["compiles"]
        compat.reset_launch_counts()
        prefill_err, decode_err, bitwise, total = [], [], 0, 0
        with compat.BuildCounter() as bc, compat.CaptureCounter() as cc:
            for idx in range(n):
                want, got = eager.prefill(idx, toks), graph.prefill(idx, toks)
                prefill_err.append(rel_err(got, want,
                                           f"graphs {name} prefill {idx}"))
                bitwise += int(np.array_equal(got, want))
                total += 1
                ce, cg = eager.init_cache(B, S), graph.init_cache(B, S)
                tok = toks[:, :1]
                for i in range(GRAPH_DECODE_STEPS):
                    want, ce = eager.decode_step(idx, tok, ce, i)
                    got, cg = graph.decode_step(idx, tok, cg, i)
                    decode_err.append(rel_err(
                        got, want, f"graphs {name} decode {idx} step {i}"))
                    bitwise += int(np.array_equal(got, want))
                    total += 1
                    tok = want.argmax(-1).astype(np.int32)[:, None]
                # the batch-1 buckets
                graph.prefill(idx, toks[:1])
                graph.decode_step(idx, toks[:1, :1], graph.init_cache(1, S), 0)
        launches = compat.launch_counts()
        if bc.count or cc.count or graph.counters()["compiles"] != compiles:
            fail(f"graphs {name} {mode}: {bc.count} builds, {cc.count} "
                 f"captures, {graph.counters()['compiles'] - compiles} "
                 f"entries built after warmup")
        need = ["subnet_rmsnorm"] + (["flash_attention", "decode_attention"]
                                     if attn else [])
        if mode == "switch":
            need.append("sliced_matmul")
        for kernel in need:
            if launches.get(kernel, 0) <= 0:
                fail(f"graphs {name} {mode}: {kernel} never launched")
        caches = {g: ex.init_cache(B, S) for g, ex in exs.items()}
        idx = n - 1

        def steps(g):
            ex, c = exs[g], caches[g]
            return {"prefill": lambda: ex.prefill(idx, toks),
                    "decode": lambda: ex.decode_step(idx, toks[:, :1], c, 3)}

        # the eager steps are traced by phases 6, 9 and 10
        rows = {f"{kind}_graph": row for kind, row in trace_steps(
            torch, steps(True), n=CONFIG_TRACE_STEPS).items()}
        for kind, step in steps(False).items():
            compat.reset_launch_counts()
            step()
            if rows[f"{kind}_graph"]["launches"] != compat.launch_counts():
                fail(f"graphs {name} {mode} {kind}: a replay counts "
                     f"{rows[f'{kind}_graph']['launches']}, the eager step "
                     f"launches {compat.launch_counts()}")
        # the device's own time of the step: its graph replayed back to
        # back under CUDA events, no profiler; and a decode step's copies
        # of the caller's cache into the graph's and back
        key = graph.ctrls[idx]["layer_gate"].tobytes()
        for kind in ("prefill", "decode"):
            row = rows[f"{kind}_graph"]
            row["replay_ms"] = time_ms(
                torch, graph._get(kind, B, S).replays[key], iters=20)
            row["replay_idle_share"] = 1 - row["replay_ms"] / row["wall_ms"]
        mine = list(_leaves(graph._get("decode", B, S).state))
        theirs = list(_leaves(caches[True].state))
        rows["decode_graph"]["cache_bytes"] = sum(
            t.numel() * t.element_size() for t in theirs)
        rows["decode_graph"]["cache_copy_ms"] = (
            time_ms(torch, lambda: torch._foreach_copy_(mine, theirs),
                    iters=20)
            + time_ms(torch, lambda: torch._foreach_copy_(theirs, mine),
                      iters=20))
        gc_ = graph.counters()
        say("graphs", arch=name, units=sum(st.repeat for st in cfg.stages),
            mode=mode, subnets=n, depth_patterns=n_patterns, batch=B, seq=S,
            decode_steps=GRAPH_DECODE_STEPS,
            max_rel_err_prefill=max(prefill_err),
            max_rel_err_decode=max(decode_err), bitwise_equal=bitwise,
            compared=total, tol="2e-2 of max|eager logit|",
            captures_at_warmup=warm[True]["graph_captures"],
            warmup_seconds={"graph": warm[True]["seconds"],
                            "eager": warm[False]["seconds"]},
            capture_seconds=gc_["capture_seconds"],
            graph_pool_bytes=gc_["graph_pool_bytes"],
            builds_after_warmup=bc.count, captures_after_warmup=cc.count,
            launches=launches, card=card.name, steps=rows)
        out.append(launches)
        del exs, eager, graph, caches
        _free(torch)
    del params
    _free(torch)
    return out


def phase_trace(torch, symbols=PORT_KERNEL_SYMBOLS):
    """Where a warmed full-width prefill (B=8, S=16, largest subnet), a
    decode step, and a switch-mode prefill of the widest and the narrowest
    full-depth subnet spend their time: host wall clock (median of 3,
    taken in rounds over the four) against device kernel time from
    torch.profiler, and the kernel launches of each; the device ms and
    launches of each kernel whose name holds one of ``symbols``
    (:func:`trace_steps`). Eager steps (``use_graphs=False``): phase 5b
    traces the graph path beside them."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import build_executor
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import ParetoPoint
    from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
    cfg = get_config("qwen2-1.5b")
    ex = build_executor(cfg, seed=0, device="cuda",
                        exec_cfg=ExecutorConfig(use_graphs=False))
    ex.warmup(batches=(8,), seqs=(16,), decode=True)
    # switch mode over the same weights: the widest subnet and the
    # narrowest at full depth (FFN 0.5, heads 0.5)
    narrow = next(s for s in sn.enumerate_space(cfg)
                  if (s.depth_frac, s.ffn_frac, s.head_frac) == (1.0, 0.5, 0.5))
    sw = SubnetExecutor(ex.params, cfg,
                        points=[ParetoPoint(sub, 0.0, 0.0, 0.0)
                                for sub in (sn.max_subnet(cfg), narrow)],
                        exec_cfg=ExecutorConfig(slice_mode="switch",
                                                use_graphs=False))
    sw.warmup(batches=(8,), seqs=(16,))
    toks, idx = np.ones((8, 16), np.int32), ex.n_subnets - 1
    cache = ex.init_cache(8, 16)
    report = trace_steps(torch, {
        "prefill": lambda: ex.prefill(idx, toks),
        "decode": lambda: ex.decode_step(idx, toks[:, :1], cache, 3),
        "switch_prefill_widest": lambda: sw.prefill(0, toks),
        "switch_prefill_narrowest": lambda: sw.prefill(1, toks)}, symbols,
        n=3)
    # the flash kernel's device ms in the switch prefills: the narrowest
    # computes half the heads of the widest
    flash = {kind: report[kind]["port_kernels_ms"].get(
                 "flash_fwd_kernel", [0.0, 0])[0]
             for kind in ("switch_prefill_widest", "switch_prefill_narrowest")}
    say("trace", batch=8, seq=16, subnet=idx,
        switch_subnets=[sw.points[0].sub.key(), narrow.key()],
        flash_ms_switch_widest=flash["switch_prefill_widest"],
        flash_ms_switch_narrowest=flash["switch_prefill_narrowest"],
        flash_narrowest_over_widest=(
            flash["switch_prefill_narrowest"] / flash["switch_prefill_widest"]
            if flash["switch_prefill_widest"] else "not measured"),
        **report)


def trace_steps(torch, steps, symbols=PORT_KERNEL_SYMBOLS, n: int = 10):
    """Each warmed step of ``steps`` (kind -> fn): its launches, host wall
    clock (median of ``n``, taken in rounds over the kinds, so a drift of
    the shared host does not favour the kind measured first), device
    kernel time from torch.profiler over ``n`` more (a trace that kept
    every event, :func:`trace_intact`, else "not measured"), the device's
    idle share, device kernels and ``aten::add`` calls a step, the top
    kernels,
    and the device ms and launches of each kernel whose name holds one of
    ``symbols``."""
    import numpy as np
    from repro_torch import compat
    launches, walls = {}, {kind: [] for kind in steps}
    for kind, step in steps.items():
        for _ in range(3):
            step()
        compat.reset_launch_counts()
        step()
        launches[kind] = compat.launch_counts()
    # host wall in rounds over the step kinds, so a drift of the shared
    # host does not favour the kind measured first
    for _ in range(n):
        for kind, step in steps.items():
            t0 = time.perf_counter()
            step()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    report = {}
    for kind, step in steps.items():
        wall_ms = float(np.median(walls[kind]))
        for _ in range(TRACE_TRIES):  # a trace that lost events: again
            one, _ = kernel_trace(torch, step, 1)
            per_kernel, adds = {}, 0
            for ev in profiled(torch, step, n):
                adds += ev.name == "aten::add"
                if on_device(torch, ev):
                    us = getattr(ev, "self_device_time_total", None)
                    if us is None:
                        us = ev.self_cuda_time_total
                    tot, cnt = per_kernel.get(ev.name, (0.0, 0))
                    per_kernel[ev.name] = (tot + us, cnt + 1)
            counts = {k: c for k, (_, c) in per_kernel.items()}
            intact = trace_intact(one, counts, n)
            if intact:
                break
        dev_ms = (sum(t for t, _ in per_kernel.values()) / n / 1e3
                  if intact else 0.0)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        port = {}
        for name, (us, cnt) in per_kernel.items():
            for tag in symbols:
                if tag in name:
                    ms, c = port.get(tag, (0.0, 0))
                    port[tag] = (ms + us / n / 1e3, c + cnt // n)
        report[kind] = dict(
            wall_ms=wall_ms,
            lost_events=[] if intact else lost_events(one, counts, n),
            device_ms=dev_ms if dev_ms > 0 else "not measured",
            device_idle_share=(1 - dev_ms / wall_ms) if dev_ms > 0
            else "not measured",
            device_kernels=sum(c for _, c in per_kernel.values()) / n,
            aten_adds=adds / n,
            launches=launches[kind],
            port_kernels_ms={k: [ms, c] for k, (ms, c) in port.items()},
            top=[[name[:60], t / n / 1e3, c // n] for name, (t, c) in top])
    return report


def depth_cut(torch, name: str, seed: int, units: int = 2):
    """The full-width ``name`` cut to ``units`` repeat units of its pattern:
    (cfg, bf16 parameters on the card from a seeded generator, the fp32
    config, the same parameters in fp32 on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.models import lm
    cfg = get_config(name)
    cfg = cfg.replace(stages=(Stage(cfg.stages[0].pattern, repeat=units),))
    gpu = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    return cfg, gpu, cfg.replace(dtype="float32"), to_cpu(gpu, torch.float32)


def to_cpu(tree, dtype=None):
    """A parameter tree's leaves on the CPU, cast to ``dtype`` if given."""
    if isinstance(tree, dict):
        return {k: to_cpu(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v, dtype) for v in tree]
    return tree.cpu() if dtype is None else tree.to(dtype).cpu()


def reference_check(torch, cut, tag: str = "reference",
                    blockwise: bool = False):
    """Kernels (bf16, card) against the plain path (fp32, CPU) on a
    ``cut`` of a few units (:func:`depth_cut`): prefill logits (B=2, S=16;
    from :func:`embed_batch` for an embed-frontend config) and 4 decode
    steps, for the first and the last Pareto subnet, in mask
    and in switch mode, within 2e-2 of max |logit|. With ``blockwise``
    (the SSM family: its random-weight blocks amplify bf16 rounding, so
    that the plain path's own bf16 walk strays past 2e-2 of the fp32 walk
    at one unit; PERF.md) every block of the card's walks is held to the
    plain fp32 block on its own inputs instead (:class:`BlockReference`),
    and the logits are reported beside the plain path's own bf16 walk on
    the CPU. A MoE block of the CPU walk routes as the card's walk did
    (:class:`Routes`), and the tokens whose own top-k differs are held to
    :func:`route_flips`. Returns the worst relative error of each mode,
    the worst of the CPU's bf16 walk and the blocks (``blockwise``) and
    the routing flips."""
    import contextlib
    import numpy as np
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import pareto_subnets
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, gpu, cfg32, cpu = cut
    cpu16 = to_cpu(gpu) if blockwise else None
    blocks = BlockReference(tag) if blockwise else None
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    # an embed-frontend config prefills from embeds (decode takes tokens)
    batch = (embed_batch(torch, cfg, 2, 16, seed=3)
             if cfg.frontend == "embed" else {"tokens": toks})
    pts = pareto_subnets(cfg)
    worst = {"mask": 0.0, "switch": 0.0}
    floor = {"mask": 0.0, "switch": 0.0}
    flips = []

    def both(on_card, on_cpu):
        """The card's walk, then the CPU's routed as the card's was."""
        with Routes() as rec, (blocks or contextlib.nullcontext()):
            got = on_card()
        with Routes(replay=rec.calls) as rep:
            want = on_cpu()
        flips.extend(rep.flips)
        return got, want

    def check(got, want, want16, mode, what):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / scale
        worst[mode] = max(worst[mode], err)
        if want16 is None:
            if not torch.allclose(got, want, atol=2e-2 * scale, rtol=2e-2):
                fail(f"{tag} {mode}: {what} off by {err} (relative)")
            return
        err16 = (want16.float() - want).abs().max().item() / scale
        floor[mode] = max(floor[mode], err16)

    with torch.no_grad():
        for mode, p in itertools.product(worst, (pts[0], pts[-1])):
            ctrl = sn.make_control(cfg, p.sub)
            got, want = both(
                lambda: lm.forward(gpu, cfg, batch, ctrl,
                                   slice_mode=mode).float().cpu(),
                lambda: lm.forward(cpu, cfg32, batch, ctrl,
                                   slice_mode=mode))
            want16 = None if cpu16 is None else lm.forward(
                cpu16, cfg, batch, ctrl, slice_mode=mode)
            check(got, want, want16, mode, "prefill logits")
            cg = lm.init_cache(cfg, 2, 16, device="cuda")
            cc = lm.init_cache(cfg32, 2, 16, device="cpu")
            c16 = None if cpu16 is None else lm.init_cache(cfg, 2, 16,
                                                           device="cpu")
            for i in range(4):
                tk = toks[:, i:i + 1]
                (lg, cg), (lc, cc) = both(
                    lambda: lm.decode_step(gpu, cfg, tk, ctrl, cg, i,
                                           slice_mode=mode),
                    lambda: lm.decode_step(cpu, cfg32, tk, ctrl, cc, i,
                                           slice_mode=mode))
                l16 = None
                if cpu16 is not None:
                    l16, c16 = lm.decode_step(cpu16, cfg, tk, ctrl, c16, i,
                                              slice_mode=mode)
                check(lg.float().cpu(), lc, l16, mode, f"decode step {i}")
    if blocks is None:
        return dict(worst, routing=flip_summary(flips))
    return dict(worst, routing=flip_summary(flips), bf16_floor=floor,
                blocks=blocks.blocks, blocks_worst=blocks.worst_by_kind,
                blocks_bf16=blocks.bf16_by_kind)


def phase_reference(torch):
    """Full width, 2 layers: kernels (bf16, card) vs plain (fp32, CPU), in
    mask and in switch mode."""
    from repro_torch.core.pareto import pareto_subnets
    cut = depth_cut(torch, "qwen2-1.5b", seed=2)
    worst = reference_check(torch, cut)
    cfg = cut[0]
    say("reference", layers=2, d_model=cfg.d_model, vocab=cfg.vocab_size,
        subnets=[0, len(pareto_subnets(cfg)) - 1], max_rel_err=worst["mask"],
        switch_max_rel_err=worst["switch"], tol="2e-2 of max|ref|")


# --------------------------------------------------------------------------
# phase 8: the other dense configurations; phase 9: the MoE family
# --------------------------------------------------------------------------

CONFIGS = ("stablelm-3b", "h2o-danube-3-4b", "qwen2.5-14b")
# (config, repeat units on the card): mixtral's 32 layers hold 93 GB of
# bf16 weights, 16 hold 47; one of llama4's 24 units (attn, moe, attn,
# mlp) holds 37 GB, 32 of them its 128 experts
MOE_CONFIGS = (("mixtral-8x7b", 16), ("llama4-maverick-400b-a17b", 1))
# (config, units of its reference cut): zamba2's shared block runs after
# every 6th unit, so its cut keeps 6 units (one invocation at full depth);
# one xlstm unit is mLSTM x 3 + sLSTM
SSM_CONFIGS = (("zamba2-2.7b", 6), ("xlstm-125m", 1))


def rel_err(got, want, what, tol: float = 2e-2) -> float:
    """max |got - want| over max |want| of two numpy logit arrays; fails
    past ``tol`` or on a shape mismatch or a non-finite value."""
    import numpy as np
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{what}: bad logits {got.shape}")
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    if err > tol:
        fail(f"{what}: off by {err} of max|logit|")
    return err


def phase_configs(torch, card):
    """Phase 8: each of CONFIGS in turn at full width and depth, random
    weights from a seeded generator, each model freed before the next.
    Returns the kernel launches of each driven path."""
    launches = []
    for name in CONFIGS:
        t0 = time.perf_counter()
        launches += config_run(torch, card, name)
        say("config-seconds", arch=name, seconds=time.perf_counter() - t0)
    return launches


def phase_moe(torch, card):
    """Phase 9: each of MOE_CONFIGS at its published widths and the depth
    that fits the card, as phase 8 runs a dense config; mixtral's 2-layer
    reference on the CPU (llama4's one unit would need 74 GB of fp32 on
    the host: the fp32 oracle stands in). Returns the kernel launches of
    each driven path."""
    launches = []
    for name, units in MOE_CONFIGS:
        t0 = time.perf_counter()
        launches += config_run(torch, card, name, units=units,
                               reference=name == "mixtral-8x7b")
        say("config-seconds", arch=name, seconds=time.perf_counter() - t0)
    return launches


def phase_ssm(torch, card):
    """Phase 10: zamba2-2.7b and xlstm-125m at their published widths and
    full depth, as phase 8 runs a dense config; each reference on a cut
    deep enough to hold every kind of block (``SSM_CONFIGS``). Returns the
    kernel launches of each driven path."""
    launches = []
    for name, cut in SSM_CONFIGS:
        t0 = time.perf_counter()
        launches += config_run(torch, card, name, cut_units=cut)
        say("config-seconds", arch=name, seconds=time.perf_counter() - t0)
    return launches


def stage_peak_gb(torch) -> float:
    """The most device memory tensors held since the last call (GB)."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return peak


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def config_run(torch, card, name: str, units=None, reference: bool = True,
               cut_units: int = 2):
    """(a) serve 32 queries with SlackFit in mask and in switch mode
    (``--units`` when given): every query answered, no build, flash (a
    config with attention), the norm (an RMSNorm config) and in switch mode
    ``sliced_matmul`` (a config with a block that slices; for a MoE config
    its grouped form too) launched; (b) switch against mask
    through the executor over the prefills (B=8, S=16) of every Pareto
    subnet and 8 greedy decode steps of the smallest and the largest,
    each held against the fp32 oracle (:func:`fp32_oracle`), which for a
    MoE config routes as the walk it checks did (:class:`Routes`, the
    tokens of its own other top-k held to :func:`route_flips`): the switch
    logits no further from it than the mask logits plus
    ``SWITCH_MARGIN`` per walk (for a MoE config: the walks whose routing
    equals the mask walk's, and the mean over every walk within
    ``MOE_MEAN_MARGIN``; for an SSM config the mean within
    ``SSM_MEAN_MARGIN``), or equal to the mask logits bit for bit where
    nothing slices; decode and ``sliced_matmul`` launched; then every
    block of the same mask walks against its switch twin
    (:class:`BlockShadow`), the number of blocks compared checked; (e)
    the trace of a warmed mask prefill and decode step at B=8, with a MoE
    layer's dispatch kernels, one layer of each recurrent kind alone
    (Mamba2, mLSTM, sLSTM) and the step's bytes bound; (c) with
    ``reference``, the reference of a ``cut_units`` cut in both modes (an
    SSM config's block by block); (d) for a dense config with a sliding
    window, a prefill past the window and decode
    steps that wrap the rolling cache against the plain path on the CPU.
    Returns the launches of the two serve runs and of the executor's walks
    in (b)."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import ParetoPoint
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
    cfg = serve.cut_units(get_config(name), units)
    rms = cfg.norm == "rmsnorm"
    moe = cfg.family == "moe"
    kinds = {k for stage in cfg.stages for k in stage.pattern}
    attn = "attn" in kinds or cfg.shared_attn_period > 0
    # a block that switch mode slices: attention (its wo), an MLP or MoE
    sliced = attn or bool(kinds & {"mlp", "moe"})
    # the SSM family: its random-weight walks amplify bf16 rounding far
    # past the dense configs' (PERF.md)
    ssm = bool(kinds & {"mamba", "mlstm", "slstm"})
    per_walk = not (moe or ssm)
    depth = ["--units", str(units)] if units else []
    secs, peak_gb = {}, {}
    torch.cuda.reset_peak_memory_stats()

    # (a) serve, mask mode and switch mode
    served, serve_launches = {}, []
    for mode in ("mask", "switch"):
        t0 = time.perf_counter()
        compat.reset_launch_counts()
        out = serve.run(["--execute", "real", "--arch", name, "--queries",
                         "32", "--seq-len", "16", "--slice-mode", mode]
                        + depth)
        serve_launches.append(compat.launch_counts())
        _free(torch)
        secs[f"serve_{mode}"] = time.perf_counter() - t0
        peak_gb[f"serve_{mode}"] = stage_peak_gb(torch)
        if out["size"] != "full" or out["slice_mode"] != mode \
                or out["units"] != sum(s.repeat for s in cfg.stages):
            fail(f"{name}: serve did not run the full-width model at "
                 f"{units} units in {mode} mode")
        if out["queries"] < 1 or out["served"] != out["queries"]:
            fail(f"{name} {mode}: served {out['served']} of "
                 f"{out['queries']} queries")
        if out["serve_phase_builds"] != 0 \
                or out["serve_phase_captures"] != 0:
            fail(f"{name} {mode}: serve phase built "
                 f"{out['serve_phase_builds']} kernels and captured "
                 f"{out['serve_phase_captures']} graphs")
        for kernel in (("flash_attention",) if attn else ()) \
                + (("subnet_rmsnorm",) if rms else ()) \
                + (("sliced_matmul",) if mode == "switch" and sliced
                   else ()) \
                + ((GROUPED,) if mode == "switch" and moe else ()):
            if out["kernel_launches"].get(kernel, 0) <= 0:
                fail(f"{name}: {kernel} never launched while serving in "
                     f"{mode} mode")
        served[mode] = out

    # (b) switch against mask through the executor over one parameter
    # tree, each against the fp32 oracle; then each block on its own
    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(4),
                           "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    # eager: the walks are instrumented (Routes, BlockShadow), and a graph
    # replay runs no Python of the model
    mask = SubnetExecutor(params, cfg,
                          exec_cfg=ExecutorConfig(use_graphs=False))
    switch = SubnetExecutor(params, cfg, exec_cfg=ExecutorConfig(
        slice_mode="switch", use_graphs=False))
    B, S, steps = 8, 16, 8
    ends = (0, mask.n_subnets - 1)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    # built before the walks, so that the routing records hold the walks'
    # dispatches only, not those of an entry's first run
    mask.warmup(batches=(B,), seqs=(S, 32), decode=True)
    switch.warmup(batches=(B,), seqs=(S, 32), decode=True)

    def walk(fn, *args):
        """fn's result and the routing of its MoE blocks."""
        with Routes() as rec:
            out = fn(*args)
        return out, rec.calls

    compat.reset_launch_counts()
    masked = [walk(mask.prefill, i, toks) for i in range(mask.n_subnets)]
    switched = [walk(switch.prefill, i, toks) for i in range(mask.n_subnets)]
    decoded = {}
    for i in ends:
        cs, cm = switch.init_cache(B, 32), mask.init_cache(B, 32)
        seq, got_m, got_s = [toks[:, :1]], [], []
        for j in range(steps):
            (got, cs), rs = walk(switch.decode_step, i, seq[-1], cs, j)
            (want, cm), rm = walk(mask.decode_step, i, seq[-1], cm, j)
            got_s.append((got, rs))
            got_m.append((want, rm))
            seq.append(want.argmax(-1).astype(np.int32)[:, None])
        decoded[i] = (np.concatenate(seq[:steps], 1), got_m, got_s)
    parity_launches = compat.launch_counts()
    for kernel in (("flash_attention", "decode_attention") if attn else ()) \
            + (("sliced_matmul",) if sliced else ()) \
            + (("subnet_rmsnorm",) if rms else ()) + ((GROUPED,) if moe else ()):
        if parity_launches.get(kernel, 0) <= 0:
            fail(f"{name}: {kernel} never launched in switch against mask")
    if not sliced:
        # nothing slices in switch mode, so both executors run the same
        # operations: the same bits
        pairs = [(sw, mk, f"prefill subnet {i}") for i, ((mk, _), (sw, _))
                 in enumerate(zip(masked, switched))]
        pairs += [(decoded[i][2][j][0], decoded[i][1][j][0],
                   f"decode {i} step {j}") for i in ends
                  for j in range(steps)]
        for sw, mk, what in pairs:
            if not np.array_equal(sw, mk):
                fail(f"{name}: switch {what} differs from mask, with "
                     f"nothing to slice")
    # which walks' MoE dispatches went exactly as their mask twins' (a
    # decode step's, with every step before it)
    alike = [same_routes(mr, sr) for (_, mr), (_, sr) in zip(masked,
                                                             switched)]
    for i in ends:
        flag = True
        for (_, rm), (_, rs) in zip(decoded[i][1], decoded[i][2]):
            flag = flag and same_routes(rm, rs)
            alike.append(flag)
    flips = []

    def oracle(tokens, ctrl, routes):
        return fp32_oracle(torch, params, cfg, tokens, ctrl, routes, flips)

    logits = {"switch_vs_mask": [], "mask_vs_fp32": [], "switch_vs_fp32": []}
    for i, ((mk, mr), (sw, sr)) in enumerate(zip(masked, switched)):
        ctrl = mask.ctrls[i]
        ref_m = oracle(toks, ctrl, mr)[:, -1]
        ref_s = oracle(toks, ctrl, sr)[:, -1] if moe else ref_m
        errs = {key: rel_err(a, b, f"{name} prefill subnet {i} {key}",
                             tol=float("inf"))
                for key, a, b in (("switch_vs_mask", sw, mk),
                                  ("mask_vs_fp32", mk, ref_m),
                                  ("switch_vs_fp32", sw, ref_s))}
        for key, e in errs.items():
            logits[key].append(e)
        if per_walk and not errs["switch_vs_fp32"] <= errs["mask_vs_fp32"] \
                + SWITCH_MARGIN:
            fail(f"{name}: switch prefill of subnet {i} is "
                 f"{errs['switch_vs_fp32']} of max|logit| off the fp32 "
                 f"oracle, mask {errs['mask_vs_fp32']}")
    decode_errs = {"switch_vs_mask": [], "mask_vs_fp32": [],
                   "switch_vs_fp32": []}
    for i in ends:
        seq, got_m, got_s = decoded[i]
        ref_m = oracle(seq, mask.ctrls[i],
                       decode_routes(torch, [r for _, r in got_m]))
        ref_s = oracle(seq, mask.ctrls[i],
                       decode_routes(torch, [r for _, r in got_s])) \
            if moe else ref_m
        for j in range(steps):
            errs = {key: rel_err(a, b, f"{name} decode {i} step {j} {key}",
                                 tol=float("inf"))
                    for key, a, b in (
                        ("switch_vs_mask", got_s[j][0], got_m[j][0]),
                        ("mask_vs_fp32", got_m[j][0], ref_m[:, j]),
                        ("switch_vs_fp32", got_s[j][0], ref_s[:, j]))}
            for key, e in errs.items():
                decode_errs[key].append(e)
            if per_walk and not errs["switch_vs_fp32"] \
                    <= errs["mask_vs_fp32"] + SWITCH_MARGIN:
                fail(f"{name}: switch decode {i} step {j} is "
                     f"{errs['switch_vs_fp32']} of max|logit| off the fp32 "
                     f"oracle, mask {errs['mask_vs_fp32']}")
    # a MoE walk at these widths strays from the oracle by bf16 noise
    # whose difference between the modes, walk by walk, has a std of about
    # 0.004 (PERF.md), and a token routed otherwise than in the mask walk
    # moves its logits further: the walks routed alike are held one by
    # one, and the mean over every walk to a few of its standard errors
    gaps = [a - b for d in (logits, decode_errs)
            for a, b in zip(d["switch_vs_fp32"], d["mask_vs_fp32"])]
    mean_gap = sum(gaps) / len(gaps)
    alike_gaps = [g for g, a in zip(gaps, alike) if a]
    if moe and not mean_gap <= MOE_MEAN_MARGIN:
        fail(f"{name}: the switch walks are {mean_gap} of max|logit| "
             f"further from the fp32 oracle than the mask walks, on "
             f"average over {len(gaps)}")
    if moe and not max(alike_gaps, default=0.0) <= SWITCH_MARGIN:
        fail(f"{name}: a switch walk routed as its mask walk is "
             f"{max(alike_gaps)} of max|logit| further from the fp32 "
             f"oracle than the mask walk")
    # an SSM walk strays 0.2-0.5 from the oracle at full depth, and two
    # walks that round one block differently part by up to 0.09: the mean
    # of the gaps is held (each block has its twin below)
    if ssm and not mean_gap <= SSM_MEAN_MARGIN:
        fail(f"{name}: the switch walks are {mean_gap} of max|logit| "
             f"further from the fp32 oracle than the mask walks, on "
             f"average over {len(gaps)}")
    seqs = {i: decoded[i][0] for i in ends}
    del masked, switched, decoded, ref_m, ref_s
    # the same mask walks again, each block against its switch twin; the
    # launches of this pass belong to no served path and are not counted
    with BlockShadow(name) as shadow:
        for i in range(mask.n_subnets):
            mask.prefill(i, toks)
        for i in ends:
            cm = mask.init_cache(B, 32)
            for j in range(steps):
                _, cm = mask.decode_step(i, seqs[i][:, j:j + 1], cm, j)
    want_blocks = shadow_blocks(cfg, mask.ctrls, ends, steps)
    n_sub = mask.n_subnets
    if shadow.blocks != want_blocks:
        fail(f"{name}: {shadow.blocks} blocks compared to their switch twins, "
             f"not {want_blocks}")
    secs["switch"] = time.perf_counter() - t0
    peak_gb["switch"] = stage_peak_gb(torch)
    t0 = time.perf_counter()
    mask.warmup(batches=(8,), seqs=(16,), decode=True)
    idx, tt = mask.n_subnets - 1, np.ones((8, 16), np.int32)
    cache = mask.init_cache(8, 16)
    trace = trace_steps(torch, {
        "prefill": lambda: mask.prefill(idx, tt),
        "decode": lambda: mask.decode_step(idx, tt[:, :1], cache, 3)},
        n=CONFIG_TRACE_STEPS)
    # the bytes bound of a step of the largest subnet: every weight of the
    # walk and the head read once (mask mode reads every expert), the
    # embedding's rows and the activations left out
    step_bytes = lm.param_bytes(cfg) - cfg.vocab_size * cfg.d_model * 2
    for kind in trace:
        trace[kind]["bytes_bound_ms"] = step_bytes / card.bw * 1e3
    trace.update(layer_trace(torch, params, cfg, mask.ctrls[idx], kinds))
    if moe:
        trace["moe_dispatch"] = dispatch_trace(torch, mask, idx, tt)
        # switch mode over the same weights: the widest subnet and the one
        # at full depth and heads with half the FFN width, whose grouped
        # products read half the expert bytes
        k = max(cfg.elastic.topk_options or (cfg.top_k,))
        half = next(sub for sub in sn.enumerate_space(cfg)
                    if sub.key() == (1.0, 0.5, 1.0, k))
        sw = SubnetExecutor(params, cfg,
                            points=[ParetoPoint(sub, 0.0, 0.0, 0.0)
                                    for sub in (sn.max_subnet(cfg), half)],
                            exec_cfg=ExecutorConfig(slice_mode="switch",
                                                    use_graphs=False))
        sw.warmup(batches=(8,), seqs=(16,))
        trace.update(trace_steps(torch, {
            "switch_prefill_widest": lambda: sw.prefill(0, tt),
            "switch_prefill_half_ffn": lambda: sw.prefill(1, tt)},
            n=CONFIG_TRACE_STEPS))
        del sw
    secs["trace"] = time.perf_counter() - t0
    peak_gb["trace"] = stage_peak_gb(torch)
    del mask, switch, params, cache, cm
    _free(torch)

    # (c) the 2-layer reference, and (d) the window past its end
    worst, window = {}, None
    if reference:
        t0 = time.perf_counter()
        cut = depth_cut(torch, name, seed=2, units=cut_units)
        worst = reference_check(torch, cut, tag=f"{name} reference",
                                blockwise=ssm)
        secs["reference"] = time.perf_counter() - t0
        peak_gb["reference"] = stage_peak_gb(torch)
        if cfg.sliding_window and not moe:
            t0 = time.perf_counter()
            window = window_check(torch, cut)
            secs["window"] = time.perf_counter() - t0
        del cut
        _free(torch)
    serve_keys = ("queries", "served", "slo_attainment", "p50_latency_ms",
                  "p99_latency_ms", "rate_qps", "slo_ms", "lat_fast_ms",
                  "lat_slow_ms", "init_seconds", "serve_phase_builds",
                  "serve_phase_captures", "kernel_launches")
    say("config", arch=name, layers=sum(s.repeat for s in cfg.stages),
        units=units, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        norm=cfg.norm, window=cfg.sliding_window, parameters=n_params,
        experts=[cfg.n_experts, cfg.top_k, cfg.resolved_moe_d_ff] if moe
        else None,
        kinds=sorted(kinds), shared_attn_period=cfg.shared_attn_period,
        peak_device_gb=peak_gb,
        left_allocated_gb=torch.cuda.memory_allocated() / 1e9,
        serve={mode: {k: out[k] for k in serve_keys}
               for mode, out in served.items()},
        subnets=n_sub, switch_margin=SWITCH_MARGIN,
        prefill_logits_rel_errs=logits,
        prefill_logits_max_rel_err={k: max(v) for k, v in logits.items()},
        decode_logits_rel_errs=decode_errs,
        decode_logits_max_rel_err={k: max(v) for k, v in decode_errs.items()},
        switch_minus_mask_vs_fp32=dict(
            mean=mean_gap, max=max(gaps), min=min(gaps), walks=len(gaps),
            mean_bound=(MOE_MEAN_MARGIN if moe else SSM_MEAN_MARGIN if ssm
                        else None),
            routed_alike=dict(walks=len(alike_gaps),
                              max=max(alike_gaps, default=None))),
        oracle_routing=flip_summary(flips) if moe else None,
        blocks_compared=shadow.blocks,
        switch_block_max_rel_err=shadow.worst,
        switch_block_max_rel_err_by_kind=shadow.worst_by_kind,
        block_tol="2e-2 of max|block output|",
        parity_launches=parity_launches,
        reference_units=cut_units if reference else None,
        reference_max_rel_err=worst.get("mask"),
        reference_switch_max_rel_err=worst.get("switch"),
        reference_routing=worst.get("routing") if moe else None,
        reference_cpu_bf16_max_rel_err=worst.get("bf16_floor"),
        reference_blocks=worst.get("blocks"),
        reference_block_max_rel_err_by_kind=worst.get("blocks_worst"),
        reference_block_cpu_bf16_max_rel_err_by_kind=worst.get("blocks_bf16"),
        window_check=window, seconds=secs, trace=trace)
    return serve_launches + [parity_launches]


# how much further from the fp32 oracle the switch logits of a full-depth
# walk may be than the mask logits of the same walk, in max|logit|: the
# two modes round differently in bf16 and both stray about 0.02 from the
# oracle at depth 24-48, but within 0.003 of each other's distance to it
SWITCH_MARGIN = 0.005
# the bound on the mean of that difference over every walk of a MoE
# config: about three standard errors of its walk-to-walk spread (0.004
# over 40 walks)
MOE_MEAN_MARGIN = 0.002
# the same for an SSM config, where nothing routes: about three standard
# errors of zamba2's walk-to-walk spread (0.011 over 22 walks)
SSM_MEAN_MARGIN = 0.007
# steps a trace of phases 5b, 8-10 and 14 times and profiles (phase 6: 3);
# each profiled step of a 54-unit model holds about 4,000 device kernels
CONFIG_TRACE_STEPS = 2
# the grouped sliced_matmul's launch count (kernels/sliced_matmul.py)
GROUPED = "sliced_matmul.experts"


def shadow_blocks(cfg, ctrls, ends, steps: int) -> int:
    """The blocks that :class:`BlockShadow` compares over the mask-mode
    prefill of every control in ``ctrls`` and ``steps`` decode steps of
    the subnets ``ends``: every live attention, MLP and MoE block of a
    prefill, every live MLP and MoE block of a decode step, and the
    attention and MLP of each invocation of zamba2's shared block (its MLP
    in decode). The recurrent kinds have no switch branch to compare."""
    import numpy as np
    period = cfg.shared_attn_period
    shared_mlp = int(bool(period and cfg.d_ff))

    def live(ctrl, kinds, shared):
        gates, offset, n = np.asarray(ctrl["layer_gate"], bool), 0, 0
        for stage in cfg.stages:
            per = sum(k in kinds for k in stage.pattern)
            on = gates[offset:offset + stage.repeat]
            n += per * int(on.sum())
            if period:
                n += shared * sum(int(on[r]) for r in range(stage.repeat)
                                  if r % period == period - 1)
            offset += stage.repeat
        return n

    return (sum(live(c, ("attn", "mlp", "moe"), 1 + shared_mlp)
                for c in ctrls)
            + steps * sum(live(ctrls[i], ("mlp", "moe"), shared_mlp)
                          for i in ends))


class BlockShadow:
    """While active, every attention, MLP and MoE block that a mask-mode
    walk runs also runs in switch mode on the same inputs (x, the pending
    delta, the weights and the control), and the worst max |switch - mask|
    over max |mask| of a block's output is kept; past ``tol`` it fails.
    Each block is compared on its own, so the bf16 rounding differences of
    the two modes do not compound over the depth (and a MoE block's twin
    routes its tokens as the block does: one norm, one fp32 router
    product). Decode has no switch branch in attention, so there the MLP
    and MoE blocks compare."""

    def __init__(self, name: str, tol: float = 2e-2):
        self.name, self.tol = name, tol
        self.worst, self.blocks, self.worst_by_kind = 0.0, 0, {}

    def __enter__(self):
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import ffn as ffn_mod
        from repro_torch.models import moe as moe_mod
        self._orig = attn, mlp, moe = (attn_mod.attention_block_pending,
                                       ffn_mod.mlp_block_pending,
                                       moe_mod.moe_block_pending)

        def attn_twin(p, cfg, x, delta, ctrl, positions, *,
                      slice_mode="mask", **kw):
            s, y = attn(p, cfg, x, delta, ctrl, positions,
                        slice_mode=slice_mode, **kw)
            if slice_mode == "mask":
                self._note(attn(p, cfg, x, delta,
                                attn_mod.with_wo_width(cfg, ctrl), positions,
                                slice_mode="switch", **kw)[1], y, "attention")
            return s, y

        def ffn_twin(block, kind):
            def twin(p, cfg, x, delta, ctrl, *, slice_mode="mask", **kw):
                s, y = block(p, cfg, x, delta, ctrl, slice_mode=slice_mode,
                             **kw)
                if slice_mode == "mask":
                    self._note(block(p, cfg, x, delta, ctrl,
                                     slice_mode="switch", **kw)[1], y, kind)
                return s, y
            return twin

        attn_mod.attention_block_pending = attn_twin
        ffn_mod.mlp_block_pending = ffn_twin(mlp, "mlp")
        moe_mod.moe_block_pending = ffn_twin(moe, "moe")
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import ffn as ffn_mod
        from repro_torch.models import moe as moe_mod
        (attn_mod.attention_block_pending, ffn_mod.mlp_block_pending,
         moe_mod.moe_block_pending) = self._orig
        return False

    def _note(self, got, want, kind):
        want = want.float()
        err = ((got.float() - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        self.blocks += 1
        self.worst = max(self.worst, err)
        self.worst_by_kind[kind] = max(self.worst_by_kind.get(kind, 0.0), err)
        if not err <= self.tol:
            fail(f"{self.name}: switch {kind} block {self.blocks} off its "
                 f"mask twin by {err} of max|output|")


class BlockReference:
    """While active, every block that a walk runs on the card (attention,
    MLP, Mamba2, mLSTM and sLSTM, prefill and decode, zamba2's shared block
    included) also runs as the plain path on the CPU on the same inputs
    (the card's x, pending delta and decode cache, the layer's weights):
    once in fp32, all upcast, and once in the card's bf16. Each of the
    block's outputs (the residual ``s``, the output ``y``, every leaf of
    the cache it updated) may be no further from the fp32 block than the
    CPU's bf16 block is, plus ``tol``, both in max |fp32|. A block is
    compared on its own, so the walk's amplification of bf16 rounding does
    not enter; the bf16 block stands for what bf16 alone costs a block
    whose contractions cancel (a Mamba2 decode step's ``C . state``). The
    walk's code is untouched: the block functions are wrapped where the
    backbone looks them up."""

    BLOCKS = (("attention", "attention_block_pending"),
              ("attention", "attention_decode_pending"),
              ("ffn", "mlp_block_pending"),
              ("ssm", "mamba_block_pending"),
              ("ssm", "mamba_decode_pending"),
              ("xlstm", "mlstm_block_pending"),
              ("xlstm", "mlstm_decode_pending"),
              ("xlstm", "slstm_block_pending"),
              ("xlstm", "slstm_decode_pending"))

    def __init__(self, name: str, tol: float = 2e-2):
        self.name, self.tol = name, tol
        self.blocks, self.worst_by_kind, self.bf16_by_kind = 0, {}, {}
        self._weights = {}

    def __enter__(self):
        import importlib
        self._orig = []
        for mod_name, fn in self.BLOCKS:
            mod = importlib.import_module(f"repro_torch.models.{mod_name}")
            orig = getattr(mod, fn)
            self._orig.append((mod, fn, orig))
            setattr(mod, fn, self._wrap(orig, fn.replace("_pending", "")))
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self._orig:
            setattr(mod, fn, orig)
        return False

    def _cpu(self, t, upcast: bool, weights: bool = False):
        """``t`` (a tensor, or a dict or tuple of them) copied to the CPU,
        floating tensors in fp32 if ``upcast``; a layer's weights are
        copied once."""
        import torch
        if isinstance(t, dict):
            return {k: self._cpu(v, upcast, weights) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(self._cpu(v, upcast, weights) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        key = (t.data_ptr(), tuple(t.shape), t.dtype, upcast)
        if weights and key in self._weights:
            return self._weights[key]
        out = t.detach().cpu().clone()
        if upcast and out.is_floating_point():
            out = out.float()
        if weights:
            self._weights[key] = out
        return out

    def _wrap(self, block, kind):
        def run(p, cfg, x, delta, ctrl, *args, **kw):
            if x.device.type != "cuda":
                return block(p, cfg, x, delta, ctrl, *args, **kw)
            plain = {}
            for upcast in (True, False):
                plain[upcast] = [self._cpu(t, upcast)
                                 for t in (x, delta, ctrl, args)]
            s, y = block(p, cfg, x, delta, ctrl, *args, **kw)
            outs = {}
            for upcast, (xc, dc, cc, ac) in plain.items():
                outs[upcast] = block(
                    self._cpu(p, upcast, weights=True),
                    cfg.replace(dtype="float32") if upcast else cfg,
                    xc, dc, cc, *ac, **kw) + tuple(
                    a for a in ac if isinstance(a, dict))
            card = (s, y) + tuple(a for a in args if isinstance(a, dict))
            self.blocks += 1
            for got, want, b16 in zip(card, outs[True], outs[False]):
                if isinstance(got, dict):
                    trios = [(k, got[k], want[k], b16[k]) for k in want]
                else:
                    trios = [("out", got, want, b16)]
                for what, g, w, b in trios:
                    scale = w.abs().max().clamp_min(1e-30)
                    err = ((g.float().cpu() - w).abs().max() / scale).item()
                    floor = ((b.float() - w).abs().max() / scale).item()
                    self.worst_by_kind[kind] = max(
                        self.worst_by_kind.get(kind, 0.0), err)
                    self.bf16_by_kind[kind] = max(
                        self.bf16_by_kind.get(kind, 0.0), floor)
                    if not err <= floor + self.tol:
                        fail(f"{self.name}: {kind} block {self.blocks} "
                             f"({what}) off the plain fp32 block by {err} "
                             f"of max|fp32|, the plain bf16 block by "
                             f"{floor}")
            return s, y
        return run


class Routes:
    """While active, each MoE dispatch of a walk is recorded, in walk
    order: per token, its router input ``h``, its fp32 ``logits``, its
    expert ids ``eids`` and which of its slots the capacity ``keep`` (on
    the walk's device). Given ``replay``, the records of another walk of
    the same model and tokens, each dispatch routes with the recorded
    expert ids in place of its own top-k, and the tokens whose own live
    experts differ go through :func:`route_flips` (``flips``). The walk's
    code is untouched: the recorder wraps ``models.moe.dispatch``, and
    ``moe_block_pending`` for the router the bound needs."""

    def __init__(self, replay=None):
        self.calls, self.flips = [], []
        self._replay = None if replay is None else list(replay)
        self._router = None

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self._orig = dispatch, block = (moe_mod.dispatch,
                                        moe_mod.moe_block_pending)

        def block_noting_router(p, *args, **kw):
            self._router = p["router"]
            return block(p, *args, **kw)

        def recorded(h, logits, eids, topk, cfg, capacity):
            G, N, k = eids.shape
            if self._replay is not None:
                walk = self._replay.pop(0)
                self.flips.append(route_flips(
                    logits.reshape(G * N, -1), h.reshape(G * N, -1).float(),
                    self._router.float(), walk, int(topk)))
                eids = walk["eids"].to(eids.device).reshape(G, N, k)
            slots, meta = dispatch(h, logits, eids, topk, cfg, capacity)
            keep = meta["keep"].new_zeros(meta["keep"].shape).scatter_(
                1, meta["order"], meta["keep"])
            self.calls.append(dict(h=h.reshape(G * N, -1),
                                   logits=logits.reshape(G * N, -1),
                                   eids=eids.reshape(G * N, k),
                                   keep=keep.reshape(G * N, k)))
            return slots, meta

        moe_mod.dispatch = recorded
        moe_mod.moe_block_pending = block_noting_router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod
        moe_mod.dispatch, moe_mod.moe_block_pending = self._orig
        return False


def same_routes(a, b) -> bool:
    """Whether two walks' records (:class:`Routes`) sent every token of
    every MoE layer to the same experts and kept the same slots."""
    import torch
    return len(a) == len(b) and all(
        torch.equal(x["eids"], y["eids"]) and torch.equal(x["keep"], y["keep"])
        for x, y in zip(a, b))


def decode_routes(torch, steps):
    """The records of one walk's decode steps (a list per step, a record
    per MoE layer of B tokens) as one record per layer over the (B, steps)
    tokens in row order, the order of a forward over the sequence."""
    out = []
    for layer in zip(*steps):
        out.append({k: torch.stack([r[k] for r in layer], 1).reshape(
            -1, *layer[0][k].shape[1:]) for k in layer[0]})
    return out


def route_flips(logits, h, router, walk, k: int):
    """The tokens of one MoE layer whose top ``k`` experts under
    ``logits`` (this walk's fp32 router product of its router input ``h``)
    are not the live experts of another walk (``walk``, a record of
    :class:`Routes`), each with its margin, the k-th minus the (k+1)-th of
    its logits, and the bound of the flips the other walk's error in the
    router input explains: twice the largest change of a logit that
    ``walk["h"] - h`` makes through the router (plus 1e-5 of the largest
    sum_i |h_i router_ie| for the products' own fp32 rounding). A flip
    past the bound fails: the router input's error does not explain it
    (routing read from another token or layer, or not the top-k). Returns
    (margin, bound, router-input relative error) of each."""
    import torch
    E = logits.shape[-1]
    vals, own = torch.topk(logits, min(k + 1, E), dim=-1)
    eids = walk["eids"].to(logits.device)
    differ = (own[:, :k].sort(-1).values
              != eids[:, :k].sort(-1).values).any(-1)
    if not bool(differ.any()):
        return []
    margin = vals[:, k - 1] - vals[:, k]
    dh = walk["h"].to(h.device).float() - h
    bound = (2 * (dh @ router).abs().max(-1).values
             + 1e-5 * (h.abs() @ router.abs()).max(-1).values)
    rel_in = dh.norm(dim=-1) / h.norm(dim=-1)
    out = list(zip(margin[differ].tolist(), bound[differ].tolist(),
                   rel_in[differ].tolist()))
    for m, b, _ in out:
        if not m <= b:
            fail(f"a routing flip at margin {m}, past the {b} that the "
                 f"router input's error explains")
    return out


def flip_summary(flips):
    """Count, widest margin, least headroom (bound minus margin) and the
    largest router-input error of routing flips (lists of :func:`route_flips`
    triples, one list per MoE layer and walk)."""
    flat = [f for layer in flips for f in layer]
    return dict(layers_checked=len(flips), flips=len(flat),
                widest_margin=max((m for m, _, _ in flat), default=None),
                least_headroom=min((b - m for m, b, _ in flat), default=None),
                max_router_input_rel_err=max((e for _, _, e in flat),
                                             default=None))


def dispatch_trace(torch, ex, idx, toks):
    """A MoE layer's dispatch apart from its expert products, on the
    inputs of the first MoE layer of a warmed prefill: ``route``,
    ``dispatch`` and ``combine`` (the slots standing in for the expert
    outputs, the same shape), their device kernels and device ms."""
    from repro_torch.models import moe as moe_mod
    cfg = ex.cfg
    with Routes() as rec:
        ex.prefill(idx, toks)
    r = rec.calls[0]
    h, logits = r["h"][None], r["logits"][None]
    topk = ex.ctrls[idx]["topk"]
    cap = moe_mod._capacity(h.shape[1], cfg)

    def step():
        slots, meta = moe_mod.dispatch(h, logits, moe_mod.route(logits, cfg),
                                       topk, cfg, cap)
        return moe_mod.combine(slots, meta, h.shape[1])

    n = 10
    got = intact_trace(torch, step, n)
    return dict(tokens=h.shape[1], capacity=cap,
                device_kernels_per_layer=(sum(got[0].values()) / n if got
                                          else "not measured"),
                device_ms_per_layer=(got[1] / n / 1e3 if got
                                     else "not measured"))


def fp32_oracle(torch, params, cfg, toks, ctrl, routes=(), flips=None,
                embeds=None, positions=None):
    """The mask-mode logits of ``toks`` (or of ``embeds``, (B, S, d), read
    in the table's type as the walk reads them, at ``positions`` if given)
    at every position in fp32 on the card, with sinusoidal positions where
    the config has them: each layer's weights upcast as the walk reaches it (the bf16
    tree stays as it is), the plain attention, the norm kernel's fp32
    form, fp32 cuBLAS products with TF32 off; the Mamba2, mLSTM and sLSTM
    blocks (fp32 inside already) on the upcast weights, and zamba2's
    shared block after every live unit whose index in its stage ends a
    period. A MoE block routes as the records ``routes`` say (one per
    live MoE layer, in walk order; see :func:`oracle_moe`) and adds its
    routing flips to ``flips``. A numpy (B, S, vocab) array."""
    from repro_torch.core import operators as ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import lm
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xlstm_mod
    recurrent = {"mamba": ssm_mod.mamba_block_pending,
                 "mlstm": xlstm_mod.mlstm_block_pending,
                 "slstm": xlstm_mod.slstm_block_pending}

    def plain(q, k, v, **kw):
        return fa.flash_attention_plain(q, k, v, **kw)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32")
    dev = params["embed"].device
    ctrl = ops.device_control(ctrl, dev)
    routes = list(routes)
    period = cfg.shared_attn_period
    shared = {key: {k: v.float() for k, v in params["backbone"][key].items()}
              for key in ("shared_attn", "shared_mlp")
              if key in params["backbone"]}
    with torch.no_grad():
        if embeds is None:
            x = params["embed"][torch.as_tensor(toks, device=dev).long()]
        else:
            x = torch.as_tensor(embeds, device=dev).to(params["embed"].dtype)
        x = x.float()
        B, S = x.shape[:2]
        positions = (lm.default_positions(cfg, B, S, dev) if positions is None
                     else torch.as_tensor(positions, device=dev))
        if cfg.pos_embed == "sinusoidal":
            x = x + lm.sinusoid_pos(positions if positions.dim() == 2
                                    else positions[0], cfg.d_model,
                                    torch.float32)
        pair, offset = (x, None), 0
        for stage, sp in zip(cfg.stages, params["backbone"]["stages"]):
            for r in range(stage.repeat):
                if not ctrl["layer_gate"][offset + r]:
                    continue
                for j, kind in enumerate(stage.pattern):
                    slot = sp[f"{j}:{kind}"]
                    if kind == "moe":
                        pair = oracle_moe(torch, {k: v[r] for k, v in
                                                  slot.items()},
                                          cfg32, *pair, ctrl,
                                          routes.pop(0), flips)
                        continue
                    p = {k: v[r].float() for k, v in slot.items()}
                    if kind == "attn":
                        pair = attn_mod.attention_block_pending(
                            p, cfg32, *pair, ctrl, positions,
                            attn_impl=plain)
                    elif kind == "mlp":
                        pair = ffn_mod.mlp_block_pending(p, cfg32, *pair,
                                                         ctrl)
                    else:
                        pair = recurrent[kind](p, cfg32, *pair, ctrl)
                if period and r % period == period - 1:
                    pair = attn_mod.attention_block_pending(
                        shared["shared_attn"], cfg32, *pair, ctrl,
                        positions, attn_impl=plain)
                    if "shared_mlp" in shared:
                        pair = ffn_mod.mlp_block_pending(
                            shared["shared_mlp"], cfg32, *pair, ctrl)
            offset += stage.repeat
        if routes:
            fail(f"fp32 oracle: {len(routes)} MoE records left unused")
        x = pair[0] if pair[1] is None else pair[0] + pair[1]
        h = ops.subnet_norm(x.reshape(B * S, -1), params["final_gamma"],
                            ctrl["subnet_id"], eps=cfg.norm_eps,
                            kind=cfg.norm)
        w = params.get("head")
        w = params["embed"].T if w is None else w
        return (h @ w.float()).reshape(B, S, -1).cpu().numpy()


def oracle_moe(torch, p, cfg32, x, delta, ctrl, walk, flips):
    """A MoE block in fp32, mask mode, independent of ``models.moe``'s
    dispatch: the tokens go to the experts ``walk`` (a record of
    :class:`Routes`) gave them and keep the slots it kept, with gates from
    this walk's own fp32 logits; one expert at a time is upcast and runs
    the tokens it holds. The tokens whose own top-k differs go to
    :func:`route_flips`. Returns the pair (x + delta, output)."""
    import torch.nn.functional as F
    from repro_torch.core import operators as ops
    from repro_torch.models.common import pre_norm
    small = {k: v.float() for k, v in p.items()
             if k not in ("wg", "wu", "wd")}
    s, h = pre_norm(small, cfg32, x, delta, ctrl)
    B, S, d = h.shape
    hf = h.reshape(B * S, d)
    logits = hf @ small["router"]
    eids, keep = walk["eids"], walk["keep"]
    k_active, k = int(ctrl["topk"]), eids.shape[1]
    if flips is not None:
        flips.append(route_flips(logits, hf, small["router"], walk,
                                 k_active))
    gates = torch.softmax(torch.gather(logits, 1, eids), dim=-1)
    live = torch.arange(k, device=h.device) < k_active
    gates = torch.where(live, gates, 0.0)
    gates = torch.where(live, gates / gates.sum(-1, keepdim=True
                                                ).clamp_min(1e-9), 0.0)
    weight = gates * keep
    width = ctrl["moe_ffn_width"]
    y = torch.zeros_like(hf)
    for e in range(cfg32.n_experts):
        sel = (eids == e) & keep
        rows = sel.any(-1).nonzero().flatten()
        if rows.numel() == 0:
            continue
        wg, wu, wd = (p[n][e].float() for n in ("wg", "wu", "wd"))
        a = F.silu(hf[rows] @ wg) * (hf[rows] @ wu)
        a = ops.slice_mask(a, width)
        y[rows] += (a @ wd) * (weight * sel).sum(-1)[rows, None]
        del wg, wu, wd
    if cfg32.shared_expert:
        a = F.silu(hf @ small["swg"]) * (hf @ small["swu"])
        y = y + ops.slice_mask(a, width) @ small["swd"]
    return s, y.reshape(B, S, d)


def layer_trace(torch, params, cfg, ctrl, kinds):
    """One layer of each recurrent kind in ``kinds`` (Mamba2, mLSTM,
    sLSTM) alone, at B = 8, S = 16 on the residual stream of a random
    input, the first such layer's weights: :func:`trace_steps`' numbers
    for it, by kind (``<kind>_layer``). The sLSTM cell runs once a
    token, so its layer launches S times a cell's device kernels."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xlstm_mod
    blocks = {"mamba": ssm_mod.mamba_block_pending,
              "mlstm": xlstm_mod.mlstm_block_pending,
              "slstm": xlstm_mod.slstm_block_pending}
    steps = {}
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((8, 16, cfg.d_model), generator=gen, device="cuda"
                    ).to(params["embed"].dtype)
    for kind in sorted(set(kinds) & set(blocks)):
        j = cfg.stages[0].pattern.index(kind)
        p = {k: v[0] for k, v in
             params["backbone"]["stages"][0][f"{j}:{kind}"].items()}
        steps[f"{kind}_layer"] = (lambda block=blocks[kind], p=p:
                                  block(p, cfg, x, None, ctrl))
    if not steps:
        return {}
    with torch.no_grad():
        return trace_steps(torch, steps, n=CONFIG_TRACE_STEPS)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def window_check(torch, cut, steps: int = 4):
    """A 2-layer ``cut`` of a sliding-window config at B = 1: a prompt of
    the window plus 64 tokens, prefilled on the card in mask and in switch
    mode (flash past the window) against the plain fp32 forward on the CPU
    at every 64th position and the last 64; then the prompt and ``steps``
    more tokens teacher-forced through decode steps on the card (the
    rolling cache of window slots wraps at the window), the steps from the
    prompt's last position on against the CPU forward at the same
    positions. Within 2e-2 of max |logit|. Returns the worst errors."""
    import numpy as np
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.models import lm
    cfg, gpu, cfg32, cpu = cut
    W = cfg.sliding_window
    P = W + 64
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, P + steps)).astype(np.int32)
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    pos = sorted(set(range(0, P, 64)) | set(range(P - 64, P)))
    dec = list(range(P - 1, P + steps))
    with torch.no_grad():
        h = lm.hidden_states(cpu, cfg32, {"tokens": toks}, ctrl)
        want = lm.head_logits(cpu, cfg32, h[:, pos + dec], ctrl).numpy()
        del h
        worst = {}
        for mode in ("mask", "switch"):
            h = lm.hidden_states(gpu, cfg, {"tokens": toks[:, :P]}, ctrl,
                                 slice_mode=mode)
            got = lm.head_logits(gpu, cfg, h[:, pos], ctrl).float().cpu()
            worst[f"prefill_{mode}"] = rel_err(
                got.numpy(), want[:, :len(pos)],
                f"window prefill {mode} past {W}")
            del h
        dctrl = ops.device_control(ctrl, "cuda")
        cache = lm.init_cache(cfg, 1, P + steps, device="cuda")
        smax = cache["stages"][0]["0:attn"]["k"].shape[3]
        if smax != W:
            fail(f"window cache holds {smax} slots, not {W}")
        errs = []
        for i in range(P + steps):
            lg, cache = lm.decode_step(gpu, cfg, toks[:, i:i + 1], dctrl,
                                       cache, i)
            if i >= P - 1:
                errs.append(rel_err(lg[:, 0].float().cpu().numpy(),
                                    want[:, len(pos) + i - (P - 1)],
                                    f"window decode position {i}"))
        worst["decode"] = max(errs)
    return dict(window=W, prompt=P, decode_positions=[dec[0], dec[-1]],
                cache_slots=smax, prefill_positions=len(pos), **worst)


# --------------------------------------------------------------------------
# phase 11: the serving plane
# --------------------------------------------------------------------------

PLANE_QUERIES = 64
# queries of the runs through replica children, paced by the wire
WIRE_QUERIES = 32
PLANE_SEED = 7
PLANE_CHECKED = 4                  # child completions held to the executor


def plane_pacing(lat_fast_ms: float, lat_slow_ms: float, replicas: int = 1):
    """Rate (q/s) and SLO (ms) from phase 3's B = 1 latencies by the
    launcher's own rule: 0.25 / the smallest subnet's, 25x the
    largest's; the rate for ``replicas`` replicas of that speed."""
    return replicas * 0.25 / (lat_fast_ms / 1e3), lat_slow_ms * 25


# replica children of runs (c) and (d): the most (d) scales to
PLANE_CHILDREN = 2


def _plane_serve(torch, tag: str, argv, rate: float, slo_ms: float,
                 queries: int = PLANE_QUERIES):
    """``launch.serve.run`` at the phase's rate and SLO: every query
    served, nothing built, the rate and SLO echoed back, the ported
    kernels launched. Returns the report."""
    from repro_torch import compat
    from repro_torch.launch import serve
    compat.reset_launch_counts()
    out = serve.run(["--execute", "real", "--arch", "qwen2-1.5b",
                     "--queries", str(queries), "--seq-len", "16",
                     "--seed", str(PLANE_SEED), "--rate", repr(rate),
                     "--slo-ms", repr(slo_ms)] + argv)
    say(f"plane-{tag}", **{k: out.get(k) for k in (
        "queries", "served", "slo_attainment", "mean_acc",
        "p50_latency_ms", "p99_latency_ms", "rate_qps", "slo_ms",
        "replicas", "placement", "per_replica_served", "slice_mode",
        "serve_phase_builds", "serve_phase_captures", "kernel_launches",
        "init_seconds", "warmup")})
    if out["size"] != "full" or out["units"] != 28:
        fail(f"plane {tag}: did not serve full-width qwen2-1.5b")
    if out["queries"] != queries or out["served"] != queries:
        fail(f"plane {tag}: served {out['served']} of {out['queries']}")
    if out["serve_phase_builds"] != 0 \
            or out.get("serve_phase_captures", 0) != 0:
        fail(f"plane {tag}: built {out['serve_phase_builds']} kernels, "
             f"captured {out.get('serve_phase_captures')} graphs")
    if out["rate_qps"] != round(rate, 1) \
            or out["slo_ms"] != round(slo_ms, 3):
        fail(f"plane {tag}: rate/SLO {out['rate_qps']}/{out['slo_ms']} "
             f"do not echo {rate}/{slo_ms}")
    for name in ("subnet_rmsnorm", "flash_attention"):
        if out["kernel_launches"].get(name, 0) <= 0:
            fail(f"plane {tag}: {name} never launched")
    return out


def frame_costs(vocab: int, reps: int = 5):
    """Host ms to encode and to decode one completion frame carrying a
    (vocab,) fp32 logits row as JSON floats (the wire's format)."""
    import numpy as np
    from repro_torch.serving import ipc
    row = np.random.default_rng(0).standard_normal(vocab).astype(np.float32)
    frame = {"t": "completion", "qid": 0, "dropped": False,
             "timed_out": False, "acc": 80.0, "latency": 0.03}
    enc, dec, size = [], [], 0
    for i in range(reps):
        t0 = time.perf_counter()
        data = ipc.encode_frame({**frame, "pred": ipc.to_jsonable(row)}, i)
        enc.append((time.perf_counter() - t0) * 1e3)
        size = len(data)
        t0 = time.perf_counter()
        got = ipc.FrameDecoder(expect_seq=False).feed(data)
        dec.append((time.perf_counter() - t0) * 1e3)
    if np.asarray(got[0]["pred"], np.float32).tolist() != row.tolist():
        fail("a completion frame did not carry its logits bit for bit")
    return {"frame_bytes": size, "encode_ms": sorted(enc)[reps // 2],
            "decode_ms": sorted(dec)[reps // 2],
            "max_frame_bytes": ipc.MAX_FRAME}


def plane_children(torch, rate: float, slo_ms: float, wire):
    """(c): two replica children over socketpairs, each building
    full-width qwen2-1.5b on the card; the coordinator's profile from the
    same config. Every query served, each child warm (0 builds, 0
    captures) with the ported kernels launched in it, and PLANE_CHECKED
    completions bit for bit an in-process executor's from the same seed
    at the subnet each reports; ``wire`` is :func:`frame_costs`'s
    measurement, reported beside them. Returns the children's
    launches."""
    import asyncio
    import numpy as np
    from repro_torch import compat
    from repro_torch.launch.serve import child_report
    from repro_torch.serving import policies, profiler, runtime
    from repro_torch.serving.executor import (build_serving_executor,
                                              serving_config)
    cfg = serving_config("qwen2-1.5b", "cuda")
    prof = profiler.build_profile(cfg)
    rng = np.random.default_rng(PLANE_SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (WIRE_QUERIES, 16)).astype(np.int32)

    async def go():
        router = runtime.ClusterRouter(
            prof, policies.SlackFit(), [1] * PLANE_CHILDREN,
            transport="proc",
            execute="real", arch="qwen2-1.5b", seq_len=16,
            seed=PLANE_SEED, device="cuda", spawn_timeout=300.0,
            slo=slo_ms / 1e3)
        t0 = time.perf_counter()
        await router.start()
        start_s = time.perf_counter() - t0
        futs = []
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            wait = i / rate - (time.perf_counter() - t0)
            if wait > 0:
                await asyncio.sleep(wait)
            futs.append(await router.submit(p.tolist(), slo_s=slo_ms / 1e3))
        results = await asyncio.gather(*futs)
        await router.drain(60.0)
        return router, results, start_s

    router, results, start_s = asyncio.run(go())
    recs = router.records()
    st = router.stats()
    children = [child_report(ch, proxy)
                for ch, proxy in zip(router._chans, router.proxies)]
    served = sum(1 for r in recs if r.finish is not None and not r.dropped)
    if len(recs) != WIRE_QUERIES or served != WIRE_QUERIES:
        fail(f"plane children: served {served} of {len(recs)}")
    card = torch.cuda.get_device_name(0)
    launches = {}
    for c in children:
        if c["device_name"] != card or not c["devices"]:
            fail(f"child {c['rid']}: hello reports {c['device_name']!r}, "
                 f"{c['devices']} cards, not the card {card!r}")
        if c["kernel_builds"] != 0 or c["graph_captures"] != 0:
            fail(f"child {c['rid']}: {c['kernel_builds']} kernel "
                 f"builds and {c['graph_captures']} graph captures after "
                 f"warmup")
        for k, v in (c["kernel_launches"] or {}).items():
            launches[k] = launches.get(k, 0) + v
    for name in ("subnet_rmsnorm", "flash_attention"):
        if launches.get(name, 0) <= 0:
            fail(f"{name} never launched in the children")
    del router
    _free(torch)
    ex = build_serving_executor("qwen2-1.5b", seq_len=16, seed=PLANE_SEED,
                                device="cuda")
    accs = ex.accs()
    errs = []
    for i in range(PLANE_CHECKED):
        pred, acc = results[i]
        if acc not in accs:
            fail(f"completion {i}: accuracy {acc} names no subnet")
        want = ex.prefill(accs.index(acc), prompts[i][None])[0]
        got = np.asarray(pred, np.float32)
        errs.append(rel_err(got, want, f"child completion {i}"))
        if not np.array_equal(got, want):
            fail(f"child completion {i}: logits not bit for bit the "
                 f"in-process executor's (max |diff| "
                 f"{float(np.abs(got - want).max())})")
    # the same prefill in this process, the card no longer shared
    step_ms = {}
    for b in (1, 4):
        toks = np.ones((b, 16), np.int32)
        ex.prefill(ex.n_subnets - 1, toks)
        t0 = time.perf_counter()
        for _ in range(5):
            ex.prefill(ex.n_subnets - 1, toks)
        step_ms[f"widest_b{b}"] = (time.perf_counter() - t0) / 5 * 1e3
    compat.reset_launch_counts()
    say("plane-children", queries=len(recs), served=served,
        slo_attainment=st["slo_attainment"], mean_acc=st["mean_acc"],
        p50_latency_ms=st["p50_latency_s"] * 1e3,
        p99_latency_ms=st["p99_latency_s"] * 1e3, rate_qps=rate,
        slo_ms=slo_ms, start_seconds=start_s,
        children=children,
        child_step_ms=[c["step_s"] / c["steps"] * 1e3 if c["steps"]
                       else None for c in children],
        child_send_ms_per_frame=[
            c["completion_send_s"] / c["completion_frames"] * 1e3
            if c["completion_frames"] else None for c in children],
        inprocess_step_ms=step_ms, rel_err_vs_inprocess=errs,
        tol="2e-2 of max|logit|, and bit for bit", **wire)
    del ex
    _free(torch)
    return launches


def phase_plane(torch, pacing):
    """Phase 11: the serving plane with full-width qwen2-1.5b at phase
    3's rate R and SLO S. Returns the kernel launches of each driven
    path (in-process and in the children). The latency profile of the
    in-process runs and of the sim is measured once, by the first run
    that asks for it, and handed to the others (:func:`measure_once`)."""
    from repro_torch.serving import profiler
    measure = profiler.measure_profile
    profiler.measure_profile = measure_once(measure)
    try:
        return _plane_runs(torch, pacing)
    finally:
        profiler.measure_profile = measure


def measure_once(measure):
    """``measure`` (``profiler.measure_profile``) run on the first call
    only; every later call gets that first profile. Each run of phase 11
    that schedules from a measured profile serves the same full-width
    qwen2-1.5b at the same sequence length, so one measurement (18
    subnets x 4 batches, 10-17 s on the card) serves them all."""
    memo = []

    def once(*args, **kw):
        if not memo:
            memo.append(measure(*args, **kw))
        return memo[0]
    return once


def _plane_runs(torch, pacing):
    rate, slo_ms = plane_pacing(*pacing)
    say("plane-pacing", rate_qps=rate, slo_ms=slo_ms,
        from_lat_ms=list(pacing))
    runs = []
    # (a) in process, bursty then time-varying
    for tag, argv in (("bursty", ["--trace", "bursty", "--cv2", "8"]),
                      ("time_varying", ["--trace", "time_varying",
                                        "--tau", "500"])):
        runs.append(_plane_serve(torch, tag, argv, rate, slo_ms))
        _free(torch)
    # (b) two in-process replicas of one executor, switch mode
    out = _plane_serve(torch, "replicas", [
        "--replicas", "2", "--placement", "slack_aware",
        "--slice-mode", "switch"], rate, slo_ms)
    if sorted(out["per_replica_served"]) != [0, 1] \
            or min(out["per_replica_served"].values()) < 1:
        fail(f"plane replicas: {out['per_replica_served']}")
    if out["kernel_launches"].get("sliced_matmul", 0) <= 0:
        fail("plane replicas: sliced_matmul never launched")
    runs.append(out)
    _free(torch)
    # (c) two child processes over socketpairs, paced as (a) is but for
    # the latency a query sees through the wire: its step, then the
    # completion frame encoded by the child and decoded here
    from repro_torch.configs import get_config
    wire = frame_costs(get_config("qwen2-1.5b").vocab_size)
    wire_ms = wire["encode_ms"] + wire["decode_ms"]
    crate, cslo = plane_pacing(pacing[0] + wire_ms, pacing[1] + wire_ms,
                               PLANE_CHILDREN)
    say("plane-wire-pacing", rate_qps=crate, slo_ms=cslo, wire_ms=wire_ms)
    launches = [r["kernel_launches"] for r in runs]
    launches.append(plane_children(torch, crate, cslo, wire))
    # (d) over TCP, autoscaled
    from repro_torch.launch import serve
    out = serve.run(["--transport", "proc", "--listen", "127.0.0.1:0",
                     "--execute", "real", "--arch", "qwen2-1.5b",
                     "--procs", "1", "--autoscale", "--min-replicas", "1",
                     "--max-replicas", str(PLANE_CHILDREN), "--queries",
                     str(WIRE_QUERIES), "--seq-len", "16", "--seed",
                     str(PLANE_SEED), "--rate", repr(crate), "--slo-ms",
                     repr(cslo)])
    say("plane-tcp-autoscale", **{k: out.get(k) for k in (
        "queries", "served", "dropped", "slo_attainment", "mean_acc",
        "p50_latency_ms", "p99_latency_ms", "rate_qps", "slo_ms",
        "replicas_total", "replica_seconds", "scale_events",
        "handshake_rejects", "serve_phase_builds", "kernel_launches")},
        children=out["children"])
    if out["queries"] != WIRE_QUERIES \
            or out["served"] + out["dropped"] != WIRE_QUERIES:
        fail(f"plane tcp: {out['served']} served + {out['dropped']} "
             f"dropped of {out['queries']}")
    for c in out["children"]:
        if c["pid"] is not None and (c["kernel_builds"] != 0
                                     or c["graph_captures"] != 0):
            fail(f"plane tcp: child {c['rid']} reports "
                 f"{c['kernel_builds']} builds and {c['graph_captures']} "
                 f"captures after warmup")
    if out["rate_qps"] != round(crate, 1) \
            or out["slo_ms"] != round(cslo, 3):
        fail("plane tcp: the rate and SLO were not echoed back")
    launches.append(out["kernel_launches"])
    # (e) sim on the profile measured on the card: 4 replicas of 8
    # simulated workers, each at phase 3's rate
    out = serve.run(["--execute", "sim", "--profile", "measured",
                     "--device", "cuda", "--arch", "qwen2-1.5b",
                     "--replicas", "4", "--placement", "slack_aware",
                     "--cv2", "8", "--duration", "10", "--rate",
                     repr(32 * rate), "--slo-ms", repr(slo_ms),
                     "--seq-len", "16", "--seed", str(PLANE_SEED)])
    lat = out["measured_lat_ms"]
    say("plane-sim", **{k: out.get(k) for k in (
        "queries", "slo_attainment", "mean_acc", "p50_latency_ms",
        "p99_latency_ms", "load_imbalance", "per_replica_served", "device",
        "profile_batches")}, widest_lat_ms=lat[-1], narrowest_lat_ms=lat[0])
    import numpy as np
    lat = np.asarray(lat)
    if out["device"] != torch.cuda.get_device_name(0) \
            or out["size"] != "full":
        fail("plane sim: the profile was not measured at full width on "
             "the card")
    if not (np.isfinite(lat).all() and (lat > 0).all()
            and (np.diff(lat, axis=1) >= 0).all()):
        fail("plane sim: a measured latency is not positive or falls "
             "with batch")
    _free(torch)
    return launches


# --------------------------------------------------------------------------
# phase 12: supernet training
# --------------------------------------------------------------------------

# launch/train's shape: B = 8, S = 64, one sampled subnet besides the max
# and the min, lr 3e-3, the order-1 synthetic task with 1% noise
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 64, 3e-3
TRAIN_STEPS = (("mask", 4), ("switch", 2))
# a leaf's gradient on the card against the CPU's fp32 walk: max |delta|
# within GRAD_TOL of the leaf's max |g_cpu| (the bf16 tolerance of
# tests/test_kernels.py), else no further than the CPU's own bf16 walk
# plus GRAD_MARGIN
GRAD_TOL = 2e-2
GRAD_MARGIN = 0.02
# each resumed step's loss against the uninterrupted run's (the embedding
# backward sums with atomics on the card, so bits may differ)
RESUME_TOL = 1e-2


def _train_task(torch, vocab: int, seq: int, batch: int):
    from repro_torch.training import data
    return data.SyntheticTask(vocab_size=vocab, seq_len=seq,
                              global_batch=batch, seed=0, order=1,
                              noise=0.01)


def _on_card(torch, batch):
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _rel(torch, got, want) -> float:
    """max |got - want| over max |want|, None read as zeros: 0 when both
    are 0, inf when only ``want`` is."""
    if got is None and want is None:
        return 0.0
    got = torch.zeros_like(want) if got is None else got.float()
    want = torch.zeros_like(got) if want is None else want.float()
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if diff == 0:
        return 0.0
    return diff / scale if scale > 0 else float("inf")


def _bits(torch, t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def train_full(torch):
    """(a) Full-width, full-depth qwen2-1.5b at launch/train's shape: 4
    sandwich steps in mask mode, then 2 in switch mode, each under
    torch.profiler (device activity only): host wall ms (to the loss read
    back), device ms and idle share, peak memory, tokens a second, loss,
    grad norm, builds and each kernel's launches. Returns the launches of
    each step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optimizer as opt, supernet
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = get_config("qwen2-1.5b")
    task = _train_task(torch, cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    n_steps = sum(n for _, n in TRAIN_STEPS)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=max(n_steps // 10, 1),
                           total_steps=n_steps)
    t0 = time.perf_counter()
    st = Trainer(cfg, ocfg, TrainerConfig(), task,
                 device="cuda").init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, state = st.params, st.opt_state
    leaves = tree_leaves(params)
    # the max subnet reaches every leaf: none may be left without a
    # gradient (as the CPU reference's is nonzero for each)
    loss = supernet.sandwich_loss(params, cfg, _on_card(torch, task.batch(0)),
                                  torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    unreached = [i for i, g in enumerate(grads) if g is None]
    del loss, grads
    if unreached:
        fail(f"train: leaves {unreached} got no gradient from the sandwich")
    rows, launches, i = [], [], 0
    for mode, n in TRAIN_STEPS:
        step = supernet.make_train_step(cfg, ocfg, n_random=1,
                                        slice_mode=mode)
        for _ in range(n):
            batch = _on_card(torch, task.batch(i))
            gen = torch.Generator().manual_seed(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            compat.reset_launch_counts()
            with compat.BuildCounter() as bc, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch, gen)
                loss = float(m["loss"])
                wall = (time.perf_counter() - t0) * 1e3
            n_launch = compat.launch_counts()
            launches.append(n_launch)
            us = 0.0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    t = getattr(ev, "self_device_time_total", None)
                    us += ev.self_cuda_time_total if t is None else t
            dev_ms = us / 1e3
            rows.append(dict(
                step=i + 1, mode=mode, wall_ms=wall,
                device_ms=dev_ms if dev_ms > 0 else "not measured",
                device_idle_share=(1 - dev_ms / wall) if dev_ms > 0
                else "not measured",
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (wall / 1e3),
                loss=loss, grad_norm=float(m["grad_norm"]),
                lr=float(m["lr"]), builds=bc.count, launches=n_launch))
            say("train-step", **rows[-1])
            if i > 0 and bc.count != 0:
                fail(f"train step {i + 1}: built {bc.count} kernels")
            if not (math.isfinite(loss)
                    and math.isfinite(rows[-1]["grad_norm"])):
                fail(f"train step {i + 1}: loss {loss}, grad norm "
                     f"{rows[-1]['grad_norm']}")
            for name in ("flash_attention", "subnet_rmsnorm") + (
                    ("sliced_matmul",) if mode == "switch" else ()):
                if n_launch.get(name, 0) <= 0:
                    fail(f"train step {i + 1} ({mode}): {name} never "
                         f"launched")
            i += 1
    n_params = sum(p.numel() for p in leaves)
    param_gb = sum(p.numel() * p.element_size() for p in leaves) / 1e9
    say("train-full", arch=cfg.name, units=28, params=n_params,
        param_gb=param_gb, grad_gb=param_gb, moment_gb=n_params * 8 / 1e9,
        init_seconds=init_s, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        logits_mb=TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size * 4 / 1e6,
        losses=[r["loss"] for r in rows],
        wall_ms=[r["wall_ms"] for r in rows],
        device_ms=[r["device_ms"] for r in rows],
        peak_gb=max(r["peak_gb"] for r in rows))
    return launches


def _loss_grads(torch, params, cfg, batch, ctrl, mode):
    """(loss, each leaf's gradient on the CPU in fp32, None where autograd
    gave none) of ``lm.loss_fn``."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(params)
    loss = lm.loss_fn(params, cfg, batch, ctrl, slice_mode=mode)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        None if g is None else g.detach().float().cpu() for g in grads]


def train_reference(torch):
    """(b) The loss and every leaf's gradient of qwen2-1.5b cut to 2 units
    at full width (B = 2, S = 32): the card (bf16, through the kernels and
    their backward passes) against the CPU's fp32 plain walk from the same
    weights, for the max and the min subnet in mask mode and the max in
    switch mode. A leaf past GRAD_TOL is held to the CPU's own bf16 walk
    plus GRAD_MARGIN."""
    from repro_torch.core import subnet as sn
    from repro_torch.models.common import tree_flatten_with_path, tree_leaves
    cfg, gpu, cfg32, cpu = depth_cut(torch, "qwen2-1.5b", seed=12)
    cpu16 = None
    for t in tree_leaves(gpu) + tree_leaves(cpu):
        t.requires_grad_()
    paths = ["/".join(map(str, p)) for p, _ in tree_flatten_with_path(gpu)]
    batch = _train_task(torch, cfg.vocab_size, 32, 2).batch(0)
    for mode, sub in (("mask", sn.max_subnet(cfg)),
                      ("mask", sn.min_subnet(cfg)),
                      ("switch", sn.max_subnet(cfg))):
        ctrl = sn.make_control(cfg, sub)
        t0 = time.perf_counter()
        loss, got = _loss_grads(torch, gpu, cfg, batch, ctrl, mode)
        want_loss, want = _loss_grads(torch, cpu, cfg32, batch, ctrl, mode)
        cpu_s = time.perf_counter() - t0
        errs = []
        for path, g, w in zip(paths, got, want):
            if g is None and w is not None and bool((w != 0).any()):
                fail(f"train reference {mode} {sub.key()}: {path} has no "
                     f"gradient on the card, a nonzero one on the CPU")
            errs.append(_rel(torch, g, w))
        held = {}
        if max(errs) > GRAD_TOL:
            if cpu16 is None:
                cpu16 = to_cpu(gpu)
                for t in tree_leaves(cpu16):
                    t.requires_grad_()
            _, ref16 = _loss_grads(torch, cpu16, cfg, batch, ctrl, mode)
            for j, e in enumerate(errs):
                if e > GRAD_TOL:
                    e16 = _rel(torch, ref16[j], want[j])
                    held[paths[j]] = [e, e16]
                    if e > e16 + GRAD_MARGIN:
                        fail(f"train reference {mode} {sub.key()}: "
                             f"{paths[j]} gradient {e} of max |g| from the "
                             f"CPU's fp32, its bf16 walk {e16}")
        worst = max(range(len(errs)), key=errs.__getitem__)
        loss_err = abs(loss - want_loss) / abs(want_loss)
        say("train-reference", mode=mode, subnet=sub.key(), units=2,
            batch=2, seq=32, loss=loss, loss_cpu_fp32=want_loss,
            loss_rel_err=loss_err, leaves=len(errs),
            worst_leaf=paths[worst], worst_rel_err=errs[worst],
            tol=GRAD_TOL, held_by_cpu_bf16=held, seconds=cpu_s)
        if loss_err > GRAD_TOL:
            fail(f"train reference {mode} {sub.key()}: loss {loss} against "
                 f"{want_loss} on the CPU")
    del gpu, cpu, cpu16
    _free(torch)


def train_functions(torch):
    """(c) Each Function alone at the full-width shapes of a training step
    (B = 8, S = 64): both norm forms at 512 rows x 1536, flash at (8, 12/2,
    64, 128) with every head and with 6, sliced_matmul at FFN up and down
    and at wo (2 segments), full and half width. The gradients through the
    kernel against torch.autograd of the plain version on the card (bf16
    tolerance), and each backward's device ms beside the plain version's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sliced_matmul as sm
    from repro_torch.kernels import subnet_rmsnorm as rn
    gen = torch.Generator(device="cuda").manual_seed(5)

    def leaf(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype).requires_grad_()

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    rows = {}

    def case(name, kernel, plain, inputs):
        outs, want_outs = kernel(*inputs), plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want_outs = want_outs if isinstance(want_outs, tuple) \
            else (want_outs,)
        dys = [torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
               for o in outs]

        def backward(o):
            return lambda: torch.autograd.grad(o, inputs, dys,
                                               retain_graph=True)

        got, want = backward(outs)(), backward(want_outs)()
        errs = [_compare(torch, f"train {name} backward", g, w)
                for g, w in zip(got, want)]
        rows[name] = dict(
            max_abs_err=max(errs),
            rel_err=max(_rel(torch, g, w) for g, w in zip(got, want)),
            backward_device_ms=device_ms(torch, backward(outs), n=10),
            plain_backward_device_ms=device_ms(torch, backward(want_outs),
                                               n=10))

    sid = i32(7)
    gamma = (1 + 0.1 * torch.randn((18, 1536), generator=gen, device="cuda")
             ).requires_grad_()
    x = leaf(512, 1536)
    case("subnet_rmsnorm", lambda x, g: kops.subnet_rmsnorm(x, g, sid),
         lambda x, g: rn.subnet_rmsnorm_plain(x, g, sid), (x, gamma))
    case("add_subnet_rmsnorm",
         lambda x, d, g: kops.add_subnet_rmsnorm(x, d, g, sid),
         lambda x, d, g: rn.add_subnet_rmsnorm_plain(x, d, g, sid),
         (x, leaf(512, 1536), gamma))
    q, k, v = leaf(8, 12, 64, 128), leaf(8, 2, 64, 128), leaf(8, 2, 64, 128)
    for hw in (None, 6):
        w = None if hw is None else i32(hw)
        case(f"flash_attention_hw{hw or 12}",
             lambda q, k, v: kops.flash_attention(q, k, v, head_width=w),
             lambda q, k, v: fa.flash_attention_plain(q, k, v, head_width=w),
             (q, k, v))
    for tag, (K, N, ai, ao, seg) in {
            "ffn_up": (1536, 8960, None, 8960, 1),
            "ffn_up_half": (1536, 8960, None, 4480, 1),
            "ffn_down": (8960, 1536, 8960, None, 1),
            "ffn_down_half": (8960, 1536, 4480, None, 1),
            "wo": (1536, 1536, 768, None, 2),
            "wo_half": (1536, 1536, 384, None, 2)}.items():
        a = None if ai is None else i32(ai)
        b = None if ao is None else i32(ao)
        case(f"sliced_matmul_{tag}",
             lambda x, w: kops.sliced_matmul(x, w, a, b, segments=seg),
             lambda x, w: sm.sliced_matmul_plain(x, w, a, b, segments=seg),
             (leaf(512, K), leaf(K, N, scale=K ** -0.5)))
    say("train-functions", tol=BF16_TOL, **rows)
    _free(torch)


def train_resume(torch):
    """(d) Crash and resume at the 2-unit cut: a Trainer with ckpt_every=2
    runs to step 2 (saving it), crashes after step 3, resumes at step 2
    with every leaf equal to the saved one bit for bit, and runs to step 4,
    each resumed loss within RESUME_TOL of an uninterrupted run's. Save and
    restore seconds and bytes. Returns the trainer's kernel launches."""
    import os
    import shutil
    import tempfile
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving.executor import cut_units
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = cut_units(get_config("qwen2-1.5b"), 2)
    task = _train_task(torch, cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=4)
    d = tempfile.mkdtemp(prefix="train-ckpt-")
    seconds = {"save": [], "restore": []}
    save, restore = ckpt.save, ckpt.restore

    def timed(kind, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[kind].append(time.perf_counter() - t0)
            return out
        return run

    ckpt.save, ckpt.restore = timed("save", save), timed("restore", restore)
    try:
        tr = Trainer(cfg, ocfg, TrainerConfig(total_steps=4, ckpt_every=2,
                                              ckpt_dir=d), task,
                     device="cuda")
        compat.reset_launch_counts()
        st = tr.run(tr.resume_or_init(0), until=2)
        saved = [_bits(torch, t).clone() for t in tree_leaves(
            {"params": st.params, "opt": st.opt_state})]
        step_dir = os.path.join(d, "step_00000002")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        first = list(st.losses)
        try:
            tr.run(st, until=4, crash_at=3)
        except RuntimeError as exc:
            if "simulated node failure at step 3" not in str(exc):
                raise
        else:
            fail("train resume: the run did not crash at step 3")
        del st
        st = tr.resume_or_init(0)
        if st.step != 2:
            fail(f"train resume: resumed at step {st.step}, not 2")
        back = tree_leaves({"params": st.params, "opt": st.opt_state})
        if len(back) != len(saved) or not all(
                torch.equal(_bits(torch, a), b) for a, b in zip(back, saved)):
            fail("train resume: a restored leaf differs from the saved one")
        del back, saved
        st = tr.run(st, until=4)
        launches = compat.launch_counts()
        ref = tr.init_state(0)
        params, state, clean = ref.params, ref.opt_state, []
        for i in range(4):
            params, state, m = tr.step_fn(params, state,
                                          _on_card(torch, task.batch(i)),
                                          torch.Generator().manual_seed(i))
            clean.append(float(m["loss"]))
        diffs = [abs(a - b) for a, b in zip(st.losses, clean[2:])]
        say("train-resume", units=2, ckpt_bytes=nbytes,
            save_seconds=seconds["save"], restore_seconds=seconds["restore"],
            losses_before_crash=first, losses_resumed=st.losses,
            losses_uninterrupted=clean, resumed_abs_diff=diffs,
            tol=RESUME_TOL, restored_bit_for_bit=True)
        if len(diffs) != 2 or max(diffs) > RESUME_TOL:
            fail(f"train resume: resumed losses {st.losses} against the "
                 f"uninterrupted {clean[2:]}")
    finally:
        ckpt.save, ckpt.restore = save, restore
        shutil.rmtree(d, ignore_errors=True)
    _free(torch)
    return launches


def train_launcher(torch):
    """(e) ``python -m repro_torch.launch.train --arch qwen2-1.5b --units 2
    --steps 4 --ckpt-every 2`` in a subprocess: exit 0 and "done: step
    4"."""
    import os
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="train-launch-")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen2-1.5b", "--units", "2", "--steps", "4", "--ckpt-every",
             "2", "--ckpt-dir", d],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=300)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    lines = proc.stdout.strip().splitlines()
    say("train-launcher", rc=proc.returncode,
        seconds=time.perf_counter() - t0, stdout=lines[-2:])
    if proc.returncode != 0 or not any(ln.startswith("done: step 4")
                                       for ln in lines):
        fail(f"train launcher: rc {proc.returncode}, stdout {lines[-3:]}, "
             f"stderr {proc.stderr.strip().splitlines()[-5:]}")


def phase_train(torch):
    """Phase 12: supernet training on the card. Returns the kernel
    launches of the driven training paths ((a)'s steps and (d)'s
    trainer)."""
    launches = train_full(torch)
    _free(torch)
    train_reference(torch)
    train_functions(torch)
    launches.append(train_resume(torch))
    train_launcher(torch)
    return launches


# --------------------------------------------------------------------------
# phase 13: the paper's OFA-ResNet supernet
# --------------------------------------------------------------------------

CONV_BATCH = 32                    # calibration batch X and the timed walks
CONV_TOL = 1e-3                    # of max |logit|


def _conv_walk_calls(torch, fn) -> int:
    """``aten::conv2d`` calls of one ``fn()``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.name == "aten::conv2d" for ev in prof.events())


def phase_conv(torch, card):
    """Phase 13: full-width OFA-ResNet (widths 256-2048, 4 units a stage,
    224 x 224 images, 1000 classes, fp32 with TF32 off, random weights
    from a seeded generator). (a) Calibrate all 27 subnets on one batch X
    of 32 images, then each subnet's inference walk on X with its
    calibrated rows against the batch-statistics walk on X, within
    ``CONV_TOL`` of max |logit|; (b) the smallest, a middle and the
    largest subnet (by FLOPs) at B = 2 against the CPU's fp32 walk of the
    same weights, tables and images, within ``CONV_TOL``; (c) every subnet
    at B = 32: host wall, device ms and images a second, every parameter
    keeping its storage and the allocated memory not growing after the
    first walk; the shallowest and the deepest subnet's conv calls counted
    by the profiler; (d) the norm tables' bytes against the shared
    weights' (paper Fig. 4) and the analytic profile's latency of each
    subnet at B = 32 beside the card's, printed only. Launches no kernel
    of the port. Returns no launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import calibrate
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import subnet_flops, subnet_weight_bytes
    from repro_torch.models import convnet
    from repro_torch.serving import profiler
    cfg = get_config("ofa_resnet")
    secs = {}
    t0 = time.perf_counter()
    params = convnet.init_convnet(
        cfg, torch.Generator(device="cuda").manual_seed(13), "cuda")
    leaves = list(_leaves(params))
    ptrs = [t.data_ptr() for t in leaves]
    gen = torch.Generator(device="cuda").manual_seed(14)
    X = torch.randn((CONV_BATCH, cfg.img_size, cfg.img_size, 3),
                    generator=gen, device="cuda")
    space = sn.enumerate_space(cfg)
    ctrls = [convnet.make_conv_control(cfg, sub) for sub in space]
    secs["init"] = time.perf_counter() - t0

    # (a) calibration, then calibrated inference against batch statistics
    t0 = time.perf_counter()
    calibrate.calibrate_convnet(params, cfg, [X], space)
    torch.cuda.synchronize()
    secs["calibrate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calib_errs = []
    with torch.no_grad():
        for sub, ctrl in zip(space, ctrls):
            got = convnet.convnet_forward(params, cfg, X, ctrl)
            want, _ = convnet.convnet_forward(
                params, cfg, X, ctrl, collect_stats=True,
                static_gates=sn.stage_gates(cfg, sub.depth_frac))
            calib_errs.append(rel_err(
                got.cpu().numpy(), want.cpu().numpy(),
                f"ofa_resnet subnet {sub.subnet_id}: calibrated walk against "
                f"the batch-statistics walk", tol=CONV_TOL))
    secs["calibrated_check"] = time.perf_counter() - t0

    # (b) the card's fp32 walk against the CPU's
    t0 = time.perf_counter()
    by_flops = sorted(space, key=lambda s: subnet_flops(cfg, s))
    picked = [by_flops[0], by_flops[len(by_flops) // 2], by_flops[-1]]
    cpu = to_cpu(params)
    x2 = X[:2]
    cpu_errs = {}
    with torch.no_grad():
        for sub in picked:
            ctrl = convnet.make_conv_control(cfg, sub)
            cpu_errs[sub.subnet_id] = rel_err(
                convnet.convnet_forward(params, cfg, x2, ctrl).cpu().numpy(),
                convnet.convnet_forward(cpu, cfg, x2.cpu(), ctrl).numpy(),
                f"ofa_resnet subnet {sub.subnet_id}: card against the CPU's "
                f"fp32 walk", tol=CONV_TOL)
    del cpu
    secs["cpu_reference"] = time.perf_counter() - t0

    # (c) every subnet at B = 32: actuation is data
    t0 = time.perf_counter()
    walks, grew = [], []
    with torch.no_grad():
        for i, (sub, ctrl) in enumerate(zip(space, ctrls)):
            dctrl = ops.device_control(ctrl, "cuda")

            def walk(dctrl=dctrl):
                return convnet.convnet_forward(params, cfg, X, dctrl)
            walk()
            torch.cuda.synchronize()
            if i == 0:
                base = torch.cuda.memory_allocated()
            grew.append(torch.cuda.memory_allocated() - base)
            walls = []
            for _ in range(3):
                t1 = time.perf_counter()
                walk()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            wall = float(np.median(walls))
            dev_ms = device_ms(torch, walk, n=1)
            lat = profiler.model_latency(profiler.RTX2080TI,
                                         subnet_flops(cfg, sub),
                                         subnet_weight_bytes(cfg, sub),
                                         CONV_BATCH) * 1e3
            walks.append(dict(
                subnet=sub.subnet_id, key=list(sub.key()),
                gflops_per_image=subnet_flops(cfg, sub) / 1e9,
                host_wall_ms=wall, device_ms=dev_ms,
                images_per_s=CONV_BATCH / wall * 1e3,
                analytic_rtx2080ti_ms=lat))
    secs["walks"] = time.perf_counter() - t0
    if [t.data_ptr() for t in leaves] != ptrs:
        fail("ofa_resnet: a parameter changed its storage while actuating")
    if max(grew) > 0:
        fail(f"ofa_resnet: allocated memory grew by {max(grew)} bytes after "
             f"the first walk")
    shallow = min(space, key=lambda s: (s.depth_frac, -s.subnet_id))
    deep = max(space, key=lambda s: s.depth_frac)
    calls = {}
    with torch.no_grad():
        for tag, sub in (("shallowest", shallow), ("deepest", deep)):
            ctrl = convnet.make_conv_control(cfg, sub)
            calls[tag] = _conv_walk_calls(
                torch, lambda: convnet.convnet_forward(params, cfg, X, ctrl))
    # the stem, then each live unit's three convs (four with the
    # projection of a stage's first unit)
    want = {tag: 1 + sum(4 + 3 * (max(1, math.ceil(s.repeat * sub.depth_frac))
                                  - 1) for s in cfg.stages)
            for tag, sub in (("shallowest", shallow), ("deepest", deep))}
    if calls != want or not calls["shallowest"] < calls["deepest"]:
        fail(f"ofa_resnet: conv calls a walk {calls}, expected {want}")
    norm_b = calibrate.norm_table_bytes(params)
    shared_b = calibrate.shared_weight_bytes(params)
    for w in walks:
        say("conv-walk", **w)
    say("conv", arch=cfg.name, widths=list(cfg.conv_stage_widths),
        units=[s.repeat for s in cfg.stages], img=cfg.img_size,
        classes=cfg.n_classes, batch=CONV_BATCH, subnets=len(space),
        parameters=sum(t.numel() for t in leaves),
        calibrated_vs_batch_stats_max_rel_err=max(calib_errs),
        card_vs_cpu_fp32_rel_err=cpu_errs, tol=f"{CONV_TOL} of max|logit|",
        conv_calls=calls, memory_growth_bytes=max(grew),
        norm_table_bytes=norm_b, shared_weight_bytes=shared_b,
        shared_over_norm=shared_b / norm_b,
        images_per_s=[min(w["images_per_s"] for w in walks),
                      max(w["images_per_s"] for w in walks)],
        seconds=secs)
    del params, X
    _free(torch)
    return []


# --------------------------------------------------------------------------
# phase 14: the embed-frontend configs
# --------------------------------------------------------------------------

FRONTEND_CONFIGS = ("musicgen-medium", "qwen2-vl-7b")


def embed_batch(torch, cfg, batch: int, seq: int, seed: int):
    """A prefill batch of an ``embed``-frontend config, numpy: seeded
    ``embeds`` (B, S, d) already rounded to bf16 (so that the card and an
    fp32 walk read the same values) and, for M-RoPE, three distinct
    position streams over a 4x4 grid of patches (t constant, h the row,
    w the column); with equal streams M-RoPE is plain RoPE."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, seq, cfg.d_model)
                                             ).astype(np.float32))
    out = {"embeds": x.bfloat16().float().numpy()}
    if cfg.mrope_sections:
        i = np.arange(seq)
        pos = np.stack([np.full(seq, 5), i // 4, i % 4]).astype(np.int32)
        out["positions"] = np.broadcast_to(pos[:, None],
                                           (3, batch, seq)).copy()
    return out


def phase_frontends(torch, card):
    """Phase 14: each of FRONTEND_CONFIGS at full width and depth, in
    turn, freed before the next (:func:`frontend_run`). Returns the kernel
    launches of each driven path."""
    launches = []
    for name in FRONTEND_CONFIGS:
        t0 = time.perf_counter()
        launches.append(frontend_run(torch, card, name))
        _free(torch)
        say("config-seconds", arch=name, seconds=time.perf_counter() - t0)
    return launches


def frontend_run(torch, card, name: str):
    """One embed-frontend config at its published widths and depth, random
    weights from a seeded generator, through ``lm.prefill`` and
    ``lm.decode_step`` (the executor serves token-frontend LMs only, as
    the reference's launcher does): (a) after one warmup walk in each
    mode, with no build, the prefill (B = 8, S = 16) from ``embeds`` (for
    qwen2-vl three distinct position streams) of each Pareto subnet in
    mask and in switch mode, and 8 greedy decode steps on
    tokens of each subnet in both modes (switch fed mask's tokens), every
    walk held against the fp32 oracle: switch no further from it than mask
    plus ``SWITCH_MARGIN``; flash and decode attention (at d = 64 or
    G = 7), ``sliced_matmul`` and, for an RMSNorm config, the norm
    launched; (b) every block of the same mask walks against its switch
    twin (:class:`BlockShadow`); (c) the trace of a prefill and a decode
    step of the largest subnet; (d) the 2-layer reference against the
    plain path on the CPU in both modes. Returns the launches of (a)."""
    import numpy as np
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import pareto_subnets
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    cfg = get_config(name)
    secs = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(4),
                           "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, steps = 8, 16, 8
    batch = embed_batch(torch, cfg, B, S, seed=5)
    gbatch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pts = pareto_subnets(cfg)
    ctrls = [ops.device_control(attn_mod.with_wo_width(
        cfg, sn.make_control(cfg, p.sub)), "cuda") for p in pts]
    ends = (0, len(pts) - 1)
    secs["init"] = time.perf_counter() - t0

    def greedy(ctrl, mode, feed=None):
        """8 decode steps from an empty cache: the logits of each (numpy)
        and the tokens fed, each step's argmax unless ``feed`` is given."""
        cache = lm.init_cache(cfg, B, 32, device="cuda")
        tok = torch.as_tensor(toks, device="cuda").long()
        seq, out = [tok], []
        for j in range(steps):
            if feed is not None:
                tok = feed[:, j:j + 1]
            logits, cache = lm.decode_step(params, cfg, tok, ctrl, cache, j,
                                           slice_mode=mode)
            out.append(logits)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            seq.append(tok)
        return (torch.cat(seq[:steps], 1),
                torch.cat(out, 1).float().cpu().numpy())

    t0 = time.perf_counter()
    with torch.no_grad():
        for mode in ("mask", "switch"):         # warmup: every entry once
            lm.prefill(params, cfg, gbatch, ctrls[-1], slice_mode=mode)
            greedy(ctrls[-1], mode)
        torch.cuda.synchronize()
        compat.reset_launch_counts()
        with compat.BuildCounter() as bc:
            prefills = {mode: [lm.prefill(params, cfg, gbatch, c,
                                          slice_mode=mode
                                          ).float().cpu().numpy()[:, -1]
                               for c in ctrls]
                        for mode in ("mask", "switch")}
            decoded = []
            for c in ctrls:
                seq, got_m = greedy(c, "mask")
                _, got_s = greedy(c, "switch", feed=seq)
                decoded.append((seq, got_m, got_s))
            torch.cuda.synchronize()
        launches = compat.launch_counts()
    if bc.count:
        fail(f"{name}: {bc.count} kernel builds after warmup")
    rms = cfg.norm == "rmsnorm"
    for kernel in ("flash_attention", "decode_attention", "sliced_matmul") \
            + (("subnet_rmsnorm",) if rms else ()):
        if launches.get(kernel, 0) <= 0:
            fail(f"{name}: {kernel} never launched in the walks")
    errs = {"prefill": {k: [] for k in ("switch_vs_mask", "mask_vs_fp32",
                                        "switch_vs_fp32")},
            "decode": {k: [] for k in ("switch_vs_mask", "mask_vs_fp32",
                                       "switch_vs_fp32")}}
    gaps = []

    def hold(kind, what, sw, mk, ref):
        e = {key: rel_err(a, b, f"{name} {what} {key}", tol=float("inf"))
             for key, a, b in (("switch_vs_mask", sw, mk),
                               ("mask_vs_fp32", mk, ref),
                               ("switch_vs_fp32", sw, ref))}
        for key, v in e.items():
            errs[kind][key].append(v)
        gaps.append(e["switch_vs_fp32"] - e["mask_vs_fp32"])
        if not e["switch_vs_fp32"] <= e["mask_vs_fp32"] + SWITCH_MARGIN:
            fail(f"{name}: switch {what} is {e['switch_vs_fp32']} of "
                 f"max|logit| off the fp32 oracle, mask {e['mask_vs_fp32']}")

    for i, c in enumerate(ctrls):
        ref = fp32_oracle(torch, params, cfg, None, c,
                          embeds=gbatch["embeds"],
                          positions=gbatch.get("positions"))[:, -1]
        hold("prefill", f"prefill subnet {i}", prefills["switch"][i],
             prefills["mask"][i], ref)
        seq, got_m, got_s = decoded[i]
        ref = fp32_oracle(torch, params, cfg, seq, c)
        for j in range(steps):
            hold("decode", f"decode subnet {i} step {j}", got_s[:, j],
                 got_m[:, j], ref[:, j])
    secs["walks"] = time.perf_counter() - t0
    peak_walks = stage_peak_gb(torch)

    # (b) each block of the mask walks against its switch twin
    t0 = time.perf_counter()
    seqs = {i: decoded[i][0] for i in ends}
    del prefills, decoded
    with torch.no_grad(), BlockShadow(name) as shadow:
        for c in ctrls:
            lm.prefill(params, cfg, gbatch, c)
        for i in ends:
            greedy(ctrls[i], "mask", feed=seqs[i])
    want_blocks = shadow_blocks(cfg, ctrls, ends, steps)
    if shadow.blocks != want_blocks:
        fail(f"{name}: {shadow.blocks} blocks compared to their switch "
             f"twins, not {want_blocks}")
    secs["block_twins"] = time.perf_counter() - t0

    # (c) the trace of a prefill and a decode step of the largest subnet
    t0 = time.perf_counter()
    top = ctrls[-1]
    cache = lm.init_cache(cfg, B, 16, device="cuda")
    tok = torch.as_tensor(toks, device="cuda")
    with torch.no_grad():
        trace = trace_steps(torch, {
            "prefill": lambda: lm.prefill(params, cfg, gbatch, top),
            "decode": lambda: lm.decode_step(params, cfg, tok, top, cache,
                                             3)},
            n=CONFIG_TRACE_STEPS)
    step_bytes = lm.param_bytes(cfg) - cfg.vocab_size * cfg.d_model * 2
    for kind in trace:
        trace[kind]["bytes_bound_ms"] = step_bytes / card.bw * 1e3
    secs["trace"] = time.perf_counter() - t0
    del params, cache, gbatch
    _free(torch)

    # (d) the 2-layer reference on the CPU
    t0 = time.perf_counter()
    cut = depth_cut(torch, name, seed=2)
    worst = reference_check(torch, cut, tag=f"{name} reference")
    del cut
    _free(torch)
    secs["reference"] = time.perf_counter() - t0
    say("config", arch=name, frontend=cfg.frontend, pos_embed=cfg.pos_embed,
        mrope_sections=list(cfg.mrope_sections),
        layers=sum(s.repeat for s in cfg.stages), d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, norm=cfg.norm,
        ffn_act=cfg.ffn_act, parameters=n_params, peak_device_gb=peak_walks,
        subnets=len(pts), builds_after_warmup=bc.count,
        switch_margin=SWITCH_MARGIN,
        prefill_logits_max_rel_err={k: max(v) for k, v in
                                    errs["prefill"].items()},
        decode_logits_max_rel_err={k: max(v) for k, v in
                                   errs["decode"].items()},
        switch_minus_mask_vs_fp32=dict(mean=sum(gaps) / len(gaps),
                                       max=max(gaps), min=min(gaps),
                                       walks=len(gaps)),
        blocks_compared=shadow.blocks, switch_block_max_rel_err=shadow.worst,
        switch_block_max_rel_err_by_kind=shadow.worst_by_kind,
        block_tol="2e-2 of max|block output|", walk_launches=launches,
        reference_max_rel_err=worst["mask"],
        reference_switch_max_rel_err=worst["switch"], seconds=secs,
        trace=trace)
    return launches


# --------------------------------------------------------------------------
# phase 15: int8 weights, distribution at world size 1, the dry-run
# --------------------------------------------------------------------------

DRYRUN_CELLS = (("train_4k", ()), ("decode_32k", ("--int8-weights",)))


def start_dryruns():
    """The dry-run cells of phase 15c, each in a subprocess of its own on
    the host (a fake 256-rank group, nothing on the card), started
    together so that they run beside 15a and 15b."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for shape, flags in DRYRUN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                "qwen2-1.5b", "--shape", shape, "--mesh", "single", *flags]
        procs.append((shape, flags, subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dryruns(procs):
    """Phase 15c: each cell must end ``status: ok``; its roofline terms,
    dominant term, per-device GB against the H100's 80 and collectives."""
    from repro_torch.roofline import hw
    for shape, flags, proc in procs:
        out, err = proc.communicate(timeout=600)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("status: ok ")]
        if proc.returncode != 0 or not lines:
            fail(f"dry-run {shape} {flags}: rc {proc.returncode}: "
                 f"{err[-2000:]}")
        rec = json.loads(lines[-1][len("status: ok "):])
        say("dist-dryrun", arch=rec["arch"], shape=shape, mesh=rec["mesh"],
            int8_weights=rec["int8_weights"], torch=rec["torch"],
            status=rec["status"], chips=rec["chips"],
            t_compute_ms=rec["t_compute"] * 1e3,
            t_memory_ms=rec["t_memory"] * 1e3,
            t_collective_ms=rec["t_collective"] * 1e3,
            dominant=rec["dominant"],
            argument_gb=rec["argument_bytes_per_device"] / 1e9,
            temp_gb=rec["temp_bytes_per_device"] / 1e9,
            hbm_gb=hw.H100_HBM_BYTES / 1e9, fits_hbm=rec["fits_hbm"],
            collective_counts=rec["collective_counts"],
            place_s=rec["place_s"], trace_s=rec["trace_s"],
            note="planning figures from H100 data-sheet peaks")


def int8_walks(torch, cfg, params, q, sc, ctrls, B=8, S=16, steps=8):
    """Prefill (B, S) and ``steps`` greedy decode steps of each control in
    ``ctrls`` in mask mode, in bf16 and with int8 weights (the reference's
    ``decode_int8``: ``dequantize_tree`` each step, then
    ``lm.decode_step``): host and device ms a step of each, the int8
    logits' gap from bf16's with both fed bf16's greedy tokens, and the
    tokens the int8 walk's own greedy choice changes. Returns a row a
    subnet."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serving import quantize as QZ
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")

    def weights(kind):
        return QZ.dequantize_tree(q, sc) if kind == "int8" else params

    def walk(kind, ctrl, feed=None):
        """(prefill logits, decode logits, tokens fed after the prompt,
        host ms a step); greedy unless ``feed`` gives the tokens."""
        first = lm.prefill(weights(kind), cfg, {"tokens": toks}, ctrl)
        cache = lm.init_cache(cfg, B, S + steps, device="cuda")
        tok = first[:, -1].argmax(-1, keepdim=True)
        outs, seq, wall = [], [], []
        for j in range(steps):
            if feed is not None:
                tok = feed[:, j:j + 1]
            seq.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(weights(kind), cfg, tok, ctrl,
                                           cache, S + j)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits.float())
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return first.float(), torch.cat(outs, 1), torch.cat(seq, 1), wall

    rows = []
    for ctrl in ctrls:
        b_first, b_walk, b_toks, b_wall = walk("bf16", ctrl)
        q_first, q_walk, _, _ = walk("int8", ctrl, feed=b_toks)
        _, _, g_toks, q_wall = walk("int8", ctrl)
        cache = lm.init_cache(cfg, B, S + steps, device="cuda")
        ms = {kind: device_ms(torch, lambda kind=kind: lm.decode_step(
            weights(kind), cfg, b_toks[:, :1], ctrl, cache, S), n=3)
            for kind in ("bf16", "int8")}
        rows.append(dict(
            bf16_host_ms=sum(b_wall) / steps, int8_host_ms=sum(q_wall) / steps,
            bf16_device_ms=ms["bf16"], int8_device_ms=ms["int8"],
            logit_gap=float((q_walk - b_walk).abs().max())
            / float(b_walk.abs().max()),
            prefill_gap=float((q_first - b_first).abs().max())
            / float(b_first.abs().max()),
            tokens_differ=int((g_toks != b_toks).sum()),
            tokens=int(b_toks.numel())))
    return rows


def int8_cut_check(torch):
    """The 2-unit cut of full-width qwen2-1.5b: the int8 tree and scales
    the card computes equal bit for bit those the CPU's plain path
    computes from the same bf16 weights, and the card's int8 walk (bf16
    dequantized weights through the kernels: prefill (B = 2, S = 16) and 4
    decode steps of the widest and the narrowest Pareto subnet, mask mode)
    within 2e-2 of max |logit| of the CPU's fp32 walk on the same
    dequantized weights."""
    import numpy as np
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import pareto_subnets
    from repro_torch.models import lm
    from repro_torch.serving import quantize as QZ
    cfg, gpu, cfg32, _ = depth_cut(torch, "qwen2-1.5b", seed=9)
    q, sc = QZ.quantize_tree(gpu)
    q_cpu, sc_cpu = QZ.quantize_tree(to_cpu(gpu))
    for a, b in zip(_leaves(q), _leaves(q_cpu)):
        if not torch.equal(a.cpu(), b):
            fail("int8 cut: the card's int8 tree differs from the CPU's")
    for a, b in zip(_leaves(sc), _leaves(sc_cpu)):
        if not torch.equal(a.cpu(), b):
            fail("int8 cut: the card's scales differ from the CPU's")
    deq = QZ.dequantize_tree(q, sc)
    deq32 = QZ.dequantize_tree(q_cpu, sc_cpu, dtype=torch.float32)
    pts = pareto_subnets(cfg)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    steps = rng.integers(0, cfg.vocab_size, (2, 4))
    worst = 0.0
    for p in (pts[-1], pts[0]):
        ctrl = sn.make_control(cfg, p.sub)
        walks = []
        for params, c, dev in ((deq, cfg, "cuda"), (deq32, cfg32, "cpu")):
            ctl = ops.device_control(ctrl, dev)
            t = torch.as_tensor(toks, device=dev)
            outs = [lm.prefill(params, c, {"tokens": t}, ctl).float()]
            cache = lm.init_cache(c, 2, 32, device=dev)
            for j in range(16):     # the prompt through the decode path
                _, cache = lm.decode_step(params, c, t[:, j:j + 1], ctl,
                                          cache, j)
            for j in range(4):
                logits, cache = lm.decode_step(
                    params, c, torch.as_tensor(steps[:, j:j + 1],
                                               device=dev), ctl, cache,
                    16 + j)
                outs.append(logits.float())
            walks.append(torch.cat(outs, 1).cpu())
        err = rel_err(walks[0].numpy(), walks[1].numpy(),
                      f"int8 cut walk {p.sub}")
        worst = max(worst, err)
    return dict(int8_tree_equal_cpu=True, scales_equal_cpu=True,
                walk_max_rel_err=worst, tol=2e-2)


def phase_dist(torch, card):
    """Phase 15. (a) Full-width, full-depth qwen2-1.5b in bf16 from the
    seeded init: ``quantize_tree`` on the card (device ms), the bytes of
    the int8 tree and its scales against the bf16 tree, every leaf's
    dequantization within amax/254, the 2-unit cut bit for bit against
    the CPU and its walk against the CPU's fp32 walk
    (:func:`int8_cut_check`), then the int8 decode of the widest and the
    narrowest Pareto subnet against bf16 (:func:`int8_walks`). (b)
    Distribution under NCCL at world size 1 on a (1, 1) mesh: a 2-unit
    cut placed with ``plan.params``, ``seq_sharded_decode`` at the served
    decode shapes against the ``decode_attention`` kernel, the int8
    all-reduce against ``ef_quantize``, a checkpoint saved and restored
    with shardings bit for bit. (c) The dry-run cells of DRYRUN_CELLS on
    this machine's torch (:func:`finish_dryruns`). Returns the kernel
    launches of (a)'s walks."""
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.core import operators as ops
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import pareto_subnets
    from repro_torch.models import lm
    from repro_torch.serving import quantize as QZ
    procs = start_dryruns()
    secs = {}
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(7),
                           "cuda")
    q, sc = QZ.quantize_tree(params)
    quant_ms = device_ms(torch, lambda: QZ.quantize_tree(params), n=2)
    bf16_bytes = QZ.quantized_bytes(params)
    int8_bytes = QZ.quantized_bytes(q) + QZ.quantized_bytes(sc)
    n_int8, worst_bound = 0, 0.0
    for a, qv, s in zip(_leaves(params), _leaves(q), _leaves(sc)):
        if qv.dtype != torch.int8:
            if not torch.equal(qv, a):
                fail("int8: a leaf that is not quantized changed")
            continue
        n_int8 += 1
        f = a.float()
        amax = f.abs().amax(dim=tuple(range(f.dim() - 1)), keepdim=True)
        err = (f - qv.float() * s).abs()
        if bool((err > amax / 254 + 1e-7).any()):
            fail("int8: a dequantized leaf strays past amax/254")
        worst_bound = max(worst_bound, float((err / (amax / 254 + 1e-12))
                                             .max()))
        del f, amax, err
    ratio = int8_bytes / bf16_bytes
    if not ratio < 0.65:
        fail(f"int8: tree plus scales {ratio:.4f} of the bf16 bytes")
    secs["quantize"] = time.perf_counter() - t0
    say("dist-int8", arch=cfg.name, params=sum(t.numel() for t in
                                                 _leaves(params)),
        bf16_gb=bf16_bytes / 1e9, int8_gb=int8_bytes / 1e9,
        byte_ratio=ratio, leaves_quantized=n_int8,
        worst_err_over_bound=worst_bound, quantize_device_ms=quant_ms,
        card=card.name)
    t0 = time.perf_counter()
    cut = int8_cut_check(torch)
    secs["cut"] = time.perf_counter() - t0
    say("dist-int8-cut", **cut)
    t0 = time.perf_counter()
    pts = pareto_subnets(cfg)
    ctrls = [ops.device_control(sn.make_control(cfg, p.sub), "cuda")
             for p in (pts[-1], pts[0])]
    deq_ms = device_ms(torch, lambda: QZ.dequantize_tree(q, sc), n=2)
    with torch.no_grad():
        int8_walks(torch, cfg, params, q, sc, ctrls[:1], steps=1)  # warm
        torch.cuda.synchronize()
        compat.reset_launch_counts()
        with compat.BuildCounter() as bc:
            rows = int8_walks(torch, cfg, params, q, sc, ctrls)
        launches = compat.launch_counts()
    if bc.count:
        fail(f"int8 walks built {bc.count} kernels after warmup")
    for name in ("subnet_rmsnorm", "flash_attention", "decode_attention"):
        if launches.get(name, 0) <= 0:
            fail(f"int8 walks never launched {name}")
    secs["walks"] = time.perf_counter() - t0
    for row, p in zip(rows, (pts[-1], pts[0])):
        share = (deq_ms / row["int8_device_ms"]
                 if isinstance(deq_ms, float)
                 and isinstance(row["int8_device_ms"], float) else None)
        say("dist-int8-decode", subnet=str(p.sub), dequantize_device_ms=deq_ms,
            dequantize_share=share, **row)
    del params, q, sc
    _free(torch)
    t0 = time.perf_counter()
    nccl = nccl_world1(torch)
    secs["nccl"] = time.perf_counter() - t0
    say("dist-nccl", **nccl)
    t0 = time.perf_counter()
    finish_dryruns(procs)
    secs["dryrun_wait"] = time.perf_counter() - t0
    say("dist", launches=launches, seconds=secs)
    return [launches]


def nccl_world1(torch):
    """Phase 15b: ``torch.distributed`` with the NCCL backend at world size
    1 (one card: NCCL takes no second rank on the same device). Not a
    multi-card result; the numbers of many ranks are held on the CPU under
    gloo (``tests/test_torch_dist.py``)."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import collectives, elastic
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import compress
    from repro_torch.training import optimizer as opt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        cfg, gpu, _, _ = depth_cut(torch, "qwen2-1.5b", seed=11)
        plan = ShardingPlan(mesh, cfg)
        placed = elastic.reshard_params(gpu, plan)
        for a, b in zip(_leaves(gpu), _leaves(placed)):
            if not torch.equal(b.full_tensor(), a):
                fail("nccl: a placed leaf differs from its source")
        # the served decode shapes against the decode kernel
        gen = torch.Generator(device="cuda").manual_seed(12)
        B, Hq, Hkv, d, smax, index = 8, 12, 2, 128, 2048, 1500
        qd = torch.randn((B, Hq, 1, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        kc, vc = (torch.randn((B, Hkv, smax, d), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        want = kops.decode_attention(qd, kc, vc, torch.full(
            (), index, dtype=torch.int32, device="cuda"))
        kd, vd = (distribute_tensor(t, mesh, [Shard(2), Replicate()])
                  for t in (kc, vc))
        got = collectives.seq_sharded_decode(mesh, qd, kd, vd, index)
        seq_err = rel_err(got.float().cpu().numpy(),
                          want.float().cpu().numpy(),
                          "nccl seq_sharded_decode")
        # the int8 all-reduce of a gradient tree
        grads = {k: torch.randn(v.shape, generator=gen, device="cuda")
                 for k, v in gpu["backbone"]["stages"][0]["0:attn"].items()}
        err0 = {k: torch.zeros_like(v) for k, v in grads.items()}
        mean, new_err = compress.all_reduce_int8(mesh, grads, err0)
        for k in grads:
            qv, s, e = compress.ef_quantize(grads[k], err0[k])
            if not (torch.equal(mean[k], compress.dequantize(qv, s))
                    and torch.equal(new_err[k], e)):
                fail(f"nccl: all_reduce_int8 of {k} is not ef_quantize's")
        # a checkpoint saved and restored onto the plan's placements
        tree = {"params": placed, "opt": opt.init(gpu)}
        t0 = time.perf_counter()
        ckpt.save(os.path.join(tmp, "ckpt"), 1, tree, extra={"step": 1})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = ckpt.restore(
            os.path.join(tmp, "ckpt"), {"params": gpu, "opt": opt.init(gpu)},
            shardings={"params": plan.params(gpu),
                       "opt": opt.state_shardings(plan, gpu)}, mesh=mesh)
        restore_s = time.perf_counter() - t0
        for a, b in zip(_leaves(gpu), _leaves(back["params"])):
            if not torch.equal(b.full_tensor(), a):
                fail("nccl: a restored leaf differs from the saved one")
        return dict(backend=dist.get_backend(), world_size=dist.get_world_size(),
                    mesh=[1, 1], placed_equal=True, seq_decode_rel_err=seq_err,
                    seq_decode_tol=2e-2, all_reduce_int8_equal=True,
                    restore_bit_equal=True, save_s=save_s,
                    restore_s=restore_s,
                    note="world size 1 on one card: not a multi-card result")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------


SOURCES = {
    "subnet_rmsnorm": ("cuda", "src/repro_torch/csrc/subnet_rmsnorm.cu",
                       "src/repro/kernels/subnet_rmsnorm.py:42"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:100"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:91"),
    "sliced_matmul": ("cuda", "src/repro_torch/csrc/sliced_matmul.cu",
                      "src/repro/kernels/sliced_matmul.py:83"),
}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from "
              f"the repository root", file=sys.stderr)
        return 3
    card = Card(torch)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say("seconds", phase=name, seconds=time.perf_counter() - t0)
        return out

    timed("build", phase_build, torch, card)
    if "--dist" in argv:        # phase 15 alone, after the build
        timed("dist", phase_dist, torch, card)
        return 0
    if "--graphs" in argv:      # phase 5b alone, after the build
        timed("graphs", phase_graphs, torch, card,
              [a for a in argv if not a.startswith("--")])
        return 0
    kernels = timed("kernels", phase_kernels, torch, card)
    if "--quick" in argv:
        return 0
    serve_launches, pacing = timed("serve", phase_serve, torch)
    path_launches = [serve_launches,
                     timed("decode", phase_decode, torch),
                     timed("switch", phase_switch, torch)]
    path_launches += timed("graphs", phase_graphs, torch, card)
    timed("trace", phase_trace, torch)
    timed("reference", phase_reference, torch)
    path_launches += timed("configs", phase_configs, torch, card)
    path_launches += timed("moe", phase_moe, torch, card)
    path_launches += timed("ssm", phase_ssm, torch, card)
    path_launches += timed("plane", phase_plane, torch, pacing)
    path_launches += timed("train", phase_train, torch)
    path_launches += timed("conv", phase_conv, torch, card)
    path_launches += timed("frontends", phase_frontends, torch, card)
    path_launches += timed("dist", phase_dist, torch, card)
    line = []
    for name in PATH_KERNELS:
        route, source, replaces = SOURCES[name]
        k = kernels[name]
        # the grouped sliced_matmul counts under a name of its own
        keys = (name, GROUPED) if name == "sliced_matmul" else (name,)
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces,
                 "launches": sum(n.get(key, 0) for n in path_launches
                                 for key in keys),
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"],
                 "library_ms": k["library_ms"]}
        if "head_dims" in k:
            # the same numbers at the other configs' heads (CONFIG_HEADS)
            entry["head_dims"] = {
                key: {f: row[f] for f in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "device_ms",
                    "library_device_ms")}
                for key, row in k["head_dims"].items()}
        if "experts" in k:
            # over a stack of experts (EXPERT_STACKS), one launch for all;
            # its launches are part of the entry's
            entry["experts_launches"] = sum(n.get(GROUPED, 0)
                                            for n in path_launches)
            entry["experts"] = {
                key: {f: row[f] for f in (
                    "shape", "width", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "device_ms",
                    "library_device_ms")}
                for key, row in k["experts"].items()}
        line.append(entry)
    if any(e["launches"] <= 0 for e in line):
        fail("a kernel of the path was never launched")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
