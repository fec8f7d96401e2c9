#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks only

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
   cases (G = 1, 5, 6, 8; B = 1, 8; Smax = 16, 32, 256, 2048; every index
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
   G = 5 and G = 4): the same case checks, and device ms beside SDPA and
   the bound counted at the real head_dim. ``sliced_matmul`` over a stack
   of experts (``EXPERT_STACKS``: mixtral's 8 experts of 4096 x 14336 at
   C = 8 and 40 rows, llama4's 128 of 5120 x 8192 at C = 8; up and down
   at each width): against the plain version, zeros past active_out,
   bitwise repeats, one device kernel a call, device ms beside
   ``torch.bmm`` on the active block and the bound.
3. Serve: ``repro_torch.launch.serve`` at the full width and depth of
   qwen2-1.5b (random weights from a seeded ``torch.Generator``), SlackFit
   through the port's Router; every query must be answered, the serve
   phase must build no kernel, and every kernel must have launched.
4. Decode: 8 greedy ``SubnetExecutor.decode_step`` steps for the smallest
   and the largest Pareto subnet; finite logits, decode kernel launched.
5. Switch: WeightSlice switch mode on the same full-width weights as a
   mask-mode executor: prefill logits (B=8, S=16) of all 18 Pareto
   subnets against mask mode, 8 decode steps of the smallest and largest
   subnet against mask mode, then ``launch.serve --slice-mode switch``
   (32 queries, SlackFit): every query answered, no build, and
   ``sliced_matmul`` launched.
6. Trace: where a warmed full-width prefill and decode step spend their
   time (host wall clock, device kernel time from ``torch.profiler``, the
   device's idle share, the device kernels and ``aten::add`` calls a
   step, the top kernels, the launches of each kernel),
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
   query served with no build; (b) two in-process replicas of one
   executor (``--replicas 2 --placement slack_aware``) in switch mode,
   each replica serving, ``sliced_matmul`` launched; (c) two replica
   child processes over socketpairs (``ClusterRouter(transport="proc",
   execute="real")``), each building the model on the card: each hello
   names the card, every query served, each child warm (0 builds) with
   flash and the norm launched in it, 4 completions held within 2e-2 of
   max |logit| to an in-process executor from the same seed at the
   subnet each reports, spawn-to-hello seconds, the frame's encode and
   decode ms and each child's step ms beside the in-process one; (d)
   ``--transport proc --listen 127.0.0.1:0 --autoscale`` (1 to 2
   children over TCP): every query accounted for, every child warm, the
   scale events printed; (e) ``--execute sim --profile measured
   --replicas 4``: the profile measured on the card, positive and not
   falling with batch.

Each phase prints its seconds. Then one JSON line with every kernel's
numbers (the attention kernels' also at each head_dim of phase 8), and
last the device line.
Exits non-zero, with no result line, when CUDA is unavailable, the port is
missing, or any phase fails.
"""
from __future__ import annotations

import itertools
import json
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


def device_ms(torch, fn, n: int = 20):
    """The device's own kernel time per call of ``fn``, from
    torch.profiler (for the small kernels the CUDA-event time of
    :func:`time_ms` is the host's launch rate). A trace holding fewer than
    ``n`` launches of its most frequent kernel lost events and would read
    low: it is taken again, and after three "not measured"."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):                # a trace that lost events: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us, names = 0.0, Counter()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if t is None else t
                names[ev.name] += 1
        if us > 0 and max(names.values()) >= n:
            return us / n / 1e3
    return "not measured"


def device_kernels(torch, fn, n: int = 3):
    """The names of the device kernels that ``n`` calls of ``fn`` run, from
    torch.profiler. A trace that holds fewer device events than calls lost
    events (as :func:`device_ms` finds now and then; it cannot hide an
    extra kernel) and is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= n:
            return names
    return names


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
    errs = _decode_checks(torch, randn, (80, 120), (1, 4, 5), (16, 256, 4096))
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
                "128-G4": (128, 32, 8)}     # mixtral-8x7b, G = 4


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
    """decode_attention at d = 128 over G = 1, 5, 6, 8 (2 kv heads),
    Smax = 16, 32, 256 and 2048 (:func:`_decode_checks`), then at
    qwen2-1.5b's heads (12 over 2), B = 8, :func:`_decode_rows` at Smax 16
    (index 3, the trace's decode step), 256 (index 255) and 2048 (index
    2047 and 1023). Returns the Smax = 256 row (the headline)."""
    errs = _decode_checks(torch, randn, (128,), (1, 5, 6, 8),
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


def _sliced_cases(torch, card, randn):
    """sliced_matmul at the switch path's shapes (qwen2-1.5b: FFN gate/up
    (M,1536)x(1536,8960), FFN down (M,8960)x(8960,1536), wo as 2 K
    segments of 768, M = 128 prefill rows and 8 decode rows; M = 2048, a
    prefill of B=8, S=256, reported only) and at awkward ones: 7 rows, a
    partial K tile, a partial N tile, and per-group strided views. Widths
    are int32 tensors in device memory. Each case reports the blocks and
    splits of the kernel's plan (``split_plan``, the Python mirror of
    what the kernel works out on the card) and the wrapper's host
    microseconds per call; two launches must give the same bits. Returns
    the FFN-up case at M=128, full width (the headline)."""
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
              ("ffn_down M=2048 ai=8960", 2048, 8960, 1536, 8960, None, 1)]
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
        kin = (K // nseg if ai is None else ai) * nseg
        kout = N if ao is None else ao
        bound, by = card.bound(2 * (M * kin + kin * kout + M * N),
                               2 * M * kin * kout)
        ops = [(x, w) for w in ws]
        row = dict(
            shape=[M, K, N], active_in=ai, active_out=ao, segments=nseg,
            max_abs_err=err, ctas=plan.grid,
            busy_ctas=min(plan.grid, plan.units), tile=[plan.bm, sm.BN],
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


# the expert stacks of MoE switch mode: (config, E, d, f, capacities)
# with C = 8 at a decode step of B = 8 (the least capacity) and C = 40 at
# a mixtral prefill of B = 8, S = 16 (8 * 16 * 2 * 1.25 / 8)
EXPERT_STACKS = (("mixtral-8x7b", 8, 4096, 14336, (8, 40)),
                 ("llama4-maverick-400b-a17b", 128, 5120, 8192, (8,)))


def _grouped_cases(torch, card, randn):
    """``sliced_matmul`` over a stack of experts (x (E, C, K), w (E, K, N),
    one launch for all experts) at the expert shapes of mixtral-8x7b and
    llama4-maverick, for the up (gate) product (K = d, N = f, active_out =
    the width) and the down product (K = f, N = d, active_in = the width)
    at each ``moe_ffn`` width. Each case: against the plain version
    (BF16_TOL), columns past active_out exactly 0, two launches bitwise
    equal, one device kernel a call; device ms against ``torch.bmm`` on
    the active block and against the bound (bytes: the active weight
    block, x and y once). Returns the rows keyed by case."""
    from repro_torch.configs import get_config
    from repro_torch.core import subnet as sn
    from repro_torch.kernels import sliced_matmul as sm
    dev = "cuda"
    rows = {}
    for name, E, d, f, caps in EXPERT_STACKS:
        widths = sn.width_options(get_config(name))["moe_ffn"]
        for kind, K, N in (("up", d, f), ("down", f, d)):
            w = randn(E, K, N)
            for C, width in itertools.product(caps, widths):
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
                bound, by = card.bound(2 * E * (C * kin + kin * kout + C * N),
                                       2 * E * C * kin * kout)

                def library():
                    return torch.bmm(x[:, :, :kin], w[:, :kin, :kout])
                row = dict(
                    shape=[E, C, K, N], width=width, max_abs_err=err,
                    tile=[plan.bm, sm.BN], live_tiles=plan.live_tiles,
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
        serve_phase_builds=out["serve_phase_builds"])
    if out["size"] != "full":
        fail("serve did not run the full-width model")
    if out["queries"] < 1 or out["served"] != out["queries"]:
        fail(f"served {out['served']} of {out['queries']} queries")
    if out["serve_phase_builds"] != 0:
        fail(f"serve phase built {out['serve_phase_builds']} kernels")
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
        serve_phase_builds=out["serve_phase_builds"], **decode)
    if out["slice_mode"] != "switch" or out["size"] != "full":
        fail("switch serve did not run full-width switch mode")
    if out["queries"] < 1 or out["served"] != out["queries"]:
        fail(f"switch served {out['served']} of {out['queries']} queries")
    if out["serve_phase_builds"] != 0:
        fail(f"switch serve phase built {out['serve_phase_builds']} kernels")
    if out["kernel_launches"].get("sliced_matmul", 0) <= 0:
        fail("sliced_matmul never launched while serving in switch mode")
    return {k: parity_launches.get(k, 0) + serve_launches.get(k, 0)
            for k in set(parity_launches) | set(serve_launches)}


def phase_trace(torch, symbols=PORT_KERNEL_SYMBOLS):
    """Where a warmed full-width prefill (B=8, S=16, largest subnet), a
    decode step, and a switch-mode prefill of the widest and the narrowest
    full-depth subnet spend their time: host wall clock (median of 10,
    taken in rounds over the four) against device kernel time from
    torch.profiler, and the kernel launches of each; the device ms and
    launches of each kernel whose name holds one of ``symbols``
    (:func:`trace_steps`)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.executor import build_executor
    from repro_torch.core import subnet as sn
    from repro_torch.core.pareto import ParetoPoint
    from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
    cfg = get_config("qwen2-1.5b")
    ex = build_executor(cfg, seed=0, device="cuda")
    ex.warmup(batches=(8,), seqs=(16,), decode=True)
    # switch mode over the same weights: the widest subnet and the
    # narrowest at full depth (FFN 0.5, heads 0.5)
    narrow = next(s for s in sn.enumerate_space(cfg)
                  if (s.depth_frac, s.ffn_frac, s.head_frac) == (1.0, 0.5, 0.5))
    sw = SubnetExecutor(ex.params, cfg,
                        points=[ParetoPoint(sub, 0.0, 0.0, 0.0)
                                for sub in (sn.max_subnet(cfg), narrow)],
                        exec_cfg=ExecutorConfig(slice_mode="switch"))
    sw.warmup(batches=(8,), seqs=(16,))
    toks, idx = np.ones((8, 16), np.int32), ex.n_subnets - 1
    cache = ex.init_cache(8, 16)
    report = trace_steps(torch, {
        "prefill": lambda: ex.prefill(idx, toks),
        "decode": lambda: ex.decode_step(idx, toks[:, :1], cache, 3),
        "switch_prefill_widest": lambda: sw.prefill(0, toks),
        "switch_prefill_narrowest": lambda: sw.prefill(1, toks)}, symbols)
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
    kernel time from torch.profiler over ``n`` more, the device's idle
    share, device kernels and ``aten::add`` calls a step, the top kernels,
    and the device ms and launches of each kernel whose name holds one of
    ``symbols``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
        per_kernel, adds = {}, 0
        for ev in prof.events():
            adds += ev.name == "aten::add"
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                tot, cnt = per_kernel.get(ev.name, (0.0, 0))
                per_kernel[ev.name] = (tot + us, cnt + 1)
        dev_ms = sum(t for t, _ in per_kernel.values()) / n / 1e3
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        port = {}
        for name, (us, cnt) in per_kernel.items():
            for tag in symbols:
                if tag in name:
                    ms, c = port.get(tag, (0.0, 0))
                    port[tag] = (ms + us / n / 1e3, c + cnt // n)
        report[kind] = dict(
            wall_ms=wall_ms,
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
    ``cut`` of a few units (:func:`depth_cut`): prefill logits (B=2, S=16)
    and 4 decode steps, for the first and the last Pareto subnet, in mask
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
                lambda: lm.forward(gpu, cfg, {"tokens": toks}, ctrl,
                                   slice_mode=mode).float().cpu(),
                lambda: lm.forward(cpu, cfg32, {"tokens": toks}, ctrl,
                                   slice_mode=mode))
            want16 = None if cpu16 is None else lm.forward(
                cpu16, cfg, {"tokens": toks}, ctrl, slice_mode=mode)
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
        if out["serve_phase_builds"] != 0:
            fail(f"{name} {mode}: serve phase built "
                 f"{out['serve_phase_builds']} kernels")
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
    mask = SubnetExecutor(params, cfg)
    switch = SubnetExecutor(params, cfg,
                            exec_cfg=ExecutorConfig(slice_mode="switch"))
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
                            exec_cfg=ExecutorConfig(slice_mode="switch"))
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
                  "kernel_launches")
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
# steps a trace of phases 8-10 times and profiles (phase 6: 10); each
# profiled step of a 54-unit model holds about 4,000 device kernels
CONFIG_TRACE_STEPS = 5
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
    from torch.profiler import ProfilerActivity, profile
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

    step()
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    us = 0.0
    for ev in evs:
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
    return dict(tokens=h.shape[1], capacity=cap,
                device_kernels_per_layer=len(evs) / n,
                device_ms_per_layer=us / n / 1e3 if us else "not measured")


def fp32_oracle(torch, params, cfg, toks, ctrl, routes=(), flips=None):
    """The mask-mode logits of ``toks`` at every position in fp32 on the
    card: each layer's weights upcast as the walk reaches it (the bf16
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
        tokens = torch.as_tensor(toks, device=dev).long()
        B, S = tokens.shape
        positions = lm.default_positions(cfg, B, S, dev)
        pair, offset = (params["embed"][tokens].float(), None), 0
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
PLANE_SEED = 7
PLANE_CHECKED = 4                  # child completions held to the executor


def plane_pacing(lat_fast_ms: float, lat_slow_ms: float):
    """Rate (q/s) and SLO (ms) from phase 3's B = 1 latencies by the
    launcher's own rule: 0.25 / the smallest subnet's, 25x the
    largest's."""
    return 0.25 / (lat_fast_ms / 1e3), lat_slow_ms * 25


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
        "serve_phase_builds", "kernel_launches", "init_seconds",
        "warmup")})
    if out["size"] != "full" or out["units"] != 28:
        fail(f"plane {tag}: did not serve full-width qwen2-1.5b")
    if out["queries"] != queries or out["served"] != queries:
        fail(f"plane {tag}: served {out['served']} of {out['queries']}")
    if out["serve_phase_builds"] != 0:
        fail(f"plane {tag}: built {out['serve_phase_builds']} kernels")
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


def plane_children(torch, rate: float, slo_ms: float):
    """(c): two replica children over socketpairs, each building
    full-width qwen2-1.5b on the card; the coordinator's profile from the
    same config. Every query served, each child warm (0 builds) with the
    ported kernels launched in it, and PLANE_CHECKED completions held to
    an in-process executor from the same seed at the subnet each reports.
    Returns the children's launches."""
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
                           (PLANE_QUERIES, 16)).astype(np.int32)

    async def go():
        router = runtime.ClusterRouter(
            prof, policies.SlackFit(), [1, 1], transport="proc",
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
    if len(recs) != PLANE_QUERIES or served != PLANE_QUERIES:
        fail(f"plane children: served {served} of {len(recs)}")
    card = torch.cuda.get_device_name(0)
    launches = {}
    for c in children:
        if c["device_name"] != card or not c["devices"]:
            fail(f"child {c['rid']}: hello reports {c['device_name']!r}, "
                 f"{c['devices']} cards, not the card {card!r}")
        if c["kernel_builds"] != 0:
            fail(f"child {c['rid']}: {c['kernel_builds']} kernel "
                 f"builds after warmup")
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
        errs.append(rel_err(np.asarray(pred, np.float32), want,
                            f"child completion {i}"))
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
        tol="2e-2 of max|logit|", **frame_costs(cfg.vocab_size))
    del ex
    _free(torch)
    return launches


def phase_plane(torch, pacing):
    """Phase 11: the serving plane with full-width qwen2-1.5b at phase
    3's rate R and SLO S. Returns the kernel launches of each driven
    path (in-process and in the children)."""
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
    # (c) two child processes over socketpairs
    launches = [r["kernel_launches"] for r in runs]
    launches.append(plane_children(torch, rate, slo_ms))
    # (d) over TCP, autoscaled
    from repro_torch.launch import serve
    out = serve.run(["--transport", "proc", "--listen", "127.0.0.1:0",
                     "--execute", "real", "--arch", "qwen2-1.5b",
                     "--procs", "1", "--autoscale", "--min-replicas", "1",
                     "--max-replicas", "2", "--queries",
                     str(PLANE_QUERIES), "--seq-len", "16", "--seed",
                     str(PLANE_SEED), "--rate", repr(rate), "--slo-ms",
                     repr(slo_ms)])
    say("plane-tcp-autoscale", **{k: out.get(k) for k in (
        "queries", "served", "dropped", "slo_attainment", "mean_acc",
        "p50_latency_ms", "p99_latency_ms", "rate_qps", "slo_ms",
        "replicas_total", "replica_seconds", "scale_events",
        "handshake_rejects", "serve_phase_builds", "kernel_launches")},
        children=out["children"])
    if out["queries"] != PLANE_QUERIES \
            or out["served"] + out["dropped"] != PLANE_QUERIES:
        fail(f"plane tcp: {out['served']} served + {out['dropped']} "
             f"dropped of {out['queries']}")
    for c in out["children"]:
        if c["pid"] is not None and c["kernel_builds"] != 0:
            fail(f"plane tcp: child {c['rid']} reports "
                 f"{c['kernel_builds']} builds after warmup")
    if out["rate_qps"] != round(rate, 1) \
            or out["slo_ms"] != round(slo_ms, 3):
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
    kernels = timed("kernels", phase_kernels, torch, card)
    if "--quick" in argv:
        return 0
    serve_launches, pacing = timed("serve", phase_serve, torch)
    path_launches = [serve_launches,
                     timed("decode", phase_decode, torch),
                     timed("switch", phase_switch, torch)]
    timed("trace", phase_trace, torch)
    timed("reference", phase_reference, torch)
    path_launches += timed("configs", phase_configs, torch, card)
    path_launches += timed("moe", phase_moe, torch, card)
    path_launches += timed("ssm", phase_ssm, torch, card)
    path_launches += timed("plane", phase_plane, torch, pacing)
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
