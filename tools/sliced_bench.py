#!/usr/bin/env python3
"""Times the port's ``sliced_matmul`` on one CUDA device at every shape the
benchmark's cells serve, for one checkout of the port, so that two commits
compare in one call on one card:

    python tools/sliced_bench.py [--src DIR] [--tiles] [--yardsticks]
                                 [--only qwen2|mixtral]

Shapes (bf16, full width, random inputs from a seeded generator):
qwen2-1.5b's switch-mode products of a 128-token prefill of Bb = 1-32
queries (M = 128 Bb rows): FFN gate/up (1536 -> 8960), down (8960 ->
1536) and ``wo`` (2 segments of 768 -> 1536); mixtral-8x7b's expert
stacks (8 experts, C = 40-640 capacity slots) up (4096 -> 14336) and down
(14336 -> 4096), and its ``wo`` (8 segments of 512 -> 4096) at M = 128 Bb
for Bb = 1-16. Each shape's device ms: ``n`` launches captured in one CUDA
graph, as the executor replays them, weights rotating over copies that
exceed the 50 MB L2, the median of the replays' CUDA-event times over
``n``. ``pick_ms`` is the wrapper as it stands (the tile it picks, in
``tile``); ``--half`` adds each product at half its FFN or head width;
``--tiles`` adds each tile the checkout has, forced (``ms_by_tile``), the
wide tile's max |error| against the 128-column tile's output, whether
the two agree bit for bit, and whether the wide tile repeats its bits.
``--yardsticks`` adds, at the full-width burst shapes (M >= 1024, C >=
320), ``torch.matmul`` / ``torch.bmm`` on the whole operands and the
plain version (CUDA events, eager), with the pick's max |error| against
the plain version. Every line carries the bound
(``chip_smoke.Card``: FLOPs over the card's bf16 peak or bytes over its
memory rate, the larger). Prints one JSON line a shape, then one line
with the card's name and power limit.

``--src`` is the ``src`` directory to import ``repro_torch`` from (default:
this checkout's); the kernels build under that checkout's ``build/``. A
checkout without ``_sliced_matmul`` (one tile) times its wrapper only.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (helpers only: it imports no kernel here)

L2_BYTES = 50 * 2 ** 20


def shapes(only, half: bool):
    """(cell, label, E, M, K, N, segments, active_in, active_out): E = 0
    for a 2-d product; the full width, and with ``half`` also half the FFN
    or head width."""
    def both(cell, kind, E, M, K, N, nseg):
        seg = K // nseg
        out = [(cell, f"{kind} {'C' if E else 'M'}={M}", E, M, K, N, nseg,
                None, None)]
        if half:
            ai, ao = (None, N // 2) if kind == "up" else (seg // 2, None)
            out.append((cell, f"{kind} {'C' if E else 'M'}={M} half", E, M,
                        K, N, nseg, ai, ao))
        return out
    out = []
    if only in (None, "qwen2"):
        for bb in (1, 2, 4, 8, 16, 32):
            M = 128 * bb
            out += (both("qwen2", "up", 0, M, 1536, 8960, 1)
                    + both("qwen2", "down", 0, M, 8960, 1536, 1)
                    + both("qwen2", "wo", 0, M, 1536, 1536, 2))
    if only in (None, "mixtral"):
        for bb in (1, 2, 4, 8, 16):
            C = max(8, -(-(128 * bb * 2 * 5 // 4 // 8) // 8) * 8)
            out += (both("mixtral", "up", 8, C, 4096, 14336, 1)
                    + both("mixtral", "down", 8, C, 14336, 4096, 1)
                    + both("mixtral", "wo", 0, 128 * bb, 4096, 4096, 8))
    return out


def graph_ms(torch, fn, n: int = 20, replays: int = 7) -> float:
    """Device ms a call of ``fn``: ``n`` calls captured in one CUDA graph
    (after two eager calls on the capture stream, which size the scratch),
    the median of ``replays`` replays timed by CUDA events, over ``n``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        fn()
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del g
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--yardsticks", action="store_true")
    ap.add_argument("--only", choices=("qwen2", "mixtral"))
    ap.add_argument("--half", action="store_true",
                    help="also each product at half its FFN or head width")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import sliced_matmul as sm
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.library()
    card = chip_smoke.Card(torch)
    for line in build.ptxas_log().splitlines():
        if "sliced_matmul_kernel" in line or (
                "Used" in line and "registers" in line and "sliced" in line):
            print(json.dumps({"ptxas": line.strip()}), flush=True)
    tiles = ()
    if args.tiles and hasattr(sm, "_sliced_matmul"):
        tiles = (sm.BN, sm.BN_WIDE)
    gen = torch.Generator(device="cuda").manual_seed(30)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for cell, label, E, M, K, N, nseg, ai, ao in shapes(args.only,
                                                        args.half):
        xs = (E,) if E else ()
        wbytes = 2 * max(E, 1) * K * N
        copies = max(1, -(-2 * L2_BYTES // wbytes))
        x = randn(*xs, M, K)
        ws = [randn(*xs, K, N) for _ in range(copies)]
        it = itertools.cycle(ws)

        a = None if ai is None else torch.full((), ai, dtype=torch.int32,
                                              device=dev)
        b = None if ao is None else torch.full((), ao, dtype=torch.int32,
                                              device=dev)

        def call(bn=None, w=None):
            w = next(it) if w is None else w
            if bn is None:
                return sm.sliced_matmul(x, w, a, b, segments=nseg)
            return sm._sliced_matmul(x, w, a, b, nseg, bn)
        row = dict(cell=cell, shape=label, E=E, M=M, K=K, N=N, segments=nseg,
                   active_in=ai, active_out=ao, weight_copies=copies)
        e, kin = max(E, 1), K if ai is None else ai * nseg
        kout = N if ao is None else ao
        row["bound_ms"], row["bound_by"] = card.bound(
            2 * e * (M * kin + kin * kout + M * N), 2 * e * M * kin * kout)
        if hasattr(sm, "block_cols"):
            row["tile"] = [sm.block_rows(M), sm.block_cols(
                M, N, K, nseg, max(E, 1), sm.grid_size(x.device))]
        else:
            row["tile"] = [sm.block_rows(M), sm.BN]
        row["pick_ms"] = graph_ms(torch, call)
        if tiles:
            row["ms_by_tile"] = {}
            ref = call(sm.BN, ws[0])
            for bn in tiles:
                if bn == sm.BN_WIDE and sm.block_rows(M) < 128:
                    continue
                row["ms_by_tile"][bn] = graph_ms(torch, lambda: call(bn))
                if bn == sm.BN_WIDE:
                    got = call(bn, ws[0])
                    row["wide_vs_128_max_abs"] = float(
                        (got.float() - ref.float()).abs().max())
                    row["wide_bitwise_128"] = bool(torch.equal(got, ref))
                    row["wide_repeats_its_bits"] = bool(torch.equal(
                        got, call(bn, ws[0])))
                    del got
            del ref
        if args.yardsticks and ai is None and ao is None and (
                M >= (320 if E else 1024)):
            w = ws[0]
            fn = torch.bmm if E else torch.matmul
            row["library_ms"] = graph_ms(torch, lambda: fn(x, next(it)))
            want = sm.sliced_matmul_plain(x, w, None, None, segments=nseg)
            row["plain_ms"] = chip_smoke.time_ms(
                torch, lambda: sm.sliced_matmul_plain(
                    x, w, None, None, segments=nseg), iters=3, warmup=1)
            row["pick_vs_plain_max_abs"] = float(
                (call(None, w).float() - want.float()).abs().max())
            del want
        print(json.dumps(row), flush=True)
        del x, ws, it
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(),
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
