#!/usr/bin/env python3
"""Times the port's ``decode_attention`` on one CUDA device, for one
checkout of the port, so that two commits compare in one call on one card:

    python tools/decode_bench.py [--src DIR] [--head-dim D] [--heads Q,KV]
                                 [--plans] [--trace]

At qwen2-1.5b's heads (12 query over 2 kv heads, head_dim 128; with
``--head-dim 80`` stablelm-3b's 32 over 32, with ``--head-dim 120``
h2o-danube-3-4b's 32 over 8; ``--heads 40,8`` with
head_dim 128 takes qwen2.5-14b's), B = 8
(``--batch``), caches of Smax = 16 (index 3, the trace's decode step),
64, 128 and 256 (index Smax - 1) and 2048 (index 2047 and 1023), random
bf16 inputs from a seeded generator: the kernel's device ms and device
kernels a call from torch.profiler, beside masked SDPA's
(``scaled_dot_product_attention`` on k/v repeated per query head, a
yardstick only) and the bound (bytes of q, the live K and V and the
output over the card's memory rate); max |error| against the plain
version; and the wrapper's host us per call at B = 8, Smax 256 (calls
enqueued back to back; the least mean of 10 rounds of 200). Prints one
JSON line.

``--shapes`` replaces the caches (``Smax:index`` pairs). ``--plans``
adds, at each shape, the device ms of every plan the kernel takes
(``kernels.decode_attention.Plan``: least chunk, ring depth, blocks an
SM) and its max |difference| from the wrapper's own plan (a checkout
without ``Plan`` has none to try). ``--trace`` then runs ``chip_smoke``'s
trace phase (full-width qwen2-1.5b prefills and a decode step, each port
kernel's device ms, the older two-kernel decode's symbols included) on
the same package. ``--src`` is the ``src`` directory to import
``repro_torch`` from (default: this checkout's); the kernels build under
that checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (helpers only: it imports no kernel here)

SHAPES = ((16, 3), (64, 63), (128, 127), (256, 255), (2048, 2047),
          (2048, 1023))
OLD_SYMBOLS = ("decode_split_kernel", "decode_combine_kernel")
# (query heads, kv heads) of a config with each head_dim
HEADS = {80: (32, 32), 120: (32, 8), 128: (12, 2)}


def _kernels_per_call(torch, fn, n: int = 3) -> int:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == torch.autograd.DeviceType.CUDA
               for ev in prof.events()) // n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128,
                    choices=sorted(HEADS))
    ap.add_argument("--heads", default=None,
                    help="query,kv heads (default: those of --head-dim's "
                         "config)")
    ap.add_argument("--shapes", default=None,
                    help="Smax:index pairs, comma-separated (default: "
                         + ",".join(f"{s}:{i}" for s, i in SHAPES) + ")")
    args = ap.parse_args(argv)
    shapes = SHAPES if args.shapes is None else tuple(
        tuple(map(int, p.split(":"))) for p in args.shapes.split(","))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    card = chip_smoke.Card(torch)
    hd = args.head_dim
    B, (Hq, Hkv) = args.batch, (HEADS[hd] if args.heads is None else
                   tuple(map(int, args.heads.split(","))))
    G = Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    out = {"src": str(Path(da.__file__).resolve().parents[2]),
           "device": torch.cuda.get_device_name(0), "batch": B,
           "heads": [Hq, Hkv, hd]}
    q = randn(B, Hq, 1, hd)
    for Smax, index in shapes:
        kc, vc = randn(B, Hkv, Smax, hd), randn(B, Hkv, Smax, hd)
        kx, vx = kc.repeat_interleave(G, dim=1), vc.repeat_interleave(G, dim=1)
        idx = torch.full((), index, dtype=torch.int32, device="cuda")
        mask = (torch.arange(Smax, device="cuda") <= index)[None, None, None]
        live = index + 1
        bound, by = chip_smoke.decode_bound(card, B, Hq, Hkv, live, hd)

        def run():
            return da.decode_attention(q, kc, vc, idx)
        want = da.decode_attention_plain(q, kc, vc, idx).float()
        row = {"device_ms": chip_smoke.device_ms(torch, run),
               "kernels_per_call": _kernels_per_call(torch, run),
               "max_abs_err": (run().float() - want).abs().max().item(),
               "sdpa_device_ms": chip_smoke.device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q, kx, vx, attn_mask=mask)),
               "bound_ms": bound, "bound_by": by}
        if isinstance(row["device_ms"], float):
            row["bound_share"] = bound / row["device_ms"]
        if Smax == 256 and B == 8:
            row["host_us"] = chip_smoke.host_us(torch, run, rounds=10)
        if args.plans and hasattr(da, "Plan"):
            # each plan's device ms and its max |difference| from the
            # wrapper's own plan
            mine = run().float()
            row["plans"] = {}
            for plan in itertools.starmap(da.Plan, itertools.product(
                    (16, 32, 64, 128), (2, 3), (1, 2))):
                o = torch.empty_like(q)

                def launch(plan=plan, o=o):
                    build.check(da.NAME,
                                da._launch(q, kc, vc, idx, o, 0, plan))
                    return o
                err = (launch().float() - mine).abs().max().item()
                row["plans"][",".join(map(str, plan))] = [
                    chip_smoke.device_ms(torch, launch), err]
        out[f"smax{Smax}_index{index}"] = row
        del kc, vc, kx, vx
    print(json.dumps(out), flush=True)
    if args.trace:
        chip_smoke.phase_trace(
            torch, symbols=chip_smoke.PORT_KERNEL_SYMBOLS + OLD_SYMBOLS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
