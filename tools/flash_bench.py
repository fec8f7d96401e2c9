#!/usr/bin/env python3
"""Times the port's ``flash_attention`` on one CUDA device, for one
checkout of the port, so that two commits compare in one call on one card:

    python tools/flash_bench.py [--src DIR] [--head-dim D] [--heads Q,KV]
                                [--plans] [--trace]

At qwen2-1.5b's heads (12 query over 2 kv heads, head_dim 128; with
``--head-dim 80`` stablelm-3b's 32 over 32, with ``--head-dim 120``
h2o-danube-3-4b's 32 over 8; ``--heads 40,8`` with
head_dim 128 takes qwen2.5-14b's), B = 8 and S = 16, 256 and 2048 (causal,
random bf16 inputs from a seeded generator): the kernel's device ms from
torch.profiler beside SDPA's (``scaled_dot_product_attention`` on k/v
repeated per query head, a yardstick only) and the bound (bytes of q, k,
v and o, and the causal tensor operations, at the real head_dim), and
the wrapper's host us per call at S = 16 (calls
enqueued back to back; the least mean of 10 rounds of 200). Then the digest
of ``sliced_matmul``'s outputs on fixed inputs
(``chip_smoke.sliced_digest``). Prints one JSON line.

``--plans`` adds, at each S, the device ms of every packing of query heads
and positions into a block that the kernel takes
(``kernels.flash_attention.Plan``) and its max |difference| from the
wrapper's own packing. ``--trace`` then runs ``chip_smoke``'s trace phase
(full-width qwen2-1.5b prefills and a decode step, each port kernel's
device ms) on the same package. ``--src`` is the ``src`` directory to
import ``repro_torch`` from (default: this checkout's); the kernels build
under that checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (helpers only: it imports no kernel here)


# (query heads, kv heads) of a config with each head_dim
HEADS = {80: (32, 32), 120: (32, 8), 128: (12, 2)}


def _plans(Sq: int, G: int):
    """Every packing of 16 to 64 positions and a divisor of G heads that
    fits a block's 64 rows, with kv tiles of 32 or 64 keys."""
    from repro_torch.kernels import flash_attention as fa
    return [fa.Plan(np_, nh, kt) for np_ in (16, 32, 64)
            if np_ <= max(16, -(-Sq // 8) * 8)
            for nh in range(1, G + 1) if G % nh == 0 and nh * np_ <= fa.ROWS
            for kt in (32, 64)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--head-dim", type=int, default=128,
                    choices=sorted(HEADS))
    ap.add_argument("--heads", default=None,
                    help="query,kv heads (default: those of --head-dim's "
                         "config)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    card = chip_smoke.Card(torch)
    hd = args.head_dim
    B, (Hq, Hkv) = 8, (HEADS[hd] if args.heads is None else
                   tuple(map(int, args.heads.split(","))))
    G = Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": str(Path(fa.__file__).resolve().parents[2]),
           "device": torch.cuda.get_device_name(0),
           "heads": [Hq, Hkv, hd]}
    for S in (16, 256, 2048):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, Hq, S, hd), (B, Hkv, S, hd),
                                 (B, Hkv, S, hd)))
        kx, vx = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        bound, by = chip_smoke.flash_bound(card, B, Hq, Hkv, S, hd)
        row = {"device_ms": chip_smoke.device_ms(
                   torch, lambda: fa.flash_attention(q, k, v)),
               "sdpa_device_ms": chip_smoke.device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q, kx, vx, is_causal=True)),
               "bound_ms": bound, "bound_by": by}
        if S == 16:
            row["host_us"] = chip_smoke.host_us(
                torch, lambda: fa.flash_attention(q, k, v), rounds=10)
        if args.plans:
            # each packing's device ms and its max |difference| from the
            # wrapper's own packing
            want = fa.flash_attention(q, k, v).float()
            row["plans"] = {}
            for p in _plans(S, G):
                def run(p=p):
                    return fa._launch(q, k, v, True, 0, (None, S), (None, -1),
                                      p)
                err = (run().float() - want).abs().max().item()
                row["plans"][",".join(map(str, p))] = [
                    chip_smoke.device_ms(torch, run), err]
        out[f"S{S}"] = row
    out["sliced_digest"] = chip_smoke.sliced_digest(torch)
    print(json.dumps(out), flush=True)
    if args.trace:
        chip_smoke.phase_trace(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
