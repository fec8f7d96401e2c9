#!/usr/bin/env python3
"""Times the port's ``subnet_rmsnorm`` on one CUDA device, for one checkout
of the port, so that two commits compare in one call on one card:

    python tools/norm_bench.py [--src DIR] [--trace]

At qwen2-1.5b's width (d = 1536, 18 subnets, bf16) and 8, 128 and 2048
rows (a decode step, a B=8 S=16 prefill, a B=8 S=256 prefill), random
inputs from a seeded generator: the device ms of the standalone call and
of the residual add with the norm, device kernels a call (torch.profiler),
beside ``F.rms_norm`` with the gain row and ``torch.add`` then
``F.rms_norm`` (yardsticks only) and the bytes bound; max |error| against
the plain version; and the wrapper's host us per call (calls enqueued
back to back; the least mean of 10 rounds of 200). A checkout whose
wrapper has no fused form (``add_subnet_rmsnorm``) times its add as
``torch.add`` then its norm, which is what its model runs. Prints one
JSON line.

``--trace`` then runs ``chip_smoke``'s trace phase (full-width qwen2-1.5b
prefills and a decode step, each port kernel's device ms and launches,
the device kernels and ``aten::add`` calls a step, the Triton norm's
symbol included) on the same package. ``--src`` is the ``src`` directory
to import ``repro_torch`` from (default: this checkout's); the kernels
build under that checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (helpers only: it imports no kernel here)

ROWS = (8, 128, 2048)
OLD_SYMBOLS = ("_rmsnorm_rows",)


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
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("norm_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import subnet_rmsnorm as rn
    card = chip_smoke.Card(torch)
    d, n_sub = 1536, 18
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    gamma = 1 + 0.1 * randn(n_sub, d, dtype=torch.float32)
    sid = torch.full((), n_sub - 1, dtype=torch.int32, device="cuda")
    w_row = gamma[n_sub - 1].bfloat16()
    fused_form = getattr(rn, "add_subnet_rmsnorm", None)
    out = {"src": str(Path(rn.__file__).resolve().parents[2]),
           "device": torch.cuda.get_device_name(0),
           "fused_form": fused_form is not None}
    for rows in ROWS:
        x, delta = randn(rows, d), randn(rows, d)

        def alone():
            return rn.subnet_rmsnorm(x, gamma, sid)

        def fused():
            if fused_form is not None:
                return fused_form(x, delta, gamma, sid)
            s = x + delta
            return s, rn.subnet_rmsnorm(s, gamma, sid)
        want = rn.subnet_rmsnorm_plain(x + delta, gamma, sid).float()
        row = {}
        for form, fn, lib in (
                ("standalone", alone,
                 lambda: F.rms_norm(x, (d,), w_row, 1e-5)),
                ("fused", fused,
                 lambda: F.rms_norm(torch.add(x, delta), (d,), w_row, 1e-5))):
            bound, by = chip_smoke.norm_bound(card, rows, d,
                                              form == "fused")
            r = {"device_ms": chip_smoke.device_ms(torch, fn),
                 "kernels_per_call": _kernels_per_call(torch, fn),
                 "library_device_ms": chip_smoke.device_ms(torch, lib),
                 "bound_ms": bound, "bound_by": by,
                 "host_us": chip_smoke.host_us(torch, fn, rounds=10)}
            if isinstance(r["device_ms"], float):
                r["bound_share"] = bound / r["device_ms"]
            row[form] = r
        s, h = fused()
        row["fused"]["s_is_x_plus_delta"] = bool(torch.equal(s, x + delta))
        row["fused"]["max_abs_err"] = (h.float() - want).abs().max().item()
        out[f"rows{rows}"] = row
    print(json.dumps(out), flush=True)
    if args.trace:
        chip_smoke.phase_trace(
            torch, symbols=chip_smoke.PORT_KERNEL_SYMBOLS + OLD_SYMBOLS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
