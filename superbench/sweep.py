"""Find a cell's SLO and knee once on the card (not part of a run).

    python3 superbench/sweep.py --workload <name> [--seconds 6]
        [--fractions 0.3,0.5,... | --rates 300,400,...] [--repeat 3]
        [--slo-ms 45]

Builds the cell as a run does (``run.build``), prints its measured
profile and the SLO rule's value: 1.25x the widest subnet's latency at
the largest batch, rounded up to 5 ms. The widest subnet's largest batch
then fits a whole SLO, but not behind another step: under load SlackFit
has to trade width and depth for time. Then serves the cell's traffic
with that SLO (or ``--slo-ms``) at each rate, or each fraction of the
profile's best throughput (the largest batch over its latency, over the
subnets), ``--repeat`` windows a rate on successive seeds, each window
through a fresh router, and prints one JSON line a window: attainment,
accuracy, the subnets served, p99, drops, and whether the queue grew
(the median queue wait of the last third of the window over the first
third). The knee is the
highest rate whose attainment is at least 99% in every window, with a
queue that does not grow; the cell runs at 4/5 of it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

from superbench import run, serve, spec  # noqa: E402
from superbench.stats import met, percentile, served  # noqa: E402

# the SLO over the widest subnet's latency at the largest batch
SLO_RULE = 1.25


def growth(window) -> float:
    """Median queue wait (ms) of the window's last third over its first."""
    steps = window.steps
    qs = [q for q in window.queries if q.step is not None]
    third = window.seconds / 3
    early = [steps[q.step].t0 - q.due for q in qs
             if q.due < window.start + third]
    late = [steps[q.step].t0 - q.due for q in qs
            if q.due >= window.end - third]
    if not early or not late:
        return float("nan")
    return float(np.median(late) / max(np.median(early), 1e-6))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=20260)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fractions", default="0.3,0.45,0.6,0.7,0.8,0.9,1.0,"
                                           "1.1,1.25")
    ap.add_argument("--rates", default="",
                    help="rates in q/s, in place of --fractions")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="the SLO, in place of the rule's")
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows a rate, each with the next seed")
    args = ap.parse_args(argv)
    import torch
    bench = spec.benchmark()
    entry = spec.workload(args.workload, bench)
    cell = spec.cell(args.workload)
    arch = spec.config(entry["config"], bench)
    dev = torch.device("cuda")
    params, ex, profile = run.build(arch, cell, args.seed, dev)
    lat = profile.lat
    widest = int(np.argmax(profile.accs))
    rule_ms = 5 * math.ceil(SLO_RULE * lat[widest, -1] * 1e3 / 5)
    slo_ms = args.slo_ms or rule_ms
    best = max(profile.batches[j] / lat[i, j] for i in range(len(lat))
               for j in range(lat.shape[1]))
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(dev),
                      "power_limit": run.power_limit(),
                      "batches": list(profile.batches),
                      "lat_ms": (lat * 1e3).round(3).tolist(),
                      "slo_rule_ms": rule_ms, "slo_ms": slo_ms,
                      "best_qps": best}), flush=True)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [float(f) * best for f in args.fractions.split(",")])
    for rate, k in [(r, k) for r in rates for k in range(args.repeat)]:
        frac = rate / best
        c = dict(cell, rate_qps=rate, slo_ms=slo_ms)
        tr = run.traffic(c, args.seconds, args.seed + k, arch["vocab_size"])
        w = serve.run_window(ex, profile, c, tr, tr["tokens"], args.seed + k,
                             0)
        qs = w.queries
        ok = [q for q in qs if met(q)]
        steps = w.window_steps()
        print(json.dumps({
            "fraction": frac, "rate_qps": rate, "seed": args.seed + k,
            "queries": len(qs),
            "attainment": sum(map(met, qs)) / len(qs),
            "dropped": sum(q.dropped for q in qs),
            "mean_acc": (float(np.mean([arch["pareto"][w.steps[q.step].subnet]
                                        ["acc"] for q in ok]))
                         if ok else None),
            "p99_ms": percentile([(q.finish - q.due) * 1e3 for q in qs
                                  if served(q)], 99),
            "p50_ms": percentile([(q.finish - q.due) * 1e3 for q in qs
                                  if served(q)], 50),
            "subnets": len({s.subnet for s in steps}),
            "mean_batch": float(np.mean([s.rows for s in steps])),
            "steps": len(steps), "queue_growth": growth(w),
            "builds": w.builds, "captures": w.captures}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
