"""Readings that set a cell's correctness limits, on the card (not part of
a run).

    python3 superbench/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 4]

Builds the cell once, then for each seed draws the weights again in
place (the executor's graphs read the same tensors), serves a short
window of the cell's traffic at its rate, and prints one JSON line: the
judge's readings of the program's served logits against the float32
reference (the lower readings), and of the control, the reference itself
with its weights rounded to fp8 (e4m3, a scale per output channel), the
precision below the configuration's bf16 (the upper readings;
``judge.control``). Each side's readings also go through a run's own
verdict (``run.verdict``, the cell's limits): the program's must come out
correct and the control's not.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from superbench import judge, run, serve, spec, subnet, weights  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch
    bench = spec.benchmark()
    entry = spec.workload(args.workload, bench)
    cell = spec.cell(args.workload)
    arch = spec.config(entry["config"], bench)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    params, ex, profile = run.build(arch, cell, seeds[0], dev)
    for seed in seeds:
        weights.refill(params, seed)
        tr = run.traffic(cell, args.seconds, seed, arch["vocab_size"])
        w = serve.run_window(ex, profile, cell, tr, tr["tokens"], seed,
                             cell["judge_steps"])
        if subnet.is_moe(arch):
            judge.program_routes(ex, w.samples)
        t0 = time.perf_counter()
        program = judge.judge(arch, cell, arch["pareto"], params, w.samples,
                              dev)
        t1 = time.perf_counter()
        control = judge.control(arch, cell, arch["pareto"], params,
                                w.samples, dev)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "program": program,
            "control": control,
            "program_correct": run.verdict(cell, program, w.builds,
                                           w.captures)[0],
            "control_correct": run.verdict(cell, control, 0, 0)[0],
            "reference_s": t1 - t0, "steps_sampled": len(w.samples),
            "subnets": sorted({s["subnet"] for s in w.samples}),
            "attained": sum(q.finish is not None and not q.dropped
                            and q.finish <= q.deadline for q in w.queries)
            / max(len(w.queries), 1),
            "builds": w.builds, "captures": w.captures}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
