"""Aggregate ``results/dryrun_torch/*.json`` into the roofline table and
pick the hillclimb cells (port of ``repro/roofline/aggregate.py``, over
the H100 constants of ``roofline/hw.py``).

    PYTHONPATH=src python -m repro_torch.roofline.aggregate [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load(mesh: str = "single", results_dir: str = RESULTS_DIR) -> List[Dict]:
    recs = []
    for fp in sorted(glob.glob(os.path.join(results_dir,
                                            f"*__{mesh}.json"))):
        with open(fp) as f:
            recs.append(json.load(f))
    return recs


def corrected(r: Dict) -> Dict:
    """Floor the counted FLOPs with the analytic lower bound (the dry-run
    already stores the floored figure; this keeps older records right)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs as S
    from repro_torch.roofline import hw
    cfg = get_config(r["arch"])
    shape = SHAPES[r["shape"]]
    ana = S.analytic_flops(cfg, shape, remat=bool(r.get("remat")))
    flops_dev = max(r["hlo_flops_per_device"], ana / r["chips"])
    t_comp = flops_dev / hw.PEAK_FLOPS_BF16
    bound = max(t_comp, r["t_memory"], r["t_collective"])
    t_useful = (r["model_flops_total"] / r["chips"]) / hw.PEAK_FLOPS_BF16
    hbm = (r["argument_bytes_per_device"] + r["temp_bytes_per_device"]) / 1e9
    return {
        "t_comp": t_comp,
        "useful": r["model_flops_total"] / (flops_dev * r["chips"]),
        "frac": t_useful / max(bound, 1e-12),
        "dominant": max((("compute", t_comp), ("memory", r["t_memory"]),
                         ("collective", r["t_collective"])),
                        key=lambda kv: kv[1])[0],
        "hbm": hbm,
    }


def fmt_table(recs: List[Dict]) -> str:
    head = ("| arch | shape | dominant | t_comp (ms) | t_mem (ms) | "
            "t_coll (ms) | useful/counted | roofline frac | GB/dev of 80 |\n"
            "|---|---|---|---|---|---|---|---|---|")
    rows = []
    for r in recs:
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — skipped: "
                        f"{r['reason'].split(';')[0]} | | | | | | |")
            continue
        c = corrected(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {c['dominant']} | "
            f"{c['t_comp']*1e3:.2f} | {r['t_memory']*1e3:.2f} | "
            f"{r['t_collective']*1e3:.2f} | {c['useful']:.2f} | "
            f"{c['frac']:.3f} | {c['hbm']:.1f} |")
    return head + "\n" + "\n".join(rows)


def pick_hillclimbs(recs: List[Dict]) -> Dict[str, Dict]:
    ok = [r for r in recs if r["status"] == "ok"]
    worst = min(ok, key=lambda r: corrected(r)["frac"])
    coll = max(ok, key=lambda r: r["t_collective"] /
               max(r["t_compute"], r["t_memory"], 1e-12))
    return {"worst_fraction": worst, "most_collective_bound": coll}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    recs = load(args.mesh)
    print(fmt_table(recs))
    picks = pick_hillclimbs(recs)
    print("\nhillclimb candidates:")
    for k, r in picks.items():
        print(f"  {k}: {r['arch']} x {r['shape']} "
              f"(frac={r['roofline_fraction']:.3f}, dominant={r['dominant']})")


if __name__ == "__main__":
    main()
