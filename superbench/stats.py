"""Arithmetic the metric readers share."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from superbench import judge, subnet
from superbench.counts import lm_step


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics), None
    for no values."""
    return float(np.percentile(values, q)) if len(values) else None


def met(q) -> bool:
    """Served by its deadline (a drop or a time-out is a miss)."""
    return (q.finish is not None and not q.dropped
            and q.finish <= q.deadline)


def served(q) -> bool:
    return q.finish is not None and not q.dropped


def step_work(run, step) -> Dict:
    """The served subnet's control and the padded shape of ``step``."""
    return {"ctrl": subnet.control(run.arch, run.points[step.subnet]),
            "bb": judge.bucket(step.rows, run.cell["batches"]),
            "sb": run.cell["prompt_tokens"]}


def roofline(run, symbol: str, names: List[str]) -> Optional[float]:
    """Percent of ``symbol``'s traced device time that its launches'
    least time (operations over the bf16 peak or bytes over HBM's,
    whichever is larger) fills; None without an intact trace, without a
    launch of it, or where ``counts/lm_step.py`` names other launches than
    the program counted."""
    tr = run.window.trace
    if tr is None or not tr.intact or tr.kernel_s.get(symbol, 0.0) <= 0:
        return None
    pk = run.peaks
    least = compute = 0.0
    n = 0
    # the trace reads the steps it counted but its first and last
    for step in [s for s in run.window.steps if s.traced == tr.attempt][1:-1]:
        w = step_work(run, step)
        per = lm_step.launches(run.arch, w["ctrl"], run.cell["slice_mode"],
                               w["bb"], w["sb"])
        for name in names:
            for flops, nbytes in per[name]:
                t_c, t_m = flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"]
                least += max(t_c, t_m)
                compute += t_c if t_c >= t_m else 0.0
                n += 1
    counted = sum(tr.launches.get(name, 0) for name in names)
    if n != counted:
        # the counts no longer describe the program's launches: no number
        run.notes[f"roofline.{symbol}"] = (f"the counts name {n} launches, "
                                           f"the program counted {counted}")
        return None
    run.notes[f"roofline.{symbol}"] = (
        f"{n} launches, compute-bound share of least time "
        f"{compute / least:.3f}" if least else "no launch")
    return 100.0 * least / tr.kernel_s[symbol]
