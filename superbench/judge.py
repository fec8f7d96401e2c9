"""Whether the window served correct logits: the seeded sample of its steps
(the tokens each step ran and the logits the router handed back) against
the plain reference (``reference/lm.py``) on the same weights and tokens.

A served row's token is the program's greedy pick, the argmax of its
logits. ``token_gap`` is the widest gap, over the sampled rows, by which
that token's reference logit lies below the reference's best; ``argmax``
pairs it with the share of rows whose pick differs, and ``logit_err_*``
with the distance of each row's logits from the reference's over the
spread of the reference's (median, 90th percentile and largest over the
rows). A dense model's rows are independent, so the reference runs the
real rows alone; an MoE model's row depends on its batch through expert
capacity, so the reference runs the padded batch the executor ran (pad
rows of token 0 up to the cell's next batch bucket).

An MoE model is followed where it routes: a token whose best experts lie
within a rounding of each other takes either in bfloat16 and in float32,
and its row parts there by a whole expert's output. So the program's walk
over each sampled batch is run once more, eagerly (the executor with
``use_graphs=False``), the experts each of its MoE layers takes are
noted, and the reference takes the same experts. The eager walk does not
always reproduce the replay (``eager_differs``, the widest gap between
their logits): a row it reproduces bit for bit took the noted experts,
one it does not may have taken others. ``logit_err_routed`` and
``token_gap_routed`` read the reproduced rows (all rows where none is),
``unrouted`` is the share of the others. The routing is then checked by
itself: ``route_margin`` is how far a taken expert's float32 router logit
lies below the reference's own best for its slot.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from superbench import subnet
from superbench.reference import lm as ref

# rows the dense reference runs together
CHUNK_ROWS = 64


def bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch {n} above the largest bucket {buckets[-1]}")


def program_routes(ex, samples: List[Dict]) -> None:
    """Note in each sample the experts the program's eager walk of its
    padded batch takes (``"routes"``, one (N, k_max) tensor a live MoE
    layer), the rows that walk reproduces bit for bit (``"exact"``) and
    how far its logits lie from the served ones (``"eager_differs"``)."""
    from repro_torch.models import moe
    from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
    xc = ex.xcfg
    eager = SubnetExecutor(ex.params, ex.cfg, points=ex.points,
                           exec_cfg=ExecutorConfig(
                               batch_buckets=xc.batch_buckets,
                               seq_buckets=xc.seq_buckets,
                               slice_mode=xc.slice_mode, use_graphs=False))
    eager.warmup(batches=xc.batch_buckets, seqs=xc.seq_buckets)
    taken: List = []
    route = moe.route

    def noting(logits, cfg):
        eids = route(logits, cfg)
        taken.append(eids[0].clone())
        return eids

    moe.route = noting
    try:
        for s in samples:
            taken.clear()
            out = eager.prefill(s["subnet"], s["tokens"])
            s["routes"] = list(taken)
            s["exact"] = np.all(out == s["logits"], axis=-1)
            s["eager_differs"] = float(np.abs(out - s["logits"]).max())
    finally:
        moe.route = route


def jobs(arch: Dict, cell: Dict, points: List[Dict],
         samples: List[Dict], device) -> List[Dict]:
    """The reference's jobs for ``samples``; each keeps ``rows``, the
    number of real rows it leads with."""
    out = []
    if subnet.is_moe(arch):
        for s in samples:
            tok = s["tokens"]
            bb = bucket(len(tok), cell["batches"])
            pad = np.zeros((bb, tok.shape[1]), np.int32)
            pad[:len(tok)] = tok
            job = {"tokens": torch.from_numpy(pad).to(device),
                   "point": points[s["subnet"]], "rows": len(tok)}
            if "routes" in s:
                job["routes"] = s["routes"]
            out.append(job)
        return out
    by_subnet: Dict[int, List[np.ndarray]] = {}
    for s in samples:
        by_subnet.setdefault(s["subnet"], []).append(s["tokens"])
    for sub, toks in sorted(by_subnet.items()):
        rows = np.concatenate(toks)
        for i in range(0, len(rows), CHUNK_ROWS):
            part = rows[i:i + CHUNK_ROWS]
            out.append({"tokens": torch.from_numpy(part).to(device),
                        "point": points[sub], "rows": len(part)})
    return out


def served(samples: List[Dict], moe: bool) -> List[np.ndarray]:
    """The sampled logits, in the order :func:`jobs` lays their rows."""
    if moe:
        return [s["logits"] for s in samples]
    by_subnet: Dict[int, List[np.ndarray]] = {}
    for s in samples:
        by_subnet.setdefault(s["subnet"], []).append(s["logits"])
    rows = [r for _, ls in sorted(by_subnet.items()) for r in ls]
    return [np.concatenate(rows)] if rows else []


def reference_logits(arch: Dict, params: Dict, js: List[Dict],
                     weight: Callable = ref.plain) -> np.ndarray:
    """Float32 reference logits of every real row of ``js``."""
    outs = ref.last_logits(arch, params, js, weight)
    return np.concatenate([o[:j["rows"]].cpu().numpy()
                           for o, j in zip(outs, js)])


def readings(picked: np.ndarray, want: np.ndarray,
             routed_rows: Optional[np.ndarray] = None) -> Dict[str, float]:
    """``token_gap`` and the other readings of the rows whose logits are
    ``picked`` against the reference's ``want``; with ``routed_rows`` (an
    MoE model's rows that took the experts the reference took) also the
    readings of those rows."""
    tok = picked.argmax(-1)
    best = want.max(-1)
    gap = best - want[np.arange(len(want)), tok]
    spread = np.linalg.norm(want - want.mean(-1, keepdims=True), axis=-1)
    err = np.linalg.norm(picked - want, axis=-1) / spread
    out = {"token_gap": float(gap.max()),
           "argmax": float(np.mean(tok != want.argmax(-1))),
           "logit_err_median": float(np.median(err)),
           "logit_err_p90": float(np.quantile(err, 0.9)),
           "logit_err_max": float(err.max()),
           "rows": float(len(want))}
    if routed_rows is not None:
        kept = routed_rows if routed_rows.any() else np.ones_like(routed_rows)
        out.update(token_gap_routed=float(gap[kept].max()),
                   logit_err_routed=float(np.median(err[kept])),
                   unrouted=float(np.mean(~routed_rows)))
    return out


def routed(js: List[Dict]) -> Dict[str, float]:
    """The MoE jobs' ``route_margin`` (after the reference ran them)."""
    return {"route_margin": max(j.get("margin", 0.0) for j in js)}


def judge(arch: Dict, cell: Dict, points: List[Dict], params: Dict,
          samples: List[Dict], device) -> Dict[str, float]:
    """The readings of the window's sample against the reference (an MoE
    sample carries the program's routes, :func:`program_routes`)."""
    js = jobs(arch, cell, points, samples, device)
    want = reference_logits(arch, params, js)
    got = np.concatenate(served(samples, subnet.is_moe(arch)))
    if not subnet.is_moe(arch):
        return readings(got, want)
    out = readings(got, want, np.concatenate([s["exact"] for s in samples]))
    out.update(routed(js), eager_differs=max(
        s["eager_differs"] for s in samples))
    return out


def control(arch: Dict, cell: Dict, points: List[Dict], params: Dict,
            samples: List[Dict], device) -> Dict[str, float]:
    """The same readings of the control: the reference with its weights
    rounded to fp8 put in the program's place (on an MoE model the float32
    reference then takes the experts the control took, so every row of the
    control is a routed row)."""
    js = jobs(arch, cell, points, samples, device)
    for j in js:
        j.pop("routes", None)
    got = reference_logits(arch, params, js, ref.fp8)
    if not subnet.is_moe(arch):
        return readings(got, reference_logits(arch, params, js))
    for j in js:
        j["routes"] = j["taken"]
    want = reference_logits(arch, params, js)
    out = readings(got, want, np.ones(len(want), bool))
    out.update(routed(js))
    return out
