"""Pareto-subnet extraction (the paper's NAS step, §4.2/§5 profiler)
plus the accuracy / latency predictors it consumes.

The paper runs OFA's NAS with latency+accuracy predictors to obtain
Phi_pareto (|Phi_pareto| ~ 1e3 out of |Phi| ~ 1e19) in <= 2 min. Our
control spaces are discrete grids, so "NAS" is exhaustive enumeration +
predictor evaluation + Pareto filtering — the same contract, exact
instead of sampled.

Accuracy predictors are *predictors* (as in the paper): monotone,
FLOPs-based, fit so the conv supernet spans the paper's published
0.9-7.5 GFLOPs / 73-80% top-1 range.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.subnet import (SubnetDescriptor, active_ffn, active_heads,
                               count_params, enumerate_space, flops_per_token,
                               stage_gates)

# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------


def conv_flops_per_image(cfg: ArchConfig, sub: SubnetDescriptor | None = None) -> int:
    """Matmul-equivalent FLOPs for one image through the conv supernet."""
    e = sub.ffn_frac if sub else 1.0
    w = sub.head_frac if sub else 1.0
    gates = stage_gates(cfg, sub.depth_frac if sub else 1.0)
    img = cfg.img_size
    hw = (img // 2) ** 2                     # after stem stride 2
    stem_w = max(64, cfg.conv_stage_widths[0] // 4)
    total = 2 * 9 * 3 * stem_w * hw
    cin = stem_w
    gi = 0
    for si, stage in enumerate(cfg.stages):
        cout = cfg.conv_stage_widths[si]
        last = si == len(cfg.stages) - 1
        c_out_active = cout if last else max(8, int(w * cout))
        mid = max(8, int(e * (cout // 4)))
        hw = hw // 4                          # stage entry stride 2
        for r in range(stage.repeat):
            live = bool(gates[gi]) or r == 0
            gi += 1
            if not live:
                continue
            c_in = cin if r == 0 else c_out_active
            total += 2 * hw * (c_in * mid + 9 * mid * mid + mid * c_out_active)
            if r == 0:
                total += 2 * hw * c_in * c_out_active
        cin = cout
    total += 2 * cfg.conv_stage_widths[-1] * cfg.n_classes
    return int(total)


def subnet_flops(cfg: ArchConfig, sub: SubnetDescriptor | None = None) -> int:
    """FLOPs per serving item (token for LMs, image for the conv net)."""
    if cfg.family == "conv":
        return conv_flops_per_image(cfg, sub)
    return flops_per_token(cfg, sub)


def conv_params(cfg: ArchConfig, sub: SubnetDescriptor | None = None,
                resident: bool = True) -> int:
    """Exact conv supernet parameter count. ``resident`` = full shared
    weights in HBM; else the extracted subnet (what Clipper+ loads)."""
    e = 1.0 if (resident or sub is None) else sub.ffn_frac
    w = 1.0 if (resident or sub is None) else sub.head_frac
    gates = stage_gates(cfg, 1.0 if (resident or sub is None) else sub.depth_frac)
    stem_w = max(64, cfg.conv_stage_widths[0] // 4)
    total = 9 * 3 * stem_w
    cin = stem_w
    gi = 0
    for si, stage in enumerate(cfg.stages):
        cout = cfg.conv_stage_widths[si]
        last = si == len(cfg.stages) - 1
        c_out = cout if last else max(8, int(w * cout))
        mid = max(8, int(e * (cout // 4)))
        for r in range(stage.repeat):
            live = bool(gates[gi]) or r == 0
            gi += 1
            if not live:
                continue
            c_in = cin if r == 0 else c_out
            total += c_in * mid + 9 * mid * mid + mid * c_out
            if r == 0:
                total += c_in * c_out
        cin = cout
    total += cfg.conv_stage_widths[-1] * cfg.n_classes
    return int(total)


def subnet_weight_bytes(cfg: ArchConfig, sub: SubnetDescriptor | None = None,
                        resident: bool = True) -> int:
    if cfg.family == "conv":
        return conv_params(cfg, sub, resident=resident) * 4
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    return count_params(cfg, sub, resident=resident) * itemsize


# --------------------------------------------------------------------------
# Accuracy predictor
# --------------------------------------------------------------------------

# Fit to the paper's published pareto range: 0.9 GF -> 73%, 7.5 GF -> 80%.
_CONV_A, _CONV_B = 81.0, 7.4


def accuracy_predictor(cfg: ArchConfig, sub: SubnetDescriptor) -> float:
    """Predicted task accuracy (%) of a subnet. Monotone in FLOPs with
    diminishing returns (paper Fig. 2 shape)."""
    f = subnet_flops(cfg, sub)
    if cfg.family == "conv":
        gf = f / 1e9
        return float(np.clip(_CONV_A - _CONV_B / max(gf, 1e-3), 50.0, 80.6))
    # LM archs: relative predictor anchored at the max subnet = 80%, the
    # same hyperbolic shape, clipped so the serving range mirrors the
    # paper's 73-80% window.
    f_max = subnet_flops(cfg, None)
    rel = f / max(f_max, 1)
    return float(np.clip(80.0 - 4.0 * (1.0 / max(rel, 1e-3) - 1.0), 70.0, 80.6))


# --------------------------------------------------------------------------
# Pareto filtering (the NAS output)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ParetoPoint:
    sub: SubnetDescriptor
    acc: float
    gflops: float
    weight_mb: float


def pareto_filter(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Keep points not dominated in (min gflops, max acc)."""
    pts = sorted(points, key=lambda p: (p.gflops, -p.acc))
    out: List[ParetoPoint] = []
    best = -np.inf
    for p in pts:
        if p.acc > best + 1e-9:
            out.append(p)
            best = p.acc
    return out


def pareto_subnets(cfg: ArchConfig) -> List[ParetoPoint]:
    """Enumerate Phi, score with the predictors, return Phi_pareto
    (ascending FLOPs/accuracy)."""
    pts = []
    for sub in enumerate_space(cfg):
        pts.append(ParetoPoint(
            sub=sub,
            acc=accuracy_predictor(cfg, sub),
            gflops=subnet_flops(cfg, sub) / 1e9,
            weight_mb=subnet_weight_bytes(cfg, sub, resident=False) / 2**20,
        ))
    return pareto_filter(pts)


def uniform_sample(pareto: Sequence[ParetoPoint], n: int) -> List[ParetoPoint]:
    """n points uniformly spaced w.r.t. FLOPs (paper Fig. 13a samples 6)."""
    if len(pareto) <= n:
        return list(pareto)
    idx = np.linspace(0, len(pareto) - 1, n).round().astype(int)
    return [pareto[i] for i in sorted(set(idx.tolist()))]
