"""SubnetNorm calibration (paper §3, "SubnetNorm" operator; port of
``repro/core/calibrate.py``).

Naive LayerSelect/WeightSlice drops subnet accuracy by up to 10% because
shared normalization statistics are wrong for every subnet but the one
they were computed on. SubnetNorm fixes this by *precomputing* per-subnet
(mu_{i,j}, sigma_{i,j}) for each subnet i and norm site j via forward
passes on calibration data — done offline by the Supernet Profiler,
never on the query critical path.

This module implements that calibration for the conv supernet's true
BatchNorm tables. RMSNorm/LayerNorm LMs are *stat-free*: their
SubnetNorm is the per-subnet gain (and bias) tables trained jointly with
the supernet (``training/supernet.py``).

Each subnet's statistics pass runs on the parameters' device with its
depth as static gates; the batches' (mean, var) come to the host and are
combined there by the law of total variance, and the subnet's rows of the
tables are written in place (every leaf keeps its storage).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.subnet import SubnetDescriptor, enumerate_space, stage_gates
from repro_torch.models import convnet
from repro_torch.models.common import tree_leaves


def _site_tables(params) -> Dict[str, Dict]:
    """Map site key -> BN table dict inside the param tree (by reference)."""
    sites = {"stem": params["stem"]["bn"]}
    for si, units in enumerate(params["stages"]):
        for r, u in enumerate(units):
            pre = f"s{si}u{r}."
            sites[pre + "bn1"] = u["bn1"]
            sites[pre + "bn2"] = u["bn2"]
            sites[pre + "bn3"] = u["bn3"]
            if "bn_proj" in u:
                sites[pre + "bn_proj"] = u["bn_proj"]
    return sites


def _host_stats(stats: Dict) -> Dict[str, tuple]:
    """Each site's (mean, var) as numpy, in one device-to-host copy."""
    keys = list(stats)
    flat = torch.cat([t for k in keys for t in stats[k]]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        n = stats[k][0].numel()
        out[k] = (flat[at:at + n], flat[at + n:at + 2 * n])
        at += 2 * n
    return out


def calibrate_convnet(params, cfg: ArchConfig, batches: Iterable,
                      subnets: Sequence[SubnetDescriptor] | None = None):
    """Fill the per-subnet BN (mean, var) table rows of ``subnets`` (every
    subnet by default); the other rows stay as they are.

    ``batches``: iterable of image batches (B, H, W, 3) — the paper uses
    training data. The rows are written in place; returns ``params``.
    (The reference's unused ``momentum`` argument is left out.)
    """
    subnets = list(subnets if subnets is not None else enumerate_space(cfg))
    batches = list(batches)
    if not batches:
        raise ValueError("calibration requires at least one batch")
    sites = _site_tables(params)
    with torch.no_grad():
        for sub in subnets:
            ctrl = convnet.make_conv_control(cfg, sub)
            gates = stage_gates(cfg, sub.depth_frac)
            acc: Dict[str, List] = {}
            for x in batches:
                _, stats = convnet.convnet_forward(
                    params, cfg, x, ctrl, collect_stats=True,
                    static_gates=gates)
                for site, mv in _host_stats(stats).items():
                    acc.setdefault(site, []).append(mv)
            sid = int(sub.subnet_id)
            for site, ms in acc.items():
                mu = np.mean([m for m, _ in ms], axis=0)
                # law of total variance across batches
                var = (np.mean([v for _, v in ms], axis=0)
                       + np.var([m for m, _ in ms], axis=0))
                t = sites[site]
                t["mean"][sid].copy_(torch.as_tensor(mu))
                t["var"][sid].copy_(torch.as_tensor(var))
    return params


def norm_table_bytes(params) -> int:
    """Bytes of non-shared SubnetNorm bookkeeping (paper Fig. 4 numerator)."""
    return sum(t[k].numel() * t[k].element_size()
               for t in _site_tables(params).values() for k in ("mean", "var"))


def shared_weight_bytes(params) -> int:
    """Bytes of shared (non-norm-table) weights (paper Fig. 4 denominator)."""
    tables = {id(t[k]) for t in _site_tables(params).values()
              for k in ("mean", "var")}
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(params) if id(leaf) not in tables)
