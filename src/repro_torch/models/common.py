"""Shared model utilities: initialization, dtype policy, parameter trees
(port of ``repro/models/common.py``).

Parameters are plain dicts with the JAX tree's keys and shapes: ``(in,
out)`` matrices used as ``x @ W`` and per-stage leaves stacked along a
leading ``repeat`` axis. Random initialization draws from an explicit
``torch.Generator`` on the parameters' device; it does not reproduce JAX's
numbers (tests copy JAX-initialized trees across with
``lm.from_jax_params``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core import operators as ops

Params = Dict[str, Any]


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (LM standard): N(0, 1) cut to
    [-2, 2], times ``scale / sqrt(shape[0])``."""
    std = scale / np.sqrt(max(shape[0], 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def ones_table(n_subnets: int, d: int, device, dtype=torch.float32):
    """SubnetNorm gain table, initialized shared (gamma == 1 for every
    subnet); calibration/training specializes rows."""
    return torch.ones((n_subnets, d), dtype=dtype, device=device)


def stack_init(init_fn: Callable[[], Dict], repeat: int) -> Dict:
    """Initialize ``repeat`` copies of a sub-block and stack every leaf
    along a new leading axis (the JAX scan-over-layers layout)."""
    parts = [init_fn() for _ in range(repeat)]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def unstack(stacked: Dict, r: int) -> Dict:
    """The ``r``-th layer of a stacked sub-block (views, no copies)."""
    return {k: v[r] for k, v in stacked.items()}


def pre_norm(p: Params, cfg, x, delta, ctrl):
    """A block's pre-norm with the previous block's pending residual add in
    front: ``(s, h)``, where ``s = x + delta`` (``x`` itself when ``delta``
    is None) is the block's input residual and ``h`` its SubnetNorm. On the
    card the RMS flavor does both in one launch."""
    kw = dict(beta_table=p.get("norm_beta"), eps=cfg.norm_eps, kind=cfg.norm)
    if delta is None:
        return x, ops.subnet_norm(x, p["norm_gamma"], ctrl["subnet_id"], **kw)
    return ops.subnet_norm(x, p["norm_gamma"], ctrl["subnet_id"],
                           residual=delta, **kw)
