"""Dense FFN (SwiGLU / GELU) with SubNetAct width elasticity (port of
``repro/models/ffn.py``).

WeightSlice mask mode runs the full d_ff and zeroes the inactive hidden
channels. Switch mode runs the three projections through the
``sliced_matmul`` kernel entry point, which reads ``ffn_width`` as data:
gate and up compute only the first ``ffn_width`` columns (zeros after
them, and silu(0) * 0 = gelu(0) = 0), down contracts only those rows.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.kernels import ops as kops
from repro_torch.models.common import Dense, ones_table, pre_norm


def init_mlp(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``."""
    d, f = cfg.d_model, cfg.d_ff
    init = partial(Dense, dtype=dtype)
    p = {
        "wu": init((d, f)),
        "wd": init((f, d)),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
    }
    if cfg.ffn_act == "swiglu":
        p["wg"] = init((d, f))
    if cfg.norm == "layernorm":
        p["norm_beta"] = torch.zeros((cfg.elastic.num_subnets, d),
                                     dtype=torch.float32, device=device)
    return p


def mlp_block(p, cfg: ArchConfig, x, ctrl, *, slice_mode: str = "mask"):
    """Pre-norm SwiGLU/GELU FFN with elastic d_ff. x: (..., d) -> (..., d)."""
    s, y = mlp_block_pending(p, cfg, x, None, ctrl, slice_mode=slice_mode)
    return s + y


def mlp_block_pending(p, cfg: ArchConfig, x, delta, ctrl, *,
                      slice_mode: str = "mask"):
    """:func:`mlp_block` with the previous block's residual add pending:
    returns ``(s, y)``, where ``s = x + delta`` is this block's input
    residual (the add fused into the pre-norm; ``delta`` None means
    ``s = x``) and ``y`` this block's output in x's type, not yet added."""
    ops.check_slice_mode(slice_mode)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    if slice_mode == "switch" and len(cfg.elastic.ffn_fracs) > 1:
        width = ctrl["ffn_width"]
        up = kops.sliced_matmul(h, p["wu"], None, width)
        if cfg.ffn_act == "swiglu":
            a = F.silu(kops.sliced_matmul(h, p["wg"], None, width)) * up
        else:
            a = F.gelu(up, approximate="tanh")
        y = kops.sliced_matmul(a, p["wd"], width, None)
        return s, y.to(s.dtype)
    if cfg.ffn_act == "swiglu":
        a = F.silu(h @ p["wg"]) * (h @ p["wu"])
    else:
        a = F.gelu(h @ p["wu"], approximate="tanh")   # jax.nn.gelu default
    # WeightSlice(mask): zeroing hidden channels beyond the active width
    # makes the down-proj rows for those channels inert.
    a = ops.slice_mask(a, ctrl["ffn_width"])
    y = a @ p["wd"]
    return s, y.to(s.dtype)
