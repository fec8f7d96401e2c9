"""Shape-only stand-ins and placements for every dry-run cell (port of
``repro/launch/specs.py``).

``input_specs(cfg, shape)`` returns the inputs of the step a cell traces
(the train step for ``train_*``, prefill for ``prefill_*``, one decode
step for ``decode_*`` / ``long_*``) as ``meta`` tensors from the port's
own ``lm.init_model`` / ``lm.init_cache``: shapes and types, nothing
allocated. ``attention_flops``, ``analytic_flops`` and ``model_flops`` are
the reference's arithmetic on the config, copied verbatim.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import subnet as sn
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.models import lm


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (a torch dtype or a
    numpy / string one)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    elif not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def ctrl_specs(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    return {k: sds(np.asarray(v).shape, np.asarray(v).dtype)
            for k, v in ctrl.items()}


def param_specs(cfg: ArchConfig) -> Any:
    return lm.init_model(cfg, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                with_labels: bool) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.frontend == "embed" and shape.kind != "decode":
        out["embeds"] = sds((B, S, cfg.d_model), cfg.dtype)
    else:
        out["tokens"] = sds((B, S), torch.int32)
    if with_labels:
        out["labels"] = sds((B, S), torch.int32)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Any:
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shape-only inputs per cell kind. Keys mirror the step signatures."""
    if shape.kind == "train":
        return {
            "params": param_specs(cfg),
            "batch": batch_specs(cfg, shape, with_labels=True),
            "ctrl": ctrl_specs(cfg),
        }
    if shape.kind == "prefill":
        return {
            "params": param_specs(cfg),
            "batch": batch_specs(cfg, shape, with_labels=False),
            "ctrl": ctrl_specs(cfg),
        }
    # decode: one new token against a seq_len-deep cache
    return {
        "params": param_specs(cfg),
        "tokens": sds((shape.global_batch, 1), torch.int32),
        "ctrl": ctrl_specs(cfg),
        "cache": cache_specs(cfg, shape),
        "index": sds((), torch.int32),
    }


def input_shardings(plan: ShardingPlan, cfg: ArchConfig, shape: ShapeSpec,
                    specs: Dict[str, Any]) -> Dict[str, Any]:
    """DTensor placements of :func:`input_specs`, tree for tree."""
    out: Dict[str, Any] = {"params": plan.params(specs["params"]),
                           "ctrl": plan.replicated(specs["ctrl"])}
    if "batch" in specs:
        out["batch"] = plan.batch(specs["batch"])
    if "tokens" in specs:
        out["tokens"] = plan.placements(
            plan.batch_spec("tokens", tuple(specs["tokens"].shape)))
    if "cache" in specs:
        out["cache"] = plan.cache(specs["cache"])
    if "index" in specs:
        out["index"] = plan.placements(())
    return out


def attention_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Quadratic attention FLOPs (score + value matmuls), not part of
    the 6*N*D convention but real compiled work. Causal => /2; sliding
    window bounds the context; SSM/xLSTM layers contribute ~0."""
    n_attn = sum(s.pattern.count("attn") * s.repeat for s in cfg.stages)
    if cfg.shared_attn_period:
        n_attn += sum(s.repeat for s in cfg.stages) // cfg.shared_attn_period
    if n_attn == 0:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if shape.kind == "decode":
        per_layer = 4.0 * B * 1 * ctx * cfg.n_heads * hd
    else:
        per_layer = 4.0 * B * S * (ctx / 2.0) * cfg.n_heads * hd
    mult = 3.0 if shape.kind == "train" else 1.0
    return per_layer * n_attn * mult


def analytic_flops(cfg: ArchConfig, shape: ShapeSpec, *,
                   remat: bool = False) -> float:
    """Lower-bound total FLOPs of the step: MODEL_FLOPS (+1/3 recompute
    under remat for train) + quadratic attention."""
    mf = model_flops(cfg, shape)
    if shape.kind == "train" and remat:
        mf *= 4.0 / 3.0
    return mf + attention_flops(cfg, shape)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for the roofline ratio: 6*N*D train (fwd+bwd),
    2*N*D prefill, 2*N*B decode — N_active for MoE (flops_per_token
    already counts active experts only)."""
    f_tok = sn.flops_per_token(cfg)                 # == 2*N_active
    if shape.kind == "train":
        return 3.0 * f_tok * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return float(f_tok) * shape.global_batch * shape.seq_len
    return float(f_tok) * shape.global_batch
