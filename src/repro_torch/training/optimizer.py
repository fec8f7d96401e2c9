"""AdamW as pure functions over the parameter tree (port of
``repro/training/optimizer.py``; not ``torch.optim``).

``init`` -> state tree, ``apply`` -> (new_params, new_state, metrics), in
the reference's order of operations: clip by the global norm, the fp32
update, decoupled weight decay on leaves with ``ndim >= 2`` only, the
result cast back to each parameter's type. The step count, the learning
rate and the clip scale stay 0-d device tensors, so an update reads
nothing back to the host. ``state_shardings`` gives the ZeRO-1 placements
of the moments over a ``ShardingPlan``'s mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32; ``step`` an int or a 0-d
    tensor (the learning rate lands on its device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    """fp32 zero moments of every leaf and a 0-d int32 step, on the
    leaves' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state):
    """One AdamW update (with clipping + decoupled weight decay). A new
    parameter leaf requires grad when the old one did."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        step_dir = mh / (torch.sqrt(vh) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0
        new_p = (p.float() - lr * (step_dir + decay)).to(p.dtype)
        return new_p.requires_grad_(p.requires_grad), m, v

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_state = {"m": tree_unflatten(params, [o[1] for o in out]),
                 "v": tree_unflatten(params, [o[2] for o in out]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}


def state_shardings(plan, params) -> Dict[str, Any]:
    """ZeRO-1: DTensor placements of the moments, each sharded over the DP
    axes on the first axis that the DP size divides (replicated where none
    does); ``step`` replicated. ``params``: tensors or shape-only leaves."""
    dp = plan.dp_axes[0] if len(plan.dp_axes) == 1 else plan.dp_axes
    dpn = plan.dp_size

    def spec(leaf):
        shape = tuple(leaf.shape)
        for i, s in enumerate(shape):
            if s % max(dpn, 1) == 0 and s >= dpn:
                return tuple(dp if j == i else None
                             for j in range(len(shape)))
        return (None,) * len(shape)

    def moments():
        return tree_map(lambda leaf: plan.placements(spec(leaf)), params)

    return {"m": moments(), "v": moments(), "step": plan.placements(())}
