"""Sandwich-rule supernet training (port of ``repro/training/supernet.py``:
the OFA/BigNAS style of training that the paper assumes, one
weight-shared supernet whose every subnet is servable).

Each step takes gradients of the mean loss of (a) the max subnet, (b) the
min subnet and (c) ``n_random`` sampled subnets. The reference samples
inside jit from a PRNG key; here ``core.subnet.sample_control`` draws the
option indices on the host from a ``torch.Generator`` (the trainer seeds
one with the step, as the reference uses ``PRNGKey(step)``). The
per-subnet SubnetNorm gamma rows get gradients only from their own
subnet, through the gather by ``subnet_id``. On the card the forward runs
the hand-written kernels and their backward passes
(``kernels/autograd.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import subnet as sn
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.training import optimizer as opt


def make_controls(cfg: ArchConfig) -> Tuple[dict, dict]:
    """The (max, min) control tuples, host numpy as ``make_control``
    gives them."""
    return (sn.make_control(cfg, sn.max_subnet(cfg)),
            sn.make_control(cfg, sn.min_subnet(cfg)))


def sandwich_loss(params, cfg: ArchConfig, batch, generator=None, *,
                  n_random: int = 1, slice_mode: str = "mask",
                  remat: bool = False, moe_groups: int = 1):
    """Mean loss over {max, min, ``n_random`` subnets sampled from
    ``generator``}."""
    kw = dict(slice_mode=slice_mode, remat=remat, moe_groups=moe_groups)
    ctrls = list(make_controls(cfg))
    ctrls += [sn.sample_control(cfg, generator) for _ in range(n_random)]
    losses = [lm.loss_fn(params, cfg, batch, c, **kw) for c in ctrls]
    return sum(losses) / len(losses)


def _rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def loss_and_grads(params, cfg: ArchConfig, batch, generator=None, *,
                   n_random: int = 1, slice_mode: str = "mask",
                   remat: bool = False, moe_groups: int = 1,
                   microbatch: int = 0):
    """(loss, grads) of :func:`sandwich_loss`, grads a tree of
    ``params``' structure. Gradients come from ``torch.autograd.grad`` over
    every leaf; a leaf the loss does not reach (a unit its layer gate
    skipped) gets zeros, so AdamW still decays its moments and weights, as
    under ``jax.grad``. ``microbatch``: gradient-accumulation chunks along
    the batch dim (0 = off), each with the same sampled subnets, the loss
    and the fp32 gradients summed over them as ``loss / n`` and ``grads /
    n``, as the reference's ``lax.scan`` sums them."""
    leaves = tree_leaves(params)

    def one(b):
        loss = sandwich_loss(params, cfg, b, generator, n_random=n_random,
                             slice_mode=slice_mode, remat=remat,
                             moe_groups=moe_groups)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if not microbatch:
        loss, grads = one(batch)
        return loss, tree_unflatten(params, grads)
    n = microbatch
    rows = len(next(iter(batch.values()))) // n
    drawn = None if generator is None else generator.get_state()
    loss = 0.0
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    for i in range(n):
        if generator is not None:
            generator.set_state(drawn)
        l, g = one(_rows(batch, i * rows, (i + 1) * rows))
        loss = loss + l / n
        grads = [a + b / n for a, b in zip(grads, g)]
    return loss, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig, *,
                    n_random: int = 1, slice_mode: str = "mask",
                    remat: bool = False, moe_groups: int = 1,
                    microbatch: int = 0):
    """Returns ``step(params, opt_state, batch, generator) -> (params,
    state, metrics)``: :func:`loss_and_grads`, then one AdamW update."""

    def step(params, opt_state, batch, generator=None):
        loss, grads = loss_and_grads(
            params, cfg, batch, generator, n_random=n_random,
            slice_mode=slice_mode, remat=remat, moe_groups=moe_groups,
            microbatch=microbatch)
        params2, opt_state2, m = opt.apply(opt_cfg, params, grads, opt_state)
        m["loss"] = loss
        return params2, opt_state2, m

    return step
