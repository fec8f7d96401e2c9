"""Shared model utilities: initialization, dtype policy, parameter trees
(port of ``repro/models/common.py``).

Parameters are plain dicts with the JAX tree's keys and shapes: ``(in,
out)`` matrices used as ``x @ W`` and per-stage leaves stacked along a
leading ``repeat`` axis. Random initialization draws from an explicit
``torch.Generator`` on the parameters' device; it does not reproduce JAX's
numbers (tests copy JAX-initialized trees across with
``lm.from_jax_params``). A block's init function describes its random
leaves as :class:`Dense` specs, and :func:`stack_init` allocates each
stacked leaf once and draws it in place, layer by layer (and expert by
expert for an expert table), so no leaf is held twice and no fp32
temporary is larger than one layer's matrix or one expert's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import operators as ops
from repro_torch.distributed.placement import gather_uneven, settle_partial

Params = Dict[str, Any]


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclass(frozen=True)
class Dense:
    """A truncated-normal fan-in leaf not drawn yet (see
    :func:`fill_dense`): what a block's init function returns for each
    random matrix, for :func:`stack_init` to allocate and draw."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    scale: float = 1.0


def fill_dense(out: torch.Tensor, generator: torch.Generator,
               scale: float = 1.0) -> torch.Tensor:
    """Draw ``out`` in place (LM standard): N(0, 1) cut to [-2, 2], times
    ``scale / sqrt(out.shape[0])``. The fan-in is the first axis whatever
    the rank, as in ``repro/models/common.py``: for an ``(E, d, f)``
    expert table that is E. A 3-d leaf is drawn one ``out[e]`` at a time,
    so the fp32 temporary is one expert's matrix."""
    if out.is_meta:
        return out
    std = scale / np.sqrt(max(out.shape[0], 1))
    for part in (out if out.dim() > 2 else (out,)):
        t = torch.empty(part.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(t * std)
    return out


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """A new leaf of ``shape`` drawn by :func:`fill_dense`."""
    return fill_dense(torch.empty(shape, dtype=dtype, device=device),
                      generator, scale)


def ones_table(n_subnets: int, d: int, device, dtype=torch.float32):
    """SubnetNorm gain table, initialized shared (gamma == 1 for every
    subnet); calibration/training specializes rows."""
    return torch.ones((n_subnets, d), dtype=dtype, device=device)


def stack_init(init_fn: Callable[[], Dict], repeat: int,
               generator: torch.Generator, device) -> Dict:
    """``repeat`` copies of a sub-block with every leaf stacked along a new
    leading axis (the JAX scan-over-layers layout). ``init_fn()`` gives one
    layer's leaves: tensors, copied in, or :class:`Dense` specs, drawn in
    place. Each stacked leaf is allocated once and filled layer by layer,
    in the order of the layers and then of the leaves."""
    out: Dict[str, torch.Tensor] = {}
    for r in range(repeat):
        for k, leaf in init_fn().items():
            if k not in out:
                out[k] = torch.empty((repeat,) + tuple(leaf.shape),
                                     dtype=leaf.dtype, device=device)
            if isinstance(leaf, Dense):
                fill_dense(out[k][r], generator, leaf.scale)
            else:
                out[k][r].copy_(leaf)
    return out


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
                           residual=settle_partial(delta), **kw)


def split_heads(t, n: int, hd: int):
    """``(..., n * hd)`` viewed as ``(..., n, hd)``. A DTensor whose last
    dim is sharded into shards that do not divide ``n`` is gathered on it
    first (``distributed.placement.gather_uneven``): DTensor cannot split
    such a shard, GSPMD re-lays it out. A plain tensor is only viewed."""
    t = gather_uneven(t, -1, n)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t):
    """``(..., n, hd)`` viewed as ``(..., n * hd)``. A DTensor sharded on
    ``hd`` is gathered on it first: the merged dim would be a strided
    shard, which the next product takes no strategy for. A plain tensor
    is only viewed."""
    t = gather_uneven(t, -1, 1)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def tree_flatten_with_path(tree, path: Tuple = ()) -> list:
    """``(path, leaf)`` of every leaf of a tree of dicts, lists and tuples,
    in the order ``jax.tree_util`` flattens one: dict keys sorted, items
    in order. A path is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_flatten_with_path`'s order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, taken in
    :func:`tree_flatten_with_path`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of the trees
    in ``rest`` (of the same structure)."""
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(leaf, *(o[i] for o in others))
                                 for i, leaf in enumerate(tree_leaves(tree))])
