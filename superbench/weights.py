"""The served model's weights, made by the benchmark from ``--seed`` on the
device, in the type each is served in, one draw a leaf.

The program's parameter tree on the ``meta`` device gives the names,
shapes and types and nothing else; every leaf is drawn here, so the
reference reads the same inputs the program serves and nothing the
program made. A matrix is N(0, 1) over the square root of its
contraction axis (the embedding over ``hidden_size``, as the tied head
contracts it); a SubnetNorm gain table is 1 + N(0, 0.1^2), one row per
subnet, so serving a subnet with another's row shows; a bias is
N(0, 0.1^2).
"""
from __future__ import annotations

from typing import Dict

import torch


BIASES = ("bq", "bk", "bv")


def _draw(path, t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place by the rule of its leaf name."""
    name = path[-1]
    t.normal_(0.0, 1.0, generator=gen)
    if name.endswith("gamma"):
        return t.mul_(0.1).add_(1.0)
    if name in BIASES:
        return t.mul_(0.1)
    if name == "embed":
        return t.mul_(t.shape[-1] ** -0.5)
    return t.mul_(t.shape[-2] ** -0.5)


def _walk(tree, path, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, path + (i,), fn) for i, v in enumerate(tree)]
    return fn(path, tree)


def make(meta_tree: Dict, seed: int, device) -> Dict:
    """A tree of ``meta_tree``'s structure drawn from ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return _walk(meta_tree, (), lambda p, m: _draw(
        p, torch.empty(m.shape, dtype=m.dtype, device=device), gen))


def refill(tree: Dict, seed: int) -> None:
    """Draw ``tree``'s leaves again, in place, from ``seed`` (the same
    values :func:`make` gives)."""
    leaves = []
    _walk(tree, (), lambda p, t: leaves.append((p, t)))
    gen = torch.Generator(device=leaves[0][1].device).manual_seed(int(seed))
    for p, t in leaves:
        _draw(p, t, gen)
