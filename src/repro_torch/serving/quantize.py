"""Weight-only int8 for the decode path (port of
``repro/serving/quantize.py``).

Decode is weight-streaming-bound: every step reads all resident weights
once. Storing matmul weights as int8 with per-output-channel scales halves
the bytes a step would stream. SubNetAct composes cleanly: quantization is
per-channel along the same output axes WeightSlice slices, so every subnet
of the quantized supernet is exactly the quantized version of that subnet.

The arithmetic is the reference's: fp32 amax over every axis but the
last, ``scale = max(amax / 127, 1e-12)``, IEEE division (by tensors on
both sides: CUDA divides by a Python scalar through its reciprocal),
round half to even (``torch.round``, as ``jnp.round``), clip to +-127,
int8. The same weights give the same int8 tree and scales on the CPU and
on the card.

Here :func:`dequantize_tree` writes a whole bf16 tree (through an fp32
temporary per leaf); XLA on the reference's TPU fuses the convert into the
consumer matmul instead. A dequantizing matmul is the port's lever for
that, not taken yet. Trees are the port's nested dicts and lists of
tensors; :func:`quantize_specs` takes and returns ``meta`` tensors and
allocates nothing.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

# leaves worth quantizing: big matmul weights (>= MIN_ELEMS, rank >= 2)
MIN_ELEMS = 1 << 16


def _is_weight(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.numel() >= MIN_ELEMS
            and leaf.dtype in (torch.bfloat16, torch.float32))


def _quantize_leaf(leaf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    f = leaf.float()
    amax = torch.amax(torch.abs(f), dim=tuple(range(leaf.dim() - 1)),
                      keepdim=True)                        # per out-channel
    # a tensor divisor: CUDA's division by a Python scalar multiplies by
    # its reciprocal, which is not IEEE division and breaks the bits
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tree(params: Any) -> Tuple[Any, Any]:
    """-> (q_tree, scale_tree). Non-weight leaves pass through in q_tree
    with a 0-d fp32 zero scale on their device."""
    def q(leaf):
        if _is_weight(leaf):
            return _quantize_leaf(leaf)
        return leaf, torch.zeros((), dtype=torch.float32,
                                 device=leaf.device)

    return _unzip(params, [q(leaf) for leaf in tree_leaves(params)])


def _unzip(tree, pairs) -> Tuple[Any, Any]:
    """Two trees of ``tree``'s structure from its leaves' pairs."""
    return (tree_unflatten(tree, [p[0] for p in pairs]),
            tree_unflatten(tree, [p[1] for p in pairs]))


def dequantize_tree(q_tree: Any, scale_tree: Any,
                    dtype=torch.bfloat16) -> Any:
    def dq(qv, scale):
        if qv.dtype != torch.int8:
            return qv
        return (qv.float() * scale).to(dtype)

    return tree_map(dq, q_tree, scale_tree)


def quantized_bytes(q_tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(q_tree))


def quantize_specs(param_specs: Any) -> Tuple[Any, Any]:
    """The ``meta`` version for the dry-run (no allocation): int8 leaves
    and ``(1, ..., 1, out)`` fp32 scales for the weights, the leaf itself
    and a 0-d fp32 scale for the rest."""
    def q(leaf):
        if not _is_weight(leaf):
            return leaf, torch.empty((), dtype=torch.float32, device="meta")
        scale_shape = (1,) * (leaf.dim() - 1) + (leaf.shape[-1],)
        return (torch.empty(leaf.shape, dtype=torch.int8, device="meta"),
                torch.empty(scale_shape, dtype=torch.float32, device="meta"))

    return _unzip(param_specs, [q(leaf) for leaf in tree_leaves(param_specs)])
