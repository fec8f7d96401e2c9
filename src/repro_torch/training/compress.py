"""int8 gradient compression with error feedback for the DP all-reduce
(port of ``repro/training/compress.py``).

Quantization is symmetric per tensor; error feedback keeps the
quantization residual locally and re-injects it next step (EF-SGD).

``all_reduce_int8`` keeps the reference's numerics: each rank quantizes
its gradient (with its error), and the ranks sum the *dequantized* fp32
values (``compress.py:62-68`` in the reference). So the all-reduce carries
fp32 on the wire, whatever the reference's docstring says of int8; only
the rounding is int8's.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_unflatten


def quantize(x, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    lim = 2.0 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(x)).float()
    # IEEE division by a tensor: the same bits on the CPU and the card
    scale = torch.clamp(amax / torch.full_like(amax, lim), min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -lim, lim).to(torch.int8)
    return q, scale


def dequantize(q, scale) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(g, err) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: q(g + err), new_err = (g + err) - deq."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    new_err = corrected - dequantize(q, scale)
    return q, scale, new_err


def all_reduce_int8(mesh, grads: Any, err: Any, axis: str = "data"):
    """Compressed mean-all-reduce of each rank's ``grads`` over mesh dim
    ``axis``. ``grads`` / ``err``: trees of this rank's tensors of the
    same shapes. Returns (mean_grads_fp32, new_err)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        q, scale, new_e = ef_quantize(g, e)
        summed = dequantize(q, scale)
        dist.all_reduce(summed, group=group)
        means.append(summed / n)
        errs.append(new_e)
    return tree_unflatten(grads, means), tree_unflatten(grads, errs)


def compression_ratio(tree) -> float:
    """Wire-bytes ratio fp32 -> int8(+scale)."""
    leaves = tree_leaves(tree)
    total = sum(x.numel() * 4 for x in leaves)
    wire = sum(x.numel() * 1 + 4 for x in leaves)
    return total / max(wire, 1)
