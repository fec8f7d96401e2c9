"""A served subnet's control, worked out from a configuration file's
frozen Pareto point with the arithmetic of SubNetAct's ``make_control``:
the first ``ceil(units * depth_frac)`` units live, FFN widths rounded to
128 channels (half to even), query heads sliced inside each KV group.

The reference, the counts and the judge read it; none of them reads the
program's own control tuples.
"""
from __future__ import annotations

import math
from typing import Dict

ALIGN = 128


def _align(x: float, align: int = ALIGN) -> int:
    return max(align, int(round(x / align)) * align)


def head_width(arch: Dict, frac: float) -> int:
    """Active query heads: a prefix of every KV group under GQA, a prefix
    of all heads under MHA."""
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    group = hq // hkv if hq % hkv == 0 else 1
    if group > 1:
        return hkv * max(1, int(round(group * frac)))
    return max(1, int(round(hq * frac)))


def ffn_size(arch: Dict) -> int:
    """The FFN's hidden size: an expert's in an MoE configuration."""
    return arch.get("moe_intermediate_size") or arch["intermediate_size"]


def control(arch: Dict, point: Dict) -> Dict:
    """The control of Pareto ``point`` (a dict of the frozen table) for
    the configuration ``arch`` (a configuration file's dict)."""
    units = arch["num_hidden_layers"]
    live = max(1, math.ceil(units * point["depth_frac"]))
    d_ff = ffn_size(arch)
    return {
        "gates": [r < live for r in range(units)],
        "ffn_width": min(d_ff, _align(d_ff * point["ffn_frac"])),
        "head_width": head_width(arch, point["head_frac"]),
        "topk": point["topk"] or arch.get("num_experts_per_tok", 0),
        "subnet_id": point["subnet_id"],
    }


def is_moe(arch: Dict) -> bool:
    return bool(arch.get("num_local_experts"))


def k_max(arch: Dict) -> int:
    """Routing slots a token takes: the largest k of any subnet."""
    return max([arch["num_experts_per_tok"]] + list(arch["topk_options"]))


def capacity(arch: Dict, n_tokens: int) -> int:
    """Slots an expert keeps for a batch of ``n_tokens``: ``k_max`` times
    the capacity factor over the experts, rounded up to 8, at least 8."""
    cap = int(n_tokens * k_max(arch) * arch["capacity_factor"]
              / arch["num_local_experts"])
    return max(8, -(-cap // 8) * 8)
