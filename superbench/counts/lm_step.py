"""The work of one served prefill step of a token LM, from its
configuration file and the served subnet's control (``subnet.control``).

* :func:`useful_flops` — what ``step_mfu`` counts: the served subnet's
  matrix products for its real rows and tokens, causal attention over the
  active heads, and the head at each row's last position only. Pad rows,
  pad tokens and mask mode's masked channels count nothing.
* :func:`launches` — the ``(FLOPs, bytes)`` of every launch of a kernel in
  one step at the padded ``(Bb, Sb)``, as the kernel is asked to work:
  ``sliced_matmul`` (switch mode only; FFN or expert products and ``wo``)
  and ``flash_attention``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from superbench import subnet
from superbench.counts import flash_attention, sliced_matmul


def _dims(arch: Dict):
    return (arch["hidden_size"], arch["head_dim"],
            arch["num_attention_heads"], arch["num_key_value_heads"])


def useful_flops(arch: Dict, ctrl: Dict, rows: int, seq: int) -> float:
    """FLOPs of ``rows`` real rows of ``seq`` real tokens."""
    d, hd, hq, hkv = _dims(arch)
    hw, fw = ctrl["head_width"], ctrl["ffn_width"]
    attn_tok = 2.0 * d * hd * (hw + 2 * hkv + hw)
    attn_row = 4.0 * hd * hw * flash_attention.causal_pairs(
        seq, arch.get("sliding_window") or 0)
    if subnet.is_moe(arch):
        ffn_tok = (2.0 * d * arch["num_local_experts"]
                   + ctrl["topk"] * 2.0 * 3 * d * fw)
    else:
        ffn_tok = 2.0 * 3 * d * fw
    units = sum(ctrl["gates"])
    per_row = (units * (seq * (attn_tok + ffn_tok) + attn_row)
               + 2.0 * d * arch["vocab_size"])
    return rows * per_row


def launches(arch: Dict, ctrl: Dict, mode: str, bb: int,
             sb: int) -> Dict[str, List[Tuple[float, float]]]:
    """Kernel name (as ``compat.launch_counts`` counts it) -> the
    ``(FLOPs, bytes)`` of each of its launches in one step."""
    d, hd, hq, hkv = _dims(arch)
    hw, fw = ctrl["head_width"], ctrl["ffn_width"]
    f = subnet.ffn_size(arch)
    m = bb * sb
    switch = mode == "switch"
    out: Dict[str, List[Tuple[float, float]]] = {
        "flash_attention": [], "sliced_matmul": [],
        "sliced_matmul.experts": []}
    for live in ctrl["gates"]:
        if not live:
            continue
        out["flash_attention"].append(flash_attention.launch(
            bb, sb, hw if switch else hq, hq, hkv, hd,
            arch.get("sliding_window") or 0))
        if not switch:
            continue
        out["sliced_matmul"].append(sliced_matmul.dense(m, hw * hd, d, d))
        if subnet.is_moe(arch):
            e = arch["num_local_experts"]
            routed, slots = m * ctrl["topk"], subnet.capacity(arch, m)
            up = sliced_matmul.experts(e, routed, slots, d, fw, f)
            out["sliced_matmul.experts"] += [
                up, up, sliced_matmul.experts(e, routed, slots, fw, d, d)]
        else:
            up = sliced_matmul.dense(m, d, fw, f)
            out["sliced_matmul"] += [up, up,
                                     sliced_matmul.dense(m, fw, d, d)]
    return out
