"""Mixture-of-Experts with capacity dispatch and SubNetAct elasticity (port
of ``repro/models/moe.py``):

* elastic top-k (``ctrl["topk"]`` masks routing slots: MoE's translation
  of WeightSlice),
* elastic per-expert d_ff (mask or switch mode),
* an optional shared expert (llama4), mask-form in both modes.

Dispatch is the reference's "dropping" strategy, batched over token
groups: tokens are reshaped to ``(n_groups, N_g, d)``, each group routes
its ``N_g * k_max`` assignments in a stable order by expert, and each
expert keeps the first ``capacity`` of them (:func:`_capacity`). It
computes what the reference computes, quirks included:

* the capacity counts ``k_max`` over ``topk_options``, not the active k;
* a dead routing slot (at or past the active k) still takes a place in
  its expert's order, so it can push a live one past capacity;
* decode routes ``B`` tokens a step and prefill ``B * S``, so they drop
  differently; pad tokens route and take capacity like real ones.

Nothing is read back to the host: the active k and width are 0-d device
tensors. The slots are written with one scatter whose only repeated
destination is the overflow row (always written with zeros), and each
token sums its k expert outputs in slot order, in the model dtype, so two
launches give the same bits. The router is an fp32 table and an fp32
product (TF32 stays off).

Mask mode runs every expert at full d_ff as batched products and zeroes
the hidden channels past ``moe_ffn_width``. Switch mode runs the three
expert products through the grouped ``sliced_matmul`` kernel entry point
(one launch for all experts), which reads ``moe_ffn_width`` as data.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.distributed.placement import (expert_matmul, group_local,
                                              pin_groups)
from repro_torch.kernels import ops as kops
from repro_torch.models.common import Dense, ones_table, pre_norm


def init_moe(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``: the fp32 router, the
    ``(E, d, f)`` / ``(E, f, d)`` expert tables (fan-in E, as the
    reference draws them) and the shared expert's matrices."""
    d, f, E = cfg.d_model, cfg.resolved_moe_d_ff, cfg.n_experts
    init = partial(Dense, dtype=dtype)
    p = {
        "router": Dense((d, E), torch.float32),
        "wg": init((E, d, f)),
        "wu": init((E, d, f)),
        "wd": init((E, f, d)),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
    }
    if cfg.shared_expert:
        p["swg"] = init((d, f))
        p["swu"] = init((d, f))
        p["swd"] = init((f, d))
    return p


def k_max(cfg: ArchConfig) -> int:
    """Routing slots per token: the largest k any subnet activates."""
    return max(cfg.top_k, max(cfg.elastic.topk_options or (cfg.top_k,)))


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for a group of ``n_tokens``: ``k_max`` (not the
    active k) times the capacity factor, rounded up to a multiple of 8,
    at least 8."""
    cap = int(n_tokens * k_max(cfg) * cfg.capacity_factor
              / max(cfg.n_experts, 1))
    return max(8, -(-cap // 8) * 8)


def route(logits, cfg: ArchConfig):
    """Expert ids ``(G, N, k_max)`` of each token, best first."""
    return torch.topk(logits, k_max(cfg), dim=-1).indices


def dispatch(h, logits, eids, topk, cfg: ArchConfig, capacity: int):
    """Dispatch token groups. h: (G, N, d); logits: (G, N, E) fp32; eids:
    (G, N, k) from :func:`route`; ``topk``: the active k (an int or a 0-d
    tensor). Returns the slots ``(G, E, C, d)`` and the combine metadata,
    each ``(G, N * k)`` in expert-sorted order: ``order``, ``src_token``,
    ``dest`` (``E * C`` for a dropped or dead assignment), ``keep``, and
    ``gates``."""
    G, N, d = h.shape
    E, k = cfg.n_experts, eids.shape[-1]
    dev = h.device
    gates = torch.softmax(torch.gather(logits, -1, eids), dim=-1)
    slot_live = torch.arange(k, device=dev) < topk                # (k,)
    gates = torch.where(slot_live, gates, 0.0)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = torch.where(slot_live, gates, 0.0)

    flat_e = eids.reshape(G, N * k)
    # group the assignments by expert (stable: a deterministic drop order)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_live = slot_live[order % k]
    first_of_e = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(N * k, device=dev) - first_of_e
    keep = (pos_in_e < capacity) & sorted_live
    dest = torch.where(keep, sorted_e * capacity + pos_in_e, E * capacity)

    src_token = order // k
    gathered = torch.gather(h, 1, src_token[..., None].expand(G, N * k, d))
    rows = E * capacity + 1                       # + the overflow row
    slots = h.new_zeros((G * rows, d))
    # kept destinations are distinct; only the overflow row repeats, and
    # every write to it is zeros
    flat_dest = dest + rows * torch.arange(G, device=dev)[:, None]
    slots.index_put_((flat_dest.reshape(-1),),
                     torch.where(keep[..., None], gathered, 0).reshape(-1, d))
    slots = slots.reshape(G, rows, d)[:, :-1].reshape(G, E, capacity, d)
    meta = dict(order=order, src_token=src_token, dest=dest, keep=keep,
                gates=torch.gather(gates.reshape(G, N * k), 1, order))
    return slots, meta


def combine(expert_out, meta, n_tokens: int):
    """expert_out: (G, E, C, d) -> (G, N, d): each token's kept expert
    outputs times their gates, summed in slot order in the model dtype."""
    G, E, C, d = expert_out.shape
    order = meta["order"]
    nk = order.shape[1]
    flat = torch.cat([expert_out.reshape(G, E * C, d),
                      expert_out.new_zeros((G, 1, d))], dim=1)
    y_sorted = torch.gather(flat, 1, meta["dest"].clamp_max(E * C)[..., None]
                            .expand(G, nk, d))
    w = (meta["gates"] * meta["keep"]).to(flat.dtype)
    y_sorted = y_sorted * w[..., None]
    # back to (token, slot) order: the inverse of the sort
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(nk, device=order.device).expand(G, nk))
    parts = torch.gather(y_sorted, 1, inv[..., None].expand(G, nk, d)
                         ).reshape(G, n_tokens, nk // n_tokens, d)
    y = parts[:, :, 0]
    for j in range(1, parts.shape[2]):
        y = y + parts[:, :, j]
    return y


def _experts_switch(slots, p, width):
    """The expert SwiGLU over the first ``width`` hidden channels, three
    grouped ``sliced_matmul`` launches. slots: (G, E, C, d)."""
    G, E, C, d = slots.shape
    x = slots[0] if G == 1 else slots.transpose(0, 1).reshape(E, G * C, d)
    a = F.silu(kops.sliced_matmul(x, p["wg"], None, width)) \
        * kops.sliced_matmul(x, p["wu"], None, width)
    out = kops.sliced_matmul(a, p["wd"], width, None)
    return (out[None] if G == 1
            else out.reshape(E, G, C, d).transpose(0, 1))


def moe_block(p, cfg: ArchConfig, x, ctrl, *, slice_mode: str = "mask",
              n_groups: int = 1, group_axes=None):
    """Pre-norm MoE. x: (B, S, d) -> (B, S, d).

    ``group_axes``: the mesh dims the group dim is sharded over (the DP
    axes). On DTensors the group tensors are pinned there
    (``distributed.placement.pin_groups``), so every dispatch sort and
    scatter stays local to its data shard, as the reference's
    ``with_sharding_constraint`` keeps it, and the dispatch and combine
    run on each rank's own groups (``placement.group_local``); on plain
    tensors it does nothing."""
    s, y = moe_block_pending(p, cfg, x, None, ctrl, slice_mode=slice_mode,
                             n_groups=n_groups, group_axes=group_axes)
    return s + y


def moe_block_pending(p, cfg: ArchConfig, x, delta, ctrl, *,
                      slice_mode: str = "mask", n_groups: int = 1,
                      group_axes=None):
    """:func:`moe_block` with the previous block's residual add pending:
    returns ``(s, y)``, ``s = x + delta`` (the add fused into the pre-norm;
    ``delta`` None means ``s = x``) and ``y`` this block's output in x's
    type, not yet added."""
    pin = partial(pin_groups, axes=group_axes)
    ops.check_slice_mode(slice_mode)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    B, S, d = h.shape
    N = B * S
    n_groups = max(1, min(n_groups, N))
    while N % n_groups:
        n_groups -= 1
    Ng = N // n_groups
    # each rank's rows are its own groups when they are sharded over the
    # group axes: the reshape is made locally (group_local)
    hg = group_local(lambda t: t.reshape(-1, Ng, d), group_axes, h)
    logits = hg.float() @ p["router"]                         # (G, Ng, E)
    cap = _capacity(Ng, cfg)
    slots, meta = group_local(
        lambda hh, ll, k: dispatch(hh, ll, route(ll, cfg), k, cfg, cap),
        group_axes, hg, logits, ctrl["topk"])
    slots = pin(slots)
    if slice_mode == "switch" and len(cfg.elastic.ffn_fracs) > 1:
        out = _experts_switch(slots, p, ctrl["moe_ffn_width"])
    else:
        a = F.silu(expert_matmul(slots, p["wg"])) \
            * expert_matmul(slots, p["wu"])
        a = ops.slice_mask(a, ctrl["moe_ffn_width"])
        out = expert_matmul(a, p["wd"])
    # combine in the model dtype, as the reference does
    y = group_local(lambda o, m: combine(o, m, Ng).reshape(-1, S, d),
                    group_axes, pin(out.to(x.dtype)), meta)
    if cfg.shared_expert:
        a = F.silu(h @ p["swg"]) * (h @ p["swu"])
        a = ops.slice_mask(a, ctrl["moe_ffn_width"])
        y = y + a @ p["swd"]
    return s, y.to(s.dtype)
