"""Subnet descriptors, the architecture space Phi, and control tuples.

A *subnet* is a point in the SubNetAct control space (paper Sec. 2.2/3):
``(D, E, W)`` = (depth, expand-ratio, width-multiplier), extended here
with the MoE top-k knob. The host-side :class:`SubnetDescriptor` is pure
metadata; :func:`make_control` lowers it into the device-side control
tuple (small integer arrays) consumed by the jitted step functions.

Actuation == passing a different control tuple. Same compiled
executable, no weight movement, no recompilation.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ElasticSpec, Stage

# Round active channel counts to the MXU-friendly lane width.
CHANNEL_ALIGN = 128


def _align(x: int, align: int = CHANNEL_ALIGN) -> int:
    return max(align, int(round(x / align)) * align)


@dataclass(frozen=True, order=True)
class SubnetDescriptor:
    """One subnet phi in Phi: host-side, hashable, orderable."""

    depth_frac: float
    ffn_frac: float
    head_frac: float
    topk: int = 0            # 0 = arch default / not MoE
    subnet_id: int = 0       # index into SubnetNorm tables & profiles

    def key(self) -> Tuple:
        return (self.depth_frac, self.ffn_frac, self.head_frac, self.topk)


def enumerate_space(cfg: ArchConfig) -> List[SubnetDescriptor]:
    """Enumerate Phi for this arch from its ElasticSpec (deterministic)."""
    e = cfg.elastic
    topks: Tuple[int, ...] = e.topk_options or (cfg.top_k,)
    out: List[SubnetDescriptor] = []
    sid = 0
    for d, f, h, k in itertools.product(
        sorted(e.depth_fracs), sorted(e.ffn_fracs), sorted(e.head_fracs), sorted(topks)
    ):
        out.append(SubnetDescriptor(d, f, h, k, subnet_id=sid))
        sid += 1
    return out


def max_subnet(cfg: ArchConfig) -> SubnetDescriptor:
    space = enumerate_space(cfg)
    return max(space, key=lambda s: (s.depth_frac, s.ffn_frac, s.head_frac, s.topk))


def min_subnet(cfg: ArchConfig) -> SubnetDescriptor:
    space = enumerate_space(cfg)
    return min(space, key=lambda s: (s.depth_frac, s.ffn_frac, s.head_frac, s.topk))


# --------------------------------------------------------------------------
# Device-side control tuple
# --------------------------------------------------------------------------


def active_ffn(cfg: ArchConfig, frac: float) -> int:
    return min(cfg.d_ff, _align(cfg.d_ff * frac))


def active_moe_ffn(cfg: ArchConfig, frac: float) -> int:
    return min(cfg.resolved_moe_d_ff, _align(cfg.resolved_moe_d_ff * frac))


def head_group_size(cfg: ArchConfig) -> int:
    """Query heads per KV head (GQA group size; 1 for MHA)."""
    kv = max(cfg.n_kv_heads, 1)
    return cfg.n_heads // kv if cfg.n_heads % kv == 0 else 1


def active_heads(cfg: ArchConfig, frac: float) -> int:
    """Active query heads under WeightSlice.

    GQA (group > 1): slice query heads *within* each KV group — every
    KV head keeps serving, so the cache layout is identical for every
    subnet. MHA (group == 1): prefix of heads (q and k/v drop together).
    """
    group = head_group_size(cfg)
    if group > 1:
        kv = cfg.n_heads // group
        a = max(1, int(round(group * frac)))
        return kv * a
    return max(1, int(round(cfg.n_heads * frac)))


def stage_gates(cfg: ArchConfig, depth_frac: float) -> np.ndarray:
    """Per-repeat-unit boolean gates (LayerSelect input), concatenated
    over stages. Active units are the *first* ceil(frac*repeat) of each
    stage (OFA keeps early layers; late layers are the elastic ones)."""
    gates = []
    for s in cfg.stages:
        n_active = max(1, int(np.ceil(s.repeat * depth_frac)))
        g = np.zeros((s.repeat,), dtype=bool)
        g[:n_active] = True
        gates.append(g)
    return np.concatenate(gates) if gates else np.zeros((0,), dtype=bool)


def make_control(cfg: ArchConfig, sub: SubnetDescriptor) -> Dict[str, np.ndarray]:
    """Lower a descriptor into the device-side control tuple.

    Everything is a *value*, never a shape: jit once, actuate forever.
    ``*_bucket`` fields index the discrete option (for WeightSlice
    switch-mode); ``*_width`` fields carry the channel count (for
    mask-mode and the Pallas sliced kernels).
    """
    e = cfg.elastic
    ffn_opts = sorted(e.ffn_fracs)
    head_opts = sorted(e.head_fracs)
    slstm_ff = int(cfg.slstm_proj_factor * cfg.d_model)
    ctrl = {
        "layer_gate": stage_gates(cfg, sub.depth_frac),
        "ffn_width": np.int32(active_ffn(cfg, sub.ffn_frac)),
        "slstm_ffn_width": np.int32(min(slstm_ff, _align(slstm_ff * sub.ffn_frac, 64))),
        "ffn_bucket": np.int32(ffn_opts.index(sub.ffn_frac)),
        "moe_ffn_width": np.int32(active_moe_ffn(cfg, sub.ffn_frac)),
        "head_width": np.int32(active_heads(cfg, sub.head_frac)),
        "head_bucket": np.int32(head_opts.index(sub.head_frac)),
        "topk": np.int32(sub.topk or cfg.top_k or 0),
        "subnet_id": np.int32(sub.subnet_id),
    }
    return ctrl


def option_counts(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """Options of each elastic dimension: depth, ffn, heads, top-k."""
    e = cfg.elastic
    return (len(e.depth_fracs), len(e.ffn_fracs), len(e.head_fracs),
            len(e.topk_options or (cfg.top_k,)))


def control_from_indices(cfg: ArchConfig, di: int, fi: int, hi: int,
                         ki: int) -> Dict[str, np.ndarray]:
    """The control tuple of the subnet with option indices ``(di, fi, hi,
    ki)`` into the sorted depth, ffn, head and top-k options, in
    :func:`make_control`'s form (``layer_gate`` a host bool array, the
    rest int32 scalars).

    Port of the body of ``repro.core.subnet.sample_control_jax``, with its
    own arithmetic: the fractions are float32, a stage keeps
    ``max(1, ceil(repeat * frac))`` units, a width is ``round(total * frac
    / align) * align`` (half to even) clipped to ``[min(align, total),
    total]``, and ``subnet_id`` the mixed-radix index of
    :func:`enumerate_space`. This is not :func:`make_control`'s ``_align``
    on float64."""
    e = cfg.elastic
    f32 = np.float32
    d_frac = f32(sorted(e.depth_fracs)[di])
    f_frac = f32(sorted(e.ffn_fracs)[fi])
    h_frac = f32(sorted(e.head_fracs)[hi])
    topk_opts = sorted(e.topk_options or (cfg.top_k,))

    gates = []
    for s in cfg.stages:
        n_active = max(1, int(np.ceil(f32(s.repeat) * d_frac)))
        gates.append(np.arange(s.repeat) < n_active)
    layer_gate = (np.concatenate(gates) if gates
                  else np.zeros((0,), dtype=bool))

    def aligned(total: int, frac, align: int = CHANNEL_ALIGN) -> np.int32:
        w = np.round(f32(total) * frac / f32(align)) * f32(align)
        return np.int32(np.clip(w, min(align, total), total))

    group = head_group_size(cfg)
    if group > 1:
        kv = cfg.n_heads // group
        head_width = kv * max(1, int(np.round(f32(group) * h_frac)))
    else:
        head_width = max(1, int(np.round(f32(cfg.n_heads) * h_frac)))
    slstm_ff = int(cfg.slstm_proj_factor * cfg.d_model)
    _, n_f, n_h, n_k = option_counts(cfg)
    return {
        "layer_gate": layer_gate,
        "ffn_width": aligned(cfg.d_ff, f_frac) if cfg.d_ff else np.int32(0),
        "slstm_ffn_width": aligned(slstm_ff, f_frac, 64),
        "ffn_bucket": np.int32(fi),
        "moe_ffn_width": (aligned(cfg.resolved_moe_d_ff, f_frac)
                          if cfg.resolved_moe_d_ff else np.int32(0)),
        "head_width": np.int32(head_width),
        "head_bucket": np.int32(hi),
        "topk": np.int32(topk_opts[ki]),
        "subnet_id": np.int32(((di * n_f + fi) * n_h + hi) * n_k + ki),
    }


def sample_control(cfg: ArchConfig, generator) -> Dict[str, np.ndarray]:
    """A random subnet's control tuple for sandwich-rule training: the
    four option indices drawn on the host from ``generator`` (a CPU
    ``torch.Generator``), uniform over each dimension's options as
    ``sample_control_jax`` draws them."""
    import torch
    idx = [int(torch.randint(0, n, (), generator=generator))
           for n in option_counts(cfg)]
    return control_from_indices(cfg, *idx)


def width_options(cfg: ArchConfig) -> Dict[str, List[int]]:
    """The discrete channel-count options per elastic dimension —
    these are the static shapes compiled into WeightSlice switch-mode."""
    e = cfg.elastic
    return {
        "ffn": [active_ffn(cfg, f) for f in sorted(e.ffn_fracs)],
        "moe_ffn": [active_moe_ffn(cfg, f) for f in sorted(e.ffn_fracs)],
        "heads": [active_heads(cfg, f) for f in sorted(e.head_fracs)],
    }


# --------------------------------------------------------------------------
# Analytic FLOPs / params per subnet (drives accuracy+latency predictors,
# memory benchmarks, and MODEL_FLOPS in the roofline report)
# --------------------------------------------------------------------------


def _unit_param_flops(cfg: ArchConfig, kind: str, sub: Optional[SubnetDescriptor]):
    """(params, flops_per_token) for one sub-block at a subnet point.

    ``sub=None`` means the full supernet (all channels, all experts
    resident). FLOPs are matmul MACs*2; norms/elementwise ignored.
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if sub is None:
        heads, ffn, moe_ffn, topk = cfg.n_heads, cfg.d_ff, cfg.resolved_moe_d_ff, cfg.top_k
    else:
        heads = active_heads(cfg, sub.head_frac)
        ffn = active_ffn(cfg, sub.ffn_frac)
        moe_ffn = active_moe_ffn(cfg, sub.ffn_frac)
        topk = sub.topk or cfg.top_k

    if kind == "attn":
        q = d * heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = heads * hd * d
        p = q + kv + o
        return p, 2 * p
    if kind == "mlp":
        mats = 3 if cfg.ffn_act == "swiglu" else 2   # SwiGLU: gate,up,down; GELU: up,down
        p = mats * d * ffn
        return p, 2 * p
    if kind == "moe":
        p_router = d * cfg.n_experts
        p_expert = 3 * d * moe_ffn
        p_shared = 3 * d * cfg.resolved_moe_d_ff if cfg.shared_expert else 0
        params_resident = p_router + cfg.n_experts * p_expert + p_shared
        flops_active = 2 * (p_router + topk * p_expert + p_shared)
        return params_resident, flops_active
    if kind == "mamba":
        d_in = cfg.ssm_expand * d
        n_h = d_in // cfg.ssm_head_dim
        # in_proj: x, z (2*d_in) + B, C (2*state) + dt (n_h); conv; out_proj.
        p = d * (2 * d_in + 2 * cfg.ssm_state + n_h) + d_in * cfg.ssm_conv_width + d_in * d
        flops = 2 * p + 4 * d_in * cfg.ssm_state   # + SSD state update/read
        return p, flops
    if kind == "mlstm":
        d_in = int(cfg.mlstm_proj_factor * d)
        qk = d_in // 2
        # up-proj (x, z), q/k proj, v==x, learnable skip, out proj.
        p = d * 2 * d_in + d_in * qk * 2 + d_in * d_in + d_in * d + 3 * d_in
        flops = 2 * p
        return p, flops
    if kind == "slstm":
        p = 4 * d * d + int(3 * d * cfg.slstm_proj_factor * d)
        return p, 2 * p
    raise ValueError(kind)


def count_params(cfg: ArchConfig, sub: Optional[SubnetDescriptor] = None,
                 resident: bool = True) -> int:
    """Parameter count. ``resident`` counts the full supernet weights
    (what sits in HBM); ``resident=False`` with a descriptor counts the
    *extracted* subnet (what Clipper+ would load per model)."""
    total = 0
    gates = stage_gates(cfg, sub.depth_frac if sub else 1.0)
    gi = 0
    for s in cfg.stages:
        for r in range(s.repeat):
            live = bool(gates[gi]) if (sub and not resident) else True
            gi += 1
            for kind in s.pattern:
                p, _ = _unit_param_flops(cfg, kind, None if resident else sub)
                if live:
                    total += p
    if cfg.shared_attn_period:
        p, _ = _unit_param_flops(cfg, "attn", None if resident else sub)
        total += p
    emb = cfg.vocab_size * cfg.d_model
    total += emb if cfg.tie_embeddings else 2 * emb
    return int(total)


def flops_per_token(cfg: ArchConfig, sub: Optional[SubnetDescriptor] = None) -> int:
    """Active matmul FLOPs per token for a subnet (or the max net)."""
    total = 0
    gates = stage_gates(cfg, sub.depth_frac if sub else 1.0)
    gi = 0
    for s in cfg.stages:
        for r in range(s.repeat):
            live = bool(gates[gi])
            gi += 1
            if not live:
                continue
            for kind in s.pattern:
                _, f = _unit_param_flops(cfg, kind, sub)
                total += f
            if cfg.shared_attn_period and (r % cfg.shared_attn_period == cfg.shared_attn_period - 1):
                _, f = _unit_param_flops(cfg, "attn", sub)
                total += f
    total += 2 * cfg.vocab_size * cfg.d_model     # lm head
    return int(total)
