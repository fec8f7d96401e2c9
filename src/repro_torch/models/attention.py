"""Attention: GQA/MHA with RoPE, M-RoPE (qwen2-vl) and partial rotary,
sliding window, SubNetAct head elasticity, flash prefill and cached decode
(port of ``repro/models/attention.py``).

The attention itself goes through the kernel entry points
(``kernels.ops.model_flash_attention`` / ``model_decode_attention``): the
CUDA kernels on the GPU, their plain versions on the CPU.

WeightSlice switch mode (prefill): attention computes only the active
query heads (the flash kernel reads ``head_width`` and writes zeros for
the rest), and the output projection goes through the ``sliced_matmul``
kernel, which contracts only the rows of the active heads: under GQA the
first ``head_width // kv`` heads of each KV group (one K segment per KV
head), under MHA the first ``head_width`` heads. The width it reads,
``wo_in_width`` = active heads per segment x head_dim, is derived once per
control tuple by :func:`with_wo_width`. Decode has no switch branch (as in
the JAX package) and runs the mask path.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.core.subnet import head_group_size
from repro_torch.distributed.placement import write_slot
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (Dense, merge_heads, ones_table,
                                      pre_norm, split_heads)

# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim_rot: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim_rot, 2, dtype=torch.float32,
                                         device=device) / head_dim_rot))


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0,
               mrope_sections=()):
    """x: (B, S, H, hd); positions: (B, S) integer tensor, or (3, B, S)
    for M-RoPE.

    M-RoPE (qwen2-vl): the rot/2 frequency slots are partitioned into
    ``mrope_sections`` (temporal, h, w); each slot takes its angle from
    its section's position stream."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, theta, x.device)                  # (rot/2,)
    if mrope_sections:
        # each slot's stream, (rot/2, B, S), as views of the three
        pos = torch.cat([positions[i:i + 1].expand(n, *positions.shape[1:])
                         for i, n in enumerate(mrope_sections)])[:rot // 2]
        ang = pos.float().permute(1, 2, 0) * inv            # (B, S, rot/2)
    else:
        ang = positions.float()[..., None] * inv            # (B, S, rot/2)
    ang = torch.cat([ang, ang], dim=-1)[:, :, None, :]      # (B, S, 1, rot)
    x_rot = (x_rot * torch.cos(ang).to(x.dtype)
             + _rotate_half(x_rot) * torch.sin(ang).to(x.dtype))
    return torch.cat([x_rot, x_pass], dim=-1)


# --------------------------------------------------------------------------
# Attention block (params + forward), SubNetAct-elastic
# --------------------------------------------------------------------------


def init_attention(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    init = partial(Dense, dtype=dtype)
    p = {
        "wq": init((d, Hq * hd)),
        "wk": init((d, Hkv * hd)),
        "wv": init((d, Hkv * hd)),
        "wo": init((Hq * hd, d)),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
    if cfg.norm == "layernorm":
        p["norm_beta"] = torch.zeros((cfg.elastic.num_subnets, d),
                                     dtype=torch.float32, device=device)
    return p


def _project_qkv(p, cfg: ArchConfig, x, positions):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct,
                       cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct,
                       cfg.mrope_sections)
    return q, k, v


def head_mask(cfg: ArchConfig, o, head_width):
    """Zero the outputs of inactive query heads. o: (..., Hq, hd).

    GQA: active heads are a per-KV-group prefix (cache layout stays
    identical across subnets); MHA: a global prefix."""
    Hq = cfg.n_heads
    m = kref.head_active(Hq, Hq // head_group_size(cfg), head_width,
                         o.device)
    shape = [1] * o.dim()
    shape[-2] = Hq
    return o * m.reshape(shape).to(o.dtype)


WO_WIDTH = "wo_in_width"


def wo_segments(cfg: ArchConfig) -> int:
    """K segments of the output projection in switch mode: one per KV head
    under GQA (heads are sliced inside each group), one under MHA."""
    group = head_group_size(cfg)
    return cfg.n_heads // group if group > 1 else 1


def with_wo_width(cfg: ArchConfig, ctrl: Dict) -> Dict:
    """``ctrl`` with ``wo_in_width``: the rows of each ``wo`` segment that
    the active heads use, ``(head_width // segments) * head_dim``. Computed
    in numpy for a host tuple and with one device op for a converted one;
    a tuple that has it passes through unchanged."""
    if WO_WIDTH in ctrl:
        return ctrl
    out = dict(ctrl)
    out[WO_WIDTH] = (ctrl["head_width"] // wo_segments(cfg)
                     * cfg.resolved_head_dim)
    return out


def attention_block(p, cfg: ArchConfig, x, ctrl, positions, *,
                    slice_mode: str = "mask", attn_impl=None,
                    q_block: int = 512, kv_block: int = 512):
    """Full-sequence attention with pre-norm. x: (B,S,d) -> (B,S,d).

    ``attn_impl=None`` takes the kernel entry point for the device of
    ``x``; pass an impl to pin one (tests)."""
    s, y = attention_block_pending(p, cfg, x, None, ctrl, positions,
                                   slice_mode=slice_mode, attn_impl=attn_impl,
                                   q_block=q_block, kv_block=kv_block)
    return s + y


def attention_block_pending(p, cfg: ArchConfig, x, delta, ctrl, positions, *,
                            slice_mode: str = "mask", attn_impl=None,
                            q_block: int = 512, kv_block: int = 512):
    """:func:`attention_block` with the previous block's residual add still
    pending: returns ``(s, y)``, where ``s = x + delta`` is this block's
    input residual (the add fused into the pre-norm; ``delta`` None means
    ``s = x``) and ``y`` is this block's output in x's type, not yet added
    (the block's result is ``s + y``)."""
    ops.check_slice_mode(slice_mode)
    if attn_impl is None:
        from repro_torch.kernels.ops import model_flash_attention
        attn_impl = partial(model_flash_attention, q_block=q_block,
                            kv_block=kv_block)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    q, k, v = _project_qkv(p, cfg, h, positions)
    B, S, Hq, hd = q.shape
    switch = slice_mode == "switch" and len(cfg.elastic.head_fracs) > 1
    # WeightSlice(switch): attention computes only the active heads (their
    # outputs; the rest are 0), as the JAX switch branch slices them
    o = attn_impl(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=True, window=cfg.sliding_window,
                  **({"head_width": ctrl["head_width"]} if switch else {}))
    o = o.transpose(1, 2)                               # (B,S,H,hd)
    if switch:
        # and only the active heads' rows of wo are read (o is a view of
        # the kernel's (B, S, H, hd) buffer on the card)
        y = kops.sliced_matmul(o.reshape(B * S, Hq * hd), p["wo"],
                               with_wo_width(cfg, ctrl)[WO_WIDTH], None,
                               segments=wo_segments(cfg))
        return s, y.reshape(B, S, -1).to(s.dtype)
    # WeightSlice(mask): zero the *outputs* of inactive heads —
    # paper-faithful routing (inactive channels contribute nothing).
    o = head_mask(cfg, o, ctrl["head_width"])
    y = merge_heads(o) @ p["wo"]
    return s, y.to(s.dtype)


def attention_decode(p, cfg: ArchConfig, x, ctrl, cache, index, *,
                     slice_mode: str = "mask", decode_impl=None,
                     kv_block: int = 512):
    """One-token decode. x: (B,1,d); cache: {'k','v'}: (B,Hkv,Smax,hd);
    ``index``: 0-d int32 tensor on x's device (the new token's absolute
    position). Unlike the functional JAX version, the new k/v are written
    into ``cache`` in place; the returned dict holds the same tensors."""
    s, y = attention_decode_pending(p, cfg, x, None, ctrl, cache, index,
                                    slice_mode=slice_mode,
                                    decode_impl=decode_impl,
                                    kv_block=kv_block)
    return s + y, {"k": cache["k"], "v": cache["v"]}


def attention_decode_pending(p, cfg: ArchConfig, x, delta, ctrl, cache,
                             index, *, slice_mode: str = "mask",
                             decode_impl=None, kv_block: int = 512):
    """:func:`attention_decode` with the previous block's residual add
    pending, as :func:`attention_block_pending`: returns ``(s, y)`` and
    updates ``cache`` in place."""
    ops.check_slice_mode(slice_mode)
    if decode_impl is None:
        from repro_torch.kernels.ops import model_decode_attention
        decode_impl = partial(model_decode_attention, kv_block=kv_block)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    B = x.shape[0]
    # M-RoPE's three streams all at index, as the reference decodes
    pos_shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
    positions = index.reshape((1,) * len(pos_shape)).expand(pos_shape)
    q, k, v = _project_qkv(p, cfg, h, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    Smax = k_cache.shape[2]
    slot = torch.remainder(index, Smax) if cfg.sliding_window else index
    slot = slot.reshape(1).long()
    write_slot(k_cache, 2, slot, k.transpose(1, 2).to(k_cache.dtype))
    write_slot(v_cache, 2, slot, v.transpose(1, 2).to(v_cache.dtype))
    o = decode_impl(q.transpose(1, 2), k_cache, v_cache, index=index,
                    window=cfg.sliding_window)
    o = o.transpose(1, 2)                               # (B,1,H,hd)
    o = head_mask(cfg, o, ctrl["head_width"])
    y = merge_heads(o) @ p["wo"]
    return s, y.to(s.dtype)


def init_attention_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype,
                         device) -> Dict:
    Smax = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, cfg.n_kv_heads, Smax, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
