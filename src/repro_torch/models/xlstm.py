"""xLSTM blocks: mLSTM (matrix memory, parallel through a flash-style
log-space gated form) and sLSTM (scalar memory, sequential over time;
O(1)-state decode). Port of ``repro/models/xlstm.py``.

Canonical semantics is the stabilized recurrence of the xLSTM paper:

    m_t = max(m_{t-1} + logf_t, i_t)
    C_t = e^{m_{t-1}+logf_t-m_t} C_{t-1} + e^{i_t-m_t} k_t v_t^T
    n_t = e^{m_{t-1}+logf_t-m_t} n_{t-1} + e^{i_t-m_t} k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, e^{-m_t})

The parallel form of prefill is its exact unrolled equivalent: exponent
e_ij = LF_i - LF_j + i_j (LF = cumsum log f), whose running row-max is
m_t, computed blockwise (:func:`gla_flash`). The sLSTM cell runs under a
Python loop over the sequence (the JAX version's ``lax.scan``), so a
prefill launches a cell's ops S times in every sLSTM layer.

Recurrent *state* dims are not SubNetAct-elastic; depth elasticity
applies per block, and the only width that actuates is the sLSTM
post-FFN's, in mask form in both WeightSlice modes (the JAX package has
no switch branch there). ``w_if``, ``b_if`` and ``head_norm`` (mLSTM) and
``w_x``, ``r`` and ``b`` (sLSTM) stay fp32 in a bf16 model.

Each block takes the pair ``(x, delta)`` and returns ``(s, y)``, as
``attention.attention_block_pending`` does: the pre-norm makes the
previous block's pending residual add, and sLSTM's second norm
(``ffn_gamma``) makes the recurrence's add the same way. No part of the
blocks reaches a TPU kernel in the JAX package, so they are plain PyTorch
on every device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.models.common import Dense, ones_table, pre_norm

NEG_INF = -1e30


def _mlstm_dims(cfg: ArchConfig):
    d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    d_qk = d_in // 2
    return d_in, H, d_qk


def _head_norm(o, gain, eps: float):
    """The per-token RMSNorm of the heads' fp32 output, times ``gain``."""
    return o * torch.rsqrt(o.square().mean(-1, keepdim=True) + eps) * gain


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def init_mlstm(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``."""
    d = cfg.d_model
    d_in, H, d_qk = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": Dense((d, 2 * d_in), dtype),                 # x_in, z
        "wq": Dense((d_in, d_qk), dtype),
        "wk": Dense((d_in, d_qk), dtype),
        "w_if": Dense((d_in, 2 * H), torch.float32),
        "b_if": torch.cat([torch.zeros((H,), **f32),
                           torch.linspace(3.0, 6.0, H, **f32)]),
        "w_out": Dense((d_in, d), dtype),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
        "head_norm": torch.ones((d_in,), **f32),
    }


def gla_flash(q, k, v, LF, b, *, block: int = 256):
    """Blockwise gated linear attention (the mLSTM parallel form).

    q, k: (B, H, S, dqk); v: (B, H, S, dv); LF: (B, H, S) cumulative
    log-forget; b: (B, H, S) per-key exponent (i_j - LF_j). Returns
    (B, H, S, dv) in fp32. The sequence is padded to whole blocks, the pad
    keys with ``b = NEG_INF``. The JAX version visits every key block of
    each query block; a block wholly past the queries is masked to
    ``NEG_INF`` there and changes neither the running max nor the sums,
    so here the walk stops at the diagonal block."""
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    blk = min(block, S)
    n = -(-S // blk)
    pad = n * blk - S
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        LF = F.pad(LF, (0, pad))
        b = F.pad(b, (0, pad), value=NEG_INF)
    q, k, v = q.float(), k.float(), v.float()
    scale = dqk ** -0.5
    pos = torch.arange(n * blk, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = []
    for i in range(n):
        qs = slice(i * blk, (i + 1) * blk)
        qblk, LFq = q[:, :, qs], LF[:, :, qs]
        m = torch.full((B, H, blk), NEG_INF, **f32)
        l = torch.zeros((B, H, blk), **f32)
        acc = torch.zeros((B, H, blk, dv), **f32)
        for j in range(i + 1):
            ks = slice(j * blk, (j + 1) * blk)
            e = LFq[..., :, None] + b[:, :, ks][..., None, :]       # (B,H,q,k)
            mask = pos[ks][None, :] <= pos[qs][:, None]
            e = torch.where(mask, e, NEG_INF)
            m_new = torch.maximum(m, e.amax(-1))
            w = torch.exp(e - m_new[..., None])
            p = torch.einsum("bhqd,bhkd->bhqk", qblk, k[:, :, ks]) * scale * w
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v[:, :, ks])
            m = m_new
        den = torch.maximum(l.abs(), torch.exp(-m))
        out.append(acc / den[..., None])
    return torch.cat(out, 2)[:, :, :S]


def mlstm_block(p, cfg: ArchConfig, x, ctrl, *, slice_mode: str = "mask"):
    s, y = mlstm_block_pending(p, cfg, x, None, ctrl, slice_mode=slice_mode)
    return s + y


def mlstm_block_pending(p, cfg: ArchConfig, x, delta, ctrl, *,
                        slice_mode: str = "mask"):
    """:func:`mlstm_block` with the previous block's residual add pending:
    returns ``(s, y)``, ``s = x + delta`` and ``y`` this block's output in
    x's type."""
    B, S, d = x.shape
    d_in, H, d_qk = _mlstm_dims(cfg)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    x_in, z = torch.chunk(h @ p["w_up"], 2, dim=-1)             # (B,S,d_in)
    q = (x_in @ p["wq"]).reshape(B, S, H, d_qk // H).transpose(1, 2)
    k = (x_in @ p["wk"]).reshape(B, S, H, d_qk // H).transpose(1, 2)
    v = x_in.reshape(B, S, H, d_in // H).transpose(1, 2)

    gates = x_in.float() @ p["w_if"] + p["b_if"]               # (B,S,2H)
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)
    LF = torch.cumsum(F.logsigmoid(f_raw), dim=1)               # (B,S,H)
    b = (i_raw - LF).transpose(1, 2)                            # i_j - LF_j

    o = gla_flash(q, k, v, LF.transpose(1, 2), b)               # (B,H,S,dv)
    o = o.transpose(1, 2).reshape(B, S, d_in)
    o = _head_norm(o, p["head_norm"], cfg.norm_eps).to(x.dtype)
    y = (o * F.silu(z)) @ p["w_out"]
    return s, y.to(s.dtype)


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device) -> Dict:
    d_in, H, d_qk = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, d_qk // H, d_in // H), **f32),
        "n": torch.zeros((batch, H, d_qk // H), **f32),
        "m": torch.full((batch, H), NEG_INF, **f32),
    }


def mlstm_decode(p, cfg: ArchConfig, x, ctrl, cache, index):
    """One-token decode; ``cache`` is updated in place and returned."""
    s, y = mlstm_decode_pending(p, cfg, x, None, ctrl, cache, index)
    return s + y, cache


def mlstm_decode_pending(p, cfg: ArchConfig, x, delta, ctrl, cache, index):
    """:func:`mlstm_decode` with the previous block's residual add pending:
    returns ``(s, y)`` and updates ``cache`` in place."""
    B = x.shape[0]
    d_in, H, d_qk = _mlstm_dims(cfg)
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    x_in, z = torch.chunk((h @ p["w_up"])[:, 0], 2, dim=-1)
    q = ((x_in @ p["wq"]).reshape(B, H, d_qk // H).float()
         * ((d_qk // H) ** -0.5))
    k = (x_in @ p["wk"]).reshape(B, H, d_qk // H).float()
    v = x_in.reshape(B, H, d_in // H).float()
    gates = x_in.float() @ p["w_if"] + p["b_if"]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)                # (B,H)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(cache["m"] + lf, i_raw)
    fprime = torch.exp(cache["m"] + lf - m_new)
    iprime = torch.exp(i_raw - m_new)
    C = (cache["C"] * fprime[..., None, None]
         + iprime[..., None, None] * k[..., :, None] * v[..., None, :])
    nvec = cache["n"] * fprime[..., None] + iprime[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, nvec).abs(),
                        torch.exp(-m_new))
    o = (num / den[..., None]).reshape(B, d_in)
    o = _head_norm(o, p["head_norm"], cfg.norm_eps).to(x.dtype)
    y = (o * F.silu(z))[:, None] @ p["w_out"]
    cache["C"].copy_(C)
    cache["n"].copy_(nvec)
    cache["m"].copy_(m_new)
    return s, y.to(s.dtype)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def init_slstm(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``. The recurrent ``r``
    is an (H, dh, 4 dh) table, drawn with fan-in H as the reference
    draws it."""
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    d_ff = int(cfg.slstm_proj_factor * d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_x": Dense((d, 4 * d), torch.float32),             # i,f,z,o pre-acts
        "r": Dense((H, dh, 4 * dh), torch.float32, scale=0.5),
        "b": torch.cat([torch.zeros((d,), **f32), torch.full((d,), 3.0, **f32),
                        torch.zeros((2 * d,), **f32)]),
        "w_up": Dense((d, d_ff), dtype),
        "w_down": Dense((d_ff, d), dtype),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
        "ffn_gamma": ones_table(cfg.elastic.num_subnets, d, device),
    }


def _slstm_cell(p, cfg: ArchConfig, xt, state):
    """One sLSTM step. xt: (B, 4d) pre-activations from the input
    projection; state: (c, n, h, m), each (B, d) fp32."""
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    c, n, hprev, m = state
    rec = torch.einsum("bhd,hde->bhe", hprev.reshape(-1, H, dh),
                       p["r"]).reshape(-1, 4 * d)
    raw = xt + rec + p["b"]
    i_raw, f_raw, z_raw, o_raw = torch.chunk(raw, 4, dim=-1)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    iprime = torch.exp(i_raw - m_new)
    fprime = torch.exp(lf + m - m_new)
    c_new = fprime * c + iprime * torch.tanh(z_raw)
    n_new = fprime * n + iprime
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_ffn(p, cfg: ArchConfig, s, y, ctrl):
    """The recurrence's residual add (fused into the ``ffn_gamma`` norm)
    and the post-FFN (GELU, proj factor 4/3) with its elastic width in
    mask form: ``(s + y, ffn output)``."""
    s, hf = ops.subnet_norm(s, p["ffn_gamma"], ctrl["subnet_id"],
                            eps=cfg.norm_eps, kind=cfg.norm, residual=y)
    a = F.gelu(hf @ p["w_up"], approximate="tanh")   # jax.nn.gelu default
    a = ops.slice_mask(a, torch.clamp(ctrl["slstm_ffn_width"],
                                      max=p["w_up"].shape[1]))
    return s, (a @ p["w_down"]).to(s.dtype)


def slstm_block(p, cfg: ArchConfig, x, ctrl, *, slice_mode: str = "mask"):
    s, y = slstm_block_pending(p, cfg, x, None, ctrl, slice_mode=slice_mode)
    return s + y


def slstm_block_pending(p, cfg: ArchConfig, x, delta, ctrl, *,
                        slice_mode: str = "mask"):
    """:func:`slstm_block` with the previous block's residual add pending:
    returns ``(s, y)``, ``s`` the residual after the recurrence's add and
    ``y`` the post-FFN's output in x's type."""
    B, S, d = x.shape
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    pre = h.float() @ p["w_x"]                                  # (B,S,4d)
    zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    state = (zero, zero, zero, torch.full_like(zero, NEG_INF))
    hs = []
    for t in range(S):
        state, ht = _slstm_cell(p, cfg, pre[:, t], state)
        hs.append(ht)
    return _slstm_ffn(p, cfg, s, torch.stack(hs, 1).to(x.dtype), ctrl)


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device) -> Dict:
    z = dict(size=(batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": torch.zeros(**z), "n": torch.zeros(**z),
            "h": torch.zeros(**z), "m": torch.full(fill_value=NEG_INF, **z)}


def slstm_decode(p, cfg: ArchConfig, x, ctrl, cache, index):
    """One-token decode; ``cache`` is updated in place and returned."""
    s, y = slstm_decode_pending(p, cfg, x, None, ctrl, cache, index)
    return s + y, cache


def slstm_decode_pending(p, cfg: ArchConfig, x, delta, ctrl, cache, index):
    """:func:`slstm_decode` with the previous block's residual add pending:
    returns ``(s, y)`` and updates ``cache`` in place."""
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    pre = (h.float() @ p["w_x"])[:, 0]
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    new, hnew = _slstm_cell(p, cfg, pre, state)
    for key, val in zip(("c", "n", "h", "m"), new):
        cache[key].copy_(val)
    return _slstm_ffn(p, cfg, s, hnew[:, None].to(x.dtype), ctrl)
