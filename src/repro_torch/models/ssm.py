"""Mamba2 (SSD, state-space duality) block: chunked parallel prefill and
O(1)-state decode (port of ``repro/models/ssm.py``).

Single B/C group (ngroups=1), multi-head states (B, H, N, P) with
N = ssm_state, P = ssm_head_dim. The chunked algorithm is O(S·Q + S·N·P)
per token stream. The JAX version scans over the chunks with
``lax.scan``; here the inter-chunk recurrence is a Python loop over the
``nC`` chunks, each step two device ops.

Width elasticity is *not* applied to state dimensions (the recurrence
would be corrupted mid-stream); depth elasticity (LayerSelect) applies at
the block level in the backbone, and ``slice_mode`` is accepted and
ignored, as in JAX. ``A_log``, ``D``, ``dt_bias`` and ``gated_norm`` stay
fp32 in a bf16 model, and the scan runs in fp32.

Each block takes the pair ``(x, delta)`` and returns ``(s, y)``, as
``attention.attention_block_pending`` does: its pre-norm makes the
previous block's pending residual add (one SubnetNorm launch on the
card), and its own output is left pending. No part of the block reaches a
TPU kernel in the JAX package, so it is plain PyTorch on every device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Dense, ones_table, pre_norm


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state          # conv over [x, B, C]
    return d_in, n_heads, conv_ch


def init_mamba(cfg: ArchConfig, dtype, device) -> Dict:
    """One layer's leaves for ``common.stack_init``."""
    d = cfg.d_model
    d_in, H, conv_ch = _dims(cfg)
    N = cfg.ssm_state
    proj_out = 2 * d_in + 2 * N + H             # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": Dense((d, proj_out), dtype),
        "conv_w": Dense((cfg.ssm_conv_width, conv_ch), dtype, scale=1.0),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gated_norm": torch.ones((d_in,), **f32),
        "w_out": Dense((d_in, d), dtype),
        "norm_gamma": ones_table(cfg.elastic.num_subnets, d, device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    d_in, H, _ = _dims(cfg)
    N = cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(xBC, conv_w, conv_b):
    """Depthwise causal conv. xBC: (B, S, C); conv_w: (W, C)."""
    W, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i: i + S, :] * conv_w[i] for i in range(W))
    return F.silu(out + conv_b)


def _gated_out(p, cfg: ArchConfig, y, z):
    """The gated RMSNorm (no subnet table: plain torch) and the output
    projection; the block's output, not yet added to the residual."""
    g = y * F.silu(z)
    gf = g.float()
    gf = gf * torch.rsqrt(gf.square().mean(-1, keepdim=True) + cfg.norm_eps)
    g = (gf * p["gated_norm"]).to(y.dtype)
    return g @ p["w_out"]


def mamba_block(p, cfg: ArchConfig, x, ctrl, *, slice_mode: str = "mask"):
    """Chunked SSD forward. x: (B, S, d) -> (B, S, d)."""
    s, y = mamba_block_pending(p, cfg, x, None, ctrl, slice_mode=slice_mode)
    return s + y


def mamba_block_pending(p, cfg: ArchConfig, x, delta, ctrl, *,
                        slice_mode: str = "mask"):
    """:func:`mamba_block` with the previous block's residual add pending:
    returns ``(s, y)``, ``s = x + delta`` made by the pre-norm and ``y``
    this block's output in x's type."""
    Bsz, S, d = x.shape
    d_in, H, _ = _dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nC = S // Q

    s, h = pre_norm(p, cfg, x, delta, ctrl)
    z, xc, B_, C_, dt = _split_proj(cfg, h @ p["w_in"])
    xBC = _causal_conv(torch.cat([xc, B_, C_], -1), p["conv_w"], p["conv_b"])
    xc, B_, C_ = torch.split(xBC, [d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,S,H)
    A = -torch.exp(p["A_log"])                                        # (H,)
    dA = dt * A                                                       # < 0

    Bc = B_.reshape(Bsz, nC, Q, N).float()
    Cc = C_.reshape(Bsz, nC, Q, N).float()
    Xc = xc.reshape(Bsz, nC, Q, H, P).float()
    dtc = dt.reshape(Bsz, nC, Q, H)
    g = torch.cumsum(dA.reshape(Bsz, nC, Q, H), dim=2)                # (B,c,Q,H)

    # --- intra-chunk (quadratic within a chunk only) ---
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # the exponent is masked before exp (non-causal entries are exp of
    # large positive values), as in the reference
    diff = g[:, :, :, None, :] - g[:, :, None, :, :]                  # (B,c,Q,K,H)
    L = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              torch.full((), -1e30, device=x.device)))
    M = CB[..., None] * L * dtc[:, :, None, :, :]
    Y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, Xc)

    # --- chunk boundary states + inter-chunk recurrence ---
    g_last = g[:, :, -1, :]                                           # (B,c,H)
    decay_states = torch.exp(g_last[:, :, None, :] - g) * dtc         # (B,c,Q,H)
    S_c = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc, decay_states, Xc)
    decay = torch.exp(g_last)
    prev = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    states_prev = []
    for c in range(nC):
        states_prev.append(prev)
        prev = prev * decay[:, c, :, None, None] + S_c[:, c]
    states_prev = torch.stack(states_prev, 1)                         # (B,c,H,N,P)

    Y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, states_prev,
                           torch.exp(g))
    Y = Y_intra + Y_inter + p["D"][None, None, None, :, None] * Xc
    Y = Y.reshape(Bsz, S, d_in).to(x.dtype)
    return s, _gated_out(p, cfg, Y, z).to(s.dtype)


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> Dict:
    d_in, H, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, ctrl, cache, index):
    """One-token decode. x: (B, 1, d); O(1) state update. ``cache`` is
    updated in place (the JAX version returns a new one); the returned
    dict holds the same tensors."""
    s, y = mamba_decode_pending(p, cfg, x, None, ctrl, cache, index)
    return s + y, cache


def mamba_decode_pending(p, cfg: ArchConfig, x, delta, ctrl, cache, index):
    """:func:`mamba_decode` with the previous block's residual add pending,
    as :func:`mamba_block_pending`: returns ``(s, y)`` and updates
    ``cache`` in place."""
    Bsz = x.shape[0]
    d_in, H, conv_ch = _dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    s, h = pre_norm(p, cfg, x, delta, ctrl)
    z, xc, B_, C_, dt = _split_proj(cfg, (h @ p["w_in"])[:, 0])       # (B, *)

    xBC_new = torch.cat([xc, B_, C_], -1)                             # (B, C)
    window = torch.cat([cache["conv"], xBC_new[:, None]], 1)          # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    xc, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                         # (B,H)
    X = xc.reshape(Bsz, H, P).float()
    dBx = torch.einsum("bn,bh,bhp->bhnp", B_.float(), dt, X)
    state = cache["ssm"] * decay[:, :, None, None] + dBx
    cache["ssm"].copy_(state)
    y = torch.einsum("bn,bhnp->bhp", C_.float(), state)
    y = y + p["D"][None, :, None] * X
    y = y.reshape(Bsz, 1, d_in).to(x.dtype)
    return s, _gated_out(p, cfg, y, z[:, None]).to(s.dtype)
