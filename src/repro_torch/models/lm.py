"""LM wrapper: embeddings, final norm, head, and the step functions that the
executor, tests and examples share (port of ``repro/models/lm.py``).

``frontend='embed'`` configs (qwen2-vl, musicgen) take precomputed
patch/frame embeddings (``batch["embeds"]``, (B, S, d)) for forward,
prefill and the loss, as the reference does (the modality frontend is a
stub); decode always consumes token ids, so the embedding table stays.
musicgen adds sinusoidal absolute positions to its inputs (in decode at
the device ``index``); qwen2-vl's M-RoPE takes (3, B, S) positions.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the step functions run wherever the parameters live. :func:`from_jax_params`
turns the numpy leaves of ``repro.models.lm.init_model`` into this tree
with the same keys and shapes, through numpy only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.distributed.placement import embedding, label_logits
from repro_torch.models import attention as attn_mod
from repro_torch.models import backbone as bb
from repro_torch.models.common import dense_init, dtype_of, ones_table


def init_model(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               device=None, dtype=None) -> Dict:
    """Random supernet parameters on ``device`` (default: the GPU) drawn
    from ``generator`` (default: seed 0 on that device). On ``meta`` the
    leaves have their shapes and types and nothing is drawn."""
    dev = compat.resolve_device(device)
    dtype = dtype or dtype_of(cfg)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), dtype, generator,
                            dev, scale=1.0),
        "backbone": bb.init_backbone(cfg, dtype, generator, dev),
        "final_gamma": ones_table(cfg.elastic.num_subnets, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                    generator, dev)
    return params


def param_bytes(cfg: ArchConfig, dtype=None) -> int:
    """Bytes of :func:`init_model`'s tree for ``cfg``, counted from the
    leaves' shapes without allocating them."""
    dtype = dtype or dtype_of(cfg)
    tables = 1 if cfg.tie_embeddings else 2
    return (tables * cfg.vocab_size * cfg.d_model * dtype.itemsize
            + cfg.elastic.num_subnets * cfg.d_model * 4
            + bb.param_bytes(cfg, dtype))


def _to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bf16 from a JAX tree
        return torch.from_numpy(np.array(arr, copy=True).view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(numpy_tree, device=None):
    """The port's parameter tree from a JAX one (``lm.init_model``), given
    as nested dicts/lists of numpy (or numpy-convertible) leaves."""
    dev = compat.resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _to_torch(t, dev)

    return conv(numpy_tree)


def _device(params) -> torch.device:
    return params["embed"].device


def _tokens(tokens, device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(device).long()


def head_logits(params, cfg: ArchConfig, x, ctrl):
    """Final SubnetNorm and the (tied) head. x: (..., d) -> (..., vocab)."""
    ctrl = ops.device_control(ctrl, x.device)
    h = ops.subnet_norm(x, params["final_gamma"], ctrl["subnet_id"],
                        eps=cfg.norm_eps, kind=cfg.norm)
    w = params.get("head")
    if w is None:
        w = params["embed"].T
    return h @ w


def default_positions(cfg: ArchConfig, batch: int, seq: int, device):
    """0 .. seq-1 for every row, (B, S); (3, B, S), the three M-RoPE
    streams alike, where ``mrope_sections`` is set."""
    pos = torch.arange(seq, dtype=torch.int32, device=device
                       ).expand(batch, seq)
    return pos.expand(3, batch, seq) if cfg.mrope_sections else pos


def embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """(B, S, d) inputs: ``batch["embeds"]`` (B, S, d) cast to the embedding
    table's type for an ``embed``-frontend config that has them, else the
    rows of ``batch["tokens"]`` (B, S)."""
    dev = _device(params)
    table = params["embed"]
    if cfg.frontend == "embed" and "embeds" in batch:
        embeds = batch["embeds"]
        if not isinstance(embeds, torch.Tensor):
            embeds = torch.as_tensor(np.asarray(embeds))
        return embeds.to(dev, table.dtype)
    return embedding(_tokens(batch["tokens"], dev), table)


def sinusoid_pos(positions, d: int, dtype):
    """Classic sinusoidal absolute embedding (musicgen). positions (B, S)
    -> (B, S, d): sines of the first d/2 frequencies, then cosines."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq                   # (B,S,half)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def hidden_states(params, cfg: ArchConfig, batch: Dict[str, Any], ctrl, *,
                  slice_mode="mask", remat=False, moe_groups=1,
                  moe_group_axes=None, attn_impl=None):
    """Backbone output (B, S, d) for ``batch["tokens"]`` (B, S) or, for an
    ``embed``-frontend config, ``batch["embeds"]`` (B, S, d); ``remat``,
    ``moe_groups`` and ``moe_group_axes`` as ``backbone.backbone_forward``
    takes them."""
    dev = _device(params)
    if slice_mode == "switch":
        ctrl = attn_mod.with_wo_width(cfg, ctrl)
    ctrl = ops.device_control(ctrl, dev)
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    positions = (default_positions(cfg, B, S, dev) if positions is None
                 else torch.as_tensor(positions, device=dev))
    if cfg.pos_embed == "sinusoidal":
        pos2d = positions if positions.dim() == 2 else positions[0]
        x = x + sinusoid_pos(pos2d, cfg.d_model, x.dtype)
    return bb.backbone_forward(params["backbone"], cfg, x, ctrl, positions,
                               slice_mode=slice_mode, remat=remat,
                               moe_groups=moe_groups,
                               moe_group_axes=moe_group_axes,
                               attn_impl=attn_impl)


def forward(params, cfg: ArchConfig, batch, ctrl, *, slice_mode="mask",
            remat=False, moe_groups=1, moe_group_axes=None, attn_impl=None):
    """Logits (B, S, vocab) for ``batch["tokens"]`` (B, S) or ``embeds``."""
    x = hidden_states(params, cfg, batch, ctrl, slice_mode=slice_mode,
                      remat=remat, moe_groups=moe_groups,
                      moe_group_axes=moe_group_axes, attn_impl=attn_impl)
    return head_logits(params, cfg, x, ctrl)


def loss_fn(params, cfg: ArchConfig, batch, ctrl, *, slice_mode="mask",
            remat=False, moe_groups=1, moe_group_axes=None,
            z_loss: float = 1e-4, attn_impl=None):
    """Mean next-token cross-entropy of ``batch["labels"]`` (B, S) over the
    positions of ``batch["loss_mask"]`` (all of them when absent), from
    fp32 logits, plus ``z_loss`` times the mean squared log-partition
    (port of ``repro.models.lm.loss_fn``)."""
    dev = _device(params)
    logits = forward(params, cfg, batch, ctrl, slice_mode=slice_mode,
                     remat=remat, moe_groups=moe_groups,
                     moe_group_axes=moe_group_axes,
                     attn_impl=attn_impl).float()
    labels = _tokens(batch["labels"], dev)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - label_logits(logits, labels)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    else:
        mask = torch.as_tensor(np.asarray(mask) if not isinstance(
            mask, torch.Tensor) else mask).to(dev, torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


def prefill(params, cfg: ArchConfig, batch, ctrl, *, slice_mode="mask",
            moe_groups=1, moe_group_axes=None, attn_impl=None):
    """Serving prefill: logits for the final position only (B, 1, vocab)."""
    x = hidden_states(params, cfg, batch, ctrl, slice_mode=slice_mode,
                      moe_groups=moe_groups, moe_group_axes=moe_group_axes,
                      attn_impl=attn_impl)
    # the norm kernel takes contiguous rows
    return head_logits(params, cfg, x[:, -1:].contiguous(), ctrl)


def decode_step(params, cfg: ArchConfig, tokens, ctrl, cache, index, *,
                slice_mode="mask"):
    """tokens: (B, 1); index: int or 0-d int32 device tensor. Returns
    (logits (B, 1, vocab), cache), the cache updated in place. Sinusoidal
    positions are added at the device ``index``, with no host read."""
    dev = _device(params)
    ctrl = ops.device_control(ctrl, dev)
    if not isinstance(index, torch.Tensor):
        index = torch.full((), int(index), dtype=torch.int32, device=dev)
    x = embedding(_tokens(tokens, dev), params["embed"])
    if cfg.pos_embed == "sinusoidal":
        pos = index.reshape(1, 1).expand(x.shape[0], 1)
        x = x + sinusoid_pos(pos, cfg.d_model, x.dtype)
    x, cache = bb.backbone_decode(params["backbone"], cfg, x, ctrl, cache,
                                  index, slice_mode=slice_mode)
    return head_logits(params, cfg, x, ctrl), cache


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
               device=None):
    dev = compat.resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return bb.init_cache(cfg, batch, seq_len, dt or dtype_of(cfg), dev)


def generate(params, cfg: ArchConfig, prompt, ctrl, max_new: int,
             seq_cap: int = 256):
    """Greedy decode; the prompt is teacher-forced through the decode path
    (as the JAX version does). Returns (B, P + max_new) int64 tokens."""
    dev = _device(params)
    ctrl = ops.device_control(ctrl, dev)
    prompt = _tokens(prompt, dev)
    B, P = prompt.shape
    cache = init_cache(cfg, B, seq_cap, dtype=params["embed"].dtype,
                       device=dev)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(P + max_new - 1):
        logits, cache = decode_step(params, cfg, tok, ctrl, cache, i)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        tok = prompt[:, i + 1: i + 2] if i + 1 < P else nxt
        out.append(tok)
    return torch.cat(out, dim=1)
