"""Backbone engine: walks the Stage patterns layer by layer with SubNetAct
LayerSelect gating, with per-kind caches for decode (port of
``repro/models/backbone.py`` for ``attn``, ``mlp`` and ``moe`` blocks).

Parameters of each stage keep the JAX layout, stacked along a leading
``repeat`` axis; layer ``r`` reads views ``leaf[r]``. The JAX backbone
scans over layers inside one executable and gates each with ``lax.cond``;
here the layer gates are host numpy (see ``core.operators.layer_select``)
and the walk is Python, so a gated-off layer launches nothing. Each
block's residual add is left pending and made by the next block's
pre-norm (one SubnetNorm launch on the card), so a walk makes one
residual add of its own, at the end. A layer gate covers a whole repeat
unit of the stage's pattern (llama4's ``(attn, moe, attn, mlp)`` is one
unit), as in the reference; MoE blocks keep no decode cache.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.operators import layer_select
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import stack_init, unstack

_PORTED = ("attn", "mlp", "moe")
_INITS = {"attn": attn_mod.init_attention, "mlp": ffn_mod.init_mlp,
          "moe": moe_mod.init_moe}


def _slot(j: int, kind: str) -> str:
    return f"{j}:{kind}"


def _check_ported(cfg: ArchConfig) -> None:
    for stage in cfg.stages:
        for kind in stage.pattern:
            if kind not in _PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} comes with a later "
                    f"slice of the port (other LM families); ported: "
                    f"{_PORTED}")
    if cfg.shared_attn_period:
        raise NotImplementedError(f"{cfg.name}: zamba2-style shared "
                                  f"attention comes with a later slice")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_backbone(cfg: ArchConfig, dtype, generator, device) -> Dict:
    _check_ported(cfg)
    params: Dict[str, Any] = {"stages": []}
    for stage in cfg.stages:
        params["stages"].append({
            _slot(j, kind): stack_init(
                lambda kind=kind: _INITS[kind](cfg, dtype, device),
                stage.repeat, generator, device)
            for j, kind in enumerate(stage.pattern)})
    return params


def param_bytes(cfg: ArchConfig, dtype) -> int:
    """Bytes of :func:`init_backbone`'s tree, from the leaves' shapes
    alone (nothing is allocated)."""
    _check_ported(cfg)
    return sum(stage.repeat * leaf.dtype.itemsize * int(np.prod(leaf.shape))
               for stage in cfg.stages for kind in stage.pattern
               for leaf in _INITS[kind](cfg, dtype, "meta").values())


def _gates(cfg: ArchConfig, ctrl) -> np.ndarray:
    gates = ctrl["layer_gate"]
    if isinstance(gates, torch.Tensor):
        raise TypeError("layer_gate is walked on the host: pass numpy "
                        "(core.operators.device_control)")
    gates = np.asarray(gates, dtype=bool)
    n = sum(s.repeat for s in cfg.stages)
    if gates.shape != (n,):
        raise ValueError(f"layer_gate has shape {gates.shape}, want ({n},)")
    return gates


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------


def _settle(pair):
    """The residual stream of a ``(x, delta)`` pair: ``x + delta``, the one
    residual add of a walk that no pre-norm took."""
    x, delta = pair
    return x if delta is None else x + delta


def _ffn(kind: str, p, cfg: ArchConfig, xd, ctrl, slice_mode: str):
    """An ``mlp`` or ``moe`` block on the pair ``xd = (x, delta)``; decode
    calls it on ``(B, 1, d)``, so a MoE block routes B tokens."""
    block = (moe_mod.moe_block_pending if kind == "moe"
             else ffn_mod.mlp_block_pending)
    return block(p, cfg, *xd, ctrl, slice_mode=slice_mode)


def backbone_forward(params, cfg: ArchConfig, x, ctrl, positions, *,
                     slice_mode: str = "mask", attn_impl=None):
    """x: (B, S, d) -> (B, S, d). ``attn_impl=None`` takes the kernel
    entry point for x's device; pass one to pin an impl (tests).

    The walk carries the pair ``(x, delta)``: each block's output ``delta``
    is added to the residual stream by the next block's pre-norm, in the
    same launch (see ``attention.attention_block_pending``); a gated-off
    unit passes the pair on, and the last pending add is made once before
    returning."""
    _check_ported(cfg)
    gates = _gates(cfg, ctrl)
    offset = 0
    pair = (x, None)
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][si]
        for r in range(stage.repeat):
            def unit(xd, r=r, stage=stage, sp=sp):
                for j, kind in enumerate(stage.pattern):
                    p = unstack(sp[_slot(j, kind)], r)
                    if kind == "attn":
                        xd = attn_mod.attention_block_pending(
                            p, cfg, *xd, ctrl, positions,
                            slice_mode=slice_mode, attn_impl=attn_impl)
                    else:
                        xd = _ffn(kind, p, cfg, xd, ctrl, slice_mode)
                return xd

            pair = layer_select(gates[offset + r], unit, pair)
        offset += stage.repeat
    return _settle(pair)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype,
               device) -> Dict:
    """Nested cache tree. Leading dim of each stage leaf = repeat."""
    _check_ported(cfg)
    cache: Dict[str, Any] = {"stages": []}
    for stage in cfg.stages:
        sc = {}
        for j, kind in enumerate(stage.pattern):
            if kind == "attn":
                one = attn_mod.init_attention_cache(cfg, batch, seq_len,
                                                    dtype, device)
                sc[_slot(j, kind)] = {
                    k: torch.zeros((stage.repeat,) + tuple(a.shape),
                                   dtype=a.dtype, device=device)
                    for k, a in one.items()}
        cache["stages"].append(sc)
    return cache


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------


def backbone_decode(params, cfg: ArchConfig, x, ctrl, cache, index, *,
                    slice_mode: str = "mask"):
    """One-token decode. x: (B, 1, d) -> ((B, 1, d), cache). ``index``:
    0-d int32 tensor on x's device. The cache is updated in place (the
    JAX version returns a new tree); the returned tree is ``cache``. The
    residual adds are carried as in :func:`backbone_forward`."""
    _check_ported(cfg)
    gates = _gates(cfg, ctrl)
    offset = 0
    pair = (x, None)
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][si]
        sc = cache["stages"][si]
        for r in range(stage.repeat):
            def unit(xd, r=r, stage=stage, sp=sp, sc=sc):
                for j, kind in enumerate(stage.pattern):
                    slot = _slot(j, kind)
                    p = unstack(sp[slot], r)
                    if kind == "attn":
                        xd = attn_mod.attention_decode_pending(
                            p, cfg, *xd, ctrl, unstack(sc[slot], r), index,
                            slice_mode=slice_mode)
                    else:
                        xd = _ffn(kind, p, cfg, xd, ctrl, slice_mode)
                return xd

            pair = layer_select(gates[offset + r], unit, pair)
        offset += stage.repeat
    return _settle(pair), cache
