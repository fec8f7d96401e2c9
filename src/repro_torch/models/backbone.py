"""Backbone engine: walks the Stage patterns layer by layer with SubNetAct
LayerSelect gating, with per-kind caches for decode and zamba2-style
shared attention (port of ``repro/models/backbone.py``).

Parameters of each stage keep the JAX layout, stacked along a leading
``repeat`` axis; layer ``r`` reads views ``leaf[r]``. The JAX backbone
scans over layers inside one executable and gates each with ``lax.cond``;
here the layer gates are host numpy (see ``core.operators.layer_select``)
and the walk is Python, so a gated-off layer launches nothing. Each
block's residual add is left pending and made by the next block's
pre-norm (one SubnetNorm launch on the card), so a walk makes one
residual add of its own, at the end. A layer gate covers a whole repeat
unit of the stage's pattern (llama4's ``(attn, moe, attn, mlp)`` is one
unit), as in the reference; MoE and MLP blocks keep no decode cache.

zamba2's shared transformer block (one attention and one MLP, the same
weights each time) runs after every unit whose gate is on and whose index
``r`` in its stage has ``r % period == period - 1``. Each invocation has
a KV cache of its own: the decode walk counts the invocations that ran
(a host int, since the gates are host numpy) and takes that slot.

For training, ``backbone_forward(remat=True)`` recomputes each repeat unit
(with the shared block after it) in the backward pass instead of keeping
its activations, as the reference wraps each unit in ``jax.checkpoint``;
``moe_groups`` sets the token groups of every MoE block's dispatch.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.operators import layer_select
from repro_torch.distributed.placement import settle_partial
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import stack_init, unstack

_INITS = {"attn": attn_mod.init_attention, "mlp": ffn_mod.init_mlp,
          "moe": moe_mod.init_moe, "mamba": ssm_mod.init_mamba,
          "mlstm": xlstm_mod.init_mlstm, "slstm": xlstm_mod.init_slstm}
_PORTED = tuple(_INITS)
# kind -> cache init(cfg, batch, seq_len, dtype, device); the other kinds
# keep no decode state
_CACHES = {
    "attn": attn_mod.init_attention_cache,
    "mamba": lambda cfg, b, s, dt, dev: ssm_mod.init_mamba_cache(cfg, b, dt,
                                                                 dev),
    "mlstm": lambda cfg, b, s, dt, dev: xlstm_mod.init_mlstm_cache(cfg, b,
                                                                   dt, dev),
    "slstm": lambda cfg, b, s, dt, dev: xlstm_mod.init_slstm_cache(cfg, b,
                                                                   dt, dev),
}


def _slot(j: int, kind: str) -> str:
    return f"{j}:{kind}"


def _check_ported(cfg: ArchConfig) -> None:
    """Raise on a block kind the LM backbone does not run: the conv
    supernet's units (the reference's LM has no conv path either)."""
    for stage in cfg.stages:
        for kind in stage.pattern:
            if kind == "conv":
                raise NotImplementedError(
                    f"{cfg.name}: the conv supernet is not an LM; it runs "
                    f"through models/convnet.py (convnet_forward)")
            if kind not in _PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: unknown block kind {kind!r}; the LM "
                    f"backbone runs {_PORTED}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _shared_inits(cfg: ArchConfig):
    """(key, init) of each sub-block of zamba2's shared block: attention,
    and the MLP when the config has one. Empty without a shared block."""
    if not cfg.shared_attn_period:
        return ()
    out = (("shared_attn", attn_mod.init_attention),)
    if cfg.d_ff:
        out += (("shared_mlp", ffn_mod.init_mlp),)
    return out


def init_backbone(cfg: ArchConfig, dtype, generator, device) -> Dict:
    _check_ported(cfg)
    params: Dict[str, Any] = {"stages": []}
    for stage in cfg.stages:
        params["stages"].append({
            _slot(j, kind): stack_init(
                lambda kind=kind: _INITS[kind](cfg, dtype, device),
                stage.repeat, generator, device)
            for j, kind in enumerate(stage.pattern)})
    for key, init in _shared_inits(cfg):
        # one layer of leaves, not stacked
        params[key] = unstack(stack_init(
            lambda init=init: init(cfg, dtype, device), 1, generator,
            device), 0)
    return params


def param_bytes(cfg: ArchConfig, dtype) -> int:
    """Bytes of :func:`init_backbone`'s tree, the shared block's included,
    from the leaves' shapes alone (nothing is allocated)."""
    _check_ported(cfg)

    def layer(init) -> int:
        return sum(leaf.dtype.itemsize * int(np.prod(leaf.shape))
                   for leaf in init(cfg, dtype, "meta").values())

    return (sum(stage.repeat * layer(_INITS[kind]) for stage in cfg.stages
                for kind in stage.pattern)
            + sum(layer(init) for _, init in _shared_inits(cfg)))


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


def _runs_shared(params, cfg: ArchConfig, r: int) -> bool:
    """Whether the shared block follows unit ``r`` of a stage (when the
    unit's gate is on)."""
    period = cfg.shared_attn_period
    return bool(period) and "shared_attn" in params \
        and r % period == period - 1


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------


def _settle(pair):
    """The residual stream of a ``(x, delta)`` pair: ``x + delta``, the one
    residual add of a walk that no pre-norm took."""
    x, delta = pair
    return x if delta is None else x + settle_partial(delta)


def _ffn(kind: str, p, cfg: ArchConfig, xd, ctrl, slice_mode: str,
         moe_groups: int = 1, moe_group_axes=None):
    """An ``mlp`` or ``moe`` block on the pair ``xd = (x, delta)``; decode
    calls it on ``(B, 1, d)``, so a MoE block routes B tokens."""
    if kind == "moe":
        return moe_mod.moe_block_pending(p, cfg, *xd, ctrl,
                                         slice_mode=slice_mode,
                                         n_groups=moe_groups,
                                         group_axes=moe_group_axes)
    return ffn_mod.mlp_block_pending(p, cfg, *xd, ctrl, slice_mode=slice_mode)


def _block(kind: str, p, cfg: ArchConfig, xd, ctrl, positions,
           slice_mode: str, attn_impl, moe_groups: int = 1,
           moe_group_axes=None):
    """One block of a prefill walk on the pair ``xd``. Each block function
    is looked up on its module at the call, so a wrapper put there is
    seen."""
    if kind == "attn":
        return attn_mod.attention_block_pending(
            p, cfg, *xd, ctrl, positions, slice_mode=slice_mode,
            attn_impl=attn_impl)
    if kind == "mamba":
        block = ssm_mod.mamba_block_pending
    elif kind == "mlstm":
        block = xlstm_mod.mlstm_block_pending
    elif kind == "slstm":
        block = xlstm_mod.slstm_block_pending
    else:
        return _ffn(kind, p, cfg, xd, ctrl, slice_mode, moe_groups,
                    moe_group_axes)
    return block(p, cfg, *xd, ctrl, slice_mode=slice_mode)


def backbone_forward(params, cfg: ArchConfig, x, ctrl, positions, *,
                     slice_mode: str = "mask", remat: bool = False,
                     moe_groups: int = 1, moe_group_axes=None,
                     attn_impl=None):
    """x: (B, S, d) -> (B, S, d). ``attn_impl=None`` takes the kernel
    entry point for x's device; pass one to pin an impl (tests).

    The walk carries the pair ``(x, delta)``: each block's output ``delta``
    is added to the residual stream by the next block's pre-norm, in the
    same launch (see ``attention.attention_block_pending``); a gated-off
    unit passes the pair on, and the last pending add is made once before
    returning. ``remat``: each live unit, the shared block after it
    included, runs under ``torch.utils.checkpoint`` (non-reentrant), so
    the backward recomputes its activations. ``moe_groups``: the token
    groups of each MoE block (``moe.moe_block``'s ``n_groups``), and
    ``moe_group_axes`` the mesh dims they are sharded over on DTensors
    (its ``group_axes``)."""
    _check_ported(cfg)
    gates = _gates(cfg, ctrl)
    offset = 0
    pair = (x, None)
    for si, stage in enumerate(cfg.stages):
        # each stacked leaf split into its layers once: under autograd the
        # layers' gradients are stacked in one op, where indexing layer by
        # layer would add a zero-filled gradient of the whole stack per layer
        sp = {slot: {k: v.unbind(0) for k, v in leaves.items()}
              for slot, leaves in params["stages"][si].items()}
        for r in range(stage.repeat):
            def unit(x, delta, r=r, stage=stage, sp=sp):
                xd = (x, delta)
                for j, kind in enumerate(stage.pattern):
                    layer = {k: v[r] for k, v in sp[_slot(j, kind)].items()}
                    xd = _block(kind, layer, cfg, xd, ctrl, positions,
                                slice_mode, attn_impl, moe_groups,
                                moe_group_axes)
                if _runs_shared(params, cfg, r):
                    xd = attn_mod.attention_block_pending(
                        params["shared_attn"], cfg, *xd, ctrl, positions,
                        slice_mode=slice_mode, attn_impl=attn_impl)
                    if "shared_mlp" in params:
                        xd = _ffn("mlp", params["shared_mlp"], cfg, xd,
                                  ctrl, slice_mode)
                return xd

            if remat:
                run = partial(checkpoint, unit, use_reentrant=False)
            else:
                run = unit
            pair = layer_select(gates[offset + r], lambda xd: run(*xd), pair)
        offset += stage.repeat
    return _settle(pair)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def _stacked(one: Dict, n: int) -> Dict:
    """``n`` copies of a cache dict, stacked along a new leading axis."""
    return {k: a.expand((n,) + tuple(a.shape)).clone() for k, a in one.items()}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype,
               device) -> Dict:
    """Nested cache tree. Leading dim of each stage leaf = repeat; the
    shared block's ``shared_attn`` leaves lead with one slot per
    invocation, ``max(1, units // period)``."""
    _check_ported(cfg)
    cache: Dict[str, Any] = {"stages": []}
    for stage in cfg.stages:
        cache["stages"].append({
            _slot(j, kind): _stacked(
                _CACHES[kind](cfg, batch, seq_len, dtype, device),
                stage.repeat)
            for j, kind in enumerate(stage.pattern) if kind in _CACHES})
    if cfg.shared_attn_period:
        n_inv = max(1, sum(s.repeat for s in cfg.stages)
                    // cfg.shared_attn_period)
        cache["shared_attn"] = _stacked(attn_mod.init_attention_cache(
            cfg, batch, seq_len, dtype, device), n_inv)
    return cache


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------


def _decode_block(kind: str, p, cfg: ArchConfig, xd, ctrl, cache, index,
                  slice_mode: str):
    """One block of a decode step on the pair ``xd``, its cache (None for
    the kinds that keep none) updated in place."""
    if kind == "attn":
        return attn_mod.attention_decode_pending(
            p, cfg, *xd, ctrl, cache, index, slice_mode=slice_mode)
    if kind == "mamba":
        block = ssm_mod.mamba_decode_pending
    elif kind == "mlstm":
        block = xlstm_mod.mlstm_decode_pending
    elif kind == "slstm":
        block = xlstm_mod.slstm_decode_pending
    else:
        return _ffn(kind, p, cfg, xd, ctrl, slice_mode)
    return block(p, cfg, *xd, ctrl, cache, index)


def backbone_decode(params, cfg: ArchConfig, x, ctrl, cache, index, *,
                    slice_mode: str = "mask"):
    """One-token decode. x: (B, 1, d) -> ((B, 1, d), cache). ``index``:
    0-d int32 tensor on x's device. The cache is updated in place (the
    JAX version returns a new tree); the returned tree is ``cache``. The
    residual adds are carried as in :func:`backbone_forward`. The shared
    block's n-th invocation that runs uses cache slot n."""
    _check_ported(cfg)
    gates = _gates(cfg, ctrl)
    offset, n_shared = 0, 0
    pair = (x, None)
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][si]
        sc = cache["stages"][si]
        for r in range(stage.repeat):
            def unit(xd, r=r, stage=stage, sp=sp, sc=sc):
                for j, kind in enumerate(stage.pattern):
                    slot = _slot(j, kind)
                    xd = _decode_block(
                        kind, unstack(sp[slot], r), cfg, xd, ctrl,
                        unstack(sc[slot], r) if slot in sc else None, index,
                        slice_mode)
                return xd

            gate = gates[offset + r]
            pair = layer_select(gate, unit, pair)
            if gate and _runs_shared(params, cfg, r):
                pair = attn_mod.attention_decode_pending(
                    params["shared_attn"], cfg, *pair, ctrl,
                    unstack(cache["shared_attn"], n_shared), index,
                    slice_mode=slice_mode)
                if "shared_mlp" in params:
                    pair = _ffn("mlp", params["shared_mlp"], cfg, pair,
                                ctrl, slice_mode)
                n_shared += 1
        offset += stage.repeat
    return _settle(pair), cache
