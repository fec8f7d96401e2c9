"""Public kernel entry points, routed by device (port of
``repro/kernels/ops.py``, lines 122-206).

Each kernel has two registered implementations in
:mod:`repro_torch.kernels.dispatch`: ``cuda`` (the hand-written Hopper
kernel) and ``torch`` (its plain version). The device of the first tensor
argument picks one; a per-call ``tier=`` must agree with it. There is no
fallthrough: a CUDA tensor runs the kernel or raises, never the plain
version.

The ``cuda`` implementations of the kernels a training forward reaches
(flash attention, both norm forms, ``sliced_matmul``) run through the
``torch.autograd.Function``s of :mod:`repro_torch.kernels.autograd`;
``decode_attention`` has none and refuses a call that needs a gradient.
"""
from __future__ import annotations

from functools import partial

from repro_torch.distributed.placement import (heads_local, heads_sharded,
                                              is_dtensor)
from repro_torch.kernels import autograd as ag
from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import sliced_matmul as _sliced
from repro_torch.kernels import subnet_rmsnorm as _rmsnorm
from repro_torch.kernels.dispatch import DISPATCHER, register


@register("flash_attention", "cuda", differentiable=True)
def _flash_cuda(q, k, v, *, causal, window, kv_len, head_width, q_block,
                kv_block):
    # the kernel picks its own tiles (kernels/flash_attention.py,
    # pack_plan); the block arguments bind only the plain version
    return ag.flash_attention(_flash.flash_attention, q, k, v, causal=causal,
                              window=window, kv_len=kv_len,
                              head_width=head_width)


@register("flash_attention", "torch")
def _flash_torch(q, k, v, *, causal, window, kv_len, head_width, q_block,
                 kv_block):
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        kv_len=kv_len, head_width=head_width,
                                        q_block=q_block, kv_block=kv_block)


@register("decode_attention", "cuda")
def _decode_cuda(q, k_cache, v_cache, index, *, window, kv_block):
    return _decode.decode_attention(q, k_cache, v_cache, index, window=window)


@register("decode_attention", "torch")
def _decode_torch(q, k_cache, v_cache, index, *, window, kv_block):
    return _decode.decode_attention_plain(q, k_cache, v_cache, index,
                                          window=window, kv_block=kv_block)


@register("sliced_matmul", "cuda", differentiable=True)
def _sliced_cuda(x, w, active_in, active_out, *, segments, bm, bk, bn):
    # tile sizes are fixed by the kernel (64 or 128 rows x 128 x 64); the
    # block arguments are kept for the JAX entry point's signature
    return ag.sliced_matmul(_sliced.sliced_matmul, x, w, active_in,
                            active_out, segments=segments)


@register("sliced_matmul", "torch")
def _sliced_torch(x, w, active_in, active_out, *, segments, bm, bk, bn):
    return _sliced.sliced_matmul_plain(x, w, active_in, active_out,
                                       segments=segments)


@register("subnet_rmsnorm", "cuda", differentiable=True)
def _rmsnorm_cuda(x, gamma_table, subnet_id, *, eps):
    return ag.subnet_rmsnorm(_rmsnorm.subnet_rmsnorm, x, gamma_table,
                             subnet_id, eps=eps)


@register("subnet_rmsnorm", "torch")
def _rmsnorm_torch(x, gamma_table, subnet_id, *, eps):
    return _rmsnorm.subnet_rmsnorm_plain(x, gamma_table, subnet_id, eps=eps)


@register("add_subnet_rmsnorm", "cuda", differentiable=True)
def _add_rmsnorm_cuda(x, delta, gamma_table, subnet_id, *, eps):
    return ag.add_subnet_rmsnorm(_rmsnorm.add_subnet_rmsnorm, x, delta,
                                 gamma_table, subnet_id, eps=eps)


@register("add_subnet_rmsnorm", "torch")
def _add_rmsnorm_torch(x, delta, gamma_table, subnet_id, *, eps):
    return _rmsnorm.add_subnet_rmsnorm_plain(x, delta, gamma_table,
                                             subnet_id, eps=eps)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    head_width=None, q_block=256, kv_block=256, tier=None):
    """Causal / windowed GQA attention; with ``head_width`` only the
    active query heads are computed and the rest are 0 (see
    ``kernels/flash_attention.py``)."""
    return DISPATCHER.call(
        "flash_attention", q, k, v, causal=causal, window=window,
        kv_len=kv_len, head_width=head_width, q_block=q_block,
        kv_block=kv_block, tier=tier)


def decode_attention(q, k_cache, v_cache, index, *, window=0, kv_block=256,
                     tier=None):
    return DISPATCHER.call(
        "decode_attention", q, k_cache, v_cache, index, window=window,
        kv_block=kv_block, tier=tier)


def sliced_matmul(x, w, active_in, active_out, *, segments=1, bm=128, bk=128,
                  bn=128, tier=None):
    """``x[..., :active_in] @ w[:active_in, :active_out]``, zeros past
    ``active_out``; with ``segments`` > 1 the prefix is taken in each of
    that many equal segments of K. Given a stack of experts, x (E, M, K)
    and w (E, K, N), every ``x[e] @ w[e]`` with the same widths, in one
    launch on the card (see ``kernels/sliced_matmul.py``)."""
    return DISPATCHER.call(
        "sliced_matmul", x, w, active_in, active_out, segments=segments,
        bm=bm, bk=bk, bn=bn, tier=tier)


def subnet_rmsnorm(x, gamma_table, subnet_id, *, eps=1e-5, tier=None):
    return DISPATCHER.call(
        "subnet_rmsnorm", x, gamma_table, subnet_id, eps=eps, tier=tier)


def add_subnet_rmsnorm(x, delta, gamma_table, subnet_id, *, eps=1e-5,
                       tier=None):
    """``(s, h)``: ``s = x + delta`` in x's type and ``h`` its SubnetNorm,
    in one launch on the card (see ``kernels/subnet_rmsnorm.py``)."""
    return DISPATCHER.call(
        "add_subnet_rmsnorm", x, delta, gamma_table, subnet_id, eps=eps,
        tier=tier)


# --------------------------------------------------------------------------
# model-grade wiring (used by models/attention and core/operators)
# --------------------------------------------------------------------------


def model_flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                          kv_len=None, q_block=512, kv_block=512, scale=None,
                          head_width=None):
    """Full-sequence attention for model forward passes; ``head_width``
    (WeightSlice switch mode) computes only the active heads and zeros the
    rest.

    The kernel does not take ``q_offset``/``scale``. On CPU tensors a call
    using them takes the plain path (the rule of
    ``repro/kernels/ops.py:173``); on any other device it raises, since the
    device alone decides between kernel and plain version. DTensors whose
    heads are sharded (the dry-run) run on each rank's own heads
    (``distributed.placement.heads_local``)."""
    if is_dtensor(q) and heads_sharded(q, k):
        return heads_local(partial(
            model_flash_attention, causal=causal, window=window,
            q_offset=q_offset, q_block=q_block, kv_block=kv_block,
            scale=scale), q, k, v, kv_len=kv_len, head_width=head_width)
    if not (isinstance(q_offset, int) and q_offset == 0 and scale is None):
        if q.device.type != "cpu":
            raise NotImplementedError(
                f"flash_attention: q_offset / scale on {q.device} tensors: "
                f"the kernel takes neither yet; they come with the slice "
                f"that needs them (chunked prefill, a cached prefix)")
        o = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len, scale=scale,
                                    q_offset=q_offset, q_block=q_block,
                                    kv_block=kv_block)
        return ref.zero_inactive_heads(o, k.shape[1], head_width)
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len, head_width=head_width,
                           q_block=q_block, kv_block=kv_block)


def model_decode_attention(q, k_cache, v_cache, *, index, window=0,
                           kv_block=512):
    """Single-token cached decode for model decode steps."""
    if is_dtensor(q) and heads_sharded(q, k_cache):
        return heads_local(partial(model_decode_attention, window=window,
                                   kv_block=kv_block),
                           q, k_cache, v_cache, index=index)
    return decode_attention(q, k_cache, v_cache, index, window=window,
                            kv_block=kv_block)


def model_subnet_rmsnorm(x, gamma_table, subnet_id, *, eps=1e-5):
    """SubnetNorm (RMS flavor) for model blocks."""
    return subnet_rmsnorm(x, gamma_table, subnet_id, eps=eps)


def model_add_subnet_rmsnorm(x, delta, gamma_table, subnet_id, *, eps=1e-5):
    """The previous block's residual add and this block's SubnetNorm (RMS
    flavor): ``(s, h)``."""
    return add_subnet_rmsnorm(x, delta, gamma_table, subnet_id, eps=eps)

