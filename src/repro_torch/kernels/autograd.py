"""Gradients through the hand-written kernels: one ``torch.autograd.Function``
for each kernel that a training forward reaches.

A cuda-tier wrapper launches through ``ctypes`` into a buffer from
``torch.empty``, so its output has no ``grad_fn``: called bare under grad
it would cut the graph at the kernel and leave every leaf in front of it
without a gradient. The JAX package has no VJP for its Pallas kernels
(``jax.grad`` through a ``pallas_call`` raises); it trains at its ``ref``
tier, where XLA differentiates the jnp versions of ``repro/kernels/ref.py``.
Here the forward runs the kernel and the backward is that same math
written in PyTorch ops, ``*_backward_plain``, which the CPU tests hold to
``torch.autograd`` of each plain version:

* :func:`subnet_rmsnorm` and :func:`add_subnet_rmsnorm` (the residual add
  fused in front): ``rstd`` recomputed in fp32 from the saved input; the
  gain gradient lands in row ``subnet_id`` only, by ``index_add_`` on the
  device;
* :func:`flash_attention`: the fp32 scores recomputed with the forward's
  masks;
* :func:`sliced_matmul`: two products masked to the active block, the
  masks built on the device from the widths.

Each Function takes the forward ``impl`` as its first argument: the
kernel's wrapper on the card, its plain version in the CPU tests, which
run the same Function in fp64 under ``gradcheck``. Tensors are kept with
``save_for_backward``, so activation checkpointing frees and recomputes
them. Outside grad (serving runs under ``torch.no_grad``) the entry points
call ``impl`` directly. A cuda-tier kernel without a Function is guarded:
:func:`check_no_grad` raises instead of returning a detached output.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ref


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_no_grad(name: str, args, kwargs) -> None:
    """Raise ``RuntimeError`` when grad is on and a tensor argument of
    ``name`` requires grad: its kernel has no backward, and its output
    would silently end the graph."""
    if _needs_grad(*args, *kwargs.values()):
        raise RuntimeError(
            f"{name}: the cuda kernel has no backward, and an input "
            f"requires grad; call it under torch.no_grad() or on detached "
            f"inputs")


def _save(ctx, *vals) -> None:
    """Keep ``vals`` for the backward: tensors through
    ``save_for_backward``, everything else (ints, None) as is."""
    ctx.kinds = [isinstance(v, torch.Tensor) for v in vals]
    ctx.rest = [v for v in vals if not isinstance(v, torch.Tensor)]
    ctx.save_for_backward(*(v for v in vals if isinstance(v, torch.Tensor)))


def _saved(ctx) -> list:
    tensors, rest = iter(ctx.saved_tensors), iter(ctx.rest)
    return [next(tensors) if k else next(rest) for k in ctx.kinds]


# --------------------------------------------------------------------------
# SubnetNorm
# --------------------------------------------------------------------------


def _row_index(subnet_id, device) -> torch.Tensor:
    if isinstance(subnet_id, torch.Tensor):
        return subnet_id.reshape(1).to(device).long()
    return torch.tensor([int(subnet_id)], device=device)


def _rmsnorm_grads(x, gamma_table, subnet_id, dy, eps):
    """(dx in the accumulation type, dgamma_table) of ``h = norm(x) *
    gamma_table[subnet_id]``."""
    xf = ref.acc(x)
    g = ref.take_row(gamma_table, subnet_id).to(xf.dtype)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    dyf = dy.to(xf.dtype)
    gdy = dyf * g
    dx = rstd * (gdy - xhat * (xhat * gdy).mean(-1, keepdim=True))
    row = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    dgamma = torch.zeros_like(gamma_table).index_add_(
        0, _row_index(subnet_id, gamma_table.device),
        row.to(gamma_table.dtype)[None])
    return dx, dgamma


def subnet_rmsnorm_backward_plain(x, gamma_table, subnet_id, dy, *,
                                  eps: float = 1e-5):
    """(dx, dgamma_table) of ``ref.subnet_rmsnorm_ref``: ``dx = rstd * (g
    dy - x̂ mean(x̂ g dy))`` with ``rstd`` recomputed from x; dgamma_table
    zero but for row ``subnet_id``, ``sum(dy * x̂)`` over the rows."""
    dx, dgamma = _rmsnorm_grads(x, gamma_table, subnet_id, dy, eps)
    return dx.to(x.dtype), dgamma


def add_subnet_rmsnorm_backward_plain(s, gamma_table, subnet_id, ds, dh, *,
                                      eps: float = 1e-5):
    """(dx, dgamma_table) of the fused form ``(s, h)``, ``s = x + delta``,
    from the saved sum ``s``: the gradient into ``s`` is ``ds`` plus the
    norm's, summed in the accumulation type, and it is both x's and
    delta's."""
    dx, dgamma = _rmsnorm_grads(s, gamma_table, subnet_id, dh, eps)
    return (dx + ref.acc(ds)).to(s.dtype), dgamma


class _SubnetRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, x, gamma_table, subnet_id, eps):
        ctx.eps = eps
        _save(ctx, x, gamma_table, subnet_id)
        return impl(x, gamma_table, subnet_id, eps=eps)

    @staticmethod
    def backward(ctx, dh):
        x, gamma_table, subnet_id = _saved(ctx)
        dx, dgamma = subnet_rmsnorm_backward_plain(
            x, gamma_table, subnet_id, dh, eps=ctx.eps)
        return None, dx, dgamma, None, None


class _AddSubnetRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, x, delta, gamma_table, subnet_id, eps):
        s, h = impl(x, delta, gamma_table, subnet_id, eps=eps)
        ctx.eps = eps
        _save(ctx, s, gamma_table, subnet_id)
        return s, h

    @staticmethod
    def backward(ctx, ds, dh):
        s, gamma_table, subnet_id = _saved(ctx)
        dx, dgamma = add_subnet_rmsnorm_backward_plain(
            s, gamma_table, subnet_id, ds, dh, eps=ctx.eps)
        return None, dx, dx, dgamma, None, None


def subnet_rmsnorm(impl: Callable, x, gamma_table, subnet_id, *,
                   eps: float = 1e-5):
    """``impl(x, gamma_table, subnet_id, eps=eps)``, differentiable in x and
    gamma_table."""
    if _needs_grad(x, gamma_table):
        return _SubnetRMSNorm.apply(impl, x, gamma_table, subnet_id, eps)
    return impl(x, gamma_table, subnet_id, eps=eps)


def add_subnet_rmsnorm(impl: Callable, x, delta, gamma_table, subnet_id, *,
                       eps: float = 1e-5):
    """``impl(x, delta, gamma_table, subnet_id, eps=eps) -> (s, h)``,
    differentiable in x, delta and gamma_table."""
    if _needs_grad(x, delta, gamma_table):
        return _AddSubnetRMSNorm.apply(impl, x, delta, gamma_table,
                                       subnet_id, eps)
    return impl(x, delta, gamma_table, subnet_id, eps=eps)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------


def flash_attention_backward_plain(q, k, v, o, do, *, causal=True, window=0,
                                   kv_len=None, head_width=None):
    """(dq, dk, dv) of the forward ``o`` of ``q`` (B, Hq, Sq, d) over ``k``,
    ``v`` (B, Hkv, Sk, d). The scores are recomputed in fp32 (fp64 for
    fp64) under the forward's causal, window and ``kv_len`` masks, and a
    fully masked row has P = 0, as the forward's output is 0 there. Then
    ``dV = Pᵀ dO``, ``dS = P (dO Vᵀ - rowsum(dO o))``, ``dQ = scale dS K``
    and ``dK = scale dSᵀ Q``, dK and dV summed over each kv group's query
    heads. With ``head_width`` the inactive heads' dO is taken as 0, so
    they pass no gradient.

    It holds a few (B, Hq, Sq, Sk) score tensors at once, 4 bytes an entry
    in fp32: B·Hq·S²·4 bytes each, 1.6 MB at B = 8, 12 heads and S = 64,
    1.6 GB at S = 2048."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = d ** -0.5
    if head_width is not None:
        do = ref.zero_inactive_heads(do, Hkv, head_width)
    qf = ref.acc(q.reshape(B, Hkv, G, Sq, d))
    kf, vf = ref.acc(k), ref.acc(v)
    dof = ref.acc(do.reshape(B, Hkv, G, Sq, d))
    of = ref.acc(o.reshape(B, Hkv, G, Sq, d))
    mask = ref._attention_mask(torch.arange(Sq, device=q.device),
                               torch.arange(Sk, device=q.device),
                               causal=causal, window=window, kv_len=kv_len)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.softmax(torch.where(mask, s, ref.NEG_INF), dim=-1)
    p = p * mask.any(-1)[:, None]
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(B, Hq, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, q, k, v, causal, window, kv_len, head_width):
        o = impl(q, k, v, causal=causal, window=window, kv_len=kv_len,
                 head_width=head_width)
        ctx.causal, ctx.window = causal, window
        _save(ctx, q, k, v, o, kv_len, head_width)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, kv_len, head_width = _saved(ctx)
        dq, dk, dv = flash_attention_backward_plain(
            q, k, v, o, do, causal=ctx.causal, window=ctx.window,
            kv_len=kv_len, head_width=head_width)
        return None, dq, dk, dv, None, None, None, None


def flash_attention(impl: Callable, q, k, v, *, causal=True, window=0,
                    kv_len=None, head_width=None):
    """``impl(q, k, v, ...)``, differentiable in q, k and v."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(impl, q, k, v, causal, window, kv_len,
                                     head_width)
    return impl(q, k, v, causal=causal, window=window, kv_len=kv_len,
                head_width=head_width)


# --------------------------------------------------------------------------
# sliced matmul
# --------------------------------------------------------------------------


def sliced_matmul_backward_plain(x, w, active_in, active_out, dy, *,
                                 segments: int = 1):
    """(dx, dw) of ``y = x[..., :active_in] @ w[:active_in, :active_out]``
    (``active_in`` a prefix of each of ``segments`` equal segments of K,
    zeros past ``active_out``): ``dx = (dy masked to the active columns)
    @ wᵀ``, masked to the active channels of x; ``dw = xᵀ dy``, zero off
    the active block. For a stack of experts, x (E, M, K) and w (E, K, N),
    the same per expert. The masks compare an ``arange`` with the widths
    on the device, so no width is read back to the host."""
    K, N = w.shape[-2:]
    dt = torch.promote_types(x.dtype, w.dtype)
    xw, wt, dyt = x.to(dt), w.to(dt), dy.to(dt)
    if active_out is not None:
        dyt = dyt * (torch.arange(N, device=dy.device) < active_out).to(dt)
    keep = None
    if active_in is not None:
        keep = ((torch.arange(K, device=x.device) % (K // segments))
                < active_in).to(dt)
        xw = xw * keep
    if w.dim() == 3:
        dx = dyt @ wt.transpose(-1, -2)
        dw = xw.transpose(-1, -2) @ dyt
    else:
        dx = dyt @ wt.T
        dw = xw.reshape(-1, K).T @ dyt.reshape(-1, N)
    if keep is not None:
        dx = dx * keep
    return dx.to(x.dtype), dw.to(w.dtype)


class _SlicedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, x, w, active_in, active_out, segments):
        ctx.segments = segments
        _save(ctx, x, w, active_in, active_out)
        return impl(x, w, active_in, active_out, segments=segments)

    @staticmethod
    def backward(ctx, dy):
        x, w, active_in, active_out = _saved(ctx)
        dx, dw = sliced_matmul_backward_plain(
            x, w, active_in, active_out, dy, segments=ctx.segments)
        return None, dx, dw, None, None, None


def sliced_matmul(impl: Callable, x, w, active_in, active_out, *,
                  segments: int = 1):
    """``impl(x, w, active_in, active_out, segments=segments)``,
    differentiable in x and w."""
    if _needs_grad(x, w):
        return _SlicedMatmul.apply(impl, x, w, active_in, active_out,
                                   segments)
    return impl(x, w, active_in, active_out, segments=segments)
