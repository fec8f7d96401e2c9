"""SubNetAct's three operators in PyTorch (port of ``repro/core/operators.py``).

* :func:`layer_select` — LayerSelect. The JAX package gates each block
  with ``lax.cond`` on a traced boolean inside one executable. Here the
  layer gates of the control tuple stay host numpy and the backbone walks
  them in Python: a gated-off layer launches nothing and costs no sync.
* :func:`subnet_norm` — SubnetNorm: normalization with per-subnet gain
  (and optional bias) rows picked by ``subnet_id``, optionally after the
  pending residual add. The RMS flavor without bias goes through the
  kernel entry points (the CUDA kernel on the card, which also fuses the
  add).
* :func:`subnet_batch_norm` — SubnetNorm in its first form, for the conv
  supernet: BatchNorm with per-subnet (mean, var) rows picked by
  ``subnet_id`` (calibrated offline by ``core.calibrate``).
* :func:`sliced_matmul` / :func:`slice_mask` — WeightSlice. Two modes:
  ``mask``   : full-shape matmul with channel masks (full FLOPs);
  ``switch`` : the ``sliced_matmul`` kernel over the active prefix. JAX
               switches over static branches with ``lax.switch``; here the
               bucket picks the widths from a small device table and the
               kernel reads them from device memory, so no branch is taken
               on the host.

Widths and ``subnet_id`` are 0-d int32 tensors on the data's device (see
:func:`device_control`), used as data by masks and kernels, never read
back to the host: actuating another subnet changes values, not shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import take_row

# control-tuple fields that stay on the host (LayerSelect walks them)
HOST_FIELDS = ("layer_gate",)
# fields that are fractions, not counts: the conv supernet's WeightSlice
# (E, W) control (``models.convnet.make_conv_control``)
FLOAT_FIELDS = ("conv_e_frac", "conv_w_frac")


def device_control(ctrl: Dict, device) -> Dict:
    """The control tuple of ``repro_torch.core.subnet.make_control`` (or
    ``models.convnet.make_conv_control``) split for execution:
    ``layer_gate`` as a host bool array, the fractions of ``FLOAT_FIELDS``
    as 0-d float32 tensors and every other field as a 0-d int32 tensor on
    ``device``. Tensors already there pass through, so an executor
    converts each subnet's tuple once."""
    dev = torch.device(device)
    out = {}
    for key, val in ctrl.items():
        if key in HOST_FIELDS:
            if isinstance(val, torch.Tensor):
                raise TypeError(f"{key} is walked on the host; pass numpy")
            out[key] = np.asarray(val, dtype=bool)
        elif isinstance(val, torch.Tensor) and val.device == dev:
            out[key] = val
        else:
            kind = np.float32 if key in FLOAT_FIELDS else np.int32
            out[key] = torch.as_tensor(np.asarray(val, kind), device=dev)
    return out


# --------------------------------------------------------------------------
# LayerSelect
# --------------------------------------------------------------------------


def layer_select(gate, block_fn: Callable, x):
    """Run ``block_fn(x)`` if the host-side ``gate`` is set, else identity.
    A skipped layer launches nothing."""
    return block_fn(x) if bool(gate) else x


# --------------------------------------------------------------------------
# SubnetNorm
# --------------------------------------------------------------------------


def subnet_norm(x, gamma_table, subnet_id, *, beta_table=None,
                eps: float = 1e-5, kind: str = "rmsnorm", residual=None):
    """Normalize ``x`` with the per-subnet rows of ``gamma_table``
    (n_subnets, d) and, optionally, ``beta_table``.

    With ``residual`` (x's shape and type) the pending residual add comes
    first and the result is ``(s, h)``: ``s = x + residual`` and ``h`` the
    norm of ``s``. The RMS flavor without bias does both in one kernel
    launch on the card; the other flavors add, then normalize."""
    if kind == "rmsnorm" and beta_table is None:
        from repro_torch.kernels import ops as kops
        # the kernel reads an fp32 table; a narrower one (the bf16 tables
        # of dequantized int8 weights) widens exactly, an fp32 one as is
        gamma_table = gamma_table.float()
        if residual is None:
            return kops.model_subnet_rmsnorm(x, gamma_table, subnet_id,
                                             eps=eps)
        return kops.model_add_subnet_rmsnorm(x, residual, gamma_table,
                                             subnet_id, eps=eps)
    if residual is not None:
        s = x + residual
        return s, subnet_norm(s, gamma_table, subnet_id,
                              beta_table=beta_table, eps=eps, kind=kind)
    gamma = take_row(gamma_table, subnet_id)
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * gamma.float()
    if beta_table is not None:
        y = y + take_row(beta_table, subnet_id).float()
    return y.to(x.dtype)


def subnet_batch_norm(x, mean_table, var_table, gamma, beta, subnet_id,
                      eps: float = 1e-5):
    """True BatchNorm SubnetNorm for the conv supernet (the paper's arch):
    ``x`` (B, H, W, C) normalized in fp32 with the (mean, var) rows of
    ``subnet_id`` from the (n_subnets, C) tables that calibration fills
    (``core.calibrate``), then the shared ``gamma`` and ``beta`` (C,).
    The rows are gathered on the device: no host read of the id."""
    mu = take_row(mean_table, subnet_id)
    scale = torch.rsqrt(take_row(var_table, subnet_id) + eps) * gamma
    return torch.addcmul(beta, x.float() - mu, scale).to(x.dtype)


# --------------------------------------------------------------------------
# WeightSlice
# --------------------------------------------------------------------------


def channel_mask(width: int, active, dtype=torch.float32, device=None):
    """(width,) mask of the first ``active`` channels (OFA channel
    sorting: an importance-ranked prefix)."""
    if device is None and isinstance(active, torch.Tensor):
        device = active.device
    return (torch.arange(width, device=device) < active).to(dtype)


def slice_mask(x, active, axis: int = -1):
    """Zero all channels of ``x`` beyond ``active`` along ``axis``."""
    width = x.shape[axis]
    m = channel_mask(width, active, x.dtype, x.device)
    shape = [1] * x.dim()
    shape[axis] = width
    return x * m.reshape(shape)


SLICE_MODES = ("mask", "switch")


def check_slice_mode(mode: str) -> None:
    """Raise ``ValueError`` unless ``mode`` is a WeightSlice mode."""
    if mode not in SLICE_MODES:
        raise ValueError(f"unknown WeightSlice mode {mode!r}; "
                         f"expected one of {SLICE_MODES}")


_option_tables: Dict[Tuple, torch.Tensor] = {}


def _option_table(pairs: Tuple[Tuple[int, int], ...],
                  device) -> torch.Tensor:
    """(n, 2) int32 table of the (in, out) width pairs on ``device``, made
    once per options tuple and device."""
    key = (pairs, str(device))
    table = _option_tables.get(key)
    if table is None:
        table = torch.tensor(pairs, dtype=torch.int32, device=device)
        _option_tables[key] = table
    return table


def sliced_matmul(x, w, active_in, active_out, *, mode: str = "mask",
                  in_options: Sequence[int] = (),
                  out_options: Sequence[int] = (), bucket=None):
    """WeightSlice matmul: ``y = x[..., :k_in] @ w[:k_in, :k_out]`` with
    the output zero-padded to w.shape[-1].

    mask mode:   ``active_in``/``active_out`` (any value), full FLOPs.
    switch mode: ``bucket`` (an int or a 0-d integer tensor, clipped)
                 indexes the zipped option lists; the kernel computes only
                 the active prefix.
    """
    check_slice_mode(mode)
    if mode == "mask":
        xm = slice_mask(x, active_in) if active_in is not None else x
        y = xm @ w
        return slice_mask(y, active_out) if active_out is not None else y

    from repro_torch.kernels import ops as kops
    ins = list(in_options) or [w.shape[0]]
    outs = list(out_options) or [w.shape[1]]
    # bucket enumerates the zipped (not crossed) option list when the two
    # dims are driven by the same control knob
    n = max(len(ins), len(outs))
    ins = ins * n if len(ins) == 1 else ins
    outs = outs * n if len(outs) == 1 else outs
    pairs = list(zip(ins, outs))
    if isinstance(bucket, torch.Tensor):
        table = _option_table(tuple(pairs), x.device)
        b = torch.clamp(bucket.reshape(1).to(x.device).long(), 0,
                        len(pairs) - 1)
        widths = torch.index_select(table, 0, b)[0]
        k_in, k_out = widths[0], widths[1]
    else:
        k_in, k_out = pairs[min(max(int(bucket), 0), len(pairs) - 1)]
    return kops.sliced_matmul(x, w, k_in, k_out)
