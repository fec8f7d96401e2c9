"""SubNetAct's three operators in PyTorch (port of ``repro/core/operators.py``).

* :func:`layer_select` — LayerSelect. The JAX package gates each block
  with ``lax.cond`` on a traced boolean inside one executable. Here the
  layer gates of the control tuple stay host numpy and the backbone walks
  them in Python: a gated-off layer launches nothing and costs no sync.
* :func:`subnet_norm` — SubnetNorm: normalization with per-subnet gain
  (and optional bias) rows picked by ``subnet_id``. The plain RMS flavor
  goes through the kernel entry point (Triton on CUDA).
* :func:`sliced_matmul` / :func:`slice_mask` — WeightSlice in mask mode:
  full-shape matmul with channel masks.

Widths and ``subnet_id`` are 0-d int32 tensors on the data's device (see
:func:`device_control`), used as data by masks and kernels, never read
back to the host: actuating another subnet changes values, not shapes.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.kernels.ref import take_row

# control-tuple fields that stay on the host (LayerSelect walks them)
HOST_FIELDS = ("layer_gate",)


def device_control(ctrl: Dict, device) -> Dict:
    """The control tuple of ``repro_torch.core.subnet.make_control`` split
    for execution: ``layer_gate`` as a host bool array, every other field
    as a 0-d int32 tensor on ``device``. Tensors already there pass
    through, so an executor converts each subnet's tuple once."""
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
            out[key] = torch.as_tensor(np.asarray(val, np.int32), device=dev)
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
                eps: float = 1e-5, kind: str = "rmsnorm"):
    """Normalize ``x`` with the per-subnet rows of ``gamma_table``
    (n_subnets, d) and, optionally, ``beta_table``."""
    if kind == "rmsnorm" and beta_table is None:
        from repro_torch.kernels import ops as kops
        return kops.model_subnet_rmsnorm(x, gamma_table, subnet_id, eps=eps)
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


def check_slice_mode(mode: str) -> None:
    """Only WeightSlice's mask mode is ported; switch mode raises."""
    if mode != "mask":
        raise NotImplementedError(f"WeightSlice mode {mode!r} comes with a "
                                  f"later slice of the port; only 'mask'")


def sliced_matmul(x, w, active_in, active_out, *, mode: str = "mask"):
    """WeightSlice matmul: ``y = x[..., :k_in] @ w[:k_in, :k_out]`` with
    the output zero-padded to w.shape[-1], at full FLOPs (mask mode)."""
    check_slice_mode(mode)
    xm = slice_mask(x, active_in) if active_in is not None else x
    y = xm @ w
    return slice_mask(y, active_out) if active_out is not None else y
