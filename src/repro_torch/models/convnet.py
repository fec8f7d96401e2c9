"""OFA-ResNet supernet (the paper's own serving architecture) with the
SubNetAct operators, including *true BatchNorm* SubnetNorm: per-subnet
(mean, var) tables calibrated offline (``core/calibrate.py``), as in the
paper's §3 (port of ``repro/models/convnet.py``).

Residual bottleneck units; elastic dims:
  D (depth)         — LayerSelect gates the last units of each stage,
  E (expand ratio)  — WeightSlice on the bottleneck mid channels,
  W (width mult)    — WeightSlice on the stage output channels.

Activations are NHWC, as in the reference: images arrive (B, H, W, 3).
A conv sees them as an NCHW view in torch's channels-last layout (no
copy), and its weights are (cout, cin, kh, kw) tensors stored channels
last; :func:`from_jax_params` turns the reference's HWIO leaves into them.
XLA's "SAME" padding is reproduced per side: a 3x3 stride-2 conv on an
even input pads (0, 1), which ``F.conv2d(padding=1)`` would not.

LayerSelect walks the host gates of the control tuple, as the LM backbone
does: a gated-off unit launches nothing (the reference branches on a
device gate with ``lax.cond``); the first unit of a stage always runs.
WeightSlice is mask mode, its active widths computed on the device from
the float32 fractions ``conv_e_frac`` / ``conv_w_frac``, and
``subnet_id`` picks the BatchNorm rows on the device.

The network is fp32, as its config is: the convolutions and the head run
with TF32 off for the length of a call (:func:`fp32_products`), and the
process's setting is restored after it. No Pallas kernel of the reference
reaches a conv, so the convs are ``F.conv2d`` and the head a matmul.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.core import operators as ops
from repro_torch.core.subnet import SubnetDescriptor, stage_gates
from repro_torch.models import lm
from repro_torch.models.common import dense_init, tree_map

EPS = 1e-5


def _conv_init(kh: int, kw: int, cin: int, cout: int,
               generator: torch.Generator, device) -> torch.Tensor:
    """He-normal (fan-in kh * kw * cin) conv weight, (cout, cin, kh, kw)
    stored channels last."""
    std = (2.0 / (kh * kw * cin)) ** 0.5
    w = torch.empty((cout, kh, kw, cin), dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return w.permute(0, 3, 1, 2)


def _bn_tables(n_subnets: int, c: int, device) -> Dict:
    """Per-subnet BatchNorm statistics and the shared affine parameters."""
    return {
        "mean": torch.zeros((n_subnets, c), dtype=torch.float32, device=device),
        "var": torch.ones((n_subnets, c), dtype=torch.float32, device=device),
        "gamma": torch.ones((c,), dtype=torch.float32, device=device),
        "beta": torch.zeros((c,), dtype=torch.float32, device=device),
    }


def init_convnet(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                 device=None) -> Dict:
    """Random supernet parameters on ``device`` (default: the GPU) drawn
    from ``generator`` (default: seed 0 on that device); the reference's
    tree, keys and BatchNorm tables alike, with torch's conv layout."""
    dev = compat.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    ns = cfg.elastic.num_subnets
    widths = cfg.conv_stage_widths
    stem_w = max(64, widths[0] // 4)
    params: Dict = {
        "stem": {"w": _conv_init(3, 3, 3, stem_w, generator, dev),
                 "bn": _bn_tables(ns, stem_w, dev)},
        "stages": [],
    }
    cin = stem_w
    for si, stage in enumerate(cfg.stages):
        cout = widths[si]
        mid = cout // 4
        units = []
        for r in range(stage.repeat):
            u = {
                "w1": _conv_init(1, 1, cin if r == 0 else cout, mid,
                                 generator, dev),
                "bn1": _bn_tables(ns, mid, dev),
                "w2": _conv_init(3, 3, mid, mid, generator, dev),
                "bn2": _bn_tables(ns, mid, dev),
                "w3": _conv_init(1, 1, mid, cout, generator, dev),
                "bn3": _bn_tables(ns, cout, dev),
            }
            if r == 0:
                u["proj"] = _conv_init(1, 1, cin, cout, generator, dev)
                u["bn_proj"] = _bn_tables(ns, cout, dev)
            units.append(u)
        params["stages"].append(units)
        cin = cout
    params["head"] = dense_init((widths[-1], cfg.n_classes), torch.float32,
                                generator, dev)
    return params


def from_jax_params(numpy_tree, device=None) -> Dict:
    """The port's tree from a JAX one (``repro.models.convnet.init_convnet``)
    given as nested dicts/lists of numpy (or numpy-convertible) leaves,
    converted as ``lm.from_jax_params`` converts an LM's; each 4-d (HWIO)
    conv weight then becomes (cout, cin, kh, kw), channels last."""

    def to_oihw(a):
        if a.dim() != 4:
            return a
        return a.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    return tree_map(to_oihw, lm.from_jax_params(numpy_tree, device))


def _same_pads(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial axis: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """NHWC ``x`` through the (cout, cin, kh, kw) ``w`` with "SAME"
    padding; NHWC out. ``F.conv2d`` is looked up at each call."""
    kh, kw = w.shape[2:]
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)               # NCHW view, channels last
    if ht == hb and wl == wr:
        y = F.conv2d(xc, w, stride=stride, padding=(ht, wl))
    else:
        y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def _bn_batch(x, t, stats: Dict, site: str, eps: float = EPS):
    """Training-mode BatchNorm: normalize with the batch's statistics (the
    population variance) and record them under ``site`` (SubnetNorm
    calibration, paper §3). x: (B, H, W, C)."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=(0, 1, 2), correction=0)
    stats[site] = (mu, var)
    scale = torch.rsqrt(var + eps) * t["gamma"]
    return torch.addcmul(t["beta"], xf - mu, scale).to(x.dtype)


@contextlib.contextmanager
def fp32_products():
    """TF32 off for cuDNN convolutions and cuBLAS products while the block
    runs; the settings before it are restored after it."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _active(frac, width: int):
    """``max(8, int32(frac * width))`` on the device, as the reference."""
    return torch.clamp((frac * width).to(torch.int32), min=8)


def convnet_forward(params, cfg: ArchConfig, images, ctrl, *,
                    collect_stats: bool = False, static_gates=None):
    """images: (B, H, W, 3) -> logits (B, n_classes), on the parameters'
    device.

    ``collect_stats=True`` is the SubnetNorm calibration path: BatchNorm
    uses batch statistics and the result is ``(logits, stats)``, each
    site's (mean, var) under its key. Depth then comes from
    ``static_gates`` (calibration runs offline, per subnet), else from the
    control tuple's ``layer_gate``.
    """
    dev = params["head"].device
    ctrl = ops.device_control(ctrl, dev)
    sid = ctrl["subnet_id"]
    gates = np.asarray(static_gates if collect_stats else ctrl["layer_gate"],
                       dtype=bool)
    e_frac, w_frac = ctrl["conv_e_frac"], ctrl["conv_w_frac"]
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(np.asarray(images))
    x = images.to(dev, torch.float32)
    stats: Dict = {}

    def bn(x, t, site):
        if collect_stats:
            return _bn_batch(x, t, stats, site)
        return ops.subnet_batch_norm(x, t["mean"], t["var"], t["gamma"],
                                     t["beta"], sid, eps=EPS)

    with fp32_products():
        x = F.relu(bn(_conv(x, params["stem"]["w"], 2), params["stem"]["bn"],
                      "stem"))
        gi = 0
        for si, stage in enumerate(cfg.stages):
            cout = cfg.conv_stage_widths[si]
            active_mid = _active(e_frac, cout // 4)
            # W applies to the intermediate stages only (the last width
            # feeds the head)
            active_out = (_active(w_frac, cout)
                          if si < len(cfg.stages) - 1 else None)
            for r, u in enumerate(params["stages"][si]):
                gate = bool(gates[gi])
                gi += 1
                if r > 0 and not gate:           # LayerSelect(D)
                    continue
                pre = f"s{si}u{r}."
                stride = 2 if r == 0 else 1
                h = F.relu(bn(_conv(x, u["w1"], stride), u["bn1"],
                              pre + "bn1"))
                h = ops.slice_mask(h, active_mid)        # WeightSlice(E)
                h = F.relu(bn(_conv(h, u["w2"]), u["bn2"], pre + "bn2"))
                h = ops.slice_mask(h, active_mid)
                h = bn(_conv(h, u["w3"]), u["bn3"], pre + "bn3")
                if "proj" in u:
                    res = bn(_conv(x, u["proj"], stride), u["bn_proj"],
                             pre + "bn_proj")
                else:
                    res = x
                x = F.relu(res + h)
                if active_out is not None:
                    x = ops.slice_mask(x, active_out)    # WeightSlice(W)
        logits = x.mean(dim=(1, 2)) @ params["head"]   # global average pool
    if collect_stats:
        return logits, stats
    return logits


def make_conv_control(cfg: ArchConfig, sub: SubnetDescriptor) -> Dict[str, np.ndarray]:
    """Conv control tuple: (D, E, W) exactly as the paper's §3 inputs."""
    return {
        "layer_gate": stage_gates(cfg, sub.depth_frac),
        "conv_e_frac": np.float32(sub.ffn_frac),
        "conv_w_frac": np.float32(sub.head_frac),
        "subnet_id": np.int32(sub.subnet_id),
    }
