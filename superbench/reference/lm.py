"""The plain reference of the served token LMs (dense, and MoE with
capacity dispatch), in float32 with TF32 off.

It follows the architectures as the configuration files state them:
pre-norm blocks, RMSNorm with the served subnet's gain row (SubnetNorm),
GQA attention with rotary positions and QKV bias where the file says so,
causal within the window, SwiGLU FFN; LayerSelect keeps the first live
units, WeightSlice zeroes the FFN channels past the active width and the
outputs of inactive query heads (a prefix of each KV group); the MoE block
routes each token to its ``k_max`` best experts by an fp32 router, weighs
the live ones by a softmax over those, and keeps an expert's first
``capacity`` assignments in token order (dead slots take places too),
as the served model does. The logits are taken at each row's last real
position through the final norm and the (tied) head.

An MoE job can carry the experts a walk took (``routes``): the
reference then takes the same experts and reads how far each choice
strays from its own best. A token whose two best experts lie within a
rounding of each other goes to either, and the expert it takes changes
its row by a whole expert's output: a float32 walk and a bfloat16 one
part there, and the rows that follow it through attention part with it.

It imports nothing of the program: it reads the weights the benchmark
made (``superbench/weights.py``) by their names, and works each subnet's
control out again from the configuration file's frozen Pareto point.
Layers run one at a time, their weights widened to float32 there, so a
model whose float32 weights do not fit still runs. ``weight`` maps each
matrix to the float32 values used (the control passes a rounding to
fp8).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from superbench import subnet


def plain(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A weight in float32 as it is."""
    return w.float()


def fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A weight rounded to fp8 (e4m3) with one scale per output channel
    (the amax over the contraction axis ``dim``), back in float32."""
    wf = w.float()
    scale = wf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (wf / scale).to(torch.float8_e4m3fn).float() * scale


class tf32_off:
    """Float32 products in float32: TF32 off for the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _rms(x, gamma, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gamma


def _rope(x, theta: float):
    """x: (B, S, H, hd), positions 0..S-1, rotate-half form."""
    hd, s = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return x * torch.cos(ang) + torch.cat([-x2, x1], dim=-1) * torch.sin(ang)


def _attention(arch, p, x, ctrl):
    d, hd = arch["hidden_size"], arch["head_dim"]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    b, s, _ = x.shape
    h = _rms(x, p["norm_gamma"][ctrl["subnet_id"]], arch["rms_norm_eps"])
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope(q.reshape(b, s, hq, hd), arch["rope_theta"])
    k = _rope(k.reshape(b, s, hkv, hd), arch["rope_theta"])
    v = v.reshape(b, s, hkv, hd)
    g = hq // hkv
    # query head j*g + i attends with KV head j
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)[:, :, None]
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    scores = (qg @ kg.transpose(-1, -2)) / math.sqrt(hd)
    i = torch.arange(s, device=x.device)
    seen = i[None, :] <= i[:, None]
    window = arch.get("sliding_window") or 0
    if window:
        seen &= (i[:, None] - i[None, :]) < window
    scores = scores.masked_fill(~seen, float("-inf"))
    o = torch.softmax(scores, dim=-1) @ vg               # (b, hkv, g, s, hd)
    heads = torch.arange(hq, device=x.device)
    active = (heads % g < ctrl["head_width"] // hkv) if g > 1 \
        else heads < ctrl["head_width"]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    o = o * active[None, None, :, None].float()
    return x + o.reshape(b, s, hq * hd) @ p["wo"]


def _swiglu(h, wg, wu, wd, width):
    a = F.silu(h @ wg) * (h @ wu)
    a[..., width:] = 0.0
    return a @ wd


def _mlp(arch, p, x, ctrl):
    h = _rms(x, p["norm_gamma"][ctrl["subnet_id"]], arch["rms_norm_eps"])
    return x + _swiglu(h, p["wg"], p["wu"], p["wd"], ctrl["ffn_width"])


def route(arch, logits, topk: int, n_tokens: int, eids=None):
    """Capacity dispatch of ``logits`` (N, E): per expert, the kept
    (token, gate) pairs in token order. ``eids`` (N, k_max), best first,
    are the experts to take; by default the ``k_max`` best of
    ``logits``."""
    kmax, n_exp = subnet.k_max(arch), arch["num_local_experts"]
    if eids is None:
        eids = torch.topk(logits, kmax, dim=-1).indices
    gates = torch.softmax(torch.gather(logits, -1, eids), dim=-1)
    live = torch.arange(kmax, device=logits.device) < topk
    gates = torch.where(live, gates, 0.0)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = eids.reshape(-1)                                   # token-major
    cap = subnet.capacity(arch, n_tokens)
    out = []
    for e in range(n_exp):
        idx = torch.nonzero(flat == e).flatten()              # token order
        idx = idx[:cap]                                       # places taken
        idx = idx[live[idx % kmax]]                           # dead slots out
        out.append((idx // kmax, gates.reshape(-1)[idx]))
    return out


def route_margin(logits, eids) -> float:
    """How far the experts ``eids`` (N, k_max), best first, stray from the
    best of ``logits`` (N, E): the largest, over tokens and slots, of the
    logit of the slot's own best expert less the logit of the one taken
    (0 where every slot takes its own best)."""
    own = torch.topk(logits, eids.shape[-1], dim=-1).indices
    gap = torch.gather(logits, -1, own) - torch.gather(logits, -1, eids)
    return float(gap.max().clamp_min(0.0))


def _moe(arch, p, x, ctrl, job=None):
    b, s, d = x.shape
    h = _rms(x, p["norm_gamma"][ctrl["subnet_id"]],
             arch["rms_norm_eps"]).reshape(b * s, d)
    logits = h @ p["router"]
    eids = None
    if job is not None:
        if "routes" in job:                 # follow the experts taken
            eids = job["routes"][len(job["taken"])].to(logits.device)
            job["margin"] = max(job.get("margin", 0.0),
                                route_margin(logits, eids))
        else:
            eids = torch.topk(logits, subnet.k_max(arch), dim=-1).indices
        job["taken"].append(eids)
    y = torch.zeros_like(h)
    for e, (tok, gate) in enumerate(route(arch, logits, ctrl["topk"], b * s,
                                          eids)):
        if len(tok):
            out = _swiglu(h[tok], p["wg"][e], p["wu"][e], p["wd"][e],
                          ctrl["ffn_width"])
            y.index_add_(0, tok, gate[:, None] * out)
    return x + y.reshape(b, s, d)


_BLOCKS = {"attn": _attention, "mlp": _mlp, "moe": _moe}
# each matrix's contraction axis (its fp8 scales run over it)
_CONTRACT = {"wq": -2, "wk": -2, "wv": -2, "wo": -2, "wg": -2, "wu": -2,
             "wd": -2}


def _layer(params_unit: Dict, r: int, weight: Callable) -> Dict:
    """Unit ``r``'s weights in float32 (matrices through ``weight``)."""
    return {k: (weight(v[r], _CONTRACT[k]) if k in _CONTRACT
                else v[r].float()) for k, v in params_unit.items()}


def last_logits(arch: Dict, params: Dict, jobs: Sequence[Dict],
                weight: Callable = plain) -> List[torch.Tensor]:
    """Float32 logits (B, vocab) at each row's last real position for
    each job: ``{"tokens": (B, S) int tensor on the weights' device,
    "lengths": (B,) or None, "point": a frozen Pareto point}``. An MoE
    job may hold ``"routes"``: the experts (N, k_max) each of its live
    MoE layers takes, in walk order; the reference then takes them and
    notes in ``"margin"`` how far they stray from its own best
    (:func:`route_margin`). Each job gets ``"taken"``, the experts its
    MoE layers took."""
    pattern = arch["pattern"]
    stage = params["backbone"]["stages"][0]
    ctrls = [subnet.control(arch, j["point"]) for j in jobs]
    for j in jobs:
        j["taken"] = []
    with tf32_off(), torch.no_grad():
        emb = weight(params["embed"], -1)
        xs = [emb[j["tokens"].long()] for j in jobs]
        for r in range(arch["num_hidden_layers"]):
            if not any(c["gates"][r] for c in ctrls):
                continue
            units = [_layer(stage[f"{i}:{kind}"], r, weight)
                     for i, kind in enumerate(pattern)]
            for n, c in enumerate(ctrls):
                if c["gates"][r]:
                    for kind, p in zip(pattern, units):
                        if kind == "moe":
                            xs[n] = _moe(arch, p, xs[n], c, jobs[n])
                        else:
                            xs[n] = _BLOCKS[kind](arch, p, xs[n], c)
            del units
        head = (emb.T if arch["tie_word_embeddings"]
                else weight(params["head"], -2))
        out = []
        for j, c, x in zip(jobs, ctrls, xs):
            b, s = j["tokens"].shape
            lengths = j.get("lengths")
            pos = (torch.full((b,), s - 1, device=x.device) if lengths is None
                   else torch.as_tensor(lengths, device=x.device) - 1)
            last = x[torch.arange(b, device=x.device), pos.long()]
            gamma = params["final_gamma"][c["subnet_id"]].float()
            out.append(_rms(last, gamma, arch["rms_norm_eps"]) @ head)
        return out
