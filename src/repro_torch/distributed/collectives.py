"""Explicit collectives over ``torch.distributed`` — the beyond-paper
distributed optimizations (port of ``repro/distributed/collectives.py``).

``seq_sharded_decode``: flash-decode over a *sequence-sharded* KV cache
(SP). Each rank computes partial online-softmax statistics (m, l, o) over
its local cache slice in plain torch, as the reference does (no kernel
computes them there); the cross-rank combine is three small all-reduces
(MAX on m, SUM on l and o) instead of all-gathering the cache.

``ring_allgather``: an all-gather as a ring of P2P sends and receives
(``dist.batch_isend_irecv``), the building block for overlapping KV
movement with per-step compute where SP is not available.

Both take a ``DeviceMesh`` and mesh dim names; the groups are the mesh's
own (``mesh.get_group``). A combine over several mesh dims reduces over
each in turn, which equals one reduction over their product.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.placement import is_dtensor

NEG_INF = -1e30


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _partial_decode(q, k, v, first_pos, index):
    """Local online-softmax stats for one cache shard.

    q: (B, Hkv, G, d); k/v: (B, Hkv, S_loc, d); first_pos: absolute
    position of this shard's slot 0. Returns (m, l, o) in fp32."""
    qf = q.float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float())
    s = s * (q.shape[-1] ** -0.5)
    pos = first_pos + torch.arange(k.shape[2], dtype=torch.int32,
                                   device=k.device)
    mask = pos <= index
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B,Hkv,G)
    p = torch.exp(s - m[..., None]) * mask[None, None, None]
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return m, l, o


def _position(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's index, shard count) over ``axes``, major to minor."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        idx, n = idx * size + coord[a], n * size
    return idx, n


def seq_sharded_decode(mesh, q, k_cache, v_cache, index,
                       seq_axes: Tuple[str, ...] = ("data",)):
    """Decode attention with the KV cache sharded along sequence.

    q: (B, Hq, 1, d), the same on every rank of ``seq_axes``; caches:
    (B, Hkv, S, d) DTensors sharded on S over ``seq_axes`` (or each rank's
    own slice as a plain tensor). ``index``: the new token's absolute
    position (an int or a 0-d tensor). Returns (B, Hq, 1, d) in the
    cache's type, the same on every rank."""
    q, k, v = _local(q), _local(k_cache), _local(v_cache)
    B, Hq, _, d = q.shape
    Hkv, s_loc = k.shape[1], k.shape[2]
    G = Hq // Hkv
    me, _ = _position(mesh, tuple(seq_axes))
    m, l, o = _partial_decode(q.reshape(B, Hkv, G, d), k, v, me * s_loc,
                              index)
    # cross-shard online-softmax combine: 3 small collectives per axis
    m_g = m.clone()
    for a in seq_axes:
        dist.all_reduce(m_g, dist.ReduceOp.MAX, group=mesh.get_group(a))
    corr = torch.exp(m - m_g)
    l_g = l * corr
    o_g = o * corr[..., None]
    for a in seq_axes:
        dist.all_reduce(l_g, group=mesh.get_group(a))
        dist.all_reduce(o_g, group=mesh.get_group(a))
    out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, Hq, 1, d).to(v.dtype)


def seq_sharded_decode_ref(q, k_cache, v_cache, index):
    """Unsharded oracle for the combine (tests)."""
    from repro_torch.kernels.ref import decode_attention_dense_ref
    return decode_attention_dense_ref(q, k_cache, v_cache, index)


def ring_allgather(mesh, x, axis: str):
    """All-gather of each rank's ``x`` along mesh dim ``axis`` as a ring of
    n - 1 P2P steps: returns (n, *x.shape) with row j the ``x`` of the
    axis's j-th rank, on every rank (the reference's buffer order: the
    block received at step i is the one from i + 1 ranks back)."""
    x = _local(x)
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt_rank = dist.get_global_rank(group, (me + 1) % n)
    prev_rank = dist.get_global_rank(group, (me - 1) % n)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[me] = x
    cur = x.contiguous()
    for i in range(n - 1):
        nxt = torch.empty_like(cur)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, nxt_rank, group),
            dist.P2POp(dist.irecv, nxt, prev_rank, group)])
        for req in reqs:
            req.wait()
        buf[(me - i - 1) % n] = nxt
        cur = nxt
    return buf
