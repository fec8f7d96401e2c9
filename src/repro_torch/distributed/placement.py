"""DTensor helpers the model code calls at the few places where DTensor's
sharding rules take no strategy and GSPMD would re-lay the tensor out on
its own. Each is the identity on a plain tensor, so the port's
single-device path is untouched bit for bit; only the dry-run's step
(``launch/dryrun.py``), which runs on DTensors, ever re-lays anything."""
from __future__ import annotations


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        out[i] = out[i + 1] * shape[i + 1]
    return tuple(out)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (checked by type name, so nothing of
    ``torch.distributed`` is imported for a plain tensor)."""
    return type(t).__name__ == "DTensor"


def gather_uneven(t, dim: int, parts: int):
    """``t`` with every mesh dim that shards tensor dim ``dim`` replicated
    when the shards of ``dim`` do not divide ``parts`` (the heads a view
    splits it into); a plain tensor, or one whose shards divide, as is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.dim()
    mesh = t.device_mesh
    placements = list(t.placements)
    shards = 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            shards *= mesh.size(i)
    if parts % shards == 0:
        return t
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                  for p in placements]
    return t.redistribute(mesh, placements)


def _group_placements(mesh, axes):
    """Shard(0) on the mesh dims named in ``axes``, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    axes = () if axes is None else (axes,) if isinstance(axes, str) \
        else tuple(axes)
    return [Shard(0) if name in axes else Replicate()
            for name in mesh.mesh_dim_names]


def pin_groups(t, axes):
    """``t`` with its leading (group) dim sharded over the mesh dims named
    in ``axes`` and replicated over the others: the counterpart of the
    reference's ``with_sharding_constraint(t, P(axes, None, ...))`` in
    ``moe_block``. ``axes`` None, or a plain tensor, leaves ``t`` as is."""
    if axes is None or not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, _group_placements(t.device_mesh,
                                                           axes))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def group_local(fn, axes, *args):
    """``fn(*args)`` run on each rank's own groups. ``fn`` works group by
    group along the leading dim of every tensor it takes and returns (the
    MoE dispatch and combine: sorts, searches, scatters and gathers that
    DTensor has no sharding rule for). With DTensor arguments, each is
    laid out with its groups sharded over ``axes`` (replicated when
    ``axes`` is None; a 0-d one replicated), ``fn`` runs on the local
    shards, and what it returns comes back as DTensors laid out alike:
    the counterpart of the reference's ``vmap`` over groups pinned to the
    DP axes. Plain arguments: ``fn(*args)`` itself."""
    mesh = None
    for a in _flatten(args):
        if is_dtensor(a):
            mesh = a.device_mesh
            break
    if mesh is None:
        return fn(*args)
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Replicate
    placements = _group_placements(mesh, axes)
    shards = 1
    for i, p in enumerate(placements):
        if not isinstance(p, Replicate):
            shards *= mesh.size(i)

    def down(a):
        if not is_dtensor(a):
            return a
        pl = placements if a.dim() else [Replicate()] * mesh.ndim
        return a.redistribute(mesh, pl).to_local()

    def up(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = (t.shape[0] * shards,) + tuple(t.shape[1:])
        return DTensor.from_local(t.contiguous(), mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    return _map(up, fn(*_map(down, args)))


def _flatten(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def write_slot(cache, dim: int, slot, new) -> None:
    """``cache.index_copy_(dim, slot, new)``: the decode step's write of
    one position. On a DTensor whose ``dim`` is not sharded the write is
    made on the local shard, ``new`` first laid out as the cache is:
    DTensor's own ``index_copy_`` builds a buffer of the cache's global
    size on every rank. Where ``dim`` is sharded (sequence-sharded
    caches) the write is a masked select over the whole cache, as an
    update at a traced position is under GSPMD."""
    if not is_dtensor(cache):
        cache.index_copy_(dim, slot, new)
        return
    import torch
    from torch.distributed.tensor import Shard
    mesh, placements = cache.device_mesh, cache.placements
    if not any(isinstance(p, Shard) and p.dim == dim for p in placements):
        local_slot = slot.to_local() if is_dtensor(slot) else slot
        cache.to_local().index_copy_(
            dim, local_slot, new.redistribute(mesh, placements).to_local())
        return
    shape = [1] * cache.dim()
    shape[dim] = cache.shape[dim]
    pos = torch.arange(cache.shape[dim], device=cache.device).reshape(shape)
    cache.copy_(torch.where(pos == slot, new, cache))


def settle_partial(t):
    """``t`` with every pending (partial) mesh dim reduced to a replica: a
    row-parallel product's output is all-reduced before the residual add
    takes it, as Megatron does; left partial, DTensor may reduce-scatter
    it onto the sequence dim, which the next product cannot take. A plain
    tensor, as is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    if all(not p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def embedding(ids, table):
    """``F.embedding(ids, table)``: the rows of ``table`` (V, d) that
    ``ids`` name (the same values as indexing). A DTensor table sharded
    on its vocab is looked up vocab-parallel, as Megatron does it: each
    rank looks up the ids in its own rows (zeros elsewhere) and the rows
    are summed over the vocab's mesh dims; DTensor's own rule leaves a
    masked partial whose gradient it cannot redistribute (torch 2.11).
    A table sharded on d (FSDP) is gathered on d first."""
    import torch
    import torch.nn.functional as F
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    table = table.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in table.placements])
    ids_pl = (list(ids.placements) if is_dtensor(ids)
              else [Replicate()] * mesh.ndim)
    vocab, offset, placements = table.shape[0], 0, []
    coord = mesh.get_coordinate()
    for i, p in enumerate(table.placements):
        if isinstance(p, Shard):          # p.dim == 0: the vocab
            vocab //= mesh.size(i)
            offset = offset * mesh.size(i) + coord[i]
            ids_pl[i] = Replicate()
            placements.append(Partial())
        else:
            placements.append(ids_pl[i])
    ids = ids.redistribute(mesh, ids_pl) if is_dtensor(ids) else ids
    local = (ids.to_local() if is_dtensor(ids) else ids) - offset * vocab
    hit = (local >= 0) & (local < vocab)
    rows = F.embedding(torch.where(hit, local, 0), table.to_local())
    rows = rows * hit[..., None].to(rows.dtype)
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(rows, mesh, placements, run_check=False,
                             shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    return settle_partial(out)


def heads_local(fn, *args, heads: bool = True, whole=None, **kw):
    """``fn(*args, **kw, **whole)`` run on each rank's own batch rows and,
    with ``heads``, its own heads, as tensor-parallel attention runs. The
    tensors of ``args`` and ``kw`` lead with the batch (dim 0) and the
    heads (dim 1): attention's (B, H, S, d) inputs, where q's G heads a kv
    head go with it, or the recurrent insides of an SSM block. Per mesh
    dim they are sharded on the batch where an input is and the batch
    divides, else on the heads likewise (with ``heads``), else replicated:
    a head_dim-sharded cache, a sequence-sharded input or a partial sum is
    gathered. The tensors of ``whole`` (weights) and 0-d ones are read
    whole. Each tensor ``fn`` returns leads the same way and comes back as
    a DTensor laid out alike. DTensor's batched product has no rule for a
    batch that flattens two sharded dims (B over data and heads over
    model), nor for the SSM scans' strided shards. On plain tensors: the
    call itself."""
    whole = whole or {}
    lead = [t for t in list(args) + list(kw.values()) if is_dtensor(t)
            and t.dim() > 0]
    if not lead:
        return fn(*args, **kw, **whole)
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Replicate, Shard
    mesh = lead[0].device_mesh
    B = lead[0].shape[0]
    H = min(t.shape[1] for t in lead if t.dim() > 1)
    placements, split = [], [1, 1]
    for i in range(mesh.ndim):
        n = mesh.size(i)
        dims = {getattr(t.placements[i], "dim", None) for t in lead}
        if 0 in dims and B % (split[0] * n) == 0:
            placements.append(Shard(0))
            split[0] *= n
        elif heads and 1 in dims and H % (split[1] * n) == 0:
            placements.append(Shard(1))
            split[1] *= n
        else:
            placements.append(Replicate())

    def local(t, pl):
        if not is_dtensor(t):
            return t
        if t.dim() == 0 or pl is None:
            pl = [Replicate()] * mesh.ndim
        return t.redistribute(mesh, pl).to_local()

    def back(t):
        shape = list(t.shape)
        for d, k in enumerate(split[:t.dim()]):
            shape[d] *= k
        return DTensor.from_local(t.contiguous(), mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    out = fn(*(local(t, placements) for t in args),
             **{key: local(t, placements) for key, t in kw.items()},
             **{key: local(t, None) for key, t in whole.items()})
    return tuple(back(t) for t in out) if isinstance(out, tuple) \
        else back(out)


def expert_matmul(x, w):
    """``x @ w`` of the MoE slots (G, E, C, k) and an expert table
    (E, k, n). A DTensor takes the product as an einsum: the broadcast
    ``matmul`` expands the table over G into a strided shard that the
    batched product has no rule for. A plain tensor: ``torch.matmul``."""
    if is_dtensor(x) or is_dtensor(w):
        import torch
        return torch.einsum("geck,ekn->gecn", x, w)
    return x @ w


def label_logits(logits, labels):
    """``logits[..., labels]``: each position's logit of its label, from
    logits (..., V) and labels (...). On DTensor logits sharded on the
    vocab it is picked vocab-parallel, as Megatron's cross-entropy does:
    each rank takes the labels in its own columns (zeros elsewhere) and
    the picks are summed over the vocab's mesh dims; DTensor's gather
    over a sharded dim leaves a strided gradient it cannot re-lay out
    under fake tensors. A plain tensor: one gather in the flat (N, V)
    form."""
    import torch
    if not is_dtensor(logits):
        return torch.gather(logits.reshape(-1, logits.shape[-1]), 1,
                            labels.reshape(-1, 1)).reshape(labels.shape)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab, offset, placements = logits.shape[-1], 0, []
    coord = mesh.get_coordinate()
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim == last:
            vocab //= mesh.size(i)
            offset = offset * mesh.size(i) + coord[i]
            placements.append(Partial())
        else:
            placements.append(p)
    lab_pl = [Replicate() if p.is_partial() else p for p in placements]
    lab = labels.redistribute(mesh, lab_pl).to_local() if is_dtensor(labels) \
        else labels
    local = lab - offset * vocab
    hit = (local >= 0) & (local < vocab)
    picked = torch.gather(logits.to_local(), last,
                          torch.where(hit, local, 0)[..., None])[..., 0]
    picked = picked * hit.to(picked.dtype)
    shape = tuple(labels.shape)
    out = DTensor.from_local(picked, mesh, placements, run_check=False,
                             shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    return settle_partial(out)
