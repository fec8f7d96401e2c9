"""Elastic scaling: reshard a live tree (params / optimizer state /
caches) onto a *different* mesh — the mechanism behind checkpoint on mesh
A, restore on mesh B and resizing the pool after node failures (port of
``repro/distributed/elastic.py``).

DTensor cannot redistribute across meshes, so each leaf goes whole
through the old mesh (``full_tensor``, an all-gather there) and each rank
of the new mesh keeps its own shard of it (``distribute_tensor`` with no
source rank: a local slice, nothing sent). Every rank of the old mesh
takes part; a rank outside the new mesh holds an empty shard.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.distributed.placement import is_dtensor
from repro_torch.distributed.sharding import ShardingPlan, leaves_with_path
from repro_torch.models.common import tree_leaves, tree_unflatten


def reshard(tree: Any, new_plan: ShardingPlan,
            placements_of: Callable[[ShardingPlan, Any], Any]) -> Any:
    """Move ``tree`` onto ``new_plan.mesh`` with the plan's placements.

    ``placements_of(plan, tree)`` selects which rule family applies
    (``plan.params`` / ``plan.cache`` / ``plan.replicated``)."""
    from torch.distributed.tensor import distribute_tensor
    placements = [p for _, p in leaves_with_path(placements_of(new_plan,
                                                               tree))]
    out = []
    for leaf, pl in zip(tree_leaves(tree), placements):
        full = leaf.full_tensor() if is_dtensor(leaf) else leaf
        out.append(distribute_tensor(full, new_plan.mesh, pl,
                                     src_data_rank=None))
    return tree_unflatten(tree, out)


def reshard_params(tree: Any, new_plan: ShardingPlan) -> Any:
    return reshard(tree, new_plan, lambda p, t: p.params(t))


def shrink_mesh(mesh, cfg=None, *, drop_axis: str = "data",
                factor: int = 2):
    """A degraded mesh after losing ``factor``-worth of ``drop_axis``
    (node failures), rebuilt from the surviving ranks (the first
    1/``factor`` along that axis). Every rank of ``mesh`` must call it."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh
    ax = mesh.mesh_dim_names.index(drop_axis)
    keep = ranks.narrow(ax, 0, ranks.shape[ax] // factor)
    return DeviceMesh(mesh.device_type, keep,
                      mesh_dim_names=mesh.mesh_dim_names)
