"""ShardingPlan: one object mapping every tensor of an architecture —
parameters, batches, KV/SSM caches, control tuples — to a placement over
the production mesh ``(pod, data, model)`` (port of
``repro/distributed/sharding.py``).

Two layers:

* **The rules** (:meth:`ShardingPlan.param_spec`, ``batch_spec``,
  ``cache_spec``, ``_add_fsdp``) are the reference's, rule for rule. They
  read only the mesh's shape and axis names, so a plan over a device-free
  :class:`MeshSpec` (:meth:`ShardingPlan.abstract`) evaluates them with no
  process group. Each returns a *spec*: one entry per tensor dim, ``None``
  or an axis name or a tuple of axis names, equal to the entries of the
  reference's ``PartitionSpec``.
* **The placements** (:meth:`ShardingPlan.placements` and the tree
  functions ``params`` / ``batch`` / ``cache`` / ``replicated``) turn a
  spec into DTensor placements over a real ``DeviceMesh``: a mesh dim
  whose name the spec puts on tensor dim i is ``Shard(i)``, any other is
  ``Replicate()``. A tuple such as ``("pod", "data")`` on one tensor dim
  is one ``Shard(i)`` on each of those mesh dims, major to minor, as the
  mesh orders them.

TP over ``model`` (attention heads / d_ff / vocab), EP over ``model`` for
many-expert MoE, DP/FSDP over ``(pod, data)``, and SP (sequence sharding)
for decode caches whose batch cannot cover the data axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig

Spec = Tuple[Any, ...]


def _normalized(rule):
    """A rule whose spec names a lone axis by its name, not a 1-tuple, as
    ``PartitionSpec`` normalizes ``("data",)`` to ``"data"``."""
    def norm(*args, **kw) -> Spec:
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in rule(*args, **kw))
    norm.__doc__, norm.__name__ = rule.__doc__, rule.__name__
    return norm


def _path_str(path) -> str:
    """A tree path (keys and indices) as the reference's ``a/b/0/c``."""
    return "/".join(str(p) for p in path)


@dataclass(frozen=True)
class MeshSpec:
    """A device-free mesh: its shape and axis names (the counterpart of
    JAX's ``AbstractMesh``). ``shape`` maps each axis name to its size,
    as a JAX mesh's ``shape`` does."""
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))


def mesh_spec(mesh) -> MeshSpec:
    """The :class:`MeshSpec` of a ``DeviceMesh`` (or a MeshSpec itself)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(int(s) for s in mesh.shape),
                    tuple(mesh.mesh_dim_names))


@dataclass
class ShardingPlan:
    # a DeviceMesh, or a MeshSpec for rule evaluation without devices
    mesh: Any
    cfg: ArchConfig
    # 2D expert sharding (EP over model x FFN over data); decode only
    moe_2d: bool = False
    # FSDP / ZeRO-3: also shard each parameter over the DP axes on its
    # first free divisible dimension
    fsdp: bool = False

    def __post_init__(self):
        self.layout = mesh_spec(self.mesh)

    @classmethod
    def abstract(cls, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 cfg: ArchConfig, **kwargs) -> "ShardingPlan":
        """Plan over a device-free mesh (rule tests, planning tools)."""
        return cls(MeshSpec(tuple(shape), tuple(axes)), cfg, **kwargs)

    # ---- axis helpers -------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data")
                     if a in self.layout.axis_names)

    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def dp_size(self) -> int:
        return int(np.prod([self.layout.shape[a] for a in self.dp_axes]))

    @property
    def tp_size(self) -> int:
        return int(self.layout.shape[self.tp_axis])

    def _dp_if(self, n: int):
        return self.dp_axes if n % max(self.dp_size, 1) == 0 else None

    def _tp_if(self, n: int):
        return self.tp_axis if n % max(self.tp_size, 1) == 0 else None

    # ---- parameters ---------------------------------------------------
    @_normalized
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """TP/EP rules keyed on the leaf name; stacked (scan) leading
        axes are never sharded."""
        name = path.rsplit("/", 1)[-1]
        rank = len(shape)

        def lead(base: Tuple) -> Spec:
            return (None,) * (rank - len(base)) + tuple(base)

        tp = self.tp_axis
        if name == "embed":
            return (self._tp_if(shape[0]), None)
        if name == "head":
            return (None, self._tp_if(shape[1]))
        if name in ("wq", "wk", "wv", "wu", "wg", "w_up", "w_in", "w_x",
                    "swg", "swu"):
            if name in ("wg", "wu") and rank >= 3 and "moe" in path:
                # MoE experts (E, d, f): EP over model when E divides,
                # else TP on the expert FFN dim
                E, _, f = shape[-3:]
                if E % self.tp_size == 0:
                    if self.moe_2d and f % max(self.dp_size, 1) == 0:
                        return lead((tp, None, self.dp_axes))
                    return lead((tp, None, None))
                return lead((None, None, self._tp_if(f)))
            return lead((None, self._tp_if(shape[-1])))
        if name in ("wo", "wd", "w_out", "w_down", "swd"):
            if name == "wd" and rank >= 3 and "moe" in path:
                E, f, _ = shape[-3:]
                if E % self.tp_size == 0:
                    if self.moe_2d and f % max(self.dp_size, 1) == 0:
                        return lead((tp, self.dp_axes, None))
                    return lead((tp, None, None))
                return lead((None, self._tp_if(f), None))
            return lead((self._tp_if(shape[-2]), None))
        # routers, biases, norm tables, SSM/conv small tensors: replicate
        return (None,) * rank

    @_normalized
    def _add_fsdp(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """Compose DP onto the first unsharded axis that divides."""
        if not self.fsdp:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (s, ax) in enumerate(zip(shape, entries)):
            if ax is None and s % max(self.dp_size, 1) == 0 \
                    and s >= self.dp_size:
                entries[i] = self.dp_axes
                return tuple(entries)
        return spec

    def param_specs(self, tree) -> Any:
        """Tree of specs matching ``tree`` (tensors or shaped records)."""
        def one(path, leaf):
            shape = tuple(leaf.shape)
            return self._add_fsdp(self.param_spec(_path_str(path), shape),
                                  shape)
        return _map_with_path(one, tree)

    # ---- batches ------------------------------------------------------
    @_normalized
    def batch_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        if name == "positions" and len(shape) == 3 and shape[0] == 3:
            # M-RoPE position streams: (3, B, S)
            return (None, self._dp_if(shape[1]), None)
        return (self._dp_if(shape[0]),) + (None,) * (len(shape) - 1)

    # ---- decode caches ------------------------------------------------
    @_normalized
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Caches carry a leading stacked-layer axis.

        Attention k/v: (L, B, Hkv, S, hd) — B over DP when divisible,
        else SP: S over DP (the long-context batch=1 case); heads over
        TP when divisible, else head_dim over TP, else S also over TP.
        SSM/xLSTM states: (L, B, ...) — B over DP when divisible; the
        mamba head axis over TP when divisible.
        """
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v") and len(shape) in (4, 5):
            lead: Tuple = (None,) * (len(shape) - 4)
            B, H, S, hd = shape[-4:]
            b_ax = self._dp_if(B)
            h_ax = self._tp_if(H)
            # heads that do not divide shard head_dim, not sequence: an
            # update at a traced position of a sequence-sharded cache
            # gathers the whole cache
            hd_ax = self._tp_if(hd) if h_ax is None else None
            s_axes = []
            if b_ax is None:
                s_axes.extend(self.dp_axes)
            if h_ax is None and hd_ax is None:
                s_axes.append(self.tp_axis)
            s_ax = tuple(s_axes) if s_axes and S % int(np.prod(
                [self.layout.shape[a] for a in s_axes])) == 0 else None
            return lead + (b_ax, h_ax, s_ax, hd_ax)
        if name == "ssm" and len(shape) == 5:        # (L, B, H, N, Pdim)
            return (None, self._dp_if(shape[1]), self._tp_if(shape[2]),
                    None, None)
        if name == "conv" and len(shape) == 4:       # (L, B, W, C)
            return (None, self._dp_if(shape[1]), None,
                    self._tp_if(shape[3]))
        # xlstm states et al: (L, B, ...)
        if len(shape) >= 2:
            return (None, self._dp_if(shape[1])) + (None,) * (len(shape) - 2)
        return (None,) * len(shape)

    def cache_specs(self, tree) -> Any:
        return _map_with_path(
            lambda path, leaf: self.cache_spec(_path_str(path),
                                               tuple(leaf.shape)), tree)

    # ---- placements over a DeviceMesh ---------------------------------
    def placements(self, spec: Spec) -> Tuple:
        """DTensor placements, one per mesh dim, of ``spec``."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.layout.axis_names
        out = [Replicate()] * len(names)
        for i, ax in enumerate(spec):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {spec}: axes {axes} are not in the "
                                 f"mesh's major-to-minor order {names}")
            for p in pos:
                out[p] = Shard(i)
        return tuple(out)

    def params(self, tree) -> Any:
        """Tree of placements matching ``tree``."""
        return _map(self.placements, self.param_specs(tree))

    def batch(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        return {k: self.placements(self.batch_spec(k, tuple(v.shape)))
                for k, v in tree.items()}

    def cache(self, tree) -> Any:
        return _map(self.placements, self.cache_specs(tree))

    def replicated(self, tree) -> Any:
        return _map(lambda leaf: self.placements(()), tree)


# --------------------------------------------------------------------------
# trees whose leaves may be tuples (specs, placements)
# --------------------------------------------------------------------------


def _is_node(t) -> bool:
    return isinstance(t, (dict, list))


def _map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (tuples are
    leaves: specs and placements are tuples)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda path, leaf: fn(leaf), tree)


def leaves_with_path(tree) -> list:
    """``(path, leaf)`` of a spec or placement tree, in the order of
    ``models.common.tree_flatten_with_path`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in [((k,) + p, l) for p, l in leaves_with_path(tree[k])]]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in [((i,) + p, l) for p, l in leaves_with_path(v)]]
    return [((), tree)]


