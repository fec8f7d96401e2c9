"""Atomic checkpoints (port of ``repro/training/checkpoint.py``).

Layout:  <dir>/step_<N>/
            manifest.json       tree structure, shapes, dtypes, checksums
            <leaf-id>.npy       one file per leaf (host-gathered)
         <dir>/LATEST           points at the last *complete* step

Write protocol: write into ``step_<N>.tmp``, then a single atomic rename
and a ``LATEST`` update, so a trainer killed mid-write never leaves a
half checkpoint that restore would accept (the manifest's checksums
re-verify every leaf). The directory layout, the leaf names, the manifest
and the bytes of every file are the reference's for the same tree: a bf16
leaf is written as the reference writes it, raw 2-byte words under the
``'<V2'`` descriptor, and the manifest names its type ``bfloat16``.
Unlike the reference, :func:`restore` reads bf16 back (by the manifest's
type) and places each leaf on the device of the template's leaf.

Sharded trees: :func:`save` takes DTensor leaves, gathers each whole
(``full_tensor``, every rank takes part) and writes the same files from
the first rank only; the other ranks wait for it. :func:`restore` with
``shardings`` (a tree of DTensor placements over ``mesh``) places each
leaf with its placements, every rank keeping its own shard of the file it
reads (the reference's ``jax.device_put`` onto ``NamedSharding``s), so a
tree saved on one mesh restores onto another.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.placement import is_dtensor
from repro_torch.models.common import tree_flatten_with_path, tree_unflatten

_BF16_DESCR = "<V2"


def _key_string(path) -> str:
    """The reference's leaf name: ``jax.tree_util.keystr`` of the path,
    cut down the same way."""
    key = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                  for k in path)
    key = key.strip("[]'").replace("']['", "/").replace("'][", "/") \
        .replace("]['", "/").replace("][", "/")
    key = key.replace("[", "").replace("]", "").replace("'", "")
    return key.replace("/", "__") or "leaf"


def _leaf_files(tree) -> Dict[str, Any]:
    return {_key_string(path): leaf
            for path, leaf in tree_flatten_with_path(tree)}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of a leaf; bf16 as its 16-bit
    words. A DTensor is gathered whole first."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(fp: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(fp, arr)
        return
    with open(fp, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(arr.astype("<i2").tobytes(order="C"))


def save(dirpath: str, step: int, tree: Any,
         extra: Optional[Dict] = None) -> str:
    """Atomic save. Returns the final checkpoint path. A tree with DTensor
    leaves is a collective: every rank calls it, the first writes."""
    leaves = _leaf_files(tree)
    sharded = any(is_dtensor(leaf) for leaf in leaves.values())
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(dirpath, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(dirpath, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for name, leaf in leaves.items():
        arr, dtype = _to_numpy(leaf)
        if not writer:
            continue
        fp = os.path.join(tmp, name + ".npy")
        _save_npy(fp, arr, dtype)
        with open(fp, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": dtype, "sha256": digest}
    if not writer:
        dist.barrier()
        return final
    mf = os.path.join(tmp, "manifest.json")
    with open(mf, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest = os.path.join(dirpath, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest + ".tmp", latest)
    if sharded:
        dist.barrier()
    return final


def latest_step(dirpath: str) -> Optional[int]:
    latest = os.path.join(dirpath, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    path = os.path.join(dirpath, name)
    return int(name.split("_")[1]) if os.path.isdir(path) else None


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded leaf as a tensor of its own on ``device`` (on the CPU too:
    torch's allocation, not numpy's, so its alignment is a fresh tensor's
    and the kernels that read it take the same paths); bf16 from its
    16-bit words."""
    t = torch.from_numpy(arr.view("<i2").astype(np.int16)).view(
        torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(arr)
    return t.to(device, copy=True)


def restore(dirpath: str, template: Any, *, step: Optional[int] = None,
            verify: bool = True, device=None, shardings: Any = None,
            mesh=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template``: each leaf read by the
    manifest's dtype (bf16 from its 16-bit words), checked against the
    template leaf's shape and, with ``verify``, the manifest's sha256,
    and placed on ``device`` or else the template leaf's device. With
    ``shardings`` (a tree of DTensor placements shaped as ``template``)
    each leaf becomes a DTensor over ``mesh`` with its placements."""
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.distributed.sharding import leaves_with_path
        if mesh is None:
            raise ValueError("restore onto shardings needs their mesh")
        placements = [p for _, p in leaves_with_path(shardings)]
        device = mesh.device_type
    if step is None:
        step = latest_step(dirpath)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {dirpath}")
    path = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    out = []
    for name, leaf in _leaf_files(template).items():
        meta = manifest["leaves"][name]
        fp = os.path.join(path, name + ".npy")
        if verify:
            with open(fp, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != meta["sha256"]:
                    raise IOError(f"checksum mismatch for {name} in {path}")
        arr = np.load(fp)
        if list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(np.shape(leaf))}")
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(_to_torch(arr, meta["dtype"], dev))
    if shardings is not None:
        # each rank keeps its own shard of what it read: nothing is sent
        out = [distribute_tensor(t, mesh, p, src_data_rank=None)
               for t, p in zip(out, placements)]
    return tree_unflatten(template, out), manifest["extra"]


def prune(dirpath: str, keep: int = 3) -> None:
    """Garbage-collect old checkpoints, never the newest ``keep``."""
    steps = sorted(d for d in os.listdir(dirpath)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(dirpath, d))
