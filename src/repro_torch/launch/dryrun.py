"""Multi-pod dry-run: trace one step of every (architecture x input shape)
cell on the production meshes, on one host, with nothing allocated, and
report the roofline terms (port of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

How a cell runs. A fake process group of 256 (``single``) or 512
(``multi``) ranks (``compat.init_fake_process_group``: collectives move
nothing) holds the production mesh, a ``DeviceMesh`` on ``cpu``. Under
``FakeTensorMode`` every input is a DTensor made from the shape of its
local shard with an explicit global shape and stride
(``DTensor.from_local``, no scatter) and the plan's placements; then the
cell's step runs once in the plain (``torch``) tier: the loss, its
gradient and the reference's SGD-flavoured apply for ``train``,
``lm.prefill`` for ``prefill``, ``lm.decode_step`` for ``decode``, and
``dequantize_tree`` then decode with ``--int8-weights``. The dispatcher
resolves CPU fake tensors to the plain versions; no DTensor reaches a
kernel. Plain tensors the step makes itself (``arange`` masks, default
positions) count as replicated (``compat.implicit_replication``).

What it reads, per device:
  * FLOPs from ``FlopCounterMode`` (on DTensors it counts the global
    product), over ``chips``, floored with ``specs.analytic_flops`` as
    ``roofline/aggregate.corrected`` does; what a local map computes
    (attention on sharded heads, ``distributed/placement.heads_local``)
    is counted for one rank, so there the count is a lower bound and the
    floor governs;
  * argument bytes, exactly, from the local shard shapes of every input;
  * temporary bytes, the peak of what the step allocates, and the bytes
    every op reads and writes, unfused (``roofline/comm.StepRecorder``;
    torch's ``MemTracker`` misreads in-place DTensor writes, see there);
  * the collectives DTensor issues and their wire bytes (same recorder).

The reference's ``cpu_f32_weight_copy_bytes`` (and the projected temp it
subtracts it from) is an artifact of XLA on the CPU promoting bf16 dots;
nothing here makes such copies, so the record has neither key. The
decode step updates the cache in place, so the cache keeps its
placements with no constraint (the reference's ``cache_constraints``).
Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``. A
cell that cannot run (an op with no DTensor sharding strategy, say) is a
sharding bug by definition: it fails loudly and the run exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from functools import partial
from typing import Optional

import torch

from repro_torch import compat
from repro_torch.configs import SHAPES, assigned_archs, get_config, \
    shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import operators as ops
from repro_torch.core import subnet as sn
from repro_torch.distributed.placement import contiguous_stride
from repro_torch.distributed.sharding import ShardingPlan, leaves_with_path
from repro_torch.kernels.ops import model_flash_attention
from repro_torch.launch import specs as S
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.roofline import comm
from repro_torch.roofline.report import RooflineTerms

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def local_shape(shape, placements, mesh) -> tuple:
    """The shard shape on one rank of a ``shape`` tensor placed so."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"{tuple(shape)}: dim {p.dim} does not "
                                 f"divide over mesh dim {i}")
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def place(spec: torch.Tensor, placements, mesh):
    """A DTensor of ``spec``'s shape and type (a meta tensor) with the
    given placements, from a local shard made in the active fake mode."""
    from torch.distributed.tensor import DTensor
    shape = tuple(spec.shape)
    local = torch.empty(local_shape(shape, placements, mesh),
                        dtype=spec.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def place_tree(specs, placements, mesh):
    """:func:`place` over a tree of specs and its tree of placements."""
    flat = [p for _, p in leaves_with_path(placements)]
    return tree_unflatten(specs, [place(s, p, mesh) for s, p in
                                  zip(tree_leaves(specs), flat)])


def argument_bytes(tree) -> int:
    """Bytes of the local shards of every DTensor in ``tree``."""
    return sum(leaf.to_local().numel() * leaf.element_size()
               for leaf in tree_leaves(tree))


def _control(cfg: ArchConfig, ctrl_specs, placements, mesh):
    """The control tuple of the widest subnet: ``layer_gate`` as host
    numpy (LayerSelect walks it), every other field a replicated 0-d
    DTensor (the reference replicates ``ctrl``)."""
    out = {k: place(spec, placements[k], mesh)
           for k, spec in ctrl_specs.items() if k not in ops.HOST_FIELDS}
    gates = sn.make_control(cfg, sn.max_subnet(cfg))["layer_gate"]
    return {"layer_gate": gates, **out}


def control_bytes(ctrl) -> int:
    """Bytes of the control tuple on one rank, the host gates included."""
    return sum(v.nbytes if k in ops.HOST_FIELDS else argument_bytes(v)
               for k, v in ctrl.items())


# --------------------------------------------------------------------------
# the step of each cell kind
# --------------------------------------------------------------------------


def _step_fn(cfg: ArchConfig, kind: str, moe_groups: int, *,
             slice_mode: str = "mask", remat: bool = False,
             moe_group_axes=None, microbatch: int = 0, grad_shardings=None,
             attn_impl=None):
    """The step a cell traces (the reference's ``_step_fn``). Inputs are
    the trees :func:`trace_cell` builds; ``grad_shardings`` (a tree of
    placements) re-lays each gradient out as ZeRO-2 would."""
    if kind == "train":
        def train_step(params, batch, ctrl):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)

            def loss_and_grads(b):
                loss = lm.loss_fn(params, cfg, b, ctrl, slice_mode=slice_mode,
                                  remat=remat, moe_groups=moe_groups,
                                  moe_group_axes=moe_group_axes,
                                  attn_impl=attn_impl)
                # a leaf the loss does not reach (an embed-frontend
                # config's table) gets a zero gradient, as jax.grad gives
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                if grad_shardings is not None:
                    flat = [p for _, p in leaves_with_path(grad_shardings)]
                    grads = [g.redistribute(g.device_mesh, pl)
                             for g, pl in zip(grads, flat)]
                return loss, list(grads)

            if microbatch:
                n = microbatch
                loss, grads = 0.0, None
                for i in range(n):
                    part = {k: v.tensor_split(n, dim=0)[i]
                            for k, v in batch.items()}
                    l_i, g_i = loss_and_grads(part)
                    loss = loss + l_i / n
                    grads = ([g / n for g in g_i] if grads is None else
                             [a + g / n for a, g in zip(grads, g_i)])
            else:
                loss, grads = loss_and_grads(batch)
            # SGD-flavoured apply: optimizer-shape-true without AdamW's
            # moments (the reference's dry-run does the same)
            with torch.no_grad():
                new = [(p.float() - 1e-3 * g.float()).to(p.dtype)
                       for p, g in zip(leaves, grads)]
            return loss, tree_unflatten(params, new)
        return train_step
    if kind == "prefill":
        def prefill_step(params, batch, ctrl):
            return lm.prefill(params, cfg, batch, ctrl, slice_mode=slice_mode,
                              moe_groups=moe_groups,
                              moe_group_axes=moe_group_axes,
                              attn_impl=attn_impl)
        return prefill_step

    if kind == "decode_int8":
        from repro_torch.serving import quantize as QZ

        def serve_step_q(q_params, scales, tokens, ctrl, cache, index):
            params = QZ.dequantize_tree(q_params, scales)
            return lm.decode_step(params, cfg, tokens, ctrl, cache, index,
                                  slice_mode=slice_mode)
        return serve_step_q

    def serve_step(params, tokens, ctrl, cache, index):
        return lm.decode_step(params, cfg, tokens, ctrl, cache, index,
                              slice_mode=slice_mode)
    return serve_step


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               arch: Optional[str] = None, mesh_kind: str = "custom",
               remat: bool = False, microbatch: int = 0,
               int8_weights: bool = False, fsdp: bool = False) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a DeviceMesh of
    the current, usually fake, process group) and return its record."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training import optimizer as _opt
    arch = arch or cfg.name
    plan = ShardingPlan(mesh, cfg, moe_2d=(shape.kind == "decode"),
                        fsdp=fsdp)
    chips = mesh.size()
    sp = S.input_specs(cfg, shape)
    sh = S.input_shardings(plan, cfg, shape, sp)
    kind = shape.kind
    if int8_weights and kind == "decode":
        kind = "decode_int8"
    grad_sh = None
    if shape.kind == "train":
        grad_sh = _opt.state_shardings(plan, sp["params"])["m"]
    # the plain attention in blocks of 1024: a quarter of the block pairs
    # of the served 512, so a 4k cell traces in a fraction of the time
    attn_impl = partial(model_flash_attention, q_block=1024, kv_block=1024)
    step = _step_fn(cfg, kind, moe_groups=plan.dp_size, remat=remat,
                    moe_group_axes=plan.dp_axes, microbatch=microbatch,
                    grad_shardings=grad_sh, attn_impl=attn_impl)

    t0 = time.time()
    with compat.fake_tensor_mode():
        ctrl = _control(cfg, sp["ctrl"], sh["ctrl"], mesh)
        if kind == "decode_int8":
            from repro_torch.serving import quantize as QZ
            q_sp, sc_sp = QZ.quantize_specs(sp["params"])
            tensors = (place_tree(q_sp, sh["params"], mesh),
                       place_tree(sc_sp, plan.replicated(sc_sp), mesh))
        else:
            tensors = (place_tree(sp["params"], sh["params"], mesh),)
        if shape.kind in ("train", "prefill"):
            tensors += ({k: place(v, sh["batch"][k], mesh)
                         for k, v in sp["batch"].items()},)
            args = tensors + (ctrl,)
        else:
            tensors += (place(sp["tokens"], sh["tokens"], mesh),
                        place_tree(sp["cache"], sh["cache"], mesh),
                        place(sp["index"], sh["index"], mesh))
            args = tensors[:-2] + (ctrl,) + tensors[-2:]
        arg_bytes = sum(argument_bytes(t) for t in tensors) \
            + control_bytes(ctrl)
        t_place = time.time() - t0
        # the recorder under the flop counter: the counter sees each
        # DTensor op whole (global FLOPs), the recorder its local ops
        with comm.StepRecorder() as rec, \
                FlopCounterMode(display=False) as flops, \
                compat.implicit_replication():
            out = step(*args)
            del out
        t_step = time.time() - t0 - t_place
    temp = float(rec.peak_bytes)
    counted = float(flops.get_total_flops())
    analytic = S.analytic_flops(cfg, shape, remat=remat)
    coll_bytes, breakdown = comm.collective_bytes(rec.records)
    terms = RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_kind, chips=chips,
        hlo_flops_per_device=max(counted, analytic) / chips,
        hlo_bytes_per_device=float(rec.bytes_accessed),
        collective_bytes_per_device=coll_bytes,
        model_flops_total=S.model_flops(cfg, shape),
        argument_bytes_per_device=float(arg_bytes),
        temp_bytes_per_device=temp,
        collective_breakdown=breakdown)
    return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
            "status": "ok", "kernel_tier": "torch",
            "torch": torch.__version__,
            "remat": remat, "microbatch": microbatch,
            "int8_weights": int8_weights, "fsdp": fsdp,
            "place_s": round(t_place, 1), "trace_s": round(t_step, 1),
            "collective_counts": comm.collective_count(rec.records),
            "counted_flops_total": counted,
            "analytic_flops_total": analytic,
            **terms.to_dict()}


# --------------------------------------------------------------------------
# the production cells
# --------------------------------------------------------------------------


def ensure_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, made anew when the
    current one has another size."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    compat.init_fake_process_group(world_size)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             save: bool = True, remat: bool = False, microbatch: int = 0,
             int8_weights: bool = False, fsdp: bool = False) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": why}
        if save:
            _save(rec)
        return rec
    multi = mesh_kind == "multi"
    ensure_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    rec = trace_cell(cfg, shape, mesh, arch=arch, mesh_kind=mesh_kind,
                     remat=remat, microbatch=microbatch,
                     int8_weights=int8_weights, fsdp=fsdp)
    if save:
        _save(rec)
    return rec


def _save(rec: dict) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(RESULTS_DIR, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    args = ap.parse_args(argv)

    archs = assigned_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                out = os.path.join(
                    RESULTS_DIR, f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_done and os.path.exists(out):
                    continue
                tag = f"{arch} x {shape} x {mesh_kind}"
                try:
                    rec = run_cell(arch, shape, mesh_kind, remat=args.remat,
                                   microbatch=args.microbatch,
                                   int8_weights=args.int8_weights,
                                   fsdp=args.fsdp)
                    if rec["status"] == "skipped":
                        print(f"[skip] {tag}: {rec['reason']}", flush=True)
                    else:
                        print(f"[ ok ] {tag}: dominant={rec['dominant']} "
                              f"frac={rec['roofline_fraction']:.3f} "
                              f"trace={rec['trace_s']}s", flush=True)
                        print("status: ok " + json.dumps(rec, default=str),
                              flush=True)
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(t for t, _ in failures))


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
