"""The port's sharding rules and dry-run specs against the JAX package's,
with nothing allocated on either side (JAX shapes from ``jax.eval_shape``,
the port's from ``meta`` tensors):

* ``param_spec`` (with ``_add_fsdp``) for every leaf of every assigned
  architecture's full config, on both production meshes, with ``moe_2d``
  and ``fsdp`` each on and off, equal to ``ShardingPlan.abstract``'s
  ``PartitionSpec`` entries; ``cache_spec`` for every cache leaf and
  ``batch_spec`` for every batch leaf of every applicable ``SHAPES`` cell;
  the ZeRO-1 ``state_shardings`` placements equal to the placements of
  JAX's specs;
* ``input_specs`` shapes and dtypes leaf for leaf, and ``model_flops`` /
  ``analytic_flops`` equal, for every architecture x ``SHAPES`` entry;
* the spec-to-placement conversion on a few hand-checked specs, and
  ``comm.collective_bytes`` on a row-parallel product whose all-reduce
  bytes are known by hand (a fake 8-rank group, in a subprocess).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import assigned_archs as jassigned
from repro.configs import get_config as jget
from repro.configs import shape_applicable as japplicable
from repro.distributed.sharding import ShardingPlan as JPlan
from repro.distributed.sharding import _path_str as jpath
from repro.launch import specs as JS
from repro.training import optimizer as jopt
from repro_torch.configs import SHAPES, assigned_archs, get_config
from repro_torch.distributed.sharding import ShardingPlan, leaves_with_path
from repro_torch.launch import specs as S
from repro_torch.models.common import tree_flatten_with_path
from repro_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = assigned_archs()


def test_same_archs_and_shapes():
    assert ARCHS == jassigned()
    assert list(SHAPES) == list(JSHAPES)


@functools.lru_cache(maxsize=None)
def jparam_specs(arch):
    return JS.param_specs(jget(arch))


@functools.lru_cache(maxsize=None)
def tparam_specs(arch):
    return S.param_specs(get_config(arch))


def _jleaves(tree):
    return [(jpath(p), tuple(l.shape), l.dtype)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def _tleaves(tree):
    return [("/".join(str(k) for k in p), tuple(l.shape), l.dtype)
            for p, l in tree_flatten_with_path(tree)]


def _entries(spec, rank):
    out = tuple(spec)
    return out + (None,) * (rank - len(out))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    jl, tl = _jleaves(jparam_specs(arch)), _tleaves(tparam_specs(arch))
    assert [(p, s) for p, s, _ in jl] == [(p, s) for p, s, _ in tl]
    for mesh, (shape, axes) in MESHES.items():
        for moe_2d in (False, True):
            for fsdp in (False, True):
                jp = JPlan.abstract(shape, axes, jget(arch), moe_2d=moe_2d,
                                    fsdp=fsdp)
                tp = ShardingPlan.abstract(shape, axes, get_config(arch),
                                           moe_2d=moe_2d, fsdp=fsdp)
                for path, s, _ in jl:
                    want = _entries(jp._add_fsdp(jp.param_spec(path, s), s),
                                    len(s))
                    got = tp._add_fsdp(tp.param_spec(path, s), s)
                    assert got == want, (mesh, moe_2d, fsdp, path, s)
                specs = [sp for _, sp in
                         leaves_with_path(tp.param_specs(tparam_specs(arch)))]
                assert len(specs) == len(jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_jax(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for name, shape in SHAPES.items():
        if not japplicable(jcfg, JSHAPES[name])[0]:
            continue
        for mesh, (mshape, axes) in MESHES.items():
            jp = JPlan.abstract(mshape, axes, jcfg)
            tp = ShardingPlan.abstract(mshape, axes, tcfg)
            if shape.kind == "decode":
                jc = _jleaves(JS.cache_specs(jcfg, JSHAPES[name]))
                tc = _tleaves(S.cache_specs(tcfg, shape))
                assert [(p, s) for p, s, _ in jc] == \
                    [(p, s) for p, s, _ in tc]
                for path, s, _ in jc:
                    assert tp.cache_spec(path, s) == _entries(
                        jp.cache_spec(path, s), len(s)), (name, mesh, path)
            jb = JS.batch_specs(jcfg, JSHAPES[name],
                                with_labels=shape.kind == "train")
            for key, leaf in jb.items():
                s = tuple(leaf.shape)
                assert tp.batch_spec(key, s) == _entries(
                    jp.batch_spec(key, s), len(s))
            pos = (3, shape.global_batch, shape.seq_len)
            assert tp.batch_spec("positions", pos) == _entries(
                jp.batch_spec("positions", pos), 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_equal_jax(arch):
    for mesh, (shape, axes) in MESHES.items():
        jp = JPlan.abstract(shape, axes, jget(arch))
        tp = ShardingPlan.abstract(shape, axes, get_config(arch))
        jst = jopt.state_shardings(jp, jparam_specs(arch))
        tst = topt.state_shardings(tp, tparam_specs(arch))
        jm = [l.spec for l in jax.tree.leaves(
            jst["m"], is_leaf=lambda x: hasattr(x, "spec"))]
        tm = [p for _, p in leaves_with_path(tst["m"])]
        tv = [p for _, p in leaves_with_path(tst["v"])]
        assert len(jm) == len(tm) == len(tv)
        for js, tpl, tvl in zip(jm, tm, tv):
            want = tp.placements(tuple(js))
            assert tpl == want and tvl == want
        assert tst["step"] == tp.placements(())


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_flops_equal_jax(arch, monkeypatch):
    # one parameter tree per architecture, shared by its four cells
    monkeypatch.setattr(JS, "param_specs", lambda c: jparam_specs(c.name))
    monkeypatch.setattr(S, "param_specs", lambda c: tparam_specs(c.name))
    jcfg, tcfg = jget(arch), get_config(arch)
    for name, shape in SHAPES.items():
        jsp = JS.input_specs(jcfg, JSHAPES[name])
        tsp = S.input_specs(tcfg, shape)
        assert sorted(jsp) == sorted(tsp)
        for key in jsp:
            jl, tl = _jleaves(jsp[key]), _tleaves(tsp[key])
            assert [(s, str(np.dtype(d))) for _, s, d in jl] == \
                [(s, str(d).replace("torch.", "")) for _, s, d in tl], key
        assert S.model_flops(tcfg, shape) == JS.model_flops(jcfg,
                                                            JSHAPES[name])
        for remat in (False, True):
            assert S.analytic_flops(tcfg, shape, remat=remat) == \
                JS.analytic_flops(jcfg, JSHAPES[name], remat=remat)
        assert S.attention_flops(tcfg, shape) == \
            JS.attention_flops(jcfg, JSHAPES[name])


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    tp = ShardingPlan.abstract((2, 16, 16), ("pod", "data", "model"),
                               get_config("qwen2-1.5b"))
    assert tp.placements((None, "model")) == (Replicate(), Replicate(),
                                              Shard(1))
    assert tp.placements((("pod", "data"), None)) == (Shard(0), Shard(0),
                                                      Replicate())
    assert tp.placements((None, ("pod", "data", "model"), None)) == \
        (Shard(1), Shard(1), Shard(1))
    with pytest.raises(ValueError):
        tp.placements((("data", "pod"), None))


ROW_PARALLEL = textwrap.dedent("""
    import json
    import torch
    torch.set_num_threads(1)
    from repro_torch import compat
    compat.init_fake_process_group(8)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import comm
    mesh = make_mesh((4, 2), ("data", "model"))
    M, K, N = 64, 128, 256
    with compat.fake_tensor_mode():
        x = DTensor.from_local(torch.empty(M // 4, K // 2), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        w = DTensor.from_local(torch.empty(K // 2, N), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with comm.StepRecorder() as rec:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    total, per_kind = comm.collective_bytes(rec.records)
    print(json.dumps({"total": total, "per_kind": per_kind,
                      "counts": comm.collective_count(rec.records)}))
""")


def test_collective_bytes_of_row_parallel_matmul():
    """x (64, 128) sharded (data, model) times w (128, 256) sharded on K
    over model: each rank holds a (16, 256) fp32 partial sum; reducing it
    over model's 2 ranks is one all-reduce of 16 * 256 * 4 = 16384 bytes,
    2 * 16384 * (2 - 1) / 2 = 16384 wire bytes a rank."""
    out = subprocess.run([sys.executable, "-c", ROW_PARALLEL], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"total": 16384.0, "per_kind": {"all_reduce": 16384.0},
                   "counts": {"all_reduce": 1}}
