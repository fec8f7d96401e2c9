"""The port's collectives, elastic reshard, int8 all-reduce, ZeRO-1 moments
and sharded restore (``repro_torch.distributed``, ``training.compress``,
``training.checkpoint``, ``Trainer(plan=)``) under a gloo process group of
8 ranks on a (4, 2) ``("data", "model")`` mesh, held against the JAX
package on the same numpy inputs:

* ``seq_sharded_decode`` over a cache sharded on sequence over ``data``,
  on the inputs of ``tests/test_distributed.py``, against JAX's
  ``seq_sharded_decode_ref`` (2e-3, fp32);
* ``ring_allgather`` along ``data``: every rank ends with every rank's
  block in the reference's order;
* ``reshard_params`` from (4, 2) onto ``shrink_mesh``'s (2, 2): every leaf
  equal to the original, bit for bit;
* ``all_reduce_int8`` on the JAX test's tree (0.25 everywhere) and on a
  random tree per rank: the mean of each data group's ``ef_quantize``
  dequantizations as JAX computes them (2e-6), the new error equal;
* a checkpoint saved on (4, 2) and restored with shardings on (2, 2),
  directly and through ``Trainer(plan=).resume_or_init``, bit for bit,
  the moments on the ZeRO-1 placements of ``state_shardings``.

All eight ranks are one group of subprocesses, each on one torch thread;
rank 0 writes what the parent checks.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8

CHILD = textwrap.dedent("""
    import json, os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=8)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, elastic
    from repro_torch.distributed.sharding import ShardingPlan, leaves_with_path
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import compress
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTask
    from repro_torch.training.trainer import Trainer, TrainerConfig

    inp = np.load(f"{tmp}/inputs.npz")
    out = {}
    mesh = make_mesh((4, 2), ("data", "model"))
    data, model = mesh.get_coordinate()

    # 1) sequence-sharded decode combine
    kc = distribute_tensor(torch.from_numpy(inp["kc"]), mesh,
                           [Shard(2), Replicate()], src_data_rank=None)
    vc = distribute_tensor(torch.from_numpy(inp["vc"]), mesh,
                           [Shard(2), Replicate()], src_data_rank=None)
    y = collectives.seq_sharded_decode(mesh, torch.from_numpy(inp["q"]),
                                       kc, vc, int(inp["index"]))
    out["seq_decode"] = y.numpy()

    # 2) ring all-gather along data
    x = torch.full((2, 3), float(10 * model + data))
    buf = collectives.ring_allgather(mesh, x, "data")
    want = torch.stack([torch.full((2, 3), float(10 * model + j))
                        for j in range(4)])
    out["ring_ok"] = np.array(bool(torch.equal(buf, want)))

    # 3) int8 all-reduce over data
    g = {"w": torch.from_numpy(inp[f"g{rank}"]),
         "b": torch.full((16, 16), 0.25)}
    e = {"w": torch.from_numpy(inp[f"e{rank}"]), "b": torch.zeros(16, 16)}
    mg, ne = compress.all_reduce_int8(mesh, g, e, axis="data")
    out.update(ar_w=mg["w"].numpy(), ar_b=mg["b"].numpy(),
               err_w=ne["w"].numpy())

    # 4) elastic reshard onto the surviving half of data
    cfg = get_config("qwen2-1.5b").reduced()
    base = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = ShardingPlan(mesh, cfg)
    placed = elastic.reshard_params(base, plan)
    small = elastic.shrink_mesh(mesh, cfg, drop_axis="data", factor=2)
    plan2 = ShardingPlan(small, cfg)
    moved = elastic.reshard_params(placed, plan2)
    member = rank < 4
    same = True
    placements_ok = True
    want_pl = [p for _, p in leaves_with_path(plan2.params(base))]
    for a, b, pl in zip(tree_leaves(base), tree_leaves(moved), want_pl):
        if member:
            same &= torch.equal(b.full_tensor(), a)
            placements_ok &= tuple(b.placements) == tuple(pl)
    out["reshard_ok"] = np.array(bool(same and placements_ok))

    # 5) save on (4, 2), restore on (2, 2) with shardings
    ck = os.path.join(tmp, "ckpt")
    tree = {"params": placed, "opt": opt.init(base)}
    ckpt.save(ck, 3, tree, extra={"step": 3})
    shardings = {"params": plan2.params(base),
                 "opt": opt.state_shardings(plan2, base)}
    got, extra = ckpt.restore(ck, {"params": base, "opt": opt.init(base)},
                              shardings=shardings, mesh=small)
    ok = extra["step"] == 3
    if member:
        for a, b in zip(tree_leaves(base), tree_leaves(got["params"])):
            ok &= torch.equal(b.full_tensor(), a)
        m = got["opt"]["m"]["embed"]
        ok &= tuple(m.placements) == tuple(
            opt.state_shardings(plan2, base)["m"]["embed"])
    out["restore_ok"] = np.array(bool(ok))

    tr = Trainer(cfg, opt.AdamWConfig(), TrainerConfig(ckpt_dir=ck),
                 SyntheticTask(cfg.vocab_size, 8, 2), device="cpu",
                 plan=plan2)
    st = tr.resume_or_init(0)
    ok = st.step == 3
    if member:
        for a, b in zip(tree_leaves(base), tree_leaves(st.params)):
            ok &= torch.equal(b.full_tensor().detach(), a)
    out["trainer_ok"] = np.array(bool(ok))

    if rank == 0:
        np.savez(f"{tmp}/out.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    from repro.distributed import collectives as jcoll
    from repro.training import compress as jcomp
    tmp = tmp_path_factory.mktemp("dist")
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (2, 4, 1, 16), jnp.float32)
    kc = jax.random.normal(ks[1], (2, 2, 32, 16), jnp.float32)
    vc = jax.random.normal(ks[2], (2, 2, 32, 16), jnp.float32)
    rng = np.random.default_rng(0)
    inputs = {"q": np.asarray(q), "kc": np.asarray(kc), "vc": np.asarray(vc),
              "index": np.int32(17)}
    for r in range(WORLD):
        inputs[f"g{r}"] = rng.normal(size=(16, 16)).astype(np.float32)
        inputs[f"e{r}"] = (rng.normal(size=(16, 16)) * 1e-3).astype(
            np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(tmp)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    out = dict(np.load(tmp / "out.npz"))
    ref = np.asarray(jcoll.seq_sharded_decode_ref(q, kc, vc, 17))

    def ef(r):
        qv, sc, err = jcomp.ef_quantize(jnp.asarray(inputs[f"g{r}"]),
                                        jnp.asarray(inputs[f"e{r}"]))
        return np.asarray(jcomp.dequantize(qv, sc)), np.asarray(err)

    # rank 0's data group on the (4, 2) mesh: ranks 0, 2, 4, 6
    group = [ef(r)[0] for r in (0, 2, 4, 6)]
    qb, sb, _ = jcomp.ef_quantize(jnp.full((16, 16), 0.25), jnp.zeros((16, 16)))
    want = {"ar_w": sum(group) / 4, "err_w": ef(0)[1],
            "ar_b": np.asarray(jcomp.dequantize(qb, sb))}
    return out, ref, want


def test_seq_sharded_decode_matches_jax_ref(dist_run):
    out, ref, _ = dist_run
    err = float(np.abs(out["seq_decode"] - ref).max())
    assert err < 2e-3, err


def test_ring_allgather_order(dist_run):
    assert bool(dist_run[0]["ring_ok"])


@pytest.mark.parametrize("key", ["ar_w", "ar_b", "err_w"])
def test_all_reduce_int8_matches_jax(dist_run, key):
    out, _, want = dist_run
    np.testing.assert_allclose(out[key], want[key], rtol=0, atol=2e-6)


def test_reshard_params_onto_shrunk_mesh(dist_run):
    assert bool(dist_run[0]["reshard_ok"])


@pytest.mark.parametrize("key", ["restore_ok", "trainer_ok"])
def test_sharded_restore_bit_for_bit(dist_run, key):
    assert bool(dist_run[0][key])
