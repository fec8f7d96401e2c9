"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake 8-rank
(4, 2) ``("data", "model")`` mesh, the cell of ``tests/test_distributed.py``
(``mini_dryrun``): the reduced configs of qwen2-1.5b and of the MoE, SSM
and embed-frontend families, each traced for train, prefill, decode and
decode with int8 weights. For every cell that runs:

* the per-device argument bytes equal the sum over the same inputs of
  JAX's ``NamedSharding.shard_shape`` bytes under the reference's plan
  (for int8, over the reference's ``quantize_specs`` inputs);
* all three roofline terms are > 0 and a train step issues collectives
  with bytes > 0; the counted FLOPs are at least the analytic ones'
  model part.

The cells the port cannot trace yet are the faults listed in
``ROADMAP.md`` §3: each must still fail, loudly, with the op named there.
The launcher's record and ``roofline.aggregate`` are checked on a
skipped production cell. Two subprocesses hold a fake group each.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import compat as jcompat
from repro.configs import get_config as jget
from repro.configs.base import ShapeSpec as JShape
from repro.distributed.sharding import ShardingPlan as JPlan
from repro.launch import specs as JS
from repro.serving import quantize as JQ

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-1.5b", "mixtral-8x7b", "llama4-maverick-400b-a17b",
         "zamba2-2.7b", "xlstm-125m", "musicgen-medium", "qwen2-vl-7b")
CELLS = (("train", False), ("prefill", False), ("decode", False),
         ("decode", True))
# the cells that fail on DTensor's missing rules (ROADMAP.md section 3):
# the mLSTM's forget gate takes an op with no sharding rule
KNOWN_FAULTS = {("xlstm-125m", kind, int8): "log_sigmoid_forward"
                for kind, int8 in (("train", False), ("prefill", False),
                                   ("decode", False), ("decode", True))}

CHILD = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    dryrun.ensure_fake_group(8)
    mesh = make_mesh((4, 2), ("data", "model"))
    out = []
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch).reduced()
        for kind, int8 in ((k, i == "1") for k, i in
                           (c.split(":") for c in sys.argv[2].split(","))):
            shape = ShapeSpec("mini_" + kind, kind, 64, 8)
            try:
                rec = dryrun.trace_cell(cfg, shape, mesh, arch=arch,
                                        mesh_kind="8dev", int8_weights=int8)
            except Exception as e:  # noqa: BLE001 - the parent checks it
                rec = {"arch": arch, "status": "failed", "error": repr(e)}
            rec.update(kind=kind, int8=int8)
            out.append(rec)
    print(json.dumps(out, default=str))
""")


@pytest.fixture(scope="module")
def records():
    """Every cell's record, from two child processes run side by side
    (each its own fake group), three and four configs."""
    cells = ",".join(f"{k}:{int(i)}" for k, i in CELLS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, ",".join(part),
                               cells], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for part in (ARCHS[:3], ARCHS[3:])]
    recs = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        recs += json.loads(out.strip().splitlines()[-1])
    return {(r["arch"], r["kind"], r["int8"]): r for r in recs}


def jax_argument_bytes(arch, kind, int8):
    """Sum over the reference's inputs of its shard shapes' bytes."""
    cfg = jget(arch).reduced()
    shape = JShape("mini_" + kind, kind, 64, 8)
    mesh = jcompat.make_abstract_mesh((4, 2), ("data", "model"))
    plan = JPlan(mesh, cfg, moe_2d=kind == "decode")
    sp = JS.input_specs(cfg, shape)
    sh = JS.input_shardings(plan, cfg, shape, sp)
    if int8:
        q_sp, sc_sp = JQ.quantize_specs(sp["params"])
        sp = {**sp, "params": q_sp, "scales": sc_sp}
        sh = {**sh, "scales": plan.replicated(sc_sp)}
    total = 0
    for key in sp:
        leaves = jax.tree.leaves(sp[key])
        shards = jax.tree.leaves(sh[key],
                                 is_leaf=lambda x: hasattr(x, "shard_shape"))
        assert len(leaves) == len(shards)
        for leaf, s in zip(leaves, shards):
            total += math.prod(s.shard_shape(leaf.shape)) \
                * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,int8", CELLS)
def test_mini_dryrun_cell(records, arch, kind, int8):
    rec = records[(arch, kind, int8)]
    fault = KNOWN_FAULTS.get((arch, kind, int8))
    if fault is not None:
        assert rec["status"] == "failed" and fault in rec["error"], rec
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["argument_bytes_per_device"] == jax_argument_bytes(
        arch, kind, int8)
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0
    assert rec["temp_bytes_per_device"] > 0
    if kind == "train":
        assert rec["t_collective"] > 0
        assert rec["collective_bytes_per_device"] > 0
    assert rec["hlo_flops_per_device"] * rec["chips"] >= \
        rec["model_flops_total"]


def test_launcher_record_and_aggregate(tmp_path, monkeypatch):
    """A production cell the shape rules skip writes the reference's
    skipped record, and ``aggregate`` tables it with an ok record."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import aggregate
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                 "--mesh", "single"])
    rec = json.loads((tmp_path / "qwen2-1.5b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped" and "skip" in rec["reason"]
    ok = {"arch": "qwen2-1.5b", "shape": "decode_32k", "mesh": "single",
          "status": "ok", "chips": 256, "hlo_flops_per_device": 1.0,
          "t_memory": 1e-3, "t_collective": 1e-4, "t_compute": 1e-6,
          "model_flops_total": 1e9, "argument_bytes_per_device": 4e9,
          "temp_bytes_per_device": 1e9, "roofline_fraction": 0.1,
          "dominant": "memory"}
    (tmp_path / "qwen2-1.5b__decode_32k__single.json").write_text(
        json.dumps(ok))
    recs = aggregate.load("single", str(tmp_path))
    table = aggregate.fmt_table(recs)
    assert "skipped" in table and "| memory |" in table and "5.0 |" in table
    assert aggregate.pick_hillclimbs(recs)["worst_fraction"] == ok
