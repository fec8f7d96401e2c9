"""The port imports neither JAX nor the JAX package, nor ``triton``: every
module of ``repro_torch`` and ``chip_smoke.py`` import in a fresh
interpreter whose meta-path finder refuses ``jax``, ``jaxlib``,
``repro``, ``triton`` and their submodules (exact names, so
``repro_torch`` itself passes), and no source of the port or its tools
imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "repro", "triton")

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = {blocked!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25


_CONFIGS_CHILD = _CHILD.split("import repro_torch")[0] + r"""
from repro_torch.configs import get_config, list_configs
for name in ("qwen2.5-14b", "stablelm-3b", "h2o-danube-3-4b",
             "mixtral-8x7b", "llama4-maverick-400b-a17b", "zamba2-2.7b",
             "xlstm-125m", "musicgen-medium", "qwen2-vl-7b", "ofa_resnet"):
    get_config(name)
mods = ("qwen2p5_14b", "stablelm_3b", "h2o_danube_3_4b", "mixtral_8x7b",
        "llama4_maverick_400b_a17b", "zamba2_2p7b", "xlstm_125m",
        "musicgen_medium", "qwen2_vl_7b", "ofa_resnet")
assert all(f"repro_torch.configs.{{m}}" in sys.modules for m in mods)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(list_configs()))
"""


def test_config_modules_import_without_jax_or_repro():
    """The configs beside qwen2-1.5b (three dense, two MoE, two of the SSM
    family, the two embed-frontend ones, and the paper's OFA-ResNet) load
    under the same blocker, each from its own module of the port."""
    proc = subprocess.run(
        [sys.executable, "-c", _CONFIGS_CHILD.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) == 11


def test_moe_modules_import_without_jax_or_repro():
    """The MoE slice's modules (the block, the backbone that routes it, the
    grouped kernel's wrapper and the launcher) import under the blocker,
    and the block runs a reduced mixtral layer on the CPU there."""
    child = _CHILD.split("import repro_torch")[0] + r"""
import torch
from repro_torch.configs import get_config
from repro_torch.core import subnet as sn
from repro_torch.launch import serve
from repro_torch.models import backbone, lm, moe
from repro_torch.kernels import sliced_matmul
cfg = get_config("mixtral-8x7b").reduced()
p = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
y = lm.forward(p, cfg, {{"tokens": [[1, 2, 3, 4]]}}, ctrl,
               slice_mode="switch")
assert y.shape == (1, 4, cfg.vocab_size) and bool(torch.isfinite(y).all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_ssm_modules_import_without_jax_or_repro():
    """The SSM slice's modules (Mamba2 and xLSTM blocks, the backbone with
    zamba2's shared block) import under the blocker, and the reduced
    zamba2 and xlstm run a forward and two decode steps on the CPU there."""
    child = _CHILD.split("import repro_torch")[0] + r"""
import torch
from repro_torch.configs import get_config
from repro_torch.core import subnet as sn
from repro_torch.models import backbone, lm, ssm, xlstm
for name in ("zamba2-2.7b", "xlstm-125m"):
    cfg = get_config(name).reduced()
    p = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    y = lm.forward(p, cfg, {{"tokens": [[1, 2, 3, 4]]}}, ctrl,
                   slice_mode="switch")
    assert y.shape == (1, 4, cfg.vocab_size) and bool(torch.isfinite(y).all())
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    for i in range(2):
        y, cache = lm.decode_step(p, cfg, [[i + 1]], ctrl, cache, i)
        assert bool(torch.isfinite(y).all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_serving_plane_modules_import_without_jax_or_repro():
    """The serving plane's modules (the wire, the replica child, the
    cluster coordinator, the autoscaler, the simulator, OFA-ResNet's
    config and the launcher) import under the blocker, and there the
    simulator serves a short trace on OFA-ResNet's analytic profile, an
    autoscaled cluster runs to quiescence on a virtual clock, and a frame
    makes the round trip."""
    child = _CHILD.split("import repro_torch")[0] + r"""
from repro_torch.configs import get_config, ofa_resnet
from repro_torch.launch import serve
from repro_torch.serving import (autoscaler, cluster, engine, ipc, policies,
                                 profiler, replica_proc, runtime, simulator,
                                 traces)
prof = profiler.build_profile(get_config("ofa_resnet"))
arr = traces.bursty_trace(100.0, 400.0, 4.0, 0.5, 1)
res = simulator.simulate_cluster(arr, prof, policies.SlackFit(),
                                 simulator.ClusterConfig(n_replicas=2))
assert len(res.records) == len(arr) > 50
router = runtime.ClusterRouter(
    prof, policies.SlackFit(),
    [[runtime.WorkerHandle(wid=0, run=lambda i, p: p)]],
    clock=engine.VirtualClock(),
    autoscale=autoscaler.AutoscaleConfig(max_replicas=3))
assert len(router.run_virtual(arr, 0.036)) == len(arr)
dec = ipc.FrameDecoder()
assert dec.feed(ipc.encode_frame({{"t": "x"}}, 0)) == [{{"t": "x", "seq": 0}}]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_training_modules_import_without_jax_or_repro(tmp_path):
    """The training slice's modules (the kernels' autograd Functions, the
    optimizer, supernet step, checkpoints, trainer and the launcher)
    import under the blocker, and there the reduced qwen2-1.5b takes two
    sandwich steps on the CPU, saves, and restores bit for bit."""
    child = _CHILD.split("import repro_torch")[0] + r"""
import torch
from repro_torch.kernels import autograd
from repro_torch.launch import train
from repro_torch.models.common import tree_leaves
from repro_torch.training import (checkpoint, data, optimizer, supernet,
                                  trainer)
cfg = train.serving_config("qwen2-1.5b", "cpu")
tr = trainer.Trainer(
    cfg, optimizer.AdamWConfig(lr=1e-3),
    trainer.TrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir={ckpt!r}),
    data.SyntheticTask(cfg.vocab_size, 8, 2), device="cpu")
st = tr.run(tr.resume_or_init(0))
assert st.step == 2 and all(l == l for l in st.losses)
back, extra = checkpoint.restore({ckpt!r}, {{"params": st.params}})
assert extra == {{"step": 2}}
assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                             tree_leaves(st.params)))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c",
         child.format(blocked=BLOCKED, ckpt=str(tmp_path))],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_conv_and_frontend_modules_import_without_jax_or_repro():
    """The conv supernet's modules (``models/convnet.py``,
    ``core/calibrate.py``) and the embed-frontend configs import under the
    blocker, and there a narrow OFA-ResNet calibrates two subnets and
    walks them, and the reduced musicgen-medium and qwen2-vl-7b run a
    forward from ``embeds`` and two decode steps on the CPU."""
    child = _CHILD.split("import repro_torch")[0] + r"""
import numpy as np
import torch
from repro_torch.configs import get_config, musicgen_medium, qwen2_vl_7b
from repro_torch.configs.base import Stage
from repro_torch.core import calibrate
from repro_torch.core import subnet as sn
from repro_torch.models import convnet, lm
cfg = get_config("ofa_resnet")
cfg = cfg.replace(stages=tuple(Stage(s.pattern, 2) for s in cfg.stages),
                  conv_stage_widths=(16, 32, 48, 64), n_classes=10)
p = convnet.init_convnet(cfg, torch.Generator().manual_seed(0), "cpu")
x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype("f4")
space = sn.enumerate_space(cfg)
calibrate.calibrate_convnet(p, cfg, [x], space[:2])
for sub in space[:2]:
    y = convnet.convnet_forward(p, cfg, x, convnet.make_conv_control(cfg, sub))
    assert y.shape == (2, 10) and bool(torch.isfinite(y).all())
assert calibrate.norm_table_bytes(p) > 0 and calibrate.shared_weight_bytes(p) > 0
for name in ("musicgen-medium", "qwen2-vl-7b"):
    cfg = get_config(name).reduced()
    p = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    ctrl = sn.make_control(cfg, sn.max_subnet(cfg))
    y = lm.forward(p, cfg, {{"embeds": torch.ones(1, 4, cfg.d_model)}}, ctrl,
                   slice_mode="switch")
    assert y.shape == (1, 4, cfg.vocab_size) and bool(torch.isfinite(y).all())
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    for i in range(2):
        y, cache = lm.decode_step(p, cfg, [[i + 1]], ctrl, cache, i)
        assert bool(torch.isfinite(y).all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_distribution_modules_import_without_jax_or_repro():
    """The int8 and distribution slice's modules (quantization, the
    sharding plan and its DTensor helpers, the collectives, elastic
    reshard, the mesh, specs and dry-run launchers, the roofline and the
    int8 all-reduce) import under the blocker, and there a reduced
    qwen2-1.5b is quantized and one decode step with int8 weights is
    traced on a fake 8-rank mesh; ``chip_smoke.py`` has phase 15."""
    child = _CHILD.split("import repro_torch")[0] + r"""
import importlib.util
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import (collectives, elastic, placement,
                                     sharding)
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import lm
from repro_torch.roofline import aggregate, comm, hw, report
from repro_torch.serving import quantize
from repro_torch.training import compress
cfg = get_config("qwen2-1.5b").reduced()
q, sc = quantize.quantize_tree(lm.init_model(cfg, device="cpu"))
assert quantize.quantized_bytes(q) > 0
dryrun.ensure_fake_group(8)
rec = dryrun.trace_cell(cfg, ShapeSpec("mini", "decode", 64, 8),
                        mesh.make_mesh((4, 2), ("data", "model")),
                        int8_weights=True)
assert rec["status"] == "ok" and rec["t_memory"] > 0
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.phase_dist) and callable(smoke.nccl_world1)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", child.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_no_source_names_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "flash_bench.py",
              ROOT / "tools" / "decode_bench.py", ROOT / "tools" / "norm_bench.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & set(BLOCKED), (path, roots)
