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
             "xlstm-125m", "ofa_resnet"):
    get_config(name)
mods = ("qwen2p5_14b", "stablelm_3b", "h2o_danube_3_4b", "mixtral_8x7b",
        "llama4_maverick_400b_a17b", "zamba2_2p7b", "xlstm_125m",
        "ofa_resnet")
assert all(f"repro_torch.configs.{{m}}" in sys.modules for m in mods)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(list_configs()))
"""


def test_config_modules_import_without_jax_or_repro():
    """The configs beside qwen2-1.5b (three dense, two MoE, two of the SSM
    family, and the paper's OFA-ResNet, which the sim path profiles) load
    under the same blocker, each from its own module of the port."""
    proc = subprocess.run(
        [sys.executable, "-c", _CONFIGS_CHILD.format(blocked=BLOCKED)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) == 9


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
