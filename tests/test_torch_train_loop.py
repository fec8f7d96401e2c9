"""The port's training loop on the CPU (``repro_torch.training``'s
optimizer, checkpoints and trainer, and ``launch.train``), against the JAX
package where it has a counterpart:

* ``optimizer.apply`` on JAX's gradients (two steps: parameters and both
  moments, within 1e-6) and ``schedule`` at 0, in the warmup and at the
  end;
* the mirror of ``test_sandwich_training_converges``: 50 sandwich steps
  drop the loss by more than 1.0;
* checkpoints: the same files, manifest and bytes as
  ``repro.training.checkpoint.save`` for the converted fp32 and bf16
  trees; the reference's checkpoint, bf16 included, restored bit for bit
  (the reference's own restore raises on bf16); corruption detected,
  ``.tmp`` ignored, ``prune`` keeping the newest;
* the mirror of ``test_trainer_crash_restart``, and the resumed run bit
  for bit equal to the uninterrupted one;
* ``launch.train.main`` on the CPU (3 steps, then a resume), and its
  refusals (``--size reduced`` on the card, a run past the device's
  memory).
"""
import contextlib
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.models import lm as jlm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.core import subnet as tsn
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import supernet as tsup
from repro_torch.training.trainer import Trainer, TrainerConfig
from test_torch_lm import port_cfg, port_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    parallel test workers each extra thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def test_schedule_matches_jax():
    c = jopt.AdamWConfig(lr=0.5, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    tc = topt.AdamWConfig(lr=0.5, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    for step in (0, 3, 10, 37, 100, 140):
        assert float(topt.schedule(tc, step)) == pytest.approx(
            float(jopt.schedule(c, step)), abs=1e-7), step
    assert float(topt.schedule(tc, torch.tensor(100, dtype=torch.int32))) \
        == pytest.approx(0.05, abs=1e-6)


def test_adamw_apply_matches_jax():
    """Two updates from JAX's gradients of tiny_dense's max and min
    subnets: the new parameters, both moments, the step, the clipped
    norm and the learning rate within 1e-6."""
    jcfg, ocfg = tiny_dense(), dict(lr=1e-2, warmup_steps=1, total_steps=10,
                                    grad_clip=0.5)
    cfg = port_cfg(jcfg)
    toks = np.random.default_rng(3).integers(0, 128, (4, 13))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    grad = jax.jit(jax.grad(lambda p, c: jlm.loss_fn(p, jcfg, batch, c)))
    japply = jax.jit(functools.partial(jopt.apply, jopt.AdamWConfig(**ocfg)))
    jp = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    js = jopt.init(jp)
    tp = port_params(jp)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    ts = topt.init(tp)
    for sub in (tsn.max_subnet(cfg), tsn.min_subnet(cfg)):
        g = grad(jp, {k: jnp.asarray(v)
                      for k, v in tsn.make_control(cfg, sub).items()})
        jp, js, jm = japply(jp, g, js)
        tp, ts, tm = topt.apply(topt.AdamWConfig(**ocfg), tp,
                                port_params(g), ts)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert all(p.requires_grad for p in tree_leaves(tp))
    for name, got, want in (("params", tp, jp), ("m", ts["m"], js["m"]),
                            ("v", ts["v"], js["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_sandwich_training_converges():
    """The mirror of tests/test_training.py's: 50 steps of sandwich
    training on the order-1 task drop the loss by more than 1.0, and the
    max and min subnets stay usable."""
    cfg = port_cfg(tiny_dense())
    task = tdata.SyntheticTask(vocab_size=128, seq_len=32, global_batch=8,
                               seed=0, order=1, noise=0.0)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    state = topt.init(params)
    step = tsup.make_train_step(
        cfg, topt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100),
        n_random=1)
    losses = []
    for i in range(50):
        params, state, m = step(params, state, task.batch(i),
                                torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0
    with torch.no_grad():
        for sub in (tsn.max_subnet(cfg), tsn.min_subnet(cfg)):
            loss = tlm.loss_fn(params, cfg, task.batch(999),
                               tsn.make_control(cfg, sub))
            assert torch.isfinite(loss)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _trees(dtype):
    jcfg = tiny_dense()
    jp = jlm.init_model(jax.random.PRNGKey(1), jcfg, dtype=dtype)
    jtree = {"params": jp, "opt": jopt.init(jp)}
    return jtree, port_params(jtree)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_bytes_equal_the_reference(tmp_path, dtype):
    jtree, ttree = _trees(dtype)
    jckpt.save(str(tmp_path / "jax"), 5, jtree, extra={"step": 5})
    tckpt.save(str(tmp_path / "port"), 5, ttree, extra={"step": 5})
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(got) == len(jax.tree.leaves(jtree)) + 2
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_reads_the_reference_checkpoint(tmp_path, dtype):
    jtree, ttree = _trees(dtype)
    jckpt.save(str(tmp_path), 7, jtree, extra={"step": 7})
    template = tree_map(torch.zeros_like, ttree)
    got, extra = tckpt.restore(str(tmp_path), template)
    assert extra == {"step": 7}
    dtypes = set()
    for g, w in zip(tree_leaves(got), tree_leaves(ttree)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w)
        dtypes.add(g.dtype)
    assert (torch.bfloat16 in dtypes) == (dtype == "bfloat16")


def test_checkpoint_atomicity_corruption_and_prune(tmp_path):
    _, tree = _trees("bfloat16")
    d = str(tmp_path)
    path = tckpt.save(d, 5, tree, extra={"step": 5})
    # a stray .tmp dir (killed mid-write) is not a checkpoint
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert tckpt.latest_step(d) == 5
    restored, _ = tckpt.restore(d, tree)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(restored), tree_leaves(tree)))
    # placements without the mesh they lie on are refused (restore onto
    # shardings itself: tests/test_torch_dist.py)
    with pytest.raises(ValueError, match="mesh"):
        tckpt.restore(d, tree, shardings={})
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(128)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(d, tree)
    for s in (6, 7, 8):
        tckpt.save(d, s, {"x": torch.ones(2)})
    tckpt.prune(d, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000007", "step_00000008", "step_00000009.tmp"]
    assert tckpt.latest_step(d) == 8


# --------------------------------------------------------------------------
# the trainer and the launcher
# --------------------------------------------------------------------------


def test_trainer_crash_restart_resumes_bit_for_bit(tmp_path):
    cfg = port_cfg(tiny_dense())
    task = tdata.SyntheticTask(vocab_size=128, seq_len=32, global_batch=8,
                               seed=0, order=1, noise=0.02)
    ocfg = topt.AdamWConfig(lr=1e-2)

    def trainer(d):
        return Trainer(cfg, ocfg, TrainerConfig(
            total_steps=15, ckpt_every=5, ckpt_dir=str(d)), task,
            n_random=1, device="cpu")

    tr = trainer(tmp_path / "a")
    st = tr.resume_or_init(0)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(st, crash_at=8)
    st2 = tr.resume_or_init(0)
    assert st2.step == 5                       # latest complete checkpoint
    assert all(p.requires_grad for p in tree_leaves(st2.params))
    st2 = tr.run(st2)
    assert st2.step == 15
    ref = trainer(tmp_path / "b")
    st_ref = ref.run(ref.resume_or_init(0))
    assert st2.losses == st_ref.losses[5:]
    for a, b in zip(tree_leaves({"p": st2.params, "o": st2.opt_state}),
                    tree_leaves({"p": st_ref.params,
                                 "o": st_ref.opt_state})):
        assert torch.equal(a, b)


def test_launch_train_runs_and_resumes_on_cpu(tmp_path):
    argv = ["--device", "cpu", "--steps", "3", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        st = tlaunch.main(argv)
    assert st.step == 3 and len(st.losses) == 3
    assert out.getvalue().startswith("done: step 3, loss ")
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(argv[:2] + ["--steps", "4"] + argv[4:])
    lines = out.getvalue().splitlines()
    assert lines[0] == "resumed from checkpoint at step 3"
    assert lines[1].startswith("done: step 4, loss ")


def test_launch_train_refusals():
    with pytest.raises(ValueError, match="reduced"):
        tlaunch.main(["--device", "cuda", "--size", "reduced"])
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--reduced", "--size", "full"])
    assert tlaunch.parse_args(["--reduced"]).size == "reduced"
    full = tlaunch.serving_config("qwen2-1.5b", "cpu", "full")
    need = tlaunch.training_bytes(full)
    assert 18.0e9 < need < 19.0e9
    with pytest.raises(MemoryError, match="gradients and fp32 moments"):
        tlaunch.check_fits(full, 16e9, need,
                           "bfloat16 weights, gradients and fp32 moments")
