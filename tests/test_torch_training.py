"""The port's training slice (``lm.loss_fn``, ``core.subnet.sample_control``,
``training.supernet``) against the JAX package on the same
numpy inputs, with the weights of ``lm.init_model`` copied across through
numpy (fp32: 2e-3 of each leaf's largest value):

* ``control_from_indices`` equals ``sample_control_jax`` field by field
  for 64 keys of four configs (each JAX ``subnet_id`` decoded into its
  indices); every port sample lies in ``enumerate_space``, and a seeded
  generator repeats;
* ``loss_fn`` and every leaf's gradient against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` for ``tiny_dense`` at
  the max and min subnets in both WeightSlice modes, with and without
  ``remat``, and with a ``loss_mask`` (the other families:
  ``tests/test_torch_train_families.py``);
* ``sandwich_loss`` with ``n_random=0`` and, the port's sampler patched to
  JAX's sample for the key, ``n_random=1``;
* microbatched gradients against the full batch's and JAX's halves.

AdamW, the loop, checkpoints and the launcher:
``tests/test_torch_train_loop.py``.
JAX's ``value_and_grad`` is jitted once per WeightSlice mode.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.configs import get_config as jget_config
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro.training import supernet as jsup
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_leaves
from repro_torch.training import supernet as tsup
from test_torch_lm import port_cfg, port_params

TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    parallel test workers each extra thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what, tol=TOL):
    """Leaf for leaf: |got - want| <= tol * (|want| + max |want|)."""
    got = [np.asarray(g.detach().float()) if isinstance(g, torch.Tensor)
           else np.asarray(g, np.float32) for g in got]
    want = [np.asarray(w, np.float32) for w in want]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what}: leaf {i}")


def _batch(vocab, B=4, S=12, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


class Model:
    """A JAX config and its weights, the port's twin, and JAX's
    ``value_and_grad`` of ``loss_fn`` jitted once per mode."""

    def __init__(self, jcfg):
        self.jcfg, self.tcfg = jcfg, port_cfg(jcfg)
        self.jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
        self._jit = {}

    def tparams(self):
        p = port_params(self.jparams)
        for leaf in tree_leaves(p):
            leaf.requires_grad_()
        return p

    def jax_loss_and_grads(self, batch, ctrl, mode):
        """(loss, gradient tree as numpy) of JAX's ``loss_fn``."""
        fn = self._jit.get(mode)
        if fn is None:
            fn = jax.jit(jax.value_and_grad(functools.partial(
                self._loss, mode=mode)))
            self._jit[mode] = fn
        jctrl = {k: jnp.asarray(v) for k, v in ctrl.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = fn(self.jparams, jb, jctrl)
        return float(loss), _np_tree(grads)

    def _loss(self, params, batch, ctrl, mode):
        return jlm.loss_fn(params, self.jcfg, batch, ctrl, slice_mode=mode)


@pytest.fixture(scope="module")
def tiny():
    return Model(tiny_dense())


def _port_loss_and_grads(m, params, batch, ctrl, **kw):
    loss = tlm.loss_fn(params, m.tcfg, batch, ctrl, **kw)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(leaves, grads)]


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

SAMPLE_CFGS = {"tiny_dense": tiny_dense,
               "qwen2-1.5b": lambda: jget_config("qwen2-1.5b"),
               "mixtral-8x7b": lambda: jget_config("mixtral-8x7b"),
               "xlstm-125m": lambda: jget_config("xlstm-125m")}


@pytest.mark.parametrize("name", list(SAMPLE_CFGS))
def test_control_from_indices_matches_sample_control_jax(name):
    jcfg = SAMPLE_CFGS[name]()
    tcfg = port_cfg(jcfg)
    n_d, n_f, n_h, n_k = tsn.option_counts(tcfg)
    draw = jax.jit(lambda key: jsn.sample_control_jax(jcfg, key))
    seen = set()
    for i in range(64):
        want = {k: np.asarray(v) for k, v in
                draw(jax.random.PRNGKey(i)).items()}
        sid = int(want["subnet_id"])
        ki, sid_ = sid % n_k, sid // n_k
        hi, sid_ = sid_ % n_h, sid_ // n_h
        fi, di = sid_ % n_f, sid_ // n_f
        seen.add(sid)
        got = tsn.control_from_indices(tcfg, di, fi, hi, ki)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(seen) > 1


def test_sample_control_lies_in_the_space_and_repeats():
    cfg = port_cfg(jget_config("qwen2-1.5b"))
    space = tsn.enumerate_space(cfg)
    e = cfg.elastic
    a, b = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    ids = []
    for _ in range(32):
        c = tsn.sample_control(cfg, a)
        assert all(np.array_equal(c[k], v)
                   for k, v in tsn.sample_control(cfg, b).items())
        sub = space[int(c["subnet_id"])]
        assert sub.ffn_frac == sorted(e.ffn_fracs)[int(c["ffn_bucket"])]
        assert sub.head_frac == sorted(e.head_fracs)[int(c["head_bucket"])]
        assert c["layer_gate"].sum() == np.ceil(28 * sub.depth_frac)
        ids.append(int(c["subnet_id"]))
    assert len(set(ids)) > 4


# --------------------------------------------------------------------------
# loss and gradients against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["mask", "switch"])
@pytest.mark.parametrize("which", ["max", "min"])
def test_loss_and_grads_match_jax_tiny_dense(tiny, which, mode, remat):
    sub = (tsn.max_subnet if which == "max" else tsn.min_subnet)(tiny.tcfg)
    ctrl = tsn.make_control(tiny.tcfg, sub)
    batch = _batch(128)
    want_loss, want = tiny.jax_loss_and_grads(batch, ctrl, mode)
    loss, got = _port_loss_and_grads(tiny, tiny.tparams(), batch, ctrl,
                                     slice_mode=mode, remat=remat)
    assert loss == pytest.approx(want_loss, rel=TOL)
    _close(got, jax.tree.leaves(want), f"{which}/{mode}/remat={remat}")


def test_loss_mask_matches_jax(tiny):
    ctrl = tsn.make_control(tiny.tcfg, tsn.enumerate_space(tiny.tcfg)[7])
    batch = _batch(128)
    batch["loss_mask"] = (np.arange(12)[None] % 3 != 0).astype(
        np.float32).repeat(4, 0)
    want_loss, want = tiny.jax_loss_and_grads(batch, ctrl, "mask")
    loss, got = _port_loss_and_grads(tiny, tiny.tparams(), batch, ctrl)
    assert loss == pytest.approx(want_loss, rel=TOL)
    _close(got, jax.tree.leaves(want), "loss_mask")


@pytest.mark.parametrize("n_random", [0, 1])
def test_sandwich_loss_matches_jax(tiny, monkeypatch, n_random):
    batch = _batch(128)
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: jsup.sandwich_loss(p, tiny.jcfg, b, key,
                                        n_random=n_random)))(
        tiny.jparams, jb)
    if n_random:
        sample = {k: np.asarray(v) for k, v in jsn.sample_control_jax(
            tiny.jcfg, jax.random.split(key, 1)[0]).items()}
        monkeypatch.setattr(tsn, "sample_control", lambda cfg, gen: sample)
    params = tiny.tparams()
    loss, grads = tsup.loss_and_grads(params, tiny.tcfg, batch,
                                      torch.Generator().manual_seed(0),
                                      n_random=n_random)
    assert float(loss) == pytest.approx(float(want_loss), rel=TOL)
    _close(tree_leaves(grads), jax.tree.leaves(_np_tree(want)),
           f"sandwich n_random={n_random}")


# --------------------------------------------------------------------------
# microbatches, convergence
# --------------------------------------------------------------------------


def test_microbatch_grads_match_full_batch_and_jax(tiny):
    batch = _batch(128, B=8)
    kw = dict(n_random=1)
    params = tiny.tparams()
    full_loss, full = tsup.loss_and_grads(
        params, tiny.tcfg, batch, torch.Generator().manual_seed(4), **kw)
    mb_loss, mb = tsup.loss_and_grads(
        params, tiny.tcfg, batch, torch.Generator().manual_seed(4),
        microbatch=2, **kw)
    assert float(mb_loss) == pytest.approx(float(full_loss), rel=1e-5)
    for a, b in zip(tree_leaves(mb), tree_leaves(full)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # JAX: the mean over the two halves and the same three subnets
    ctrls = list(tsup.make_controls(tiny.tcfg))
    ctrls.append(tsn.sample_control(tiny.tcfg,
                                    torch.Generator().manual_seed(4)))
    grads = [tiny.jax_loss_and_grads(
        {k: v[i * 4:(i + 1) * 4] for k, v in batch.items()}, c, "mask")[1]
        for i in range(2) for c in ctrls]
    want = jax.tree.map(lambda *g: sum(g) / len(g), *grads)
    _close(tree_leaves(mb), jax.tree.leaves(want), "microbatch")
