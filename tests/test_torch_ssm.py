"""The port's Mamba2 family (``repro_torch.models.ssm`` and zamba2's shared
attention + MLP block in ``models.backbone``) against the JAX package on
the same numpy inputs, with the weights of ``lm.init_model`` copied across
through numpy (fp32, 2e-3):

* ``from_jax_params`` leaf by leaf (the shared block's subtrees, and the
  fp32 leaves of a bf16 tree), and ``param_bytes`` counting them;
* ``_causal_conv``, ``mamba_block`` (one chunk, and two chunks with the
  inter-chunk recurrence) and ``mamba_decode`` on seeded inputs, with
  per-subnet norm rows and non-trivial ``D``, ``dt_bias`` and gains;
* for zamba2's ``reduced()`` (2 units, the shared block every 2nd) and a
  4-unit twin (the shared block after units 1 and 3: at depth 0.5 it runs
  once and skips the second, at full depth the decode walk takes two cache
  slots): forward and prefill for every subnet in both WeightSlice modes,
  12 decode steps for every subnet in both modes, the port's own decode
  against its own forward, and the executor's padded prefill (B=3, S=12
  bucketed to 4 x 16) against JAX's unpadded forward;
* the bf16 walk of the 4-unit twin strays from its fp32 walk past 2e-2,
  as the reference's own does, and by as much.

Each model is built once per module, and each JAX step is jitted once per
(config, mode) with the control traced. The helpers are shared with
``tests/test_torch_xlstm.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import Stage as JStage
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.core import operators as tops
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
from test_torch_lm import port_cfg, port_params

TOL = dict(rtol=2e-3, atol=2e-3)
DECODE_STEPS = 12
MODES = ("mask", "switch")
CONFIGS = {
    "zamba2-reduced": lambda: jget_config("zamba2-2.7b").reduced(),
    # the shared block after units 1 and 3 (period 2)
    "zamba2-4units": lambda: jget_config("zamba2-2.7b").reduced().replace(
        stages=(JStage(("mamba",), repeat=4),)),
}


# --------------------------------------------------------------------------
# helpers shared with tests/test_torch_xlstm.py
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build(name, make):
    """(jcfg, tcfg, JAX params, port params) of ``make()``, once a name."""
    jcfg = make()
    jparams = jlm.init_model(jax.random.PRNGKey(3), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


@functools.lru_cache(maxsize=None)
def jax_forward(jcfg, slice_mode):
    """JAX's forward logits, jitted once per (config, mode), the control
    traced."""
    return jax.jit(lambda p, t, c: jlm.forward(p, jcfg, {"tokens": t}, c,
                                               slice_mode=slice_mode))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the many small ops: under the parallel
    test workers each extra thread only adds contention."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def subnets(jcfg, tcfg):
    """(JAX control, port control, descriptor) of every subnet."""
    js, ts = jsn.enumerate_space(jcfg), tsn.enumerate_space(tcfg)
    assert [s.key() for s in js] == [s.key() for s in ts]
    return [(jsn.make_control(jcfg, a), tsn.make_control(tcfg, b), b)
            for a, b in zip(js, ts)]


def tokens(jcfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, shape).astype(np.int32)


def leaf_paths(tree, path=()):
    """{path: leaf} of a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in leaf_paths(t, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in leaf_paths(t, path + (i,)).items()}
    return {path: tree}


def check_from_jax_params(jparams, tparams):
    """Every leaf of the JAX tree at the same path of the port's, with the
    same shape, dtype and values, and no other leaf."""
    flat = leaf_paths(tparams)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(jl)
    for path, leaf in jl:
        t = flat[tuple(getattr(p, "key", getattr(p, "idx", None))
                       for p in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def check_fp32_leaves_of_bf16_tree(jcfg, fp32_keys):
    """A bf16 JAX tree of ``jcfg`` converts leaf by leaf; the leaves named
    in ``fp32_keys`` (slot -> keys) are fp32 in both, the matrices bf16,
    and ``lm.param_bytes`` counts the tree's bytes."""
    jcfg16 = jcfg.replace(dtype="bfloat16")
    jparams = jlm.init_model(jax.random.PRNGKey(5), jcfg16)
    tparams = port_params(jparams)
    check_from_jax_params(jparams, tparams)
    stage = tparams["backbone"]["stages"][0]
    for slot, keys in fp32_keys.items():
        for key, leaf in stage[slot].items():
            want = torch.float32 if key in keys or "gamma" in key \
                else torch.bfloat16
            assert leaf.dtype == want, (slot, key, leaf.dtype)
    nbytes = sum(t.numel() * t.element_size()
                 for t in leaf_paths(tparams).values())
    assert tlm.param_bytes(port_cfg(jcfg16)) == nbytes


def jax_param_bytes(jcfg) -> int:
    """Bytes of JAX's ``lm.init_model`` tree for ``jcfg``, from its shapes
    alone (``jax.eval_shape`` allocates nothing)."""
    tree = jax.eval_shape(lambda k: jlm.init_model(k, jcfg),
                          jax.random.PRNGKey(0))
    return sum(a.size * a.dtype.itemsize
               for a in jax.tree_util.tree_leaves(tree))


def check_forward_and_prefill(model, slice_mode, toks):
    """Forward and prefill logits of every subnet against JAX's forward
    (JAX's prefill is its last position)."""
    jcfg, tcfg, jparams, tparams = model
    fwd = jax_forward(jcfg, slice_mode)
    for jctrl, tctrl, sub in subnets(jcfg, tcfg):
        want = np.asarray(fwd(jparams, toks, jctrl))
        got = tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"forward {sub}")
        got = tlm.prefill(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(), want[:, -1:], **TOL,
                                   err_msg=f"prefill {sub}")


def check_decode_steps(model, slice_mode, toks):
    """DECODE_STEPS teacher-forced decode steps of every subnet against
    JAX's. Returns the port's last cache of each subnet."""
    jcfg, tcfg, jparams, tparams = model
    step = jlm.cached_decode_step(jcfg, slice_mode)
    B = toks.shape[0]
    caches = []
    for jctrl, tctrl, sub in subnets(jcfg, tcfg):
        jcache = jlm.init_cache(jcfg, B, 16)
        tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
        for i in range(DECODE_STEPS):
            want, jcache = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                                jctrl, jcache, jnp.int32(i))
            got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1],
                                          tctrl, tcache, i,
                                          slice_mode=slice_mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{sub} step {i}")
        caches.append((sub, tcache))
    return caches


def check_own_decode_against_forward(model, slice_mode, toks):
    """The port's decode steps against the port's own forward at every
    position, for every subnet (no JAX)."""
    _, tcfg, _, tparams = model
    B, S = toks.shape
    for _, tctrl, sub in subnets(model[0], tcfg):
        full = tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                           slice_mode=slice_mode)
        cache = tlm.init_cache(tcfg, B, 16, device="cpu")
        for i in range(S):
            got, cache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1],
                                         tctrl, cache, i,
                                         slice_mode=slice_mode)
            np.testing.assert_allclose(got.numpy(), full[:, i:i + 1].numpy(),
                                       **TOL, err_msg=f"{sub} position {i}")


def check_executor_padded_prefill(model, slice_mode):
    """A ragged batch (3 rows of up to 12 tokens) through the executor,
    padded to the (4, 16) bucket, against JAX's forward of the unpadded
    (3, 12) batch at each row's last real position, for every subnet:
    the scans run forward in time, so the pad changes nothing before it."""
    jcfg, tcfg, jparams, tparams = model
    ex = SubnetExecutor(tparams, tcfg, exec_cfg=ExecutorConfig(
        batch_buckets=(4,), seq_buckets=(16,), slice_mode=slice_mode))
    toks = tokens(jcfg, (3, 12), seed=6)
    lengths = np.array([12, 7, 10])
    fwd = jax_forward(jcfg, slice_mode)
    for idx, point in enumerate(ex.points):
        jctrl = jsn.make_control(jcfg, next(
            s for s in jsn.enumerate_space(jcfg)
            if s.key() == point.sub.key()))
        want = np.asarray(fwd(jparams, toks, jctrl))[np.arange(3),
                                                     lengths - 1]
        got = ex.prefill(idx, toks, lengths=lengths)
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"subnet {point.sub}")
    assert ex.cache_keys() == [("prefill", 4, 16, "torch")]


def bf16_drift(jcfg):
    """How far the bf16 walk of ``jcfg``'s largest subnet strays from the
    fp32 walk on the same weights (a bf16 tree, upcast), in max |fp32
    logit|: (JAX's, the port's on the CPU)."""
    jcfg16 = jcfg.replace(dtype="bfloat16")
    jp16 = jlm.init_model(jax.random.PRNGKey(0), jcfg16)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = tokens(jcfg, (2, 16), seed=3)
    jctrl, tctrl, _ = subnets(jcfg, port_cfg(jcfg))[-1]
    out = []
    for fwd in (lambda p, c, ctrl: np.asarray(jlm.forward(
                    p, c, {"tokens": toks}, ctrl), np.float32),
                lambda p, c, ctrl: tlm.forward(
                    port_params(p), port_cfg(c), {"tokens": toks},
                    tctrl).float().numpy()):
        lo = fwd(jp16, jcfg16, jctrl)
        hi = fwd(jp32, jcfg16.replace(dtype="float32"), jctrl)
        out.append(float(np.abs(lo - hi).max() / np.abs(hi).max()))
    return tuple(out)


def check_bf16_drift(jcfg):
    """The reference's own bf16 walk strays past the bf16 tolerance of
    2e-2 from its fp32 walk (these random-weight blocks amplify rounding),
    and the port's bf16 walk strays as far, within a factor of 2: what
    the card's end-to-end checks of the SSM family can hold to."""
    jax_err, port_err = bf16_drift(jcfg)
    assert jax_err > 2e-2, jax_err
    assert 0.5 * jax_err <= port_err <= 2 * jax_err, (jax_err, port_err)


def block_params(jp, seed):
    """A JAX block's numpy leaves with every per-subnet norm table given
    distinct rows (so that ``subnet_id`` matters) and the fp32 vectors
    moved off their init values; (JAX tree, port tree)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jp.items():
        v = np.asarray(v)
        if k in ("D", "dt_bias", "conv_b", "gated_norm", "head_norm") \
                or k.endswith("gamma"):
            v = (v + rng.uniform(-0.5, 0.5, v.shape)).astype(v.dtype)
        out[k] = v
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v.copy()) for k, v in out.items()})


def block_ctrls(jcfg, tcfg):
    """(JAX control, port control on the CPU) of every subnet, without the
    layer gates (a block does not read them)."""
    return [({k: v for k, v in jc.items() if k != "layer_gate"},
             tops.device_control(tc, "cpu"))
            for jc, tc, _ in subnets(jcfg, tcfg)]


def x_input(jcfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# zamba2
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    return build(request.param, CONFIGS[request.param])


def test_from_jax_params_converts_leaf_by_leaf(model):
    """Every leaf lands at its path with its shape, dtype and values; the
    shared block's ``shared_attn`` and ``shared_mlp`` subtrees with it."""
    jcfg, tcfg, jparams, tparams = model
    check_from_jax_params(jparams, tparams)
    assert set(tparams["backbone"]) == {"stages", "shared_attn",
                                        "shared_mlp"}
    assert tparams["backbone"]["shared_attn"]["wq"].shape \
        == (jcfg.d_model, jcfg.n_heads * jcfg.resolved_head_dim)


def test_bf16_tree_keeps_fp32_leaves_and_param_bytes_counts_them():
    """In a bf16 tree ``A_log``, ``D``, ``dt_bias`` and ``gated_norm`` stay
    fp32 (and the norm tables); ``param_bytes`` counts the shared block,
    in the reduced config and at full size (the bytes of JAX's tree, about
    4.7 GB of bf16)."""
    jcfg = CONFIGS["zamba2-reduced"]()
    check_fp32_leaves_of_bf16_tree(
        jcfg, {"0:mamba": ("A_log", "D", "dt_bias", "gated_norm")})
    full = port_cfg(jget_config("zamba2-2.7b"))
    shared = (4 * 2560 * 2560 + 3 * 2560 * 10240) * 2
    no_shared = full.replace(shared_attn_period=0)
    assert tlm.param_bytes(full) - tlm.param_bytes(no_shared) \
        == shared + 2 * 18 * 2560 * 4
    assert tlm.param_bytes(full) == jax_param_bytes(jget_config("zamba2-2.7b"))
    assert 4.5e9 < tlm.param_bytes(full) < 5.0e9


def test_causal_conv_matches_jax():
    jcfg = CONFIGS["zamba2-reduced"]()
    _, _, conv_ch = jssm._dims(jcfg)
    rng = np.random.default_rng(0)
    xBC = rng.standard_normal((2, 12, conv_ch)).astype(np.float32)
    w = rng.standard_normal((jcfg.ssm_conv_width, conv_ch)).astype(np.float32)
    b = rng.standard_normal((conv_ch,)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(*map(torch.from_numpy, (xBC, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _mamba_layer():
    jcfg = CONFIGS["zamba2-reduced"]()
    jp = jssm.init_mamba(jax.random.PRNGKey(1), jcfg, jnp.float32)
    return (jcfg, port_cfg(jcfg)) + block_params(jp, seed=2)


@pytest.mark.parametrize("S", [12, 40])
def test_mamba_block_matches_jax_for_every_subnet(S):
    """S = 12 is one chunk; S = 40 at the reduced chunk of 32 is two chunks
    of 20, through the inter-chunk recurrence. Each subnet's norm row."""
    jcfg, tcfg, jp, tp = _mamba_layer()
    nC = S // next(q for q in range(min(jcfg.ssm_chunk, S), 0, -1)
                   if S % q == 0)
    assert nC == (1 if S == 12 else 2)
    x = x_input(jcfg, 2, S, seed=S)
    fn = jax.jit(lambda p, x, c: jssm.mamba_block(p, jcfg, x, c))
    for jc, tc in block_ctrls(jcfg, tcfg):
        want = fn(jp, jnp.asarray(x), jc)
        got = tssm.mamba_block(tp, tcfg, torch.from_numpy(x), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"subnet {int(tc['subnet_id'])}")


def test_mamba_decode_matches_jax_and_its_own_block():
    """12 decode steps of one layer: outputs and both cache leaves against
    JAX's, and the outputs against the port's own chunked block over the
    same 12 tokens."""
    jcfg, tcfg, jp, tp = _mamba_layer()
    x = x_input(jcfg, 2, DECODE_STEPS, seed=7)
    jc, tc = block_ctrls(jcfg, tcfg)[-1]
    fn = jax.jit(lambda p, x, c, cache: jssm.mamba_decode(p, jcfg, x, c,
                                                          cache, 0))
    jcache = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    tcache = tssm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for i in range(DECODE_STEPS):
        want, jcache = fn(jp, jnp.asarray(x[:, i:i + 1]), jc, jcache)
        got, tcache = tssm.mamba_decode(tp, tcfg, torch.from_numpy(
            x[:, i:i + 1]), tc, tcache, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL,
                                       err_msg=f"step {i} {key}")
        outs.append(got)
    full = tssm.mamba_block(tp, tcfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


@pytest.mark.parametrize("slice_mode", MODES)
def test_forward_and_prefill_match_jax_for_every_subnet(model, slice_mode):
    check_forward_and_prefill(model, slice_mode,
                              tokens(model[0], (3, 12), seed=6))


@pytest.mark.parametrize("slice_mode", MODES)
def test_decode_steps_match_jax_for_every_subnet(model, slice_mode):
    """DECODE_STEPS steps of every subnet; then the shared block's cache:
    one slot per invocation that ran (the 4-unit twin at depth 0.5 runs
    the block after unit 1 and skips unit 3, so its second slot stays
    empty), none past the slots JAX allots."""
    jcfg = model[0]
    caches = check_decode_steps(model, slice_mode,
                                tokens(jcfg, (2, DECODE_STEPS), seed=21))
    period = jcfg.shared_attn_period
    units = jcfg.stages[0].repeat
    for sub, cache in caches:
        k = cache["shared_attn"]["k"]
        assert k.shape[0] == max(1, units // period)
        active = int(np.ceil(units * sub.depth_frac))
        ran = active // period
        written = [bool(k[n].abs().sum() > 0) for n in range(k.shape[0])]
        assert written == [n < ran for n in range(k.shape[0])], (sub, written)


@pytest.mark.parametrize("slice_mode", MODES)
def test_own_decode_matches_own_forward(model, slice_mode):
    check_own_decode_against_forward(
        model, slice_mode, tokens(model[0], (2, DECODE_STEPS), seed=22))


def test_bf16_walk_strays_from_fp32_as_jax_does():
    check_bf16_drift(CONFIGS["zamba2-4units"]())


@pytest.mark.parametrize("slice_mode", MODES)
def test_executor_padded_prefill_matches_unpadded_jax(slice_mode):
    check_executor_padded_prefill(build("zamba2-reduced",
                                        CONFIGS["zamba2-reduced"]),
                                  slice_mode)
