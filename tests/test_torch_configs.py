"""The port's dense configurations beside qwen2-1.5b: qwen2.5-14b,
stablelm-3b and h2o-danube-3-4b (the MoE ones: ``test_torch_configs_moe``,
which takes its twins and test bodies from here).

* The port's copies of the configs equal ``repro.configs`` field by field.
* Tiny twins of each family at the head dims the attention kernels are
  built for run forward, prefill and decode steps against
  ``repro.models.lm`` for every subnet, in both WeightSlice modes, with
  the weights of ``lm.init_model`` copied across through numpy (fp32,
  2e-3): stablelm-3b's at head_dim 80 (MHA, layernorm, 25% rotary),
  h2o-danube-3-4b's at 120 (G = 4, a sliding window the decode steps run
  past) and qwen2.5-14b's at 128 (G = 5, QKV bias). Each config's own
  ``reduced()`` runs forward for every subnet.
* ``lm.from_jax_params`` converts each of those trees.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tiny_dense
from repro.configs import get_config as jget_config
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_configs
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm
from test_torch_lm import port_cfg, port_params

TOL = dict(rtol=2e-3, atol=2e-3)
NAMES = ("qwen2.5-14b", "stablelm-3b", "h2o-danube-3-4b")
MOE_NAMES = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
TWINS = {
    # stablelm-3b: MHA, layernorm with its beta table, 25% rotary
    "stablelm-h80": lambda: tiny_dense(n_heads=4, n_kv_heads=4, head_dim=80,
                                       norm="layernorm", rotary_pct=0.25),
    # h2o-danube-3-4b: G = 4 and a sliding window
    "danube-h120": lambda: tiny_dense(n_heads=8, n_kv_heads=2, head_dim=120,
                                      sliding_window=8),
    # qwen2.5-14b: G = 5 and QKV bias
    "qwen14b-h128": lambda: tiny_dense(n_heads=10, n_kv_heads=2,
                                       head_dim=128, qkv_bias=True),
}
MOE_TWINS = {
    # the MoE family: capacity dispatch, elastic top-k, a shared expert
    # (mixtral's with a window of 8 slots, which the decode steps wrap)
    "mixtral-moe512": lambda: jget_config("mixtral-8x7b").reduced().replace(
        moe_d_ff=512, sliding_window=8),
    "llama4-moe512": lambda: jget_config(
        "llama4-maverick-400b-a17b").reduced().replace(moe_d_ff=512),
}
ALL_TWINS = {**TWINS, **MOE_TWINS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the twins' many small ops: under the
    parallel test workers each extra thread only adds contention."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DECODE_STEPS = 12        # past the danube twin's window of 8 slots


@pytest.mark.parametrize("name", NAMES + ("qwen2-1.5b",)
                         + ("zamba2-2.7b", "xlstm-125m"))
def test_port_config_equals_jax_config(name):
    check_config_equals_jax(name)


def check_config_equals_jax(name):
    """The port's copy has every field of ``repro``'s, equal (a drift
    test), and the registry lists it."""
    want, got = jget_config(name), tget_config(name)
    assert name in list_configs()
    assert [f.name for f in dataclasses.fields(got)] \
        == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.reduced() == port_cfg(want.reduced())


def test_config_shapes_reach_the_kernels():
    """The head dims, groups and switch-mode widths the kernels are built
    and tested for: 80 under MHA, 120 with G = 4 and a 4096 window, 128
    with G = 5; the wo segments of switch mode are 2560 (one, MHA), 480
    and 640, and the FFN widths are multiples of 8."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as tattn
    want = {"qwen2.5-14b": (128, 5, 0, 640), "stablelm-3b": (80, 1, 0, 2560),
            "h2o-danube-3-4b": (120, 4, 4096, 480)}
    for name, (hd, G, window, seg) in want.items():
        cfg = tget_config(name)
        assert cfg.resolved_head_dim == hd and hd in fa.HEAD_DIMS \
            and hd in da.HEAD_DIMS
        assert tsn.head_group_size(cfg) == G and cfg.sliding_window == window
        assert cfg.n_heads * hd // tattn.wo_segments(cfg) == seg
        for sub in tsn.enumerate_space(cfg):
            ctrl = tsn.make_control(cfg, sub)
            assert int(ctrl["ffn_width"]) % 8 == 0
            wid = tattn.with_wo_width(cfg, ctrl)[tattn.WO_WIDTH]
            assert 0 < wid <= seg and wid % hd == 0


@functools.lru_cache(maxsize=None)
def _build(name):
    if name in ALL_TWINS:
        jcfg = ALL_TWINS[name]()
    else:
        jcfg = jget_config(name[:-len("-reduced")]).reduced()
    jparams = jlm.init_model(jax.random.PRNGKey(3), jcfg)
    return name, jcfg, port_cfg(jcfg), jparams, port_params(jparams)


@pytest.fixture(scope="module",
                params=list(TWINS) + [f"{n}-reduced" for n in NAMES])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module", params=list(TWINS))
def twin(request):
    return _build(request.param)


def _subnets(jcfg, tcfg):
    js, ts = jsn.enumerate_space(jcfg), tsn.enumerate_space(tcfg)
    assert [s.key() for s in js] == [s.key() for s in ts]
    return list(zip(js, ts))


def test_from_jax_params_converts_each_tree(model):
    """Every leaf of the JAX tree lands at the same path with the same
    shape and values, the layernorm beta tables and QKV biases included."""
    _, jcfg, _, jparams, tparams = model
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    n = 0
    for path, leaf in leaves:
        t = tparams
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        n += 1
    attn = tparams["backbone"]["stages"][0]["0:attn"]
    assert ("norm_beta" in attn) == (jcfg.norm == "layernorm")
    assert ("bq" in attn) == jcfg.qkv_bias
    assert n == len(leaves)


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
def test_forward_and_prefill_match_jax_for_every_subnet(model, slice_mode):
    name, jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(20).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    fwd = jax.jit(lambda p, t, c: jlm.forward(p, jcfg, {"tokens": t}, c,
                                              slice_mode=slice_mode))
    pre = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, {"tokens": t}, c,
                                              slice_mode=slice_mode))
    for jsub, tsub in _subnets(jcfg, tcfg):
        jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
        got = tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(fwd(jparams, toks, jctrl)),
                                   **TOL, err_msg=f"{name} forward {tsub}")
        if name in ALL_TWINS:
            got = tlm.prefill(tparams, tcfg, {"tokens": toks}, tctrl,
                              slice_mode=slice_mode)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(pre(jparams, toks, jctrl)),
                                       **TOL, err_msg=f"{name} prefill {tsub}")


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
def test_decode_steps_match_jax_for_every_subnet(twin, slice_mode):
    """DECODE_STEPS decode steps of every subnet of each twin (the danube
    twin's rolling cache of 8 slots wraps after the eighth)."""
    name, jcfg, tcfg, jparams, tparams = twin
    toks = np.random.default_rng(21).integers(
        0, jcfg.vocab_size, (2, DECODE_STEPS)).astype(np.int32)
    step = jlm.cached_decode_step(jcfg, slice_mode)
    for jsub, tsub in _subnets(jcfg, tcfg):
        jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
        jcache = jlm.init_cache(jcfg, 2, 16)
        tcache = tlm.init_cache(tcfg, 2, 16, device="cpu")
        for i in range(DECODE_STEPS):
            want, jcache = step(jparams, jnp.asarray(toks[:, i:i + 1]), jctrl,
                                jcache, jnp.int32(i))
            got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1],
                                          tctrl, tcache, i,
                                          slice_mode=slice_mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{name} {tsub} step {i}")
    if jcfg.sliding_window:
        slots = tcache["stages"][0]["0:attn"]["k"].shape[3]
        assert slots == jcfg.sliding_window < DECODE_STEPS
