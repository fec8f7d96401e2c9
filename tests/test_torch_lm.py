"""The PyTorch port's dense LM against repro.models.lm, with the weights of
``lm.init_model(PRNGKey(0), cfg)`` copied across through numpy
(``repro_torch.models.lm.from_jax_params``): forward logits for every
subnet, a 16-token greedy ``generate`` and 8 ``decode_step`` logits, for
``tiny_dense`` and ``qwen2-1.5b``'s reduced config, plus a sliding-window
and a layernorm / partial-rotary variant of ``tiny_dense`` (fp32, 2e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.configs import get_config
from repro.core import subnet as jsn
from repro.models import lm as jlm
from repro_torch.configs import base as pbase
from repro_torch.core import subnet as tsn
from repro_torch.models import lm as tlm

TOL = dict(rtol=2e-3, atol=2e-3)
CFGS = {"tiny_dense": tiny_dense,
        "qwen2-1.5b-reduced": lambda: get_config("qwen2-1.5b").reduced(),
        # the rolling-buffer decode cache and the window mask
        "tiny_dense-window8": lambda: tiny_dense(sliding_window=8),
        # layernorm with its beta table, partial rotary, QKV bias
        "tiny_dense-layernorm-rot25": lambda: tiny_dense(
            norm="layernorm", rotary_pct=0.25, qkv_bias=True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the many small ops: under the parallel
    test workers each extra thread only adds contention."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    """The port's ArchConfig with the same fields as a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["stages"] = tuple(pbase.Stage(s.pattern, s.repeat) for s in jcfg.stages)
    kw["elastic"] = pbase.ElasticSpec(**dataclasses.asdict(jcfg.elastic))
    return pbase.ArchConfig(**kw)


def port_params(jparams):
    return tlm.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    jcfg = CFGS[request.param]()
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


def _subnets(jcfg, tcfg):
    js, ts = jsn.enumerate_space(jcfg), tsn.enumerate_space(tcfg)
    assert [s.key() for s in js] == [s.key() for s in ts]
    return list(zip(js, ts))


def test_from_jax_params_keeps_keys_and_shapes(model):
    _, _, jparams, tparams = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            flat[path] = t

    walk(tparams, ())
    assert len(flat) == len(jl)
    for path, leaf in jl:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        t = flat[key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_from_jax_params_bf16_leaves():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(jnp.bfloat16)
    t = tlm.from_jax_params({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_forward_matches_for_every_subnet(model):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    fwd = jax.jit(lambda p, t, c: jlm.forward(p, jcfg, {"tokens": t}, c))
    for jsub, tsub in _subnets(jcfg, tcfg):
        want = fwd(jparams, toks, jsn.make_control(jcfg, jsub))
        got = tlm.forward(tparams, tcfg, {"tokens": toks},
                          tsn.make_control(tcfg, tsub))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"subnet {tsub}")


def test_generate_16_tokens_matches(model):
    jcfg, tcfg, jparams, tparams = model
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    for jsub, tsub in (_subnets(jcfg, tcfg)[0], _subnets(jcfg, tcfg)[-1]):
        want = jlm.generate(jparams, jcfg, jnp.asarray(prompt),
                            jsn.make_control(jcfg, jsub), max_new=16,
                            seq_cap=32)
        got = tlm.generate(tparams, tcfg, prompt,
                           tsn.make_control(tcfg, tsub), max_new=16,
                           seq_cap=32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_logits_match(model):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    step = jlm.cached_decode_step(jcfg)
    jsub, tsub = _subnets(jcfg, tcfg)[-1]
    jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
    jcache = jlm.init_cache(jcfg, 2, 16)
    tcache = tlm.init_cache(tcfg, 2, 16, device="cpu")
    for i in range(8):
        want, jcache = step(jparams, jnp.asarray(toks[:, i:i + 1]), jctrl,
                            jcache, jnp.int32(i))
        got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1], tctrl,
                                      tcache, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")


def test_prefill_is_last_position_of_forward(model):
    _, tcfg, _, tparams = model
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    ctrl = tsn.make_control(tcfg, tsn.max_subnet(tcfg))
    full = tlm.forward(tparams, tcfg, {"tokens": toks}, ctrl)
    last = tlm.prefill(tparams, tcfg, {"tokens": toks}, ctrl)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_unported_families_raise():
    """The LM refuses a ``conv`` stage (the paper's OFA-ResNet supernet),
    naming ``models/convnet.py``, which runs it; the reference's LM has no
    conv path either. The ``embed`` frontend is an LM's and builds."""
    cfg = port_cfg(tiny_dense()).replace(
        stages=(pbase.Stage(("conv",), repeat=1),))
    with pytest.raises(NotImplementedError, match="models/convnet.py"):
        tlm.init_model(cfg, device="cpu")
    cfg = port_cfg(tiny_dense()).replace(frontend="embed")
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tuple(params["embed"].shape) == (cfg.vocab_size, cfg.d_model)


# --------------------------------------------------------------------------
# the pending residual: each block's add is made by the next block's norm
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_stage():
    """``tiny_dense`` as two stages of three (attn, mlp) units."""
    from repro.configs.base import Stage as JStage
    jcfg = tiny_dense(stages=(JStage(("attn", "mlp"), repeat=3),) * 2)
    jparams = jlm.init_model(jax.random.PRNGKey(2), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
def test_pending_residual_crosses_gated_units_and_stages(two_stage,
                                                         slice_mode,
                                                         monkeypatch):
    """At depth 1/3 only the first unit of each stage runs, so the delta
    left pending by the first stage's MLP crosses two gated-off units and
    the stage boundary before the second stage's attention norm adds it.
    Prefill, forward and 6 decode steps match JAX for every such subnet;
    a forward makes 3 fused norms (one per block after the first) and 2
    plain ones (the first block's and the final norm)."""
    from repro_torch.kernels import ops as kops
    jcfg, tcfg, jparams, tparams = two_stage
    toks = np.random.default_rng(14).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    fwd = jax.jit(lambda p, t, c: jlm.forward(p, jcfg, {"tokens": t}, c,
                                              slice_mode=slice_mode))
    pre = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, {"tokens": t}, c,
                                              slice_mode=slice_mode))
    step = jlm.cached_decode_step(jcfg, slice_mode)
    calls = {"fused": 0, "plain": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(kops, "model_add_subnet_rmsnorm",
                        spy("fused", kops.model_add_subnet_rmsnorm))
    monkeypatch.setattr(kops, "model_subnet_rmsnorm",
                        spy("plain", kops.model_subnet_rmsnorm))
    subs = [(j, t) for j, t in _subnets(jcfg, tcfg) if t.depth_frac < 0.5]
    assert len(subs) == 4
    for jsub, tsub in subs:
        jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
        assert tctrl["layer_gate"].tolist() == [True, False, False] * 2
        calls.update(fused=0, plain=0)
        got = tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode=slice_mode)
        assert calls == {"fused": 3, "plain": 2}
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(fwd(jparams, toks, jctrl)),
                                   **TOL, err_msg=f"forward {tsub}")
        got = tlm.prefill(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(pre(jparams, toks, jctrl)),
                                   **TOL, err_msg=f"prefill {tsub}")
        jcache = jlm.init_cache(jcfg, 2, 16)
        tcache = tlm.init_cache(tcfg, 2, 16, device="cpu")
        for i in range(6):
            want, jcache = step(jparams, jnp.asarray(toks[:, i:i + 1]), jctrl,
                                jcache, jnp.int32(i))
            got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1],
                                          tctrl, tcache, i,
                                          slice_mode=slice_mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{tsub} step {i}")


# --------------------------------------------------------------------------
# WeightSlice switch mode: the sliced_matmul entry point against JAX's
# lax.switch branches, for a GQA and an MHA config, every subnet
# --------------------------------------------------------------------------

SWITCH_CFGS = {"gqa": tiny_dense, "mha": lambda: tiny_dense(n_kv_heads=4)}


@pytest.fixture(scope="module", params=list(SWITCH_CFGS))
def switch_model(request):
    jcfg = SWITCH_CFGS[request.param]()
    jparams = jlm.init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


@pytest.mark.parametrize("level", ["lm", "attention_block"])
def test_switch_forward_and_prefill_match_jax_for_every_subnet(switch_model,
                                                               level):
    jcfg, tcfg, jparams, tparams = switch_model
    if level == "attention_block":
        _switch_attention_block_matches_jax(jcfg, tcfg, jparams, tparams)
        return
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    fwd = jax.jit(lambda p, t, c: jlm.forward(p, jcfg, {"tokens": t}, c,
                                              slice_mode="switch"))
    pre = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, {"tokens": t}, c,
                                              slice_mode="switch"))
    for jsub, tsub in _subnets(jcfg, tcfg):
        jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
        got = tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode="switch")
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(fwd(jparams, toks, jctrl)),
                                   **TOL, err_msg=f"forward {tsub}")
        got = tlm.prefill(tparams, tcfg, {"tokens": toks}, tctrl,
                          slice_mode="switch")
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(pre(jparams, toks, jctrl)),
                                   **TOL, err_msg=f"prefill {tsub}")


def _switch_attention_block_matches_jax(jcfg, tcfg, jparams, tparams):
    """The first attention block alone in switch mode, against the JAX
    switch branch (which slices the active heads before attention): the
    port's flash entry point is handed ``ctrl["head_width"]``, and the
    outputs of inactive heads leave it exactly 0."""
    from repro.models import attention as jattn
    from repro_torch.core import operators as tops
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import attention as tattn
    jp = jax.tree.map(lambda a: a[0],
                      jparams["backbone"]["stages"][0]["0:attn"])
    tp = {k: v[0] for k, v in
          tparams["backbone"]["stages"][0]["0:attn"].items()}
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    block = jax.jit(lambda p, xx, c: jattn.attention_block(
        p, jcfg, xx, c, jnp.asarray(pos), slice_mode="switch"))
    for jsub, tsub in _subnets(jcfg, tcfg):
        jctrl = jsn.make_control(jcfg, jsub)
        tctrl = tops.device_control(
            tattn.with_wo_width(tcfg, tsn.make_control(tcfg, tsub)), "cpu")
        seen = []

        def spy(q, k, v, **kw):
            o = kops.model_flash_attention(q, k, v, **kw)
            seen.append((kw.get("head_width"), o, k.shape[1]))
            return o

        got = tattn.attention_block(tp, tcfg, torch.from_numpy(x), tctrl,
                                    torch.from_numpy(pos),
                                    slice_mode="switch", attn_impl=spy)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(block(jp, x, jctrl)), **TOL,
                                   err_msg=f"attention block {tsub}")
        (hw, o, hkv), = seen
        assert int(hw) == int(tctrl["head_width"])
        inactive = ~kref.head_active(o.shape[1], hkv, hw, "cpu")
        assert inactive.any() == (int(hw) < tcfg.n_heads)
        assert (o[:, inactive] == 0).all(), tsub


def test_switch_decode_8_steps_match_jax_for_every_subnet(switch_model):
    jcfg, tcfg, jparams, tparams = switch_model
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    step = jlm.cached_decode_step(jcfg, "switch")
    for jsub, tsub in _subnets(jcfg, tcfg):
        jctrl, tctrl = jsn.make_control(jcfg, jsub), tsn.make_control(tcfg, tsub)
        jcache = jlm.init_cache(jcfg, 2, 16)
        tcache = tlm.init_cache(tcfg, 2, 16, device="cpu")
        for i in range(8):
            want, jcache = step(jparams, jnp.asarray(toks[:, i:i + 1]), jctrl,
                                jcache, jnp.int32(i))
            got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1],
                                          tctrl, tcache, i,
                                          slice_mode="switch")
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{tsub} step {i}")


def test_switch_equals_mask_in_the_port(switch_model):
    """Both WeightSlice modes compute the same subnet function."""
    _, tcfg, _, tparams = switch_model
    toks = np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    for sub in tsn.enumerate_space(tcfg):
        ctrl = tsn.make_control(tcfg, sub)
        mask = tlm.forward(tparams, tcfg, {"tokens": toks}, ctrl)
        switch = tlm.forward(tparams, tcfg, {"tokens": toks}, ctrl,
                             slice_mode="switch")
        np.testing.assert_allclose(switch.numpy(), mask.numpy(), **TOL,
                                   err_msg=f"subnet {sub}")
    with pytest.raises(ValueError, match="unknown WeightSlice mode"):
        tlm.forward(tparams, tcfg, {"tokens": toks}, ctrl, slice_mode="slice")


def test_switch_widths_agree_with_buckets_for_qwen2():
    """Switch mode reads ``ffn_width`` and ``head_width`` directly; they
    are the options the JAX branches index by bucket, for every subnet of
    the full qwen2-1.5b config, and the derived wo width is per KV group."""
    from repro_torch.configs import get_config as tget
    from repro_torch.models import attention as tattn
    cfg = tget("qwen2-1.5b")
    opts = tsn.width_options(cfg)
    assert opts["ffn"] == [4480, 6656, 8960]
    for sub in tsn.enumerate_space(cfg):
        ctrl = tsn.make_control(cfg, sub)
        assert ctrl["ffn_width"] == opts["ffn"][ctrl["ffn_bucket"]]
        assert ctrl["head_width"] == opts["heads"][ctrl["head_bucket"]]
        wid = tattn.with_wo_width(cfg, ctrl)[tattn.WO_WIDTH]
        assert wid == ctrl["head_width"] // 2 * 128 in (384, 768)
    assert tattn.wo_segments(cfg) == 2
    assert tattn.wo_segments(port_cfg(tiny_dense(n_kv_heads=4))) == 1
