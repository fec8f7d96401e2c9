"""The port's embed-frontend configurations, musicgen-medium (sinusoidal
positions, layernorm, GELU, MHA at head_dim 64) and qwen2-vl-7b (M-RoPE,
GQA with 7 query heads a kv head), against the JAX package on the same
numpy inputs, the weights of ``lm.init_model`` copied across through numpy
(fp32, 2e-3):

* both configs equal ``repro``'s field for field, and the registry lists
  them;
* ``sinusoid_pos``, and ``apply_rope`` with M-RoPE over three distinct
  position streams (with equal streams M-RoPE is plain RoPE);
* each config's ``reduced()``: ``forward``, ``prefill`` and ``loss_fn``
  from ``embeds`` (qwen2-vl with t constant and h, w over a 4x4 grid), and
  8 decode steps on tokens, for every subnet in both WeightSlice modes;
* the port's decode against its own forward for musicgen on tokens (as
  ``tests/test_models.py::test_decode_matches_prefill``);
* the plain flash and decode attention at head_dim 64 (musicgen's, MHA)
  and at G = 7 (qwen2-vl's group) against the JAX kernels in interpret
  mode, as ``tests/test_torch_kernels.py`` runs them at 80 and 120;
* the shapes that reach the kernels at full width: head dims, groups,
  flash's packing at G = 7, and the switch-mode widths of ``sliced_matmul``.

Each model is built once per module, and each JAX step is jitted once per
(config, mode) with the control traced.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import subnet as jsn
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_configs
from repro_torch.core import subnet as tsn
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from test_torch_kernels import (
    test_decode_attention_plain_matches_jax_at_head_dims as decode_at,
    test_flash_attention_head_width_matches_jax_at_head_dims as flash_width_at,
    test_flash_attention_plain_matches_jax_at_head_dims as flash_at)
from test_torch_lm import port_cfg, port_params

TOL = dict(rtol=2e-3, atol=2e-3)
NAMES = ("musicgen-medium", "qwen2-vl-7b")
MODES = ("mask", "switch")
B, S, DECODE_STEPS = 2, 16, 8
N_SUBNETS = 18


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    parallel test workers each extra thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def build(name):
    """(jcfg, tcfg, JAX params, port params) of ``name``'s ``reduced()``."""
    jcfg = jget_config(name).reduced()
    jparams = jlm.init_model(jax.random.PRNGKey(7), jcfg)
    return jcfg, port_cfg(jcfg), jparams, port_params(jparams)


def grid_positions(batch, seq, side=4):
    """M-RoPE's three streams over a ``side`` x ``side`` grid of patches:
    t constant, h the row, w the column; (3, B, S) int32."""
    i = np.arange(seq)
    pos = np.stack([np.full(seq, 3), i // side, i % side]).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).copy()


@functools.lru_cache(maxsize=None)
def inputs(name):
    """The batch both frameworks take: seeded ``embeds`` (B, S, d),
    ``labels``, and for qwen2-vl the grid positions."""
    jcfg = build(name)[0]
    rng = np.random.default_rng(11)
    batch = {"embeds": rng.standard_normal((B, S, jcfg.d_model)
                                           ).astype(np.float32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if jcfg.mrope_sections:
        batch["positions"] = grid_positions(B, S)
    return batch


def subnets(name):
    jcfg, tcfg = build(name)[:2]
    js, ts = jsn.enumerate_space(jcfg), tsn.enumerate_space(tcfg)
    assert [s.key() for s in js] == [s.key() for s in ts]
    return [(jsn.make_control(jcfg, a), tsn.make_control(tcfg, b))
            for a, b in zip(js, ts)]


@functools.lru_cache(maxsize=None)
def jax_steps(name, mode):
    """JAX's forward, loss and decode step, jitted once per (config,
    mode), the control traced."""
    jcfg = build(name)[0]
    fwd = jax.jit(lambda p, b, c: jlm.forward(p, jcfg, b, c,
                                              slice_mode=mode))
    loss = jax.jit(lambda p, b, c: jlm.loss_fn(p, jcfg, b, c,
                                               slice_mode=mode))
    dec = jax.jit(lambda p, t, c, cache, i: jlm.decode_step(
        p, jcfg, t, c, cache, i, slice_mode=mode))
    return fwd, loss, dec


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **TOL, err_msg=what)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_port_config_equals_jax_config(name):
    want, got = jget_config(name), tget_config(name)
    assert name in list_configs()
    assert [f.name for f in dataclasses.fields(got)] \
        == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.reduced() == port_cfg(want.reduced())


def test_config_shapes_reach_the_kernels():
    """musicgen: 24 heads of 64 under MHA (one wo segment of 1536, 768 at
    half heads), FFN 3072 / 4608 / 6144; qwen2-vl: 28 heads of 128 over 4
    kv heads (G = 7: flash packs one head a block, decode's G of at most
    8 holds), wo segments of 896 (512 at 4 of 7 heads), FFN 9472 / 14208
    / 18944. Every width is one ``sliced_matmul`` takes: a multiple of 8
    within its segment."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    want = {"musicgen-medium": (64, 1, 1536, {768, 1536},
                                {3072, 4608, 6144}),
            "qwen2-vl-7b": (128, 7, 896, {512, 896}, {9472, 14208, 18944})}
    for name, (hd, G, seg, wos, ffns) in want.items():
        cfg = tget_config(name)
        assert cfg.resolved_head_dim == hd and hd in fa.HEAD_DIMS \
            and hd in da.HEAD_DIMS
        assert tsn.head_group_size(cfg) == G <= da.G_MAX
        assert cfg.n_heads * hd // tattn.wo_segments(cfg) == seg
        got_wo, got_ffn = set(), set()
        for sub in tsn.enumerate_space(cfg):
            ctrl = tsn.make_control(cfg, sub)
            got_ffn.add(int(ctrl["ffn_width"]))
            got_wo.add(int(tattn.with_wo_width(cfg, ctrl)[tattn.WO_WIDTH]))
        assert got_wo == wos and got_ffn == ffns
        assert all(w % 8 == 0 and 0 < w <= seg for w in got_wo)
        assert all(f % 8 == 0 for f in got_ffn)
        assert (cfg.d_model * 2) % 16 == 0     # 16-byte rows
    for Sq in (1, 16, 256):
        assert fa.pack_plan(Sq, 7).nh == 1
    assert fa.pack_plan(16, 1).nh == 1


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 1536])
def test_sinusoid_pos_matches_jax(d):
    pos = np.random.default_rng(d).integers(0, 4096, (3, 7)).astype(np.int32)
    want = jlm.sinusoid_pos(jnp.asarray(pos), d, jnp.float32)
    got = tlm.sinusoid_pos(torch.from_numpy(pos), d, torch.float32)
    assert tuple(got.shape) == (3, 7, d)
    _close(got, want)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((8, 4, 4), 32)])
def test_apply_rope_mrope_matches_jax_with_distinct_streams(sections, hd):
    """M-RoPE over three distinct streams (t constant, h and w over a
    grid) against JAX, and unlike plain RoPE on the h stream alone."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 16, 3, hd)).astype(np.float32)
    pos = grid_positions(2, 16)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                            mrope_sections=sections)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           mrope_sections=sections)
    _close(got, want)
    plain = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[1]),
                             1e6)
    assert not torch.allclose(got, plain, **TOL)


def test_default_positions_are_three_equal_streams():
    tcfg = build("qwen2-vl-7b")[1]
    pos = tlm.default_positions(tcfg, 2, 5, "cpu")
    assert tuple(pos.shape) == (3, 2, 5)
    want = jlm.default_positions(build("qwen2-vl-7b")[0], 2, 5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    assert tuple(tlm.default_positions(build("musicgen-medium")[1], 2, 5,
                                       "cpu").shape) == (2, 5)


# --------------------------------------------------------------------------
# the reduced configs against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("index", range(N_SUBNETS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_loss_from_embeds_match_jax(name, mode, index):
    _, tcfg, jparams, tparams = build(name)
    jctrl, tctrl = subnets(name)[index]
    batch = inputs(name)
    fwd, loss, _ = jax_steps(name, mode)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = fwd(jparams, jbatch, jctrl)
    got = tlm.forward(tparams, tcfg, batch, tctrl, slice_mode=mode)
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    _close(got, want, "forward")
    _close(tlm.prefill(tparams, tcfg, batch, tctrl, slice_mode=mode),
           np.asarray(want)[:, -1:], "prefill")
    _close(tlm.loss_fn(tparams, tcfg, batch, tctrl, slice_mode=mode),
           loss(jparams, jbatch, jctrl), "loss")


@pytest.mark.parametrize("index", range(N_SUBNETS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name, mode, index):
    jcfg, tcfg, jparams, tparams = build(name)
    jctrl, tctrl = subnets(name)[index]
    _, _, dec = jax_steps(name, mode)
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, B, 16)
    tcache = tlm.init_cache(tcfg, B, 16, device="cpu")
    for i in range(DECODE_STEPS):
        want, jcache = dec(jparams, jnp.asarray(toks[:, i:i + 1]), jctrl,
                           jcache, jnp.int32(i))
        got, tcache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1], tctrl,
                                      tcache, i, slice_mode=mode)
        _close(got, want, f"step {i}")


def test_embeds_are_cast_to_the_table_type():
    """A bf16 model takes fp32 ``embeds`` in its own type, and the same
    values as tokens whose rows they are give the same logits."""
    tcfg = build("musicgen-medium")[1].replace(dtype="bfloat16")
    params = tlm.init_model(tcfg, torch.Generator().manual_seed(1), "cpu")
    toks = np.arange(6, dtype=np.int32).reshape(1, 6)
    ctrl = tsn.make_control(tcfg, tsn.max_subnet(tcfg))
    embeds = params["embed"][torch.from_numpy(toks).long()].float()
    assert tlm.embed_inputs(params, tcfg, {"embeds": embeds}).dtype \
        == torch.bfloat16
    a = tlm.forward(params, tcfg, {"embeds": embeds}, ctrl)
    b = tlm.forward(params, tcfg, {"tokens": toks}, ctrl)
    assert torch.equal(a, b)


def test_musicgen_decode_matches_its_own_forward():
    """Teacher-forced decode on tokens reproduces the port's forward over
    the same tokens (sinusoid at the device index, the cache)."""
    _, tcfg, _, tparams = build("musicgen-medium")
    ctrl = tsn.make_control(tcfg, tsn.max_subnet(tcfg))
    toks = np.random.default_rng(13).integers(
        0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    full = tlm.forward(tparams, tcfg, {"tokens": toks}, ctrl)
    cache = tlm.init_cache(tcfg, 1, 8, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = tlm.decode_step(tparams, tcfg, toks[:, i:i + 1], ctrl,
                                    cache, i)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


# --------------------------------------------------------------------------
# the plain attention at musicgen's head_dim and qwen2-vl's group
# --------------------------------------------------------------------------

HEADS = [(64, 1), (64, 4), (128, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,G", HEADS)
def test_flash_attention_plain_matches_jax_at_new_heads(d, G, dtype):
    flash_at(d, G, dtype)


@pytest.mark.parametrize("d,G", HEADS)
def test_flash_attention_head_width_matches_jax_at_new_heads(d, G):
    flash_width_at(d, G)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,G", HEADS)
def test_decode_attention_plain_matches_jax_at_new_heads(d, G, dtype):
    decode_at(d, G, dtype)
