"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and xlstm-125m
against the JAX package on the same numpy inputs, with the weights of
``lm.init_model`` copied across through numpy (fp32, 2e-3):

* ``from_jax_params`` leaf by leaf, the fp32 leaves of a bf16 tree
  (``w_if``, ``b_if``, ``head_norm``; ``w_x``, ``r``, ``b``), and
  ``param_bytes``;
* ``gla_flash`` at sequence lengths that are not a multiple of its block
  (pad keys at ``b = NEG_INF``), ``mlstm_block`` (one block, and two at
  the default block of 256) and ``mlstm_decode`` with its cache,
  ``slstm_block`` and ``slstm_decode`` with theirs, for every subnet (the
  sLSTM post-FFN width is the one that actuates);
* xlstm-125m's ``reduced()`` (2 units of mLSTM x 3 + sLSTM): forward and
  prefill for every subnet in both WeightSlice modes, switch equal to mask
  bit for bit (nothing slices), 12 decode steps for every subnet in both
  modes, the port's own decode against its own forward, and the
  executor's padded prefill (B=3, S=12 bucketed to 4 x 16) against JAX's
  unpadded forward; its bf16 walk strays from its fp32 walk past 2e-2, as
  the reference's own does, and by as much.

The helpers are ``tests/test_torch_ssm.py``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxl
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txl
from test_torch_lm import port_cfg
from test_torch_ssm import (DECODE_STEPS, MODES, TOL, block_ctrls,
                            block_params, build, check_bf16_drift,
                            check_decode_steps,
                            check_executor_padded_prefill,
                            check_forward_and_prefill,
                            check_fp32_leaves_of_bf16_tree,
                            check_from_jax_params,
                            check_own_decode_against_forward,
                            jax_param_bytes, subnets, tokens, x_input)


def _reduced():
    return jget_config("xlstm-125m").reduced()


@pytest.fixture(scope="module")
def model():
    return build("xlstm-reduced", _reduced)


def test_from_jax_params_converts_leaf_by_leaf(model):
    _, _, jparams, tparams = model
    check_from_jax_params(jparams, tparams)
    assert set(tparams["backbone"]["stages"][0]) \
        == {"0:mlstm", "1:mlstm", "2:mlstm", "3:slstm"}


def test_bf16_tree_keeps_fp32_leaves_and_param_bytes_counts_them():
    """In a bf16 tree the gate and recurrence leaves stay fp32; at full
    size ``param_bytes`` is the bytes of JAX's tree (125M parameters, the
    recurrence's fp32)."""
    check_fp32_leaves_of_bf16_tree(_reduced(), {
        f"{j}:mlstm": ("w_if", "b_if", "head_norm") for j in range(3)} | {
        "3:slstm": ("w_x", "r", "b")})
    full = jget_config("xlstm-125m")
    assert tlm.param_bytes(port_cfg(full)) == jax_param_bytes(full)
    assert 0.2e9 < jax_param_bytes(full) < 0.3e9


@pytest.mark.parametrize("S,block", [(12, 8), (20, 8), (5, 256)])
def test_gla_flash_matches_jax(S, block):
    """Blockwise gated linear attention with a running max, at S not a
    multiple of the block (the pad keys at NEG_INF) and S under it."""
    rng = np.random.default_rng(S)
    B, H, dqk, dv = 2, 3, 8, 16
    q, k = (rng.standard_normal((B, H, S, dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, dv)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.normal(2.0, 2.0, (B, H, S)))))
    LF = np.cumsum(lf, -1).astype(np.float32)
    b = (rng.normal(0.0, 2.0, (B, H, S)) - LF).astype(np.float32)
    want = jxl.gla_flash(*map(jnp.asarray, (q, k, v, LF, b)), block=block)
    got = txl.gla_flash(*map(torch.from_numpy, (q, k, v, LF, b)),
                        block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _layer(kind):
    jcfg = _reduced()
    init = jxl.init_mlstm if kind == "mlstm" else jxl.init_slstm
    jp = init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    return (jcfg, port_cfg(jcfg)) + block_params(jp, seed=2)


_BLOCKS = {"mlstm": (jxl.mlstm_block, txl.mlstm_block),
           "slstm": (jxl.slstm_block, txl.slstm_block)}
_DECODES = {"mlstm": (jxl.mlstm_decode, txl.mlstm_decode,
                      jxl.init_mlstm_cache, txl.init_mlstm_cache),
            "slstm": (jxl.slstm_decode, txl.slstm_decode,
                      jxl.init_slstm_cache, txl.init_slstm_cache)}


@pytest.mark.parametrize("kind,B,S", [("mlstm", 2, 12), ("mlstm", 1, 300),
                                      ("slstm", 2, 12)])
def test_block_matches_jax_for_every_subnet(kind, B, S):
    """mLSTM at S = 12 (one gla block) and S = 300 (two blocks of 256, the
    second padded); sLSTM at S = 12, every subnet's norm rows and post-FFN
    width."""
    jcfg, tcfg, jp, tp = _layer(kind)
    jblock, tblock = _BLOCKS[kind]
    x = x_input(jcfg, B, S, seed=S)
    fn = jax.jit(lambda p, x, c: jblock(p, jcfg, x, c))
    for jc, tc in block_ctrls(jcfg, tcfg):
        want = fn(jp, jnp.asarray(x), jc)
        got = tblock(tp, tcfg, torch.from_numpy(x), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"subnet {int(tc['subnet_id'])}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax_and_its_own_block(kind):
    """12 decode steps of one layer at the largest subnet: outputs and
    every cache leaf against JAX's, and the outputs against the port's own
    parallel block over the same 12 tokens."""
    jcfg, tcfg, jp, tp = _layer(kind)
    jdec, tdec, jinit, tinit = _DECODES[kind]
    x = x_input(jcfg, 2, DECODE_STEPS, seed=7)
    jc, tc = block_ctrls(jcfg, tcfg)[-1]
    fn = jax.jit(lambda p, x, c, cache: jdec(p, jcfg, x, c, cache, 0))
    jcache = jinit(jcfg, 2, jnp.float32)
    tcache = tinit(tcfg, 2, torch.float32, "cpu")
    outs = []
    for i in range(DECODE_STEPS):
        want, jcache = fn(jp, jnp.asarray(x[:, i:i + 1]), jc, jcache)
        got, tcache = tdec(tp, tcfg, torch.from_numpy(x[:, i:i + 1]), tc,
                           tcache, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")
        assert set(tcache) == set(jcache)
        for key in jcache:
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL,
                                       err_msg=f"step {i} {key}")
        outs.append(got)
    full = _BLOCKS[kind][1](tp, tcfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


@pytest.mark.parametrize("slice_mode", MODES)
def test_forward_and_prefill_match_jax_for_every_subnet(model, slice_mode):
    check_forward_and_prefill(model, slice_mode,
                              tokens(model[0], (3, 12), seed=6))


def test_switch_equals_mask_bit_for_bit(model):
    """Nothing of xlstm slices in switch mode (the sLSTM post-FFN is mask
    form in both modes), so the two modes give the same bits."""
    jcfg, tcfg, _, tparams = model
    toks = tokens(jcfg, (3, 12), seed=6)
    for _, tctrl, sub in subnets(jcfg, tcfg):
        mask, switch = (tlm.forward(tparams, tcfg, {"tokens": toks}, tctrl,
                                    slice_mode=mode) for mode in MODES)
        assert torch.equal(mask, switch), sub


@pytest.mark.parametrize("slice_mode", MODES)
def test_decode_steps_match_jax_for_every_subnet(model, slice_mode):
    check_decode_steps(model, slice_mode,
                       tokens(model[0], (2, DECODE_STEPS), seed=21))


@pytest.mark.parametrize("slice_mode", MODES)
def test_own_decode_matches_own_forward(model, slice_mode):
    check_own_decode_against_forward(
        model, slice_mode, tokens(model[0], (2, DECODE_STEPS), seed=22))


def test_bf16_walk_strays_from_fp32_as_jax_does():
    check_bf16_drift(_reduced())


@pytest.mark.parametrize("slice_mode", MODES)
def test_executor_padded_prefill_matches_unpadded_jax(model, slice_mode):
    check_executor_padded_prefill(model, slice_mode)
