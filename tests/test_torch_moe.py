"""The port's MoE block (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs, with the weights of
``init_moe`` copied across (fp32, 2e-3):

* ``moe_block`` of the reduced mixtral-8x7b and llama4-maverick configs
  (experts of d_ff 512, so that the width options differ) for every subnet, in both WeightSlice modes, with 1 and 2 token groups; the
  dispatch metadata (``order``, ``dest``, ``keep``, ``gates``) equal to
  JAX's;
* the traps of the reference's dispatch: a dead routing slot that pushes
  a live one past capacity (top-1 active of ``k_max`` 2), one expert that
  overflows, llama4's shared expert in mask form in both modes;
* the grouped plain ``sliced_matmul`` against JAX's switch branch;
* each subnet's ``moe_ffn_width`` is the ``ffn_bucket`` option;
* the executor's padded prefill against the JAX executor's, where pad
  tokens take capacity;
* ``serve --units`` and its refusal of a depth that does not fit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import subnet as jsn
from repro.models import moe as jmoe
from repro.serving import executor as jexec
from repro_torch.core import operators as tops
from repro_torch.core import subnet as tsn
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.models import moe as tmoe
from repro_torch.serving.executor import ExecutorConfig, SubnetExecutor
from test_torch_lm import port_cfg, port_params

TOL = dict(rtol=2e-3, atol=2e-3)
MOE_CONFIGS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")


# the reduced configs' experts have d_ff 128, a single width option;
# at 512 the options are 256, 384 and 512
MOE_D_FF = 512


@functools.lru_cache(maxsize=None)
def _layer(name, **changes):
    """(jcfg, tcfg, JAX params, port params) of one MoE layer of ``name``'s
    reduced config, with experts of d_ff MOE_D_FF."""
    jcfg = jget_config(name).reduced().replace(moe_d_ff=MOE_D_FF, **changes)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    return jcfg, port_cfg(jcfg), jp, port_params(jp)


def _x(jcfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_block(name, slice_mode, n_groups, **changes):
    jcfg = _layer(name, **changes)[0]
    return jax.jit(lambda p, x, c: jmoe.moe_block(
        p, jcfg, x, c, slice_mode=slice_mode, n_groups=n_groups))


def _ctrls(jcfg, tcfg):
    """(descriptor, JAX control, port control) of every subnet; the layer
    gates are not the block's."""
    out = []
    for jsub, tsub in zip(jsn.enumerate_space(jcfg),
                          tsn.enumerate_space(tcfg)):
        assert jsub.key() == tsub.key()
        jc = {k: v for k, v in jsn.make_control(jcfg, jsub).items()
              if k != "layer_gate"}
        tc = tsn.make_control(tcfg, tsub)
        out.append((tsub, jc, tops.device_control(tc, "cpu")))
    return out


def _jax_meta(jcfg, jp, x, ctrl, n_groups):
    """JAX's dispatch metadata for x, as moe_block computes it."""
    from repro.core import operators as jops
    B, S, d = x.shape
    h = jops.subnet_norm(jnp.asarray(x), jp["norm_gamma"], ctrl["subnet_id"],
                         eps=jcfg.norm_eps, kind=jcfg.norm)
    hg = h.reshape(n_groups, B * S // n_groups, d)
    logits = hg.astype(jnp.float32) @ jp["router"]
    cap = jmoe._capacity(B * S // n_groups, jcfg)
    _, meta = jax.vmap(lambda xx, ll: jmoe._dispatch_one_group(
        xx, ll, ctrl["topk"], jcfg, cap))(hg, logits)
    return {k: np.asarray(v) for k, v in meta.items()}


def _port_meta(tcfg, tp, x, ctrl, n_groups):
    from repro_torch.models.common import pre_norm
    B, S, d = x.shape
    _, h = pre_norm(tp, tcfg, torch.from_numpy(x), None, ctrl)
    hg = h.reshape(n_groups, B * S // n_groups, d)
    logits = hg.float() @ tp["router"]
    cap = tmoe._capacity(B * S // n_groups, tcfg)
    _, meta = tmoe.dispatch(hg, logits, tmoe.route(logits, tcfg),
                            ctrl["topk"], tcfg, cap)
    return {k: v.numpy() for k, v in meta.items()}


def _same_meta(want, got, what):
    for k in ("order", "src_token", "dest", "keep"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["gates"], want["gates"], rtol=1e-6,
                               atol=1e-7, err_msg=f"{what} gates")


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_block_matches_jax_for_every_subnet(name, slice_mode, n_groups):
    jcfg, tcfg, jp, tp = _layer(name)
    x = _x(jcfg)
    fn = _jax_block(name, slice_mode, n_groups)
    for sub, jc, tc in _ctrls(jcfg, tcfg):
        got = tmoe.moe_block(tp, tcfg, torch.from_numpy(x), tc,
                             slice_mode=slice_mode, n_groups=n_groups)
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jp, x, jc)),
                                   **TOL, err_msg=f"{name} {sub}")


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_dispatch_metadata_equals_jax(name, n_groups):
    """order, src_token, dest and keep bit for bit, gates to fp32 rounding,
    for each active k of the config."""
    jcfg, tcfg, jp, tp = _layer(name)
    x = _x(jcfg, seed=1)
    seen = set()
    for sub, jc, tc in _ctrls(jcfg, tcfg):
        if (int(jc["topk"]), int(jc["subnet_id"]) > 0) in seen:
            continue
        seen.add((int(jc["topk"]), int(jc["subnet_id"]) > 0))
        _same_meta(_jax_meta(jcfg, jp, x, jc, n_groups),
                   _port_meta(tcfg, tp, x, tc, n_groups), f"{name} {sub}")
    assert {k for k, _ in seen} == set(jcfg.elastic.topk_options)


def _dispatch_both(jcfg, tcfg, h, logits, topk):
    cap = jmoe._capacity(h.shape[0], jcfg)
    assert cap == tmoe._capacity(h.shape[0], tcfg)
    js, jm = jmoe._dispatch_one_group(jnp.asarray(h), jnp.asarray(logits),
                                      jnp.int32(topk), jcfg, cap)
    th, tl = torch.from_numpy(h)[None], torch.from_numpy(logits)[None]
    ts, tm = tmoe.dispatch(th, tl, tmoe.route(tl, tcfg),
                           torch.tensor(topk, dtype=torch.int32), tcfg, cap)
    _same_meta({k: np.asarray(v) for k, v in jm.items()},
               {k: v[0].numpy() for k, v in tm.items()}, "dispatch")
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    return cap, {k: v[0].numpy() for k, v in tm.items()}


def test_dead_slot_pushes_a_live_one_past_capacity():
    """Top-1 active of k_max 2, 12 tokens (a capacity of 8): tokens 0-7
    rank expert 0 second (a dead slot), token 8 ranks it first. The dead
    slots fill expert 0's 8 places, so token 8's live assignment is
    dropped, as in the reference."""
    jcfg, tcfg, _, _ = _layer("mixtral-8x7b")
    N, E, d = 12, jcfg.n_experts, jcfg.d_model
    rng = np.random.default_rng(2)
    logits = rng.uniform(-1, 0, (N, E)).astype(np.float32)
    logits[:8, 1], logits[:8, 0] = 3.0, 2.0
    logits[8, 0] = 3.0
    h = rng.standard_normal((N, d)).astype(np.float32)
    cap, meta = _dispatch_both(jcfg, tcfg, h, logits, topk=1)
    assert cap == 8
    # token 8's first slot, flat index 16, sorts after the eight slot-1
    # assignments of tokens 0-7 to expert 0
    i = int(np.flatnonzero(meta["order"] == 8 * 2)[0])
    assert meta["src_token"][i] == 8 and not meta["keep"][i]
    assert meta["dest"][i] == E * cap
    # with the dead slots on other experts it is kept
    logits[:8, 0] = -2.0
    _, meta = _dispatch_both(jcfg, tcfg, h, logits, topk=1)
    i = int(np.flatnonzero(meta["order"] == 8 * 2)[0])
    assert meta["keep"][i]


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
def test_dominant_expert_overflows(slice_mode):
    """A router with one dominant column: every token picks expert 0
    first, so expert 0 keeps its capacity and drops the rest, in both
    modes. (The inputs are positive, so after the norm every h is too: a
    positive router column 0 against negative others decides.)"""
    jcfg, tcfg, jp, tp = _layer("mixtral-8x7b")
    x = np.abs(_x(jcfg, B=4, S=12, seed=3))
    router = -np.abs(np.random.default_rng(4).standard_normal(
        (jcfg.d_model, jcfg.n_experts))).astype(np.float32) * 0.01
    router[:, 0] = 0.01
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    fn = _jax_block("mixtral-8x7b", slice_mode, 1)
    for sub, jc, tc in _ctrls(jcfg, tcfg)[::5]:
        got = tmoe.moe_block(tp, tcfg, torch.from_numpy(x), tc,
                             slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jp, x, jc)),
                                   **TOL, err_msg=str(sub))
        meta = _port_meta(tcfg, tp, x, tc, 1)
        _same_meta(_jax_meta(jcfg, jp, x, jc, 1), meta, str(sub))
        cap = tmoe._capacity(x.shape[0] * x.shape[1], tcfg)
        first = meta["order"] % 2 == 0             # the slot-0 assignments
        assert meta["keep"][first].sum() == cap
        assert (meta["dest"][first & meta["keep"]] < cap).all()
        assert (~meta["keep"][first]).sum() == first.sum() - cap > 0


@pytest.mark.parametrize("slice_mode", ["mask", "switch"])
def test_llama4_shared_expert_is_mask_form_in_both_modes(slice_mode):
    """With the routed experts zeroed, the block's output is the shared
    expert alone, its hidden channels cut at ``moe_ffn_width`` in both
    modes, equal to JAX's."""
    jcfg, tcfg, jp, tp = _layer("llama4-maverick-400b-a17b")
    assert jcfg.shared_expert
    zero = ("wg", "wu", "wd")
    jp = dict(jp, **{k: jnp.zeros_like(jp[k]) for k in zero})
    tp = dict(tp, **{k: torch.zeros_like(tp[k]) for k in zero})
    x = _x(jcfg, seed=4)
    fn = _jax_block("llama4-maverick-400b-a17b", slice_mode, 1)
    widths = set()
    for sub, jc, tc in _ctrls(jcfg, tcfg):
        got = tmoe.moe_block(tp, tcfg, torch.from_numpy(x), tc,
                             slice_mode=slice_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(jp, x, jc)),
                                   **TOL, err_msg=str(sub))
        from repro_torch.models.common import pre_norm
        _, h = pre_norm(tp, tcfg, torch.from_numpy(x), None, tc)
        w = int(tc["moe_ffn_width"])
        a = torch.nn.functional.silu(h @ tp["swg"][:, :w]) \
            * (h @ tp["swu"][:, :w])
        torch.testing.assert_close(got - torch.from_numpy(x),
                                   a @ tp["swd"][:w], **TOL)
        widths.add(w)
    assert len(widths) == len(jcfg.elastic.ffn_fracs)


def test_grouped_plain_matches_jax_switch_branch():
    """The grouped plain ``sliced_matmul`` (the CPU tier of the switch
    path) against the reference's switch branch at each width option:
    three einsums over the sliced expert tables."""
    jcfg, tcfg, jp, tp = _layer("mixtral-8x7b")
    E, C, d = jcfg.n_experts, 8, jcfg.d_model
    slots = np.random.default_rng(5).standard_normal(
        (1, E, C, d)).astype(np.float32)
    for kf in jsn.width_options(jcfg)["moe_ffn"]:
        wg = jax.lax.slice(jp["wg"], (0, 0, 0), (E, d, kf))
        wu = jax.lax.slice(jp["wu"], (0, 0, 0), (E, d, kf))
        wd = jax.lax.slice(jp["wd"], (0, 0, 0), (E, kf, d))
        a = jax.nn.silu(jnp.einsum("gecd,edf->gecf", slots, wg))
        a = a * jnp.einsum("gecd,edf->gecf", slots, wu)
        want = jnp.einsum("gecf,efd->gecd", a, wd)
        x = torch.from_numpy(slots[0])
        k = torch.tensor(kf, dtype=torch.int32)
        gate = sm.sliced_matmul_plain(x, tp["wg"], None, k)
        assert not gate[..., kf:].any()
        a = torch.nn.functional.silu(gate) \
            * sm.sliced_matmul_plain(x, tp["wu"], None, k)
        got = sm.sliced_matmul_plain(a, tp["wd"], k, None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], **TOL)
        np.testing.assert_allclose(
            tmoe._experts_switch(torch.from_numpy(slots), tp, k).numpy(),
            np.asarray(want), **TOL)


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_ffn_width_is_the_ffn_bucket_option(name):
    """Switch mode reads ``moe_ffn_width``; the reference switches on
    ``ffn_bucket``: for every subnet they name the same width."""
    cfg = port_cfg(jget_config(name))
    opts = tsn.width_options(cfg)["moe_ffn"]
    assert opts == sorted(opts) and all(w % 8 == 0 for w in opts)
    for sub in tsn.enumerate_space(cfg):
        ctrl = tsn.make_control(cfg, sub)
        assert int(ctrl["moe_ffn_width"]) == opts[int(ctrl["ffn_bucket"])]


def test_decode_capacity_comes_from_the_batch():
    """Decode routes B tokens a step, prefill B * S: the capacities
    differ, and both count k_max whatever the active k."""
    cfg = port_cfg(jget_config("mixtral-8x7b"))
    assert tmoe.k_max(cfg) == 2
    assert tmoe._capacity(8, cfg) == 8                   # decode, B = 8
    assert tmoe._capacity(8 * 16, cfg) == 40             # prefill B=8 S=16
    llama = port_cfg(jget_config("llama4-maverick-400b-a17b"))
    assert tmoe._capacity(128, llama) == 8
    for n in (1, 7, 100, 4096):
        for c in (cfg, llama):
            assert tmoe._capacity(n, c) == jmoe._capacity(n, c)


def test_executor_padded_prefill_matches_jax_where_pads_take_capacity():
    """A ragged batch of reduced mixtral (3 rows of up to 12 tokens) is
    padded to the (4, 16) bucket. With a capacity of 8 slots an expert at
    both shapes, the pad tokens, routed like real ones, push real tokens
    of later rows out: the port's executor equals the JAX executor's, and
    differs from the forward of the unpadded (3, 12) batch."""
    from repro_torch.models import lm as tlm
    jcfg = jget_config("mixtral-8x7b").reduced().replace(
        capacity_factor=0.25)
    xc = dict(batch_buckets=(4,), seq_buckets=(16,))
    jex = jexec.build_executor(jcfg, exec_cfg=jexec.ExecutorConfig(**xc))
    tcfg = port_cfg(jcfg)
    tex = SubnetExecutor(port_params(jex.params), tcfg,
                         exec_cfg=ExecutorConfig(**xc))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    lengths = [12, 7, 10]
    assert tmoe._capacity(4 * 16, tcfg) == tmoe._capacity(3 * 12, tcfg) == 8
    differs = False
    for idx in (0, tex.n_subnets // 2, tex.n_subnets - 1):
        want = np.asarray(jex.prefill(idx, toks, lengths=lengths))
        got = tex.prefill(idx, toks, lengths=lengths)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"subnet {idx}")
        np.testing.assert_allclose(tex.run_prefill(idx, toks),
                                   np.asarray(jex.run_prefill(idx, toks)),
                                   **TOL, err_msg=f"subnet {idx}")
        ctrl = tsn.make_control(tcfg, tex.points[idx].sub)
        unpadded = tlm.forward(tex.params, tcfg, {"tokens": toks}, ctrl)
        last = unpadded[np.arange(3), np.asarray(lengths) - 1].numpy()
        differs |= not np.allclose(last, got, **TOL)
    assert differs


def test_serve_units_cuts_depth_and_refuses_what_does_not_fit(capsys):
    """``--units`` keeps the first N repeat units of each stage (reported
    as ``units``); a depth whose bf16 weights exceed the device's free
    memory is refused before anything is allocated, with the size."""
    from repro_torch.launch import serve
    cfg = port_cfg(jget_config("llama4-maverick-400b-a17b"))
    cut = serve.cut_units(cfg, 1)
    assert [s.repeat for s in cut.stages] == [1]
    assert cut.stages[0].pattern == cfg.stages[0].pattern
    assert serve.cut_units(cfg, None) == cfg
    from repro_torch.models import lm as tlm
    full, one = tlm.param_bytes(cfg), tlm.param_bytes(cut)
    assert 700e9 < full < 900e9 and 30e9 < one < 45e9
    with pytest.raises(MemoryError, match=r"795\.5 GB of bfloat16 weights"):
        serve.check_fits(cfg, available=80e9)
    serve.check_fits(cut, available=80e9)
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--size", "reduced",
                          "--units", "1"])
    with pytest.raises(MemoryError, match=r"llama4.*GB"):
        serve.run(["--device", "cpu", "--size", "full", "--arch",
                   "llama4-maverick-400b-a17b"])
    out = serve.run(["--device", "cpu", "--arch", "mixtral-8x7b",
                     "--queries", "4", "--seq-len", "8"])
    assert out["units"] == 2 and out["served"] == out["queries"] == 4
