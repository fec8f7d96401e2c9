"""The port's conv supernet (``repro_torch.models.convnet``, the paper's
OFA-ResNet) and its SubnetNorm calibration (``repro_torch.core.calibrate``)
against the JAX package on the same numpy inputs, the weights of
``repro.models.convnet.init_convnet`` copied across through numpy
(``convnet.from_jax_params``; HWIO conv weights become (cout, cin, kh, kw)),
fp32, 2e-3 (relative to max |logit| for logits):

* ``subnet_batch_norm`` gathering its rows by a device ``subnet_id``;
* ``device_control`` keeping the conv fractions float32;
* ``convnet_forward`` for all 27 subnets at image size 16 (even: XLA's
  "SAME" pads a 3x3 stride-2 conv by (0, 1)) and 15 (odd), with random
  per-subnet BatchNorm tables so that every subnet reads rows of its own;
* the ``collect_stats`` logits and every site's batch (mean, var);
* ``calibrate_convnet`` over 2 batches and the first 2 subnets, the other
  rows untouched; ``norm_table_bytes`` and ``shared_weight_bytes``;
* LayerSelect: a gated-off unit calls no ``F.conv2d``, and the TF32
  switches are restored after a call.

The config is ``tests/test_models.py``'s hand-reduced OFA-ResNet (2 units a
stage, widths 16/32/48/64, 10 classes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import Stage as JStage
from repro.core import calibrate as jcal
from repro.core import operators as jops
from repro.core import subnet as jsn
from repro.models import convnet as jconv
from repro_torch.core import calibrate as tcal
from repro_torch.core import operators as tops
from repro_torch.core import subnet as tsn
from repro_torch.models import convnet as tconv
from test_torch_lm import port_cfg

TOL = 2e-3
SIZES = (16, 15)
N_SUBNETS = 27


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    parallel test workers each extra thread only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_jcfg():
    cfg = jget_config("ofa_resnet")
    return cfg.replace(stages=tuple(JStage(s.pattern, 2) for s in cfg.stages),
                       conv_stage_widths=(16, 32, 48, 64), img_size=16,
                       n_classes=10, d_model=64)


def _randomize_tables(params, seed):
    """Random per-subnet (mean, var) rows and shared (gamma, beta), so that
    each subnet normalizes with rows of its own."""
    rng = np.random.default_rng(seed)
    for t in jcal._site_tables(params).values():
        ns, c = t["mean"].shape
        t["mean"] = jnp.asarray(0.3 * rng.standard_normal((ns, c)), jnp.float32)
        t["var"] = jnp.asarray(rng.uniform(0.5, 2.0, (ns, c)), jnp.float32)
        t["gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
        t["beta"] = jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32)
    return params


@functools.lru_cache(maxsize=None)
def model():
    """(jcfg, tcfg, JAX params with random tables, port params)."""
    jcfg = reduced_jcfg()
    jparams = _randomize_tables(jconv.init_convnet(jax.random.PRNGKey(0),
                                                   jcfg), 1)
    return jcfg, port_cfg(jcfg), jparams, to_port(jparams)


def to_port(jparams):
    return tconv.from_jax_params(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def images(size, batch=2, seed=0):
    return np.random.default_rng(seed + size).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_forward():
    jcfg = model()[0]
    return jax.jit(lambda p, x, c: jconv.convnet_forward(p, jcfg, x, c))


def subnets():
    jcfg, tcfg = model()[:2]
    js, ts = jsn.enumerate_space(jcfg), tsn.enumerate_space(tcfg)
    assert [s.key() for s in js] == [s.key() for s in ts]
    return list(zip(js, ts))


def assert_logits(got, want, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def test_space_has_27_subnets():
    assert len(subnets()) == N_SUBNETS


def test_from_jax_params_transposes_conv_weights():
    _, _, jparams, tparams = model()
    w = np.asarray(jparams["stages"][1][0]["w2"])             # HWIO
    got = tparams["stages"][1][0]["w2"]
    assert tuple(got.shape) == (w.shape[3], w.shape[2], w.shape[0], w.shape[1])
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tparams["stem"]["bn"]["var"].numpy(),
                                  np.asarray(jparams["stem"]["bn"]["var"]))


def test_init_convnet_matches_the_reference_tree():
    """Seeded init on the CPU: the reference's keys, and each leaf's shape
    (conv weights in torch's layout)."""
    jcfg, tcfg, jparams, _ = model()
    got = tconv.init_convnet(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = to_port(jconv.init_convnet(jax.random.PRNGKey(3), jcfg))
    assert jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, got)) \
        == jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    w1 = got["stages"][0][0]["w1"]
    std = float(w1.std())
    assert 0.5 < std / (2.0 / w1.shape[1]) ** 0.5 < 1.5


@pytest.mark.parametrize("sid", [0, 13, 26])
def test_subnet_batch_norm_matches_jax(sid):
    rng = np.random.default_rng(sid)
    x = rng.standard_normal((2, 5, 5, 24)).astype(np.float32)
    mean = rng.standard_normal((27, 24)).astype(np.float32)
    var = rng.uniform(0.2, 3.0, (27, 24)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    beta = rng.standard_normal(24).astype(np.float32)
    want = jops.subnet_batch_norm(x, mean, var, gamma, beta, jnp.int32(sid))
    got = tops.subnet_batch_norm(*(torch.from_numpy(a) for a in
                                   (x, mean, var, gamma, beta)),
                                 torch.tensor(sid, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_device_control_keeps_conv_fractions_float():
    """The conv fractions stay float32 on the device (as int32 they would
    be 0 or 1); ``subnet_id`` stays int32 and the gates host numpy."""
    jcfg, tcfg = model()[:2]
    sub = tsn.enumerate_space(tcfg)[0]
    ctrl = tops.device_control(tconv.make_conv_control(tcfg, sub), "cpu")
    assert ctrl["conv_e_frac"].dtype == torch.float32
    assert ctrl["conv_w_frac"].dtype == torch.float32
    assert float(ctrl["conv_e_frac"]) == pytest.approx(sub.ffn_frac)
    assert float(ctrl["conv_w_frac"]) == pytest.approx(sub.head_frac)
    assert ctrl["subnet_id"].dtype == torch.int32
    assert isinstance(ctrl["layer_gate"], np.ndarray)
    want = jconv.make_conv_control(jcfg, jsn.enumerate_space(jcfg)[0])
    for key, val in tconv.make_conv_control(tcfg, sub).items():
        np.testing.assert_array_equal(val, want[key])
        assert np.asarray(val).dtype == np.asarray(want[key]).dtype


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("index", range(N_SUBNETS))
def test_convnet_forward_matches_jax(size, index):
    _, tcfg, jparams, tparams = model()
    jsub, tsub = subnets()[index]
    x = images(size)
    want = jax_forward()(jparams, x, jconv.make_conv_control(model()[0], jsub))
    got = tconv.convnet_forward(tparams, tcfg, x,
                                tconv.make_conv_control(tcfg, tsub))
    assert tuple(got.shape) == (2, 10)
    assert_logits(got, want, f"subnet {index} size {size}")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("index", [0, 13, 26])
def test_collect_stats_matches_jax(size, index):
    """Batch-statistics walk: the logits and every site's (mean, var)."""
    jcfg, tcfg, jparams, tparams = model()
    jsub, tsub = subnets()[index]
    gates = tsn.stage_gates(tcfg, tsub.depth_frac)
    x = images(size, batch=4)
    wl, ws = jconv.convnet_forward(jparams, jcfg, x,
                                   jconv.make_conv_control(jcfg, jsub),
                                   collect_stats=True,
                                   static_gates=tuple(bool(g) for g in gates))
    gl, gs = tconv.convnet_forward(tparams, tcfg, x,
                                   tconv.make_conv_control(tcfg, tsub),
                                   collect_stats=True, static_gates=gates)
    assert_logits(gl, wl)
    assert sorted(gs) == sorted(ws)
    for site, (mu, var) in ws.items():
        for got, want in zip(gs[site], (mu, var)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=TOL,
                atol=TOL * max(float(np.abs(want).max()), 1.0),
                err_msg=site)


def test_calibrate_convnet_matches_jax():
    """Two batches, the first two subnets: the filled rows equal the
    reference's (law of total variance), and every other row, and the rows
    of the sites these subnets do not visit, are left as they were."""
    jcfg, tcfg = model()[:2]
    jparams = _randomize_tables(jconv.init_convnet(jax.random.PRNGKey(5),
                                                   jcfg), 6)
    tparams = to_port(jparams)
    before = {site: (t["mean"].clone(), t["var"].clone())
              for site, t in tcal._site_tables(tparams).items()}
    ptrs = [leaf.data_ptr() for leaf in jax.tree.leaves(tparams)]
    batches = [images(16, batch=4, seed=10 + i) for i in range(2)]
    want = jcal.calibrate_convnet(jparams, jcfg, [jnp.asarray(b)
                                                  for b in batches],
                                  jsn.enumerate_space(jcfg)[:2])
    got = tcal.calibrate_convnet(tparams, tcfg, batches,
                                 tsn.enumerate_space(tcfg)[:2])
    assert got is tparams
    assert [leaf.data_ptr() for leaf in jax.tree.leaves(got)] == ptrs
    wsites = jcal._site_tables(want)
    for site, t in tcal._site_tables(got).items():
        for key, old in zip(("mean", "var"), before[site]):
            w = np.asarray(wsites[site][key])
            np.testing.assert_allclose(
                t[key][:2].numpy(), w[:2], rtol=TOL,
                atol=TOL * max(float(np.abs(w[:2]).max()), 1.0),
                err_msg=f"{site} {key}")
            assert torch.equal(t[key][2:], old[2:]), (site, key)
            # both subnets are at depth 0.5: the sites of each stage's
            # second unit are not visited, and their rows stay
            visited = "u1." not in site
            assert torch.equal(t[key][:2], old[:2]) != visited, (site, key)


def test_calibrated_walk_equals_batch_statistics_walk():
    """Calibrated on one batch, the inference walk on that batch equals the
    batch-statistics walk for the calibrated subnets."""
    _, tcfg, _, tparams = model()
    params = jax.tree.map(lambda t: t.clone(), tparams)
    x = images(16, batch=4, seed=20)
    space = tsn.enumerate_space(tcfg)
    picked = [space[0], space[13], space[26]]
    tcal.calibrate_convnet(params, tcfg, [x], picked)
    for sub in picked:
        ctrl = tconv.make_conv_control(tcfg, sub)
        want, _ = tconv.convnet_forward(
            params, tcfg, x, ctrl, collect_stats=True,
            static_gates=tsn.stage_gates(tcfg, sub.depth_frac))
        assert_logits(tconv.convnet_forward(params, tcfg, x, ctrl),
                      want.numpy())


def test_norm_and_shared_bytes_equal_jax():
    _, _, jparams, tparams = model()
    assert tcal.norm_table_bytes(tparams) == jcal.norm_table_bytes(jparams)
    assert tcal.shared_weight_bytes(tparams) \
        == jcal.shared_weight_bytes(jparams)
    assert tcal.norm_table_bytes(tparams) > 0


def _conv_calls(monkeypatch, params, cfg, sub, size=16):
    calls = []
    real = torch.nn.functional.conv2d

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(torch.nn.functional, "conv2d", counted)
    tconv.convnet_forward(params, cfg, images(size),
                          tconv.make_conv_control(cfg, sub))
    monkeypatch.setattr(torch.nn.functional, "conv2d", real)
    return len(calls)


def test_gated_off_unit_calls_no_conv(monkeypatch):
    """LayerSelect on the host: at depth 0.5 each stage runs its first
    unit only (4 convs with the projection), at full depth both units
    (3 more each), and the stem's conv runs always."""
    _, tcfg, _, tparams = model()
    space = tsn.enumerate_space(tcfg)
    shallow = min(space, key=lambda s: s.depth_frac)
    deep = max(space, key=lambda s: s.depth_frac)
    assert _conv_calls(monkeypatch, tparams, tcfg, shallow) == 1 + 4 * 4
    assert _conv_calls(monkeypatch, tparams, tcfg, deep) == 1 + 4 * (4 + 3)


def test_same_padding_per_side():
    """XLA's "SAME": (0, 1) for a 3x3 stride-2 conv on an even size, (1, 1)
    on an odd one and at stride 1, none for a 1x1 conv."""
    assert tconv._same_pads(16, 3, 2) == (0, 1)
    assert tconv._same_pads(224, 3, 2) == (0, 1)
    assert tconv._same_pads(15, 3, 2) == (1, 1)
    assert tconv._same_pads(16, 3, 1) == (1, 1)
    assert tconv._same_pads(16, 1, 2) == (0, 0)
    assert tconv._same_pads(15, 1, 2) == (0, 0)


def test_fp32_products_restores_the_tf32_switches():
    _, tcfg, _, tparams = model()
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with tconv.fp32_products():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        tconv.convnet_forward(tparams, tcfg, images(16),
                              tconv.make_conv_control(
                                  tcfg, tsn.enumerate_space(tcfg)[0]))
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
