"""The paper's CNN path in the port against the reference, on the CPU.

AnalogNet-KWS and AnalogNet-VWW at their published widths (and the
depthwise ``KWS_BENCH_DW`` of the benchmarks):

* ``cnn_init`` from one key is the reference's weights bit for bit;
* ``compile_program(transforms=crossbar_transforms(cfg), with_mapping=True)``
  programs the reference's chip: every state tensor, effective weight and
  GDC scalar bitwise, the plans and the physical-array mapping equal;
* the walk order is part of the chip: the same tree with its keys sorted
  (as ``jax.tree.map`` returns it) programs another chip in both packages,
  and the bridge keeps the order it is given;
* ``cnn_apply`` on a programmed chip: each layer's outputs, fed the
  reference's input, within the repo's ADC tolerance model (max |diff| <=
  1.01 ADC steps per crossbar tile, < 1% of outputs more than half a step
  off: the two sum each fp32 dot product in another order); the whole
  forward's logits within a few ADC steps of the last layer, argmax equal
  except where the reference's top two logits lie within that difference;
* ``digital`` and keyed ``pcm_infer`` forwards (pcm_infer draws the
  reference's weights: the reference jitted, as its compiler fuses the
  draws' arithmetic);
* ``age_program`` to 24 h bitwise, without a programming event;
* artifacts with a mapping round-trip both ways, and ``params_like``
  takes ``cnn_init``'s 4D tree against the chip's 2D blocks (a rank
  change) while a same-rank mismatch is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from benchmarks.common import KWS_BENCH_DW as J_KWS_BENCH_DW
from repro.checkpoint import store as jstore
from repro.core import crossbar as jcrossbar
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.core.analog import AnalogCtx as JAnalogCtx
from repro.models import analognet as jan
from repro_torch import convert, prng
from repro_torch.bench.common import KWS_BENCH_DW
from repro_torch.checkpoint import store as tstore
from repro_torch.core import crossbar as tcrossbar
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.core.analog import AnalogCtx as TAnalogCtx
from repro_torch.models import analognet as tan

SEP = "::"
T_PROG = 25.0


def _jflat(tree) -> dict:
    return jstore._flatten(tree)


def _tflat(tree) -> dict:
    return {k: v.numpy() for k, v in tstore._flatten(tree).items()}


def _assert_trees_bitwise(jtree, ttree):
    want, got = _jflat(jtree), _tflat(ttree)
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if k.endswith(f"{SEP}key"):
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


def _configs(name):
    if name == "kws":
        return jan.analognet_kws_config(), tan.analognet_kws_config()
    if name == "vww":
        return jan.analognet_vww_config(), tan.analognet_vww_config()
    return J_KWS_BENCH_DW, KWS_BENCH_DW


def _program(name):
    jcfg, tcfg = _configs(name)
    jparams = jan.cnn_init(jax.random.PRNGKey(0), jcfg)
    tparams = tan.cnn_init(prng.PRNGKey(0), tcfg, device="cpu")
    jprog = jengine.compile_program(
        jparams, JAnalogConfig().infer(b_adc=8, t_seconds=T_PROG), jax.random.PRNGKey(1),
        transforms=jan.crossbar_transforms(jcfg), with_mapping=True)
    tprog = tengine.compile_program(
        tparams, TAnalogConfig().infer(b_adc=8, t_seconds=T_PROG), prng.PRNGKey(1),
        transforms=tan.crossbar_transforms(tcfg), with_mapping=True, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, jprog=jprog,
                tprog=tprog)


@pytest.fixture(scope="module")
def chips():
    return {name: _program(name) for name in ("kws", "vww", "dw")}


def _inputs(cfg, batch, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (batch,) + tuple(cfg.input_hw) + (cfg.in_channels,)).astype(np.float32)
    return x


@pytest.mark.parametrize("name", ["kws", "vww", "vww_bneck", "micronet"])
def test_cnn_init_is_the_references_weights(name):
    from repro.models import micronet as jmn
    from repro_torch.models import micronet as tmn

    jcfg, tcfg = {
        "kws": (jan.analognet_kws_config(), tan.analognet_kws_config()),
        "vww": (jan.analognet_vww_config(), tan.analognet_vww_config()),
        "vww_bneck": (jan.analognet_vww_config(True), tan.analognet_vww_config(True)),
        "micronet": (jmn.micronet_kws_s_config(), tmn.micronet_kws_s_config()),
    }[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jan.cnn_init(jax.random.PRNGKey(3), jcfg)
    tparams = tan.cnn_init(prng.PRNGKey(3), tcfg, device="cpu")
    assert list(jparams) == list(tparams)  # insertion order: the walk order
    _assert_trees_bitwise(jparams, tparams)


@pytest.mark.parametrize("name", ["kws", "vww", "dw"])
def test_compiled_chip_is_the_references(chips, name):
    c = chips[name]
    _assert_trees_bitwise(c["jprog"].params, c["tprog"].params)
    _assert_trees_bitwise(c["jprog"].state, c["tprog"].state)
    assert {p: (pl.k, pl.n, pl.spec.b_adc) for p, pl in c["jprog"].plans.items()} == {
        p: (pl.k, pl.n, pl.spec.b_adc) for p, pl in c["tprog"].plans.items()}
    assert list(c["tprog"].plans) == list(c["jprog"].plans)
    assert jcrossbar.mapping_to_dict(c["jprog"].mapping) == tcrossbar.mapping_to_dict(
        c["tprog"].mapping)
    for spec in c["tcfg"].convs:  # conv weights come back as their 2D blocks
        assert c["tprog"].params[spec.name]["w"].dim() == 2


def test_walk_order_is_part_of_the_chip():
    """``jax.tree.map`` sorts a dict's keys; for VWW the sorted order
    (b1_expand ... fc, head, stem) walks the layers in another order, so
    the same weights and key program a different chip, in both packages.
    The bridge keeps the order it is given: from ``cnn_init``'s own dict
    it programs the reference's chip."""
    jcfg, tcfg = jan.analognet_vww_config(), tan.analognet_vww_config()
    jparams = jan.cnn_init(jax.random.PRNGKey(0), jcfg)
    as_numpy = {k: (jax.tree.map(np.asarray, v) if isinstance(v, dict) else np.asarray(v))
                for k, v in jparams.items()}
    sorted_np = jax.tree.map(np.asarray, jparams)
    assert list(sorted_np) == sorted(jparams) != list(jparams)
    jkw = dict(transforms=jan.crossbar_transforms(jcfg))
    tkw = dict(transforms=tan.crossbar_transforms(tcfg), device="cpu")
    jcfg_a = JAnalogConfig().infer(b_adc=8, t_seconds=T_PROG)
    tcfg_a = TAnalogConfig().infer(b_adc=8, t_seconds=T_PROG)
    j_ordered = jengine.compile_program(jparams, jcfg_a, jax.random.PRNGKey(1), **jkw)
    j_sorted = jengine.compile_program(jax.tree.map(jnp.asarray, sorted_np), jcfg_a,
                                       jax.random.PRNGKey(1), **jkw)
    t_ordered = tengine.compile_program(convert.cnn_params_from_numpy(as_numpy, tcfg, "cpu"),
                                        tcfg_a, prng.PRNGKey(1), **tkw)
    t_sorted = tengine.compile_program(convert.cnn_params_from_numpy(sorted_np, tcfg, "cpu"),
                                       tcfg_a, prng.PRNGKey(1), **tkw)
    _assert_trees_bitwise(j_ordered.state, t_ordered.state)
    _assert_trees_bitwise(j_sorted.state, t_sorted.state)
    a = np.asarray(j_ordered.state["stem"]["g_pos"])
    b = np.asarray(j_sorted.state["stem"]["g_pos"])
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_cnn_bridge_refuses_another_model():
    jparams = jan.cnn_init(jax.random.PRNGKey(0), jan.analognet_kws_config())
    tree = {k: (jax.tree.map(np.asarray, v) if isinstance(v, dict) else np.asarray(v))
            for k, v in jparams.items()}
    with pytest.raises(ValueError, match="do not match 'analognet_vww'"):
        convert.cnn_params_from_numpy(tree, tan.analognet_vww_config(), "cpu")
    flat = {k: np.asarray(v) for k, v in jstore._flatten(jparams).items()}
    _assert_trees_bitwise(jparams, convert.cnn_params_from_numpy(
        flat, tan.analognet_kws_config(), "cpu"))


def _step(p, b_adc: int) -> float:
    r = abs(float(np.asarray(p["r_adc"]))) + 1e-9
    return r / (2 ** (b_adc - 1) - 1) * float(np.asarray(p["out_scale_buf"]))


def _within_adc_tolerance(got, want, step: float, n_tiles: int = 1):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1.01 * step * n_tiles, (d.max() / step)
    assert (d > 0.5 * step).mean() < 0.01, (d > 0.5 * step).mean()


@pytest.mark.parametrize("name,batch", [("kws", 2), ("vww", 1), ("dw", 4)])
def test_programmed_forward_within_adc_tolerance(chips, name, batch):
    c = chips[name]
    jp, tp = c["jprog"].params, c["tprog"].params
    jctx = JAnalogCtx(cfg=c["jprog"].cfg, gain_s=jp["gain_s"])
    tctx = TAnalogCtx(cfg=c["tprog"].cfg, gain_s=tp["gain_s"])
    x = _inputs(c["jcfg"], batch)
    for jspec, tspec in zip(c["jcfg"].convs, c["tcfg"].convs):
        # every layer on the reference's own input: its ADC outputs alone
        want = jan.conv_apply(jp[jspec.name], jnp.asarray(x), jspec, jctx, relu=False)
        got = tan.conv_apply(tp[tspec.name], torch.from_numpy(x.copy()), tspec, tctx,
                             relu=False)
        _within_adc_tolerance(got.numpy(), want, _step(jp[jspec.name], 8),
                              -(-tp[tspec.name]["w"].shape[0] // 1024))
        x = np.asarray(jax.nn.relu(want))
    # the FC alone: a config without convs over the pooled input
    pooled = x.mean(axis=(1, 2))
    jcfg0 = dataclasses.replace(c["jcfg"], convs=(), input_hw=(1, 1),
                                in_channels=c["jcfg"].fc_width)
    tcfg0 = dataclasses.replace(c["tcfg"], convs=(), input_hw=(1, 1),
                                in_channels=c["tcfg"].fc_width)
    want = jan.cnn_apply(jp, jnp.asarray(pooled[:, None, None, :]), c["jprog"].cfg, jcfg0)
    got = tan.cnn_apply(tp, torch.from_numpy(pooled[:, None, None, :].copy()),
                        c["tprog"].cfg, tcfg0)
    fc_step = _step(jp["fc"], 8)
    _within_adc_tolerance(got.numpy(), want, fc_step)
    # the whole forward: errors cascade through the layers
    x = _inputs(c["jcfg"], batch)
    want = np.asarray(jan.cnn_apply(jp, jnp.asarray(x), c["jprog"].cfg, c["jcfg"]))
    got = tan.cnn_apply(tp, torch.from_numpy(x), c["tprog"].cfg, c["tcfg"]).numpy()
    assert got.shape == want.shape == (batch, c["jcfg"].n_classes)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= 4 * fc_step, d.max() / fc_step
    for row in range(batch):
        a, b = int(np.argmax(got[row])), int(np.argmax(want[row]))
        assert a == b or want[row, b] - want[row, a] <= d[row].max(), row


@pytest.mark.parametrize("name", ["kws", "dw"])
def test_digital_and_keyed_pcm_infer_forwards(chips, name):
    c = chips[name]
    x = _inputs(c["jcfg"], 2, seed=1)
    want = np.asarray(jan.cnn_apply(c["jparams"], jnp.asarray(x), JAnalogConfig(), c["jcfg"]))
    got = tan.cnn_apply(c["tparams"], torch.from_numpy(x), TAnalogConfig(), c["tcfg"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    jcfg_a = JAnalogConfig().infer(b_adc=8, t_seconds=86400.0)
    tcfg_a = TAnalogConfig().infer(b_adc=8, t_seconds=86400.0)
    fwd = jax.jit(lambda p, x, k: jan.cnn_apply(p, x, jcfg_a, c["jcfg"], rng=k))
    events = tengine.program_event_count()
    want = np.asarray(fwd(c["jparams"], jnp.asarray(x), jax.random.PRNGKey(5)))
    got = tan.cnn_apply(c["tparams"], torch.from_numpy(x), tcfg_a, c["tcfg"],
                        rng=prng.PRNGKey(5)).numpy()
    assert tengine.program_event_count() - events == len(c["tcfg"].convs) + 1
    # the weights are the reference's draws; the MVMs sum in another order
    d = np.abs(got - want)
    step = (1.0 + 1e-9) / 127
    assert d.max() <= 8 * step, d.max() / step
    with pytest.raises(ValueError, match="requires a key"):
        tan.cnn_apply(c["tparams"], torch.from_numpy(x), tcfg_a, c["tcfg"])


def test_age_program_to_24h_bitwise(chips):
    c = chips["vww"]
    jaged = jengine.age_program(c["jprog"], 86400.0)
    events = tengine.program_event_count()
    taged = tengine.age_program(c["tprog"], 86400.0)
    assert tengine.program_event_count() == events
    _assert_trees_bitwise(jaged.params, taged.params)
    assert taged.age_history == jaged.age_history == (T_PROG, 86400.0)
    assert taged.mapping is c["tprog"].mapping


def test_artifacts_with_a_mapping_round_trip_both_ways(chips, tmp_path):
    c = chips["kws"]
    # the port's artifact, read by the reference (which takes no template
    # for plain-dict models) and by the port against cnn_init's 4D tree
    tpath = tstore.save_program(str(tmp_path / "port"), c["tprog"])
    jload = jstore.load_program(tpath)
    _assert_trees_bitwise(jload.params, c["tprog"].params)
    assert jcrossbar.mapping_to_dict(jload.mapping) == tcrossbar.mapping_to_dict(
        c["tprog"].mapping)
    tload = tstore.load_program(tpath, params_like=c["tparams"], device="cpu")
    assert isinstance(tload.mapping, tcrossbar.Mapping)
    assert tcrossbar.mapping_to_dict(tload.mapping) == tcrossbar.mapping_to_dict(
        c["tprog"].mapping)
    _assert_trees_bitwise(c["jprog"].params, tload.params)
    _assert_trees_bitwise(c["jprog"].state, tload.state)
    # the reference's artifact, read by the port
    jpath = jstore.save_program(str(tmp_path / "ref"), c["jprog"])
    tload = tstore.load_program(jpath, params_like=c["tparams"], device="cpu")
    _assert_trees_bitwise(c["jprog"].params, tload.params)
    assert tcrossbar.mapping_to_dict(tload.mapping) == jcrossbar.mapping_to_dict(
        c["jprog"].mapping)
    x = torch.from_numpy(_inputs(c["jcfg"], 1))
    assert torch.equal(tan.cnn_apply(tload.params, x, tload.cfg, c["tcfg"]),
                       tan.cnn_apply(c["tprog"].params, x, c["tprog"].cfg, c["tcfg"]))
    # a same-rank mismatch is still refused
    other = tan.cnn_init(prng.PRNGKey(0), dataclasses.replace(
        c["tcfg"], n_classes=10), device="cpu")
    with pytest.raises(ValueError, match="2 with mismatched shapes"):
        tstore.load_program(tpath, params_like=other, device="cpu")
