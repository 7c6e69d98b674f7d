"""The port's program phase against the reference's, key for key.

``engine.compile_program(params, cfg, key)`` on the smoke tinyllama is
held bitwise against JAX's host ``compile_program`` on the same key: every
state tensor (conductance pairs, read-noise Q factors, weight scales,
det-summed GDC numerators, member keys) and every programmed param
(effective weights, GDC scalars, bitwidth buffers, read buffers), at
b_adc 4, 6 and 8, with per-layer overrides and with
``resample_read_noise``. ``lm_init`` from the same key gives the
reference's weights. Artifacts round-trip both ways, bitwise, and both
packages refuse an artifact that does not fit the model with the same
message.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

SEP = "::"


def _jflat(tree) -> dict:
    return jstore._flatten(tree)


def _tflat(tree) -> dict:
    return {k: v.numpy() for k, v in tstore._flatten(tree).items()}


def _assert_trees_bitwise(jtree, ttree, keys_as_uint32=False):
    want, got = _jflat(jtree), _tflat(ttree)
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if keys_as_uint32 and k.endswith(f"{SEP}key"):
            assert g.dtype == np.int64
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_smoke("tinyllama-1.1b")
    tcfg = t_get_smoke("tinyllama-1.1b")
    return jcfg, tcfg, jlm.lm_init(jax.random.PRNGKey(0), jcfg), tlm.lm_init(
        prng.PRNGKey(0), tcfg, device="cpu")


def test_lm_init_is_the_references_weights(models):
    _, _, jparams, tparams = models
    _assert_trees_bitwise(jparams, tparams)


def test_lm_init_with_a_tail_layer():
    jcfg = dataclasses.replace(j_get_smoke("tinyllama-1.1b"), n_layers=3)
    tcfg = dataclasses.replace(t_get_smoke("tinyllama-1.1b"), n_layers=3)
    _assert_trees_bitwise(jlm.lm_init(jax.random.PRNGKey(5), jcfg),
                          tlm.lm_init(prng.PRNGKey(5), tcfg, device="cpu"))


@pytest.mark.parametrize("b_adc,overrides,resample", [
    (4, None, False), (6, None, False), (8, None, False),
    (8, {"blocks/*/ffn/*": 4, "lm_head": 6}, False),
    (8, None, True),
], ids=["b4", "b6", "b8", "overrides", "resample"])
def test_compile_program_bitwise(models, b_adc, overrides, resample):
    _, _, jparams, tparams = models
    kw = dict(tile_rows=32, resample_read_noise=resample)
    jprog = jengine.compile_program(
        jparams, JAnalogConfig(**kw).infer(b_adc=b_adc, t_seconds=3600.0),
        jax.random.PRNGKey(42), b_adc_overrides=overrides, chip_id=3,
    )
    before = tengine.program_event_count()
    tprog = tengine.compile_program(
        tparams, TAnalogConfig(**kw).infer(b_adc=b_adc, t_seconds=3600.0),
        prng.PRNGKey(42), b_adc_overrides=overrides, chip_id=3, device="cpu",
    )
    assert tengine.program_event_count() - before == len(jprog.plans)
    _assert_trees_bitwise(jprog.params, tprog.params)
    _assert_trees_bitwise(jprog.state, tprog.state, keys_as_uint32=True)
    assert dataclasses.asdict(tprog.cfg) == dataclasses.asdict(jprog.cfg)
    assert tprog.age_history == jprog.age_history and tprog.chip_id == 3
    for path, jp in jprog.plans.items():
        tp = tprog.plans[path]
        assert (tp.k, tp.n, tp.spec.b_adc) == (jp.k, jp.n, jp.spec.b_adc)
    assert tengine.plan_bit_overrides(tprog) == jengine.plan_bit_overrides(jprog)


def test_program_for_serving_and_refresh_bitwise(models):
    _, _, jparams, tparams = models
    jprog = jsteps.program_for_serving(
        jparams, JAnalogConfig(tile_rows=32).infer(b_adc=6), jax.random.PRNGKey(1),
        b_adc_overrides={"lm_head": 8}, t_seconds=86400.0,
    )
    tprog = tsteps.program_for_serving(
        tparams, TAnalogConfig(tile_rows=32).infer(b_adc=6), prng.PRNGKey(1),
        b_adc_overrides={"lm_head": 8}, t_seconds=86400.0,
    )
    _assert_trees_bitwise(jprog.params, tprog.params)
    jfresh = jsteps.refresh_program(jprog, jparams, jax.random.fold_in(jax.random.PRNGKey(43), 1))
    tfresh = tsteps.refresh_program(tprog, tparams, prng.fold_in(prng.PRNGKey(43), 1))
    assert tfresh.t_seconds == jfresh.t_seconds == 25.0
    _assert_trees_bitwise(jfresh.params, tfresh.params)
    _assert_trees_bitwise(jfresh.state, tfresh.state, keys_as_uint32=True)


def test_artifacts_round_trip_both_ways(models, tmp_path):
    _, _, jparams, tparams = models
    cfg = dict(tile_rows=32, resample_read_noise=True)
    tprog = tengine.compile_program(tparams, TAnalogConfig(**cfg).infer(b_adc=6),
                                    prng.PRNGKey(9), b_adc_overrides={"lm_head": 8},
                                    chip_id=1, device="cpu")
    tprog = tengine.age_program(tprog, 3600.0)
    # the port saves, JAX loads: the same arrays and metadata
    tstore.save_program(str(tmp_path / "port"), tprog)
    jloaded = jstore.load_program(str(tmp_path / "port"), params_like=jparams)
    _assert_trees_bitwise(jloaded.params, tprog.params)
    _assert_trees_bitwise(jloaded.state, tprog.state, keys_as_uint32=True)
    assert jloaded.age_history == tprog.age_history and jloaded.chip_id == 1
    # ... and JAX ages it to the port's chip at a later age
    jaged = jengine.age_program(jloaded, 86400.0)
    taged = tengine.age_program(tprog, 86400.0)
    _assert_trees_bitwise(jaged.params, taged.params)
    # JAX saves, the port loads and ages
    jstore.save_program(str(tmp_path / "jax"), jaged)
    tloaded = tstore.load_program(str(tmp_path / "jax"), params_like=tparams, device="cpu")
    _assert_trees_bitwise(jaged.params, tloaded.params)
    _assert_trees_bitwise(jaged.state, tloaded.state, keys_as_uint32=True)
    assert tloaded.age_history == jaged.age_history
    _assert_trees_bitwise(jengine.age_program(jaged, 30 * 86400.0).params,
                          tengine.age_program(tloaded, 30 * 86400.0).params)


def test_load_program_refuses_another_model_with_the_references_message(tmp_path):
    jcfg4 = dataclasses.replace(j_get_smoke("tinyllama-1.1b"), n_layers=4)
    jprog = jengine.compile_program(jlm.lm_init(jax.random.PRNGKey(0), jcfg4),
                                    JAnalogConfig(tile_rows=32).infer(), jax.random.PRNGKey(42))
    path = str(tmp_path / "four_layers")
    jstore.save_program(path, jprog)
    jtemplate = jlm.lm_init(jax.random.PRNGKey(0), j_get_smoke("tinyllama-1.1b"))
    ttemplate = tlm.lm_init(prng.PRNGKey(0), t_get_smoke("tinyllama-1.1b"), device="cpu")
    with pytest.raises(ValueError) as jerr:
        jstore.load_program(path, params_like=jtemplate)
    with pytest.raises(ValueError) as terr:
        tstore.load_program(path, params_like=ttemplate, device="cpu")
    assert "does not match the model" in str(terr.value)
    assert str(terr.value) == str(jerr.value)
    # a missing leaf is refused too
    arrays = dict(np.load(f"{path}/arrays.npz"))
    del arrays["params::final_norm::scale"]
    np.savez(f"{path}/arrays.npz", **arrays)
    with pytest.raises(ValueError, match="1 template leaves absent"):
        tstore.load_program(path, params_like=ttemplate, device="cpu")


def test_compile_program_refusals(models):
    _, _, _, tparams = models
    cfg = TAnalogConfig().infer()
    key = prng.PRNGKey(0)
    # sharded programming exists (tests/test_torch_distributed.py); an
    # empty shardings tree names no mesh
    with pytest.raises(ValueError, match="holds no leaf"):
        tengine.compile_program(tparams, cfg, key, device="cpu", shardings={})
    # a kernel of more than one stack dim needs its transforms= entry (a conv
    # kernel's im2col block); with it, the block is what gets programmed
    conv = {"gain_s": torch.ones(()), "c": {"w": torch.ones((3, 3, 2, 4)), "r_adc": torch.ones(()),
                                             "w_clip_buf": torch.tensor([-1.0, 1.0])}}
    with pytest.raises(ValueError, match="transforms= entry"):
        tengine.compile_program(conv, cfg, key, device="cpu")
    prog = tengine.compile_program(conv, cfg, key, device="cpu", with_mapping=True,
                                   transforms={"c": lambda w: w.reshape(18, 4)})
    assert prog.params["c"]["w"].shape == (18, 4) and prog.mapping.n_arrays == 1
    assert torch.equal(key, prng.PRNGKey(0))
