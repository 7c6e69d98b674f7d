"""Port parity: the MoE family (``repro_torch.models.moe``, expert banks in
``core.engine`` and ``checkpoint.store``, MoE serving).

* ``_topk_routing`` fed JAX's gates gives the reference's expert indices,
  slots, keep masks and gate values bitwise; the port's copies of
  ``tests/test_moe.py`` (einsum == scatter dispatch to rtol 1e-4 / atol
  1e-5 at capacity factors 8 and 1, capacity respected, a starved capacity
  finite).
* ``moe_apply`` against the reference on the same numpy inputs, both
  dispatches: digital, on a bank JAX programmed (``tile_rows=32``: every
  family spans several crossbar tiles) and in ``analog_train`` with quant
  noise, within ``atol=1e-4`` (the f32 matmuls sum in other orders; an ADC
  code flip would move an output by a step, r_adc / 127 ~ 8e-3, and none
  does at this size). The reference vmaps one expert over the bank, so its
  experts share each family's key; so do the port's.
* Expert banks programmed on the llama4-maverick smoke LM (a bank with a
  shared expert and a digital router beside it, interleaved with dense
  blocks): params and state bitwise JAX's, with a bank-level
  ``b_adc_overrides`` and ``resample_read_noise``; aged in place bitwise;
  the artifact in both directions bitwise; the shared expert programmed,
  the router untouched (the port's copy of ``tests/test_engine.py``'s
  test).
* Serving: at ``tests/test_serving.py``'s MoE config (capacity factor 8)
  the port's engine serves JAX's tokens from JAX's chip, rectangular and
  paged (solo prefill); the serving CLIs print the same summary and tokens
  for phi3.5-moe's smoke config.
"""

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.core.analog import AnalogCtx as JAnalogCtx
from repro.launch import serve as jserve
from repro.models import ModelConfig as JModelConfig
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import clock as tclock
from repro_torch import convert, prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.core.analog import AnalogCtx as TAnalogCtx
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ModelConfig as TModelConfig

from test_torch_traces import numpy_trace

SEP = "::"
TRAIN = dict(eta=0.1, b_adc=6, quant_noise_p=0.5)


def _flat_bitwise(jtree, ttree, keys_as_uint32=False):
    want = jstore._flatten(jtree)
    got = {k: v.numpy() for k, v in tstore._flatten(ttree).items()}
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if keys_as_uint32 and k.endswith(f"{SEP}key"):
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("g,sg,e,k,cap", [(2, 32, 4, 2, 3), (4, 16, 8, 2, 2), (2, 8, 16, 1, 1)])
def test_topk_routing_bitwise_on_jax_gates(g, sg, e, k, cap):
    logits = np.random.default_rng(g * sg + e).standard_normal((g, sg, e)).astype(np.float32)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    want = jmoe._topk_routing(jnp.asarray(gates), k, cap)
    got = tmoe._topk_routing(torch.from_numpy(gates.copy()), k, cap)
    for w_list, g_list in zip(want, got, strict=True):
        for w, t in zip(w_list, g_list, strict=True):
            assert np.array_equal(t.numpy(), np.asarray(w))


def _tsetup(cf=8.0, e=8, k=2):
    cfg = TModelConfig(family="moe", n_experts=e, top_k=k, d_model=32, d_ff=64,
                       capacity_factor=cf, moe_groups=2)
    p = tmoe.moe_init(prng.PRNGKey(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 32)).astype(np.float32))
    ctx = TAnalogCtx(cfg=TAnalogConfig(), gain_s=torch.tensor(1.0))
    return cfg, p, x, ctx


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_scatter_equals_einsum_dispatch(cf):
    cfg, p, x, ctx = _tsetup(cf=cf)
    y_e = tmoe.moe_apply(p, x, ctx, cfg)
    y_s = tmoe.moe_apply(p, x, ctx, dataclasses.replace(cfg, moe_dispatch="scatter"))
    np.testing.assert_allclose(y_e.numpy(), y_s.numpy(), rtol=1e-4, atol=1e-5)


def test_topk_routing_respects_capacity():
    gates = torch.softmax(torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 32, 4)).astype(np.float32)), -1)
    idxs, poss, keeps, _ = tmoe._topk_routing(gates, 2, cap=3)
    for idx, pos, keep in zip(idxs, poss, keeps):
        assert (pos[keep] < 3).all()
        for gi in range(2):
            pairs = [(int(a), int(b)) for a, b, c in zip(idx[gi], pos[gi], keep[gi]) if c]
            assert len(pairs) == len(set(pairs))


def test_capacity_drops_tokens_when_tight():
    cfg, p, x, ctx = _tsetup(cf=0.25)  # deliberately starved
    assert torch.isfinite(tmoe.moe_apply(p, x, ctx, cfg)).all()


# ---------------------------------------------------------------- moe_apply


@pytest.fixture(scope="module")
def bank():
    kw = dict(family="moe", n_experts=4, top_k=2, d_model=64, d_ff=96, capacity_factor=1.25,
              moe_groups=2, shared_expert=True)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jp = {"moe": jmoe.moe_init(jax.random.PRNGKey(0), jcfg)}
    tp = {"moe": tmoe.moe_init(prng.PRNGKey(0), tcfg)}
    acfg = dict(tile_rows=32)
    jprog = jengine.compile_program(jp, JAnalogConfig(**acfg).infer(b_adc=8),
                                    jax.random.PRNGKey(3))
    tprog = tengine.compile_program(tp, TAnalogConfig(**acfg).infer(b_adc=8), prng.PRNGKey(3),
                                    device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jprog=jprog, tprog=tprog, x=x)


def test_moe_init_and_bank_program_bitwise(bank):
    _flat_bitwise(bank["jp"], bank["tp"])
    _flat_bitwise(bank["jprog"].params, bank["tprog"].params)
    _flat_bitwise(bank["jprog"].state, bank["tprog"].state, keys_as_uint32=True)
    assert bank["tprog"].params["moe"]["out_scale_buf"].shape == (3, 4)
    assert sorted(bank["tprog"].plans) == sorted(bank["jprog"].plans)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("mode", ["digital", "pcm_programmed", "analog_train"])
def test_moe_apply_matches_reference(bank, mode, dispatch):
    jcfg = dataclasses.replace(bank["jcfg"], moe_dispatch=dispatch)
    tcfg = dataclasses.replace(bank["tcfg"], moe_dispatch=dispatch)
    if mode == "pcm_programmed":
        jp, jac, tp, tac = (bank["jprog"].params["moe"], bank["jprog"].cfg,
                            bank["tprog"].params["moe"], bank["tprog"].cfg)
    elif mode == "digital":
        jp, jac, tp, tac = bank["jp"]["moe"], JAnalogConfig(), bank["tp"]["moe"], TAnalogConfig()
    else:
        jp, jac = bank["jp"]["moe"], JAnalogConfig(tile_rows=32).train(**TRAIN)
        tp, tac = bank["tp"]["moe"], TAnalogConfig(tile_rows=32).train(**TRAIN)
    keyed = mode == "analog_train"
    jctx = JAnalogCtx(cfg=jac, gain_s=jnp.float32(1.0),
                      key=jax.random.PRNGKey(5) if keyed else None)
    tctx = TAnalogCtx(cfg=tac, gain_s=torch.tensor(1.0), key=prng.PRNGKey(5) if keyed else None)
    want = jmoe.moe_apply(jp, jnp.asarray(bank["x"]), jctx, jcfg)
    got = tmoe.moe_apply(tp, torch.from_numpy(bank["x"]), tctx, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    if keyed:  # the same draws: the key counters end together
        assert tctx.layer_counter == jctx.layer_counter > 0


def test_shared_expert_and_router_handled(bank):
    """The port's copy of the reference's test: the bank match does not
    swallow its siblings, and drift_to keeps walking the shared expert."""
    node, src = bank["tprog"].params["moe"], bank["tp"]["moe"]
    for fam in ("w1", "w3", "w2"):
        assert "out_scale_buf" in node["shared"][fam]
        assert not torch.equal(node["shared"][fam]["w"], src["shared"][fam]["w"])
        assert f"moe/shared/{fam}" in bank["tprog"].plans
    assert torch.equal(node["router"]["w"], src["router"]["w"])
    aged = bank["tprog"].drift_to(365 * 86400.0)
    assert not torch.equal(aged.params["moe"]["shared"]["w1"]["w"], node["shared"]["w1"]["w"])


# ---------------------------------------------------------------- programs


@pytest.fixture(scope="module")
def maverick():
    jcfg, tcfg = j_get_smoke("llama4-maverick-400b-a17b"), t_get_smoke("llama4-maverick-400b-a17b")
    assert jlm.block_period(jcfg) == tlm.block_period(tcfg) == ["attn", "moe"]
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp)


def test_lm_init_and_bridge_bitwise(maverick, chips):
    _flat_bitwise(maverick["jp"], maverick["tp"])
    bridged = convert.params_from_numpy(jax.tree.map(np.asarray, maverick["jp"]),
                                        maverick["tcfg"], device="cpu")
    _flat_bitwise(maverick["jp"], bridged)
    with pytest.raises(ValueError, match="expert banks"):
        convert.params_from_numpy(jax.tree.map(np.asarray, maverick["jp"]),
                                  dataclasses.replace(maverick["tcfg"], n_experts=8),
                                  device="cpu")
    # JAX params through the bridge program the port's chip bitwise JAX's
    jprog = chips[0]
    tprog = tengine.compile_program(
        bridged, TAnalogConfig(tile_rows=32, resample_read_noise=True).infer(
            b_adc=8, t_seconds=3600.0),
        prng.PRNGKey(42), b_adc_overrides={"blocks/1/moe": 6}, device="cpu")
    _flat_bitwise(jprog.params, tprog.params)
    _flat_bitwise(jprog.state, tprog.state, keys_as_uint32=True)


@pytest.fixture(scope="module")
def chips(maverick):
    """maverick's smoke LM programmed by both packages from one key, with
    a bank-level bitwidth and ``resample_read_noise``."""
    kw = dict(tile_rows=32, resample_read_noise=True)
    overrides = {"blocks/1/moe": 6}
    jprog = jengine.compile_program(
        maverick["jp"], JAnalogConfig(**kw).infer(b_adc=8, t_seconds=3600.0),
        jax.random.PRNGKey(42), b_adc_overrides=overrides)
    before = tengine.program_event_count()
    tprog = tengine.compile_program(
        maverick["tp"], TAnalogConfig(**kw).infer(b_adc=8, t_seconds=3600.0),
        prng.PRNGKey(42), b_adc_overrides=overrides, device="cpu")
    return jprog, tprog, tengine.program_event_count() - before


def test_bank_programmed_aged_overridden_saved_bitwise(maverick, chips, tmp_path):
    jprog, tprog, events = chips
    assert events == len(jprog.plans)
    _flat_bitwise(jprog.params, tprog.params)
    _flat_bitwise(jprog.state, tprog.state, keys_as_uint32=True)
    bank = tprog.params.blocks[1]["moe"]
    assert bank["b_adc_buf"].shape == (1, 4, 6) and bank["out_scale_buf"].shape == (1, 3, 4)
    assert set(bank["read_buf"]) == {"w1", "w3", "w2"}
    assert tengine.plan_bit_overrides(tprog) == jengine.plan_bit_overrides(jprog)
    assert tengine.plan_bit_overrides(tprog)["blocks/1/moe"] == 6
    # aged in place, bitwise
    jaged, taged = jengine.age_program(jprog, 86400.0), tengine.age_program(tprog, 86400.0)
    _flat_bitwise(jaged.params, taged.params)
    # the port saves, JAX loads; JAX saves, the port loads
    tstore.save_program(str(tmp_path / "port"), taged)
    jloaded = jstore.load_program(str(tmp_path / "port"), params_like=maverick["jp"])
    _flat_bitwise(jloaded.params, taged.params)
    _flat_bitwise(jloaded.state, taged.state, keys_as_uint32=True)
    jstore.save_program(str(tmp_path / "jax"), jaged)
    tloaded = tstore.load_program(str(tmp_path / "jax"), params_like=maverick["tp"],
                                  device="cpu")
    _flat_bitwise(jaged.params, tloaded.params)
    _flat_bitwise(jaged.state, tloaded.state, keys_as_uint32=True)
    assert tloaded.plans.keys() == jaged.plans.keys()
    _flat_bitwise(jengine.age_program(jaged, 30 * 86400.0).params,
                  tengine.age_program(tloaded, 30 * 86400.0).params)


# ---------------------------------------------------------------- serving


def _serving_cfg(module):
    cfg = module(name="t", family="moe", n_layers=2, n_experts=4, top_k=2).smoke()
    return dataclasses.replace(cfg, capacity_factor=8.0)


def test_moe_serving_tokens_match_reference(tmp_path):
    jcfg, tcfg = _serving_cfg(JModelConfig), _serving_cfg(TModelConfig)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jprog = jengine.compile_program(jparams, JAnalogConfig(tile_rows=32).infer(b_adc=6),
                                    jax.random.PRNGKey(7))
    jstore.save_program(str(tmp_path / "chip"), jprog)
    trace = numpy_trace(3, 5, vocab=tcfg.vocab, rate=400.0, prompt_lens=(4, 8),
                        new_tokens=(3, 6))
    jtrace = [jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                               arrival_t=r.arrival_t) for r in trace]
    jrep = jserving.ServingEngine.for_program(
        jprog, jcfg, jserving.ServingConfig(n_slots=2, s_max=32),
        ref_params=jparams).run(jtrace, clock=jclock.VirtualClock())
    template = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    tprog = tstore.load_program(str(tmp_path / "chip"), params_like=template, device="cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for extra in ({}, dict(paged=True, page_size=4, prefill_batch=4)):
        trep = tserving.ServingEngine.for_program(
            tprog, tcfg, tserving.ServingConfig(n_slots=2, s_max=32, **extra),
            ref_params=tparams, device="cpu").run(trace, clock=tclock.VirtualClock())
        assert trep.n_requests == jrep.n_requests == len(trace)
        for r in trace:
            assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), (extra, r.rid)
        assert trep.counters["decisions"] == jrep.counters["decisions"]


def _summary_and_tokens(out: str):
    summary = re.search(r"^serving: .*requests=(\d+) tokens=(\d+) steps=(\d+)", out, re.M)
    tokens = re.search(r"^generated token ids \(longest request\): (.*)$", out, re.M)
    assert summary and tokens, out
    return summary.groups(), tokens.group(1)


def test_cli_tokens_match_the_reference(capsys, monkeypatch):
    argv = ["--arch", "phi3.5-moe-42b-a6.6b", "--analog", "--request-trace", "3", "--batch",
            "2", "--prompt-len", "8", "--tokens", "6"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    jout = capsys.readouterr()
    tserve.main(["--device", "cpu", *argv])
    tout = capsys.readouterr()
    assert _summary_and_tokens(tout.out) == _summary_and_tokens(jout.out)
    assert "MoE capacity routing pools tokens" in tout.err
    assert _rejects(argv + ["--fused-decode"])


def _rejects(argv) -> bool:
    results = []
    for module in (tserve, jserve):
        ap = module.build_parser()
        try:
            module.validate_args(ap, ap.parse_args(argv))
            results.append(False)
        except SystemExit:
            results.append(True)
    assert results[0] == results[1]
    return results[0]


def test_refresh_and_resampled_read_noise_as_the_reference(maverick, chips):
    """A bank's refresh (``launch/steps.py::refresh_program``: a new chip
    with the program's bitwidths) bitwise JAX's, and a forward of a
    ``resample_read_noise`` chip -- each family's read noise redrawn for
    the whole bank from the call's key -- within ``atol=1e-4`` of JAX's."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps as tsteps

    jprog, tprog, _ = chips
    jfresh = jsteps.refresh_program(jprog, maverick["jp"], jax.random.PRNGKey(9))
    tfresh = tsteps.refresh_program(tprog, maverick["tp"], prng.PRNGKey(9))
    _flat_bitwise(jfresh.params, tfresh.params)
    _flat_bitwise(jfresh.state, tfresh.state, keys_as_uint32=True)
    toks = np.random.default_rng(6).integers(0, maverick["jcfg"].vocab, (2, 10)).astype(np.int32)
    want, _ = jlm.lm_forward(jprog.params, {"tokens": jnp.asarray(toks)}, jprog.cfg,
                             maverick["jcfg"], rng=jax.random.PRNGKey(10))
    got, _ = tlm.lm_forward(tprog.params, {"tokens": torch.from_numpy(toks).long()}, tprog.cfg,
                            maverick["tcfg"], rng=prng.PRNGKey(10))
    frozen, _ = tlm.lm_forward(tprog.params, {"tokens": torch.from_numpy(toks).long()},
                               tprog.cfg, maverick["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert not torch.equal(got, frozen)  # the draws were fresh
