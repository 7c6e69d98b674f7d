"""Port parity: the fused programmed decode (``repro_torch.kernels.decode_fused``).

A smoke tinyllama chip (2 layers, d 64, ``tile_rows=32`` so every
projection spans several crossbar tiles) programmed by JAX and saved as an
artifact is loaded by the port; port-only checks also program port chips.

* ``build_fused_plan`` accepts and rejects exactly what the reference does.
* The stacked-cache helpers and the scalar table are bitwise the reference's.
* ``decode_fused_ref`` (the fused step's plain version, what a CPU tensor
  runs) is BITWISE the port's per-layer ``lm_forward`` decode -- logits and
  every cache row -- in f32 and bf16, at b_adc 4/6/8 and mixed overrides,
  including a slot that steps past ``s_max`` (the clamped write).
* Against JAX ``fused_decode_step`` and JAX's unfused decode: logits and
  cache rows within ``atol=1e-4`` and identical greedy tokens (the
  frameworks sum f32 matmuls in different orders; the JAX fused kernel is
  itself one ulp off its own unfused decode on this tree, so nothing here
  holds the port bitwise to it).
* The port's fused ServingEngine serves the reference engines' tokens and
  counters on one VirtualClock trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.kernels import decode_fused as jdf
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch import convert
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels.ref import decode_fused_ref
from repro_torch.models import lm as tlm
from repro_torch.models.attention import KVCache

from test_torch_traces import numpy_trace

S = 16
S_MAX = 48



@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_get_smoke("tinyllama-1.1b")
    tcfg = t_get_smoke("tinyllama-1.1b")
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jprog = jengine.compile_program(
        jparams, JAnalogConfig(tile_rows=32).infer(b_adc=6), jax.random.PRNGKey(7)
    )
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams, jprog=jprog,
        tparams=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu"),
        tprog=tstore.load_program(path, device="cpu"),
    )


# ------------------------------------------------------------ (a) the plan


def _mutate(program, kind):
    """The same edit on a reference or a port program."""
    params = program.params
    block = dict(params.blocks[0])
    if kind == "ok":
        return program
    if kind == "use_kernel":
        return dataclasses.replace(
            program, cfg=dataclasses.replace(program.cfg, use_kernel=True))
    if kind == "missing_head_plan":
        plans = {k: v for k, v in program.plans.items() if k != "lm_head"}
        return dataclasses.replace(program, plans=plans)
    if kind == "tail_plan":
        plans = dict(program.plans)
        plans["tail/0/attn/wq"] = plans["blocks/0/attn/wq"]
        return dataclasses.replace(program, plans=plans)
    if kind == "extras_plan_ignored":
        plans = dict(program.plans)
        plans["extras/proj"] = plans["lm_head"]
        return dataclasses.replace(program, plans=plans)
    if kind in ("bias", "no_out_scale"):
        attn = dict(block["attn"])
        wq = dict(attn["wq"])
        if kind == "bias":
            wq["b"] = wq["out_scale_buf"]
        else:
            del wq["out_scale_buf"]
        attn["wq"] = wq
        block["attn"] = attn
        return dataclasses.replace(
            program, params=params._replace(blocks=(block,)))
    if kind == "no_head_out_scale":
        head = {k: v for k, v in params.lm_head.items() if k != "out_scale_buf"}
        return dataclasses.replace(program, params=params._replace(lm_head=head))
    if kind == "no_blocks":
        return dataclasses.replace(program, params=params._replace(blocks=()))
    raise AssertionError(kind)


def _outcome(build, program):
    try:
        plan = build(program)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", plan.n_groups,
            [(p.k, p.n, p.spec.b_adc, p.tile_rows, p.per_tile_adc)
             for p in plan.proj_plans + (plan.head_plan,)])


@pytest.mark.parametrize("kind", [
    "ok", "use_kernel", "missing_head_plan", "tail_plan",
    "extras_plan_ignored", "bias", "no_out_scale", "no_head_out_scale",
    "no_blocks",
])
def test_build_fused_plan_accepts_and_rejects_as_reference(setup, kind):
    j = _outcome(jengine.build_fused_plan, _mutate(setup["jprog"], kind))
    t = _outcome(tengine.build_fused_plan, _mutate(setup["tprog"], kind))
    assert t == j
    assert (t[0] == "ok") == (kind in ("ok", "extras_plan_ignored"))


def test_fused_engine_guards(setup):
    s = setup
    with pytest.raises(ValueError, match="CiMProgram"):
        tserving.ServingEngine(
            s["tcfg"], TAnalogConfig(), s["tparams"],
            tserving.ServingConfig(n_slots=2, s_max=S, fused_decode=True),
            device="cpu",
        )
    with pytest.raises(ValueError, match="use_kernel"):
        tserving.ServingEngine.for_program(
            _mutate(s["tprog"], "use_kernel"), s["tcfg"],
            tserving.ServingConfig(n_slots=2, s_max=S, fused_decode=True),
            device="cpu",
        )
    fplan = tengine.build_fused_plan(s["tprog"])
    resample = dataclasses.replace(s["tprog"].cfg, resample_read_noise=True)
    # a key with a resampling config but no read buffers serves the frozen
    # weights: the same logits as the step without a key
    steps = [
        tdf.fused_decode_step(
            s["tprog"].params, torch.zeros((1, 1), dtype=torch.long),
            tdf.init_fused_cache(s["tcfg"], fplan.n_groups, 1, S, s["tcfg"].dtype,
                                 device="cpu"),
            fplan, s["tcfg"], acfg, rng=rng,
        )[0]
        for acfg, rng in ((resample, prng.PRNGKey(0)), (s["tprog"].cfg, None))
    ]
    assert torch.equal(*steps)


# ------------------------------------------- (b, c) cache helpers and table


def _jax_prefill(s, prompt, cache_s):
    c = jlm.init_lm_cache(s["jcfg"], 1, cache_s, s["jcfg"].dtype)
    _, c = jlm.lm_forward(s["jprog"].params, {"tokens": jnp.asarray(prompt)[None]},
                          s["jprog"].cfg, s["jcfg"], cache=c, last_token_only=True)
    return jlm.unstack_cache(c)


def _port_src(jsrc):
    """The port's list-layout prefill cache holding the same values."""
    groups, _ = jsrc
    return ([(KVCache(*(torch.from_numpy(np.array(t)) for t in g[0])),)
             for g in groups], ())


def test_fused_slot_helpers_bitwise_the_reference(setup):
    s = setup
    n_groups = s["tcfg"].n_layers
    jc = jdf.init_fused_cache(s["jcfg"], n_groups, 3, S, s["jcfg"].dtype)
    tc = tdf.init_fused_cache(s["tcfg"], n_groups, 3, S, s["tcfg"].dtype, device="cpu")
    for slot, n in ((1, 5), (0, 9), (2, 3)):
        src = _jax_prefill(s, (np.arange(n) * 11 + slot) % s["jcfg"].vocab, S)
        jc = jdf.write_fused_slot(jc, src, slot)
        tc = tdf.write_fused_slot(tc, _port_src(src), slot)
    jc = jdf.reset_fused_slot(jc, 1)
    tc = tdf.reset_fused_slot(tc, 1)
    for jt, tt in zip(jc, tc):
        assert tt.dtype == convert.to_tensor(np.asarray(jt), "cpu").dtype
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc.length.tolist() == [9, 0, 3]


def test_scalar_table_bitwise_the_reference(setup):
    n_groups = setup["tcfg"].n_layers
    jtab = np.asarray(jdf._scalar_table(setup["jprog"].params, n_groups))
    ttab = tdf._scalar_table(setup["tprog"].params, n_groups)
    assert ttab.shape == (n_groups + 1, 7, 3) and ttab.dtype == torch.float32
    np.testing.assert_array_equal(ttab.numpy(), jtab)


# ------------------------- (d) the plain version IS the per-layer decode


def _port_walk(program, cfg, prompts, cur, n_steps, cache_s):
    """Prefill ``prompts`` into a per-slot list cache and a fused cache,
    then decode ``n_steps`` greedy steps on both paths, asserting logits
    and every K/V row bitwise equal at each step."""
    params = tengine.cast_weights(program.params, cfg.dtype)
    acfg = program.cfg
    fplan = tengine.build_fused_plan(program)
    ucache = tlm.init_lm_cache(cfg, len(prompts), cache_s, cfg.dtype,
                               stacked=False, per_slot=True, device="cpu")
    fcache = tdf.init_fused_cache(cfg, fplan.n_groups, len(prompts), cache_s,
                                  cfg.dtype, device="cpu")
    for slot, p in enumerate(prompts):
        c = tlm.init_lm_cache(cfg, 1, cache_s, cfg.dtype, stacked=False,
                              device="cpu")
        _, c = tlm.lm_forward(params, {"tokens": torch.as_tensor(p)[None].long()},
                              acfg, cfg, cache=c, last_token_only=True)
        ucache = tlm.write_cache_slot(ucache, c, slot)
        fcache = tdf.write_fused_slot(fcache, c, slot)
    dec = tdf.FusedDecoder(params, fplan, cfg, acfg, len(prompts), cache_s)
    calls = decode_fused_ref.calls
    for _ in range(n_steps):
        ul, ucache = tlm.lm_forward(params, {"tokens": cur}, acfg, cfg, cache=ucache)
        fl, fcache = dec.step(cur, fcache)
        assert fl.dtype == ul.dtype == cfg.dtype
        assert torch.equal(fl, ul)
        for g, (c,) in enumerate(ucache[0]):
            assert torch.equal(fcache.k[g], c.k) and torch.equal(fcache.v[g], c.v)
        assert torch.equal(fcache.length, ucache[0][0][0].length)
        cur = ul[:, -1].argmax(-1)[:, None]
    assert decode_fused_ref.calls == calls + n_steps
    return fcache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b_adc,overrides", [
    (4, None), (6, None), (8, None),
    (8, {"blocks/0/attn/*": 4, "blocks/0/ffn/w2": 6}),
], ids=["b4", "b6", "b8", "mixed"])
def test_decode_fused_ref_bitwise_the_per_layer_decode(dtype, b_adc, overrides):
    cfg = dataclasses.replace(t_get_smoke("tinyllama-1.1b"), dtype=dtype)
    params = tlm.lm_init(prng.PRNGKey(b_adc), cfg, device="cpu")
    program = tengine.compile_program(
        params, TAnalogConfig(tile_rows=32).infer(b_adc=b_adc),
        prng.PRNGKey(1), b_adc_overrides=overrides, device="cpu",
    )
    fplan = tengine.build_fused_plan(program)
    if overrides:
        assert [p.spec.b_adc for p in fplan.proj_plans] == [4, 4, 4, 4, 8, 8, 6]
    rng = np.random.default_rng(b_adc)
    # the 14-token prompt's slot reaches s_max and keeps stepping: its third
    # row lands on the clamped last position, as in the per-layer path
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (4, 14, 7)]
    before = kernel.analog_mvm.launches
    fcache = _port_walk(program, cfg, prompts,
                        torch.tensor([[3], [5], [7]]), 3, S)
    assert fcache.length.tolist() == [7, 17, 10]
    assert kernel.analog_mvm.launches == before


# ------------------------------------- (e) against the reference's decode


def test_decode_fused_ref_matches_reference_fused_and_unfused(setup):
    s = setup
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jprog, tprog = s["jprog"], s["tprog"]
    jplan = jengine.build_fused_plan(jprog)
    tplan = tengine.build_fused_plan(tprog)
    prompts = [np.array([3, 5, 7, 9]), np.array([11, 13, 17, 19, 23])]
    ju = jlm.init_lm_cache(jcfg, 2, S, jcfg.dtype, stacked=False, per_slot=True)
    jf = jdf.init_fused_cache(jcfg, jplan.n_groups, 2, S, jcfg.dtype)
    tf = tdf.init_fused_cache(tcfg, tplan.n_groups, 2, S, tcfg.dtype, device="cpu")
    for slot, p in enumerate(prompts):
        src = _jax_prefill(s, p, S)
        ju = jlm.write_cache_slot(ju, src, slot)
        jf = jdf.write_fused_slot(jf, src, slot)
        tf = tdf.write_fused_slot(tf, _port_src(src), slot)
    dec = tdf.FusedDecoder(tprog.params, tplan, tcfg, tprog.cfg, 2, S)
    cur = np.array([[4], [6]], np.int32)
    for _ in range(3):
        ul, ju = jlm.lm_forward(jprog.params, {"tokens": jnp.asarray(cur)},
                                jprog.cfg, jcfg, cache=ju)
        fl, jf = jdf.fused_decode_step(jprog.params, jnp.asarray(cur), jf, jplan,
                                       jcfg, jprog.cfg)
        tl, tf = dec.step(torch.from_numpy(cur).long(), tf)
        for want in (np.asarray(ul), np.asarray(fl)):
            np.testing.assert_allclose(tl.numpy(), want, atol=1e-4, rtol=0)
            assert np.array_equal(tl.numpy()[:, -1].argmax(-1), want[:, -1].argmax(-1))
        for g in range(tplan.n_groups):
            for side in ("k", "v"):
                want = np.asarray(getattr(jf, side)[g])
                np.testing.assert_allclose(getattr(tf, side)[g].numpy(), want,
                                           atol=1e-4, rtol=0)
        assert tf.length.tolist() == np.asarray(jf.length).tolist()
        cur = np.asarray(ul)[:, -1].argmax(-1).astype(np.int32)[:, None]


# ---------------------------------------------- (f) the serving engine


def test_fused_engine_serves_the_reference_tokens(setup):
    s = setup
    trace = numpy_trace(
        5, 5, vocab=s["tcfg"].vocab, rate=400.0,
        prompt_lens=(4, 8, 12), new_tokens=(3, 8),
    )
    jtrace = [jserving.Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens,
                               arrival_t=r.arrival_t) for r in trace]
    jreps = [
        jserving.ServingEngine.for_program(
            s["jprog"], s["jcfg"],
            jserving.ServingConfig(n_slots=3, s_max=S_MAX, fused_decode=fused),
            ref_params=s["jparams"],
        ).run(jtrace, clock=jclock.VirtualClock())
        for fused in (False, True)
    ]
    before = kernel.analog_mvm.launches, tdf.launches, tengine.program_event_count()
    calls = decode_fused_ref.calls
    trep = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"],
        tserving.ServingConfig(n_slots=3, s_max=S_MAX, fused_decode=True),
        ref_params=s["tparams"], device="cpu",
    ).run(trace, clock=tclock.VirtualClock())
    assert (kernel.analog_mvm.launches, tdf.launches,
            tengine.program_event_count()) == before
    assert decode_fused_ref.calls == calls + trep.n_steps
    assert trep.program_events_delta == 0
    for jrep in jreps:
        for r in trace:
            assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), r.rid
        assert trep.n_steps == jrep.n_steps
        assert trep.counters["decisions"] == jrep.counters["decisions"]
        assert abs(trep.counters["top1"] - jrep.counters["top1"]) <= 1e-5
        assert abs(trep.counters["logit_mse"] - jrep.counters["logit_mse"]) <= 1e-5
    assert trep.peak_kv_bytes == jreps[1].peak_kv_bytes
