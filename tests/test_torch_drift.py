"""The drift lifecycle of the port against the reference's.

``CiMProgram.drift_to`` and ``engine.age_program`` along the paper's Fig. 7
ages, bitwise against JAX; transitivity on unsharded chips (aging through
intermediate ages gives the chip aged directly, as
``tests/test_drift_lifecycle.py`` pins for the reference); zero programming
events; ``resample_read`` key for key against the reference's compiled
function; the ``pcm_infer`` forward; ``DriftSchedule``/``device_age``; and
a serving engine that ages and refreshes its chip under a ``DriftPolicy``,
per layer and fused, with and without resampled read noise, against the
reference engine on the same trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import clock as jclock
from repro import serving as jserving
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core import pcm as jpcm
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core import pcm as tpcm
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.kernels import decode_fused as tdf
from repro_torch.models import lm as tlm

FIG7 = tuple(jpcm.FIG7_TIMES.values())


def _bitwise(jtree, ttree):
    want = {k: np.asarray(v) for k, v in tstore._flatten(jtree).items()}
    got = {k: v.numpy() for k, v in tstore._flatten(ttree).items()}
    assert set(want) == set(got)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def chips():
    jcfg, tcfg = j_get_smoke("tinyllama-1.1b"), t_get_smoke("tinyllama-1.1b")
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tparams = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    kw = dict(tile_rows=32, resample_read_noise=True)
    jprog = jengine.compile_program(jparams, JAnalogConfig(**kw).infer(b_adc=6, t_seconds=25.0),
                                    jax.random.PRNGKey(42))
    tprog = tengine.compile_program(tparams, TAnalogConfig(**kw).infer(b_adc=6, t_seconds=25.0),
                                    prng.PRNGKey(42), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, jprog=jprog, tprog=tprog)


@pytest.mark.parametrize("t", (FIG7[1], FIG7[3], 12_345.678), ids=lambda t: jpcm.format_age(t))
def test_drift_to_and_age_program_bitwise(chips, t):
    before = tengine.program_event_count()
    taged = tengine.age_program(chips["tprog"], t)
    assert tengine.program_event_count() == before  # aging programs nothing
    jaged = jengine.age_program(chips["jprog"], t)
    _bitwise(jaged.params, taged.params)
    assert taged.age_history == jaged.age_history == (25.0, float(t))
    assert taged.t_seconds == float(t)
    _bitwise(chips["jprog"].drift_to(t).params, chips["tprog"].drift_to(t).params)


def test_drift_is_transitive_on_an_unsharded_chip(chips):
    prog = chips["tprog"]
    stepped = prog
    for t in FIG7[1:3]:
        stepped = tengine.age_program(stepped, t)
    direct = tengine.age_program(prog, FIG7[2])
    for a, b in zip(tstore._flatten(stepped.params).values(),
                    tstore._flatten(direct.params).values()):
        assert torch.equal(a, b)
    assert stepped.age_history == (25.0,) + FIG7[1:3]
    # the state never changes: drift only re-evaluates the frozen devices
    for path, st in stepped.state.items():
        for name, v in st.items():
            assert torch.equal(v, prog.state[path][name]), (path, name)


def test_age_program_refuses_a_reprogramming_drift(chips, monkeypatch):
    bad = lambda self, t: (tengine.record_program_event(), self)[1]
    monkeypatch.setattr(tengine.CiMProgram, "drift_to", bad)
    with pytest.raises(RuntimeError, match="reprogrammed"):
        tengine.age_program(chips["tprog"], 3600.0)


def test_resample_read_key_for_key(chips):
    path = "blocks/0/attn/wk"
    jbuf = jax.tree.map(lambda a: a[0], chips["jprog"].params.blocks[0]["attn"]["wk"]["read_buf"])
    tbuf = {k: v[0] for k, v in chips["tprog"].params.blocks[0]["attn"]["wk"]["read_buf"].items()}
    resample = jax.jit(jengine.resample_read)
    for i in range(4):
        jk = jax.random.fold_in(jax.random.PRNGKey(5), i)
        want = np.asarray(resample(jk, jbuf))
        got = tengine.resample_read(prng.fold_in(prng.PRNGKey(5), i), tbuf).numpy()
        assert np.array_equal(want, got), path
    # the stacked form draws over the whole stack with one key
    jstack = chips["jprog"].params.lm_head["read_buf"]
    tstack = chips["tprog"].params.lm_head["read_buf"]
    assert np.array_equal(np.asarray(resample(jax.random.PRNGKey(1), jstack)),
                          tengine.resample_read(prng.PRNGKey(1), tstack).numpy())


def test_keyed_forward_resamples_as_the_reference(chips):
    """A forward with a key redraws every layer's read noise under the
    reference's per-group ``fold_in`` keys; without one the frozen chip
    executes."""
    toks = np.random.default_rng(0).integers(0, chips["tcfg"].vocab, (2, 5))
    fwd = jax.jit(lambda p, t, r: jlm.lm_forward(p, {"tokens": t}, chips["jprog"].cfg,
                                                 chips["jcfg"], rng=r)[0])
    tparams = tengine.cast_weights(chips["tprog"].params, chips["tcfg"].dtype)
    for rng in (None, 0, 7):
        jl = fwd(chips["jprog"].params, jnp.asarray(toks),
                 None if rng is None else jax.random.PRNGKey(rng))
        tl, _ = tlm.lm_forward(tparams, {"tokens": torch.as_tensor(toks)}, chips["tprog"].cfg,
                               chips["tcfg"], rng=None if rng is None else prng.PRNGKey(rng))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).mean() > 0.9


def test_pcm_infer_forward(chips):
    """Per-call simulation: every MVM programs, drifts and reads its layer
    afresh from the call's key (one programming event per MVM)."""
    toks = np.random.default_rng(1).integers(0, chips["tcfg"].vocab, (2, 4))
    jcfg_a = JAnalogConfig(tile_rows=32).infer(b_adc=8, t_seconds=86400.0)
    tcfg_a = TAnalogConfig(tile_rows=32).infer(b_adc=8, t_seconds=86400.0)
    jl = jax.jit(lambda p, t, r: jlm.lm_forward(p, {"tokens": t}, jcfg_a, chips["jcfg"], rng=r)[0])(
        chips["jparams"], jnp.asarray(toks), jax.random.PRNGKey(3))
    before = tengine.program_event_count()
    tl, _ = tlm.lm_forward(chips["tparams"], {"tokens": torch.as_tensor(toks)}, tcfg_a,
                           chips["tcfg"], rng=prng.PRNGKey(3))
    # one event per MVM: 2 groups x 7 projections + the lm_head
    assert tengine.program_event_count() - before == 15
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="requires a key"):
        tlm.lm_forward(chips["tparams"], {"tokens": torch.as_tensor(toks)}, tcfg_a, chips["tcfg"])


def test_simulate_weights_bitwise():
    w = np.random.default_rng(2).standard_normal((48, 40)).astype(np.float32) * 0.4
    simulate = jax.jit(jpcm.simulate_weights)
    for t in (25.0, 86400.0):
        jw, jg = simulate(jax.random.PRNGKey(4), w, np.float32(t))
        tw, tg = tpcm.simulate_weights(prng.PRNGKey(4), torch.from_numpy(w), t)
        assert np.array_equal(np.asarray(jw), tw.numpy()) and np.asarray(jg) == tg.numpy()


def test_drift_schedule_and_device_age_match_the_reference():
    for text in ("fig7", "25,3600,86400", " 30, 100 "):
        j, t = jengine.DriftSchedule.parse(text), tengine.DriftSchedule.parse(text)
        assert t.times == j.times and t.labels == j.labels and len(t) == len(j)
    assert tengine.DriftSchedule.fig7().times == jengine.DriftSchedule.fig7().times
    assert (tengine.DriftSchedule.log_spaced(1, 1e6, 5).times
            == jengine.DriftSchedule.log_spaced(1, 1e6, 5).times)
    for bad in ("", "10,5", "nan", "3600,25", "abc"):
        with pytest.raises(ValueError):
            jengine.DriftSchedule.parse(bad)
        with pytest.raises(ValueError):
            tengine.DriftSchedule.parse(bad)
    for args in ((3600.0, None), (3600.0, 3000.0), (86400.0, 3600.0), (100.0, 90.0)):
        assert tengine.device_age(*args) == jengine.device_age(*args)


@pytest.mark.parametrize("fused,resample", [(False, False), (True, True)],
                         ids=["per_layer", "fused_resample"])
def test_engine_drift_policy_matches_the_reference(chips, fused, resample):
    """One continuous run ages the chip between decode steps and refreshes
    it when the segment's agreement drops: the same tokens, age events,
    refresh count and counters as the reference engine."""
    prog_j, prog_t = chips["jprog"], chips["tprog"]
    if not resample:
        prog_j = dataclasses.replace(prog_j, cfg=dataclasses.replace(prog_j.cfg, resample_read_noise=False))
        prog_t = dataclasses.replace(prog_t, cfg=dataclasses.replace(prog_t.cfg, resample_read_noise=False))
    trace = tserving.poisson_trace(prng.PRNGKey(7), 5, vocab=chips["tcfg"].vocab, rate=200.0,
                                   prompt_lens=(3, 6), new_tokens=(3, 6))
    sched = dict(every_steps=3, refresh_below=0.9)
    jrep = jserving.ServingEngine.for_program(
        prog_j, chips["jcfg"], jserving.ServingConfig(n_slots=2, s_max=16, fused_decode=fused),
        ref_params=chips["jparams"], src_params=chips["jparams"], rng=jax.random.PRNGKey(3),
    ).run([jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            arrival_t=r.arrival_t) for r in trace],
          drift_policy=jserving.DriftPolicy(jengine.DriftSchedule.fig7(), **sched),
          clock=jclock.VirtualClock())
    eng = tserving.ServingEngine.for_program(
        prog_t, chips["tcfg"], tserving.ServingConfig(n_slots=2, s_max=16, fused_decode=fused),
        ref_params=chips["tparams"], src_params=chips["tparams"], rng=prng.PRNGKey(3),
        device="cpu",
    )
    trep = eng.run(trace, drift_policy=tserving.DriftPolicy(tengine.DriftSchedule.fig7(), **sched),
                   clock=tclock.VirtualClock())
    for r in trace:
        assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), r.rid
    strip = lambda evs: [{k: (round(v, 6) if isinstance(v, float) else v) for k, v in e.items()}
                         for e in evs]
    assert strip(trep.age_events) == strip(jrep.age_events)
    assert trep.reprograms == jrep.reprograms and trep.program_events_delta == 0
    assert trep.counters["decisions"] == jrep.counters["decisions"]
    assert abs(trep.counters["logit_mse"] - jrep.counters["logit_mse"]) <= 1e-6
    assert eng.program.t_seconds == jrep.age_events[-1]["t_device"] or trep.reprograms
    # the engine serves the chip it was last given: the fused decoder's
    # params and GDC table are the aged (or refreshed) program's
    if fused:
        assert eng.decoder.params is eng.params
        n_groups = eng.params.blocks[0]["attn"]["wq"]["w"].shape[0]
        assert torch.equal(eng.decoder.tab, tdf._scalar_table(eng.params, n_groups))
