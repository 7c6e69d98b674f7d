"""The port's fleet router (``repro_torch.serving.fleet``) against JAX's.

The reference's own fixtures (``tests/test_fleet.py``): a smoke dense LM,
three chips built from ``PRNGKey(42)``, the trace from key 5, chip 0
killed mid-flight at tick 3, all on a virtual clock. The port's
``FleetRouter.build`` programs JAX's chips bit for bit (chip ``c`` from
``fold_in(key, c)`` through the RNG bridge), and the storm routes,
migrates, reprograms and stamps every record as the reference does.

Then the invariants the reference pins, held on the port: conservation,
the migration oracle (a migrated remainder is what a fresh single-slot
engine over the destination chip produces from the continuation), the
refreshed chip's identity, replicas of a JAX-saved artifact, config
validation with the reference's messages, router preconditions and
forced-refresh deferral.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import lm_init as j_lm_init
from repro_torch import clock as tclock
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.core import pcm as tpcm
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.core.engine import DriftSchedule
from repro_torch.models import lm as tlm
from repro_torch.models.common import ModelConfig as TModelConfig

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

S_MAX = 24
J_ACFG = JAnalogConfig().infer(b_adc=8, t_seconds=86400.0)
T_ACFG = TAnalogConfig().infer(b_adc=8, t_seconds=86400.0)
TRACE_KW = dict(rate=500.0, prompt_lens=(4, 8))
#: the fields of a FleetRecord the storm must reproduce exactly
RECORD_FIELDS = ("rid", "chips", "migrations", "arrival_t", "first_token_t",
                 "finish_t", "finished_by", "n_prompt")


def _bitwise(a: torch.Tensor, b) -> bool:
    want = np.asarray(b)
    return a.numpy().astype(want.dtype).tobytes() == want.tobytes()


def _jtrace(cfg, n=8, key=5, new_tokens=(6, 12)):
    return jserving.poisson_trace(jax.random.PRNGKey(key), n, vocab=cfg.vocab,
                                  new_tokens=new_tokens, **TRACE_KW)


def _ttrace(cfg, n=8, key=5, new_tokens=(6, 12)):
    return tserving.poisson_trace(prng.PRNGKey(key), n, vocab=cfg.vocab,
                                  new_tokens=new_tokens, **TRACE_KW)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(name="t", family="dense", n_kv_heads=2).smoke()
    tcfg = TModelConfig(name="t", family="dense", n_kv_heads=2).smoke()
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=j_lm_init(jax.random.PRNGKey(0), jcfg),
                tparams=tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu"))


@pytest.fixture(scope="module")
def storms(model):
    """The reference's storm, run by JAX and by the port: 3 chips, chip 0
    drained at tick 3, refreshed after 2 ticks down. Each side keeps its
    chips as built (the storm replaces chip 0's)."""
    jr = jserving.FleetRouter.build(
        model["jparams"], J_ACFG, model["jcfg"], jserving.ServingConfig(n_slots=2, s_max=S_MAX),
        jserving.FleetConfig(n_chips=3, refresh_steps=2), key=jax.random.PRNGKey(42),
        ref_params=model["jparams"], src_params=model["jparams"])
    tr = tserving.FleetRouter.build(
        model["tparams"], T_ACFG, model["tcfg"], tserving.ServingConfig(n_slots=2, s_max=S_MAX),
        tserving.FleetConfig(n_chips=3, refresh_steps=2), key=prng.PRNGKey(42),
        ref_params=model["tparams"], src_params=model["tparams"])
    built = dict(j=[e.program for e in jr.engines], t=[e.program for e in tr.engines])
    # the same storm through the async front end's deterministic driver, on
    # engines over the same chips
    front = tserving.AsyncFleetRouter(
        [tserving.ServingEngine.for_program(
            p, model["tcfg"], tserving.ServingConfig(n_slots=2, s_max=S_MAX),
            ref_params=model["tparams"], src_params=model["tparams"],
            rng=prng.fold_in(prng.PRNGKey(42), 10_000 + c), device="cpu")
         for c, p in enumerate(built["t"])],
        tserving.FleetConfig(n_chips=3, refresh_steps=2), rng=prng.PRNGKey(42),
        deterministic=True)
    jtrace, ttrace = _jtrace(model["jcfg"]), _ttrace(model["tcfg"])
    jrep = jr.run(jtrace, force_refresh={3: 0}, clock=jclock.VirtualClock(), max_ticks=2000)
    trep = tr.run(ttrace, force_refresh={3: 0}, clock=tclock.VirtualClock(), max_ticks=2000)
    arep = front.serve(ttrace, force_refresh={3: 0}, clock=tclock.VirtualClock(),
                       max_ticks=2000)
    return dict(jr=jr, tr=tr, built=built, jtrace=jtrace, ttrace=ttrace, jrep=jrep, trep=trep,
                arep=arep, front=front)


# ----------------------------------------------------------- port vs JAX


def test_build_programs_the_reference_chips_bitwise(storms):
    for c, (jp, tp) in enumerate(zip(storms["built"]["j"], storms["built"]["t"])):
        assert tp.chip_id == jp.chip_id == c
        assert set(tp.state) == set(jp.state)
        for path, st in tp.state.items():
            for name, v in st.items():
                assert _bitwise(v, jp.state[path][name]), (c, path, name)
        got = tstore._flatten(tp.params)
        for k, v in tstore._flatten(jp.params).items():
            assert _bitwise(got[k], v), (c, k)
    # every engine draws under fold_in(key, 10_000 + c)
    for c, e in enumerate(storms["tr"].engines):
        want = np.asarray(storms["jr"].engines[c].rng)
        assert np.array_equal(e.rng.numpy().astype(want.dtype), want), c


@pytest.mark.parametrize("router", ["sync", "async_deterministic"])
def test_storm_records_equal_the_reference(storms, router):
    """``FleetRouter.run`` and ``AsyncFleetRouter.serve(deterministic)``
    both replay the reference's storm: routing, migration, timestamps."""
    jrep, trep = storms["jrep"], storms["trep" if router == "sync" else "arep"]
    assert trep.n_ticks == jrep.n_ticks
    assert [r.rid for r in trep.records] == [r.rid for r in jrep.records]
    for t, j in zip(trep.records, jrep.records):
        assert np.array_equal(t.tokens, j.tokens), t.rid
        for f in RECORD_FIELDS:
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
    assert trep.n_migrated == jrep.n_migrated >= 1
    assert trep.summary() == jrep.summary()
    assert trep.events == jrep.events


def test_storm_events_and_refreshed_chip_equal_the_reference(storms):
    jrep, trep = storms["jrep"], storms["trep"]
    assert trep.events == jrep.events
    assert [e["kind"] for e in trep.events] == ["drain", "reprogram"]
    jp, tp = storms["jr"].engines[0].program, storms["tr"].engines[0].program
    assert tp.t_seconds == jp.t_seconds == tpcm.T_C
    for path, st in tp.state.items():
        for name, v in st.items():
            assert _bitwise(v, jp.state[path][name]), (path, name)
    got = tstore._flatten(tp.params)
    for k, v in tstore._flatten(jp.params).items():
        assert _bitwise(got[k], v), k
    # the refresh rewrote the chip: not the chip it built
    assert not torch.equal(tp.state["blocks/0/attn/wk"]["g_pos"],
                           storms["built"]["t"][0].state["blocks/0/attn/wk"]["g_pos"])


def test_window_agreements_and_top1_agree_with_the_reference(storms):
    """Each is a ratio of greedy-agreement counts: equal counts give equal
    ratios (tolerance 1e-12); an exact logit tie decided differently would
    move one by a whole decision."""
    jrep, trep = storms["jrep"], storms["trep"]
    assert [w["tick"] for w in trep.windows] == [w["tick"] for w in jrep.windows]
    assert [w["decisions"] for w in trep.windows] == [w["decisions"] for w in jrep.windows]
    assert [w["any_down"] for w in trep.windows] == [w["any_down"] for w in jrep.windows]
    np.testing.assert_allclose(trep.window_agreements, jrep.window_agreements, rtol=0, atol=1e-12)
    assert trep.counters["decisions"] == jrep.counters["decisions"]
    assert trep.counters["top1"] == pytest.approx(jrep.counters["top1"], abs=1e-12)
    assert trep.min_down_window_agreement == pytest.approx(jrep.min_down_window_agreement,
                                                           abs=1e-12)


# ------------------------------------------------- invariants on the port


def test_storm_conserves_every_request(storms):
    trace, rep = storms["ttrace"], storms["trep"]
    assert len(rep.records) == len(trace) == len({r.rid for r in rep.records})
    budget_of = {r.rid: r.max_new_tokens for r in trace}
    for rec in rep.records:
        assert rec.n_new == budget_of[rec.rid], rec.rid
    assert rep.program_events_delta == 0
    for rec in rep.records:
        assert np.array_equal(rep.tokens_of(rec.rid), rec.tokens)
    with pytest.raises(KeyError):
        rep.tokens_of(123456)


def test_storm_migrates_bit_identically(storms, model):
    """A migrated request's remainder equals a fresh single-slot engine
    over the destination chip serving the continuation alone; the
    continuation keeps the original arrival and the first chip's first
    token time, so latency and TTFT span both chips."""
    router, trace, rep = storms["tr"], storms["ttrace"], storms["trep"]
    by_rid = {r.rid: r for r in trace}
    migrated = [r for r in rep.records if r.migrations]
    assert migrated
    for rec in migrated:
        dest = rec.chips[-1]
        assert dest != 0
        req = by_rid[rec.rid]
        dest_rec = next(r for r in rep.per_chip[dest].records if r.rid == rec.rid)
        k = dest_rec.n_prompt - rec.n_prompt
        assert 0 < k < req.max_new_tokens
        remainder = np.asarray(dest_rec.tokens)
        assert np.array_equal(rec.tokens[k:], remainder)
        solo = tserving.ServingEngine.for_program(
            router.engines[dest].program, model["tcfg"],
            tserving.ServingConfig(n_slots=1, s_max=S_MAX), device="cpu")
        cont = tserving.Request(
            rid=900_000 + rec.rid,
            prompt=np.concatenate([req.prompt, rec.tokens[:k].astype(np.int32)]),
            max_new_tokens=req.max_new_tokens - k)
        assert np.array_equal(solo.run([cont]).tokens_of(cont.rid), remainder), rec.rid
        assert dest_rec.arrival_t == req.arrival_t
        assert rec.first_token_t == dest_rec.admit_t
        assert 0.0 <= rec.ttft_s <= rec.latency_s
        assert dest_rec.latency_s > rec.ttft_s


def test_refreshed_chip_rejoins_young_with_same_identity(storms):
    router, rep = storms["tr"], storms["trep"]
    kinds = [(e["kind"], e["chip"]) for e in rep.events]
    assert kinds.index(("drain", 0)) < kinds.index(("reprogram", 0))
    assert rep.reprograms == 1
    prog = router.engines[0].program
    assert prog.t_seconds == tpcm.T_C and prog.chip_id == 0
    assert router.engines[0].reprograms == 1
    assert rep.min_down_window_agreement is not None


def test_replicas_of_a_jax_artifact_serve_as_the_source_chip(model, tmp_path):
    """``from_program`` replicas of a chip JAX saved and the port loaded
    share its tensors and generate what the chip generates alone; a fleet
    of one is the single engine."""
    jprog = jengine.compile_program(model["jparams"], J_ACFG, jax.random.PRNGKey(7), chip_id=11)
    path = jstore.save_program(str(tmp_path / "chip"), jprog)
    loaded = tstore.load_program(path, params_like=model["tparams"], device="cpu")
    assert loaded.chip_id == 11
    scfg = tserving.ServingConfig(n_slots=2, s_max=S_MAX)
    router = tserving.FleetRouter.from_program(
        loaded, model["tcfg"], scfg, tserving.FleetConfig(n_chips=2), rng=prng.PRNGKey(1))
    assert [e.program.chip_id for e in router.engines] == [0, 1]
    w = router.engines[0].params.blocks[0]["attn"]["wq"]["w"]
    assert w.dtype == model["tcfg"].dtype
    for e in router.engines:  # nothing copied: every replica executes the same tensors
        assert e.params.blocks[0]["attn"]["wq"]["w"].data_ptr() == w.data_ptr()
        assert e.program.state is loaded.state
    trace = _ttrace(model["tcfg"], n=5, key=9, new_tokens=(3, 6))
    rep = router.run(trace, clock=tclock.VirtualClock(), max_ticks=2000)
    solo = tserving.ServingEngine.for_program(
        loaded, model["tcfg"], tserving.ServingConfig(n_slots=1, s_max=S_MAX), device="cpu")
    for r in trace:
        assert np.array_equal(rep.tokens_of(r.rid), solo.run([r]).tokens_of(r.rid)), r.rid
    one = tserving.FleetRouter.from_program(loaded, model["tcfg"], scfg,
                                            tserving.FleetConfig(n_chips=1))
    rep1 = one.run(trace, clock=tclock.VirtualClock(), max_ticks=2000)
    rep_solo = tserving.ServingEngine.for_program(loaded, model["tcfg"], scfg,
                                                  device="cpu").run(trace)
    for r in trace:
        assert np.array_equal(rep1.tokens_of(r.rid), rep_solo.tokens_of(r.rid)), r.rid


CONFIG_CASES = [
    ("FleetConfig", dict(n_chips=0)),
    ("FleetConfig", dict(n_chips=2, check_every=0)),
    ("FleetConfig", dict(n_chips=2, max_refreshing=0)),
    ("FleetConfig", dict(n_chips=2, refresh_steps=-1)),
    ("FleetConfig", dict(n_chips=2, agreement_slo=1.5)),
    ("FleetConfig", dict(n_chips=2, refresh_below=-0.1)),
    ("FleetConfig", dict(n_chips=2, refresh_below=0.5, max_refreshing=2)),
    ("FleetConfig", dict(n_chips=1, refresh_below=0.5)),
    ("AsyncConfig", dict(queue_cap=0)),
    ("AsyncConfig", dict(shed_policy="drop")),
    ("AsyncConfig", dict(workers=0)),
    ("AsyncConfig", dict(submit_timeout_s=-1.0)),
    ("AsyncConfig", dict(poll_s=0.0)),
]


@pytest.mark.parametrize("name,kw", CONFIG_CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.items()))}" for n, k in CONFIG_CASES])
def test_configs_refuse_as_the_reference(name, kw):
    with pytest.raises(ValueError) as want:
        getattr(jserving, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tserving, name)(**kw)
    assert str(got.value) == str(want.value)


def _digital_engine(model, **kw):
    return tserving.ServingEngine(model["tcfg"], TAnalogConfig(), model["tparams"],
                                  tserving.ServingConfig(n_slots=1, s_max=16), device="cpu",
                                  **kw)


def _req(rid=1):
    return tserving.Request(rid=rid, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2)


def test_router_preconditions(model, storms):
    e1 = _digital_engine(model)
    with pytest.raises(ValueError, match="n_chips=2"):
        tserving.FleetRouter([e1], tserving.FleetConfig(n_chips=2))
    other = tserving.ServingEngine(model["tcfg"], TAnalogConfig(), model["tparams"],
                                   tserving.ServingConfig(n_slots=2, s_max=16), device="cpu")
    with pytest.raises(ValueError, match="share one ServingConfig"):
        tserving.FleetRouter([e1, other], tserving.FleetConfig(n_chips=2))
    engines = [_digital_engine(model) for _ in range(2)]
    router = tserving.FleetRouter(engines, tserving.FleetConfig(n_chips=2))
    policy = tserving.DriftPolicy(schedule=DriftSchedule.parse("25,3600"), every_steps=2,
                                  refresh_below=0.5)
    with pytest.raises(ValueError, match="engine-local"):
        router.run([_req()], drift_policies=policy)
    with pytest.raises(ValueError, match="refresh needs"):
        router.run([_req()], force_refresh={1: 0})
    bad = tserving.FleetRouter(engines, tserving.FleetConfig(n_chips=2, refresh_below=0.5))
    with pytest.raises(ValueError, match="refresh needs"):
        bad.run([_req()])
    with pytest.raises(ValueError, match="unique"):
        router.run([_req(), _req()])
    with pytest.raises(ValueError, match="one drift policy per chip"):
        router.run([_req()], drift_policies=[None])
    # a programmed, refreshable fleet without the reference counters cannot
    # run the agreement trigger, and a forced schedule wide enough to drain
    # the last serving chip dies at serve time
    siblings = _siblings(storms, model)
    blind = tserving.FleetRouter(siblings, tserving.FleetConfig(n_chips=2, refresh_below=0.5))
    with pytest.raises(ValueError, match="reference"):
        blind.run([_req()])
    wide = tserving.FleetRouter(siblings, tserving.FleetConfig(n_chips=2, max_refreshing=2))
    with pytest.raises(ValueError, match="last serving chip"):
        wide.run([_req()], force_refresh={2: 0, 3: 1})


def _siblings(storms, model):
    """Two refreshable engines over the storm's chips 1 and 2 (src_params,
    no reference counters)."""
    return [tserving.ServingEngine.for_program(
        storms["tr"].engines[c].program, model["tcfg"],
        tserving.ServingConfig(n_slots=2, s_max=S_MAX), src_params=model["tparams"],
        device="cpu") for c in (1, 2)]


def test_forced_refresh_defers_until_eligible(storms, model):
    """A forced drain landing while the stagger cap is saturated re-queues
    to the next eligible tick and still reprograms its chip."""
    fleet = tserving.FleetRouter(
        _siblings(storms, model),
        tserving.FleetConfig(n_chips=2, refresh_steps=6, max_refreshing=1),
        rng=prng.PRNGKey(7))
    trace = _ttrace(model["tcfg"], n=8, key=11, new_tokens=(10, 16))
    rep = fleet.run(trace, force_refresh={3: 0, 4: 1}, clock=tclock.VirtualClock(),
                    max_ticks=2000)
    assert rep.reprograms == 2
    drains = [e for e in rep.events if e["kind"] == "drain"]
    assert [d["chip"] for d in drains] == [0, 1]
    rejoin0 = next(e for e in rep.events if e["kind"] == "reprogram" and e["chip"] == 0)
    assert drains[1]["tick"] >= rejoin0["tick"]
    assert len(rep.records) == len(trace)
    assert rep.program_events_delta == 0


def test_first_token_time_survives_retirement(model):
    eng = _digital_engine(model)
    req = dataclasses.replace(_req(7), arrival_t=1.0, first_token_t=1.25)
    rec = eng.run([req], clock=tclock.VirtualClock(start=2.0)).records[0]
    assert rec.admit_t == 1.25
    assert rec.ttft_s == pytest.approx(0.25)
