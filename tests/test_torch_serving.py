"""Port parity: continuous-batching serving (repro_torch.serving).

One JAX-programmed artifact and one request trace, built once from numpy,
are served by the reference's ServingEngine and the port's under virtual
clocks. Per-request greedy tokens are identical; the digital-reference
agreement counters match within 1e-5 (f32 logits summed in different
orders); the port's continuous batching equals serving each request alone.
"""

import jax
import numpy as np
import pytest
import torch

from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch import convert
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.kernels import analog_mvm as kernel

from test_torch_traces import numpy_trace

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
    trace = numpy_trace(
        11, 6, vocab=tcfg.vocab, rate=400.0,
        prompt_lens=(4, 8, 12), new_tokens=(3, 10),
    )
    return dict(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams, jprog=jprog,
        tparams=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu"),
        tprog=tstore.load_program(path, device="cpu"),
        trace=trace,
        jtrace=[jserving.Request(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens,
                                 arrival_t=r.arrival_t) for r in trace],
    )


def test_port_serves_the_reference_tokens_and_counters(setup):
    s = setup
    jrep = jserving.ServingEngine.for_program(
        s["jprog"], s["jcfg"], jserving.ServingConfig(n_slots=3, s_max=S_MAX),
        ref_params=s["jparams"],
    ).run(s["jtrace"], clock=jclock.VirtualClock())
    before = (kernel.analog_mvm.launches, tengine.program_event_count())
    trep = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=3, s_max=S_MAX),
        ref_params=s["tparams"], device="cpu",
    ).run(s["trace"], clock=tclock.VirtualClock())
    assert (kernel.analog_mvm.launches, tengine.program_event_count()) == before
    assert trep.n_requests == jrep.n_requests == len(s["trace"])
    assert trep.program_events_delta == 0
    for r in s["trace"]:
        assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), r.rid
    assert trep.counters["decisions"] == jrep.counters["decisions"]
    assert abs(trep.counters["top1"] - jrep.counters["top1"]) <= 1e-5
    assert abs(trep.counters["logit_mse"] - jrep.counters["logit_mse"]) <= 1e-5
    assert "top1_agreement" in trep.summary()


def test_bridge_trace_differs_from_the_reference_only_at_a_tie(setup):
    """The known fault of PERF.md section 7, kept in view: the port's fp32
    execute phase is not bitwise XLA's (XLA fuses some dequantizing
    multiplies into the tile sum), and on the trace ``poisson_trace`` draws
    through the bridge from key 11 one greedy token flips where two logits
    tie exactly. Every request but that one keeps the reference's tokens;
    the flipped one agrees up to the tie. This fails once the execute phase
    is bitwise XLA's: the test then becomes plain token equality."""
    import jax.numpy as jnp

    from repro_torch import prng

    s = setup
    trace = tserving.poisson_trace(
        prng.PRNGKey(11), 6, vocab=s["tcfg"].vocab, rate=400.0,
        prompt_lens=(4, 8, 12), new_tokens=(3, 10),
    )
    jtrace = [jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                               arrival_t=r.arrival_t) for r in trace]
    jrep = jserving.ServingEngine.for_program(
        s["jprog"], s["jcfg"], jserving.ServingConfig(n_slots=3, s_max=S_MAX),
        ref_params=s["jparams"],
    ).run(jtrace, clock=jclock.VirtualClock())
    trep = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=3, s_max=S_MAX),
        ref_params=s["tparams"], device="cpu",
    ).run(trace, clock=tclock.VirtualClock())
    flipped = [r.rid for r in trace
               if not np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid))]
    assert flipped == [1]
    got, want = trep.tokens_of(1).tolist(), jrep.tokens_of(1).tolist()
    d = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    # the reference's own forward over the prompt and the agreed prefix:
    # the two tokens' logits are equal and the largest
    toks = np.concatenate([trace[1].prompt, want[:d]]).astype(np.int32)[None]
    logits, _ = jlm.lm_forward(s["jprog"].params, {"tokens": jnp.asarray(toks)},
                               s["jprog"].cfg, s["jcfg"])
    last = np.asarray(logits[0, -1], np.float32)
    assert last[got[d]] == last[want[d]] == last.max()


def test_continuous_equals_solo_and_static(setup):
    s = setup
    served = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=3, s_max=S_MAX),
        device="cpu",
    )
    rep = served.run(s["trace"], clock=tclock.VirtualClock())
    static = served.run(s["trace"], scheduler=tserving.StaticBatchScheduler(),
                        clock=tclock.VirtualClock())
    solo = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=1, s_max=S_MAX),
        device="cpu",
    )
    for r in s["trace"]:
        alone = solo.run([r], clock=tclock.VirtualClock()).tokens_of(r.rid)
        assert np.array_equal(alone, rep.tokens_of(r.rid)), r.rid
        assert np.array_equal(static.tokens_of(r.rid), rep.tokens_of(r.rid))
    assert rep.n_steps <= static.n_steps
    assert rep.counters is None


def test_digital_engine_matches_reference(setup):
    s = setup
    jrep = jserving.ServingEngine(
        s["jcfg"], JAnalogConfig(), s["jparams"],
        jserving.ServingConfig(n_slots=2, s_max=S_MAX),
    ).run(s["jtrace"][:3], clock=jclock.VirtualClock())
    trep = tserving.ServingEngine(
        s["tcfg"], tserving.engine.AnalogConfig(), s["tparams"],
        tserving.ServingConfig(n_slots=2, s_max=S_MAX), device="cpu",
    ).run(s["trace"][:3], clock=tclock.VirtualClock())
    for r in s["trace"][:3]:
        assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid))


def test_engine_guards(setup):
    s = setup
    eng = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=2, s_max=16),
        device="cpu",
    )
    long = tserving.Request(rid=0, prompt=np.arange(10), max_new_tokens=10)
    with pytest.raises(ValueError, match="s_max"):
        eng.run([long])
    # a drift policy ages a compiled program: a digital engine has none
    digital = tserving.ServingEngine(
        s["tcfg"], tserving.engine.AnalogConfig(), s["tparams"],
        tserving.ServingConfig(n_slots=2, s_max=16), device="cpu",
    )
    policy = tserving.DriftPolicy(tengine.DriftSchedule.parse("25,3600"), every_steps=1)
    with pytest.raises(ValueError, match="compiled program"):
        digital.start_run(drift_policy=policy)
    # a mesh is served (tests/test_torch_distributed.py) except through
    # fused decode, as in the reference
    with pytest.raises(NotImplementedError):
        tserving.ServingEngine.for_program(
            s["tprog"], s["tcfg"],
            tserving.ServingConfig(n_slots=2, s_max=16, fused_decode=True),
            mesh=object(), device="cpu",
        )
    with pytest.raises(TypeError):
        tserving.ServingEngine(s["tcfg"], s["tprog"].cfg, s["tprog"].params,
                               device="cpu")
    with pytest.raises(ValueError):
        tserving.ServingConfig(n_slots=0, s_max=8)
    assert torch.equal(s["tprog"].params.gain_s, torch.ones(()))
