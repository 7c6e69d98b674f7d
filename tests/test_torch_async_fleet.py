"""The port's async fleet front end (``repro_torch.serving.async_fleet``).

The reference's claims (``tests/test_async_fleet.py``), held on the port:

* **Backpressure**: ``AdmissionQueue`` sheds at the cap, blocks until
  capacity frees, and times a blocked submit out into ``QueueFull``; the
  router's submit path applies the same cap.
* **Determinism**: the deterministic driver is the synchronous router, and
  threaded serving gives every request the deterministic generation
  (identical replicas, continuous batching inert).
* **Streaming**: consumers iterating ``TokenStream``s from their own threads
  collect exactly their requests' stitched records.
* **Conservation under threads**: a forced drain and reprogram mid-flight
  loses and duplicates nothing and accounts for every programming event.

Plus the session API's refusals (the reference's messages) and the
thread-safe launch counts and library loads the workers rely on.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import clock as jclock
from repro import serving as jserving
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import lm_init as j_lm_init
from repro_torch import clock as tclock
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.core.analog import AnalogConfig
from repro_torch.kernels import build
from repro_torch.models import lm as tlm
from repro_torch.models.common import ModelConfig
from repro_torch.serving.async_fleet import _ChipWorker

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

DIGITAL = AnalogConfig()
ACFG = AnalogConfig().infer(b_adc=8, t_seconds=86400.0)
S_MAX = 24
SCFG = tserving.ServingConfig(n_slots=2, s_max=S_MAX)
JOIN_S = 60.0


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="t", family="dense", n_kv_heads=2).smoke()
    return cfg, tlm.lm_init(prng.PRNGKey(0), cfg, device="cpu")


def _trace(cfg, n=8, key=5, new_tokens=(6, 12)):
    return tserving.poisson_trace(prng.PRNGKey(key), n, vocab=cfg.vocab, rate=500.0,
                                  prompt_lens=(4, 8), new_tokens=new_tokens)


def _engines(model, n):
    cfg, params = model
    return [tserving.ServingEngine(cfg, DIGITAL, params, SCFG, device="cpu") for _ in range(n)]


def _req(rid, arrival_t=0.0):
    return tserving.Request(rid=rid, prompt=np.arange(1, 5, dtype=np.int32), max_new_tokens=2,
                            arrival_t=arrival_t)


# ---------------------------------------------------------- AdmissionQueue


def test_admission_queue_sheds_at_cap():
    q = tserving.AdmissionQueue(2, "shed")
    q.put(_req(1), lambda: 0)
    q.put(_req(2), lambda: 0)
    with pytest.raises(tserving.QueueFull):
        q.put(_req(3), lambda: 0)
    assert q.accepted == 2 and q.shed == 1
    q.drain()
    with pytest.raises(tserving.QueueFull):  # outside work counts against the cap
        q.put(_req(3), lambda: 5)


def test_admission_queue_blocks_until_capacity_frees():
    q = tserving.AdmissionQueue(1, "block", timeout_s=10.0)
    q.put(_req(1), lambda: 0)

    def late_drain():
        time.sleep(0.05)
        q.drain()

    t = threading.Thread(target=late_drain)
    t.start()
    q.put(_req(2), lambda: 0)  # blocks until the drain frees space
    t.join(JOIN_S)
    assert not t.is_alive()
    assert [r.rid for r in q.drain()] == [2]
    assert q.accepted == 2 and q.shed == 0


def test_admission_queue_blocked_submit_times_out():
    q = tserving.AdmissionQueue(1, "block", timeout_s=0.05)
    q.put(_req(1), lambda: 0)
    with pytest.raises(tserving.QueueFull, match="blocked submit"):
        q.put(_req(2), lambda: 0)
    assert q.shed == 1


# ------------------------------------------------------------- determinism


def test_deterministic_mode_matches_sync_router(model):
    engines = _engines(model, 3)
    trace = _trace(model[0])
    rep1 = tserving.FleetRouter(engines, tserving.FleetConfig(n_chips=3)).run(
        trace, clock=tclock.VirtualClock())
    rep2 = tserving.AsyncFleetRouter(engines, tserving.FleetConfig(n_chips=3),
                                     deterministic=True).serve(trace, clock=tclock.VirtualClock())
    assert rep1.n_ticks == rep2.n_ticks
    for a, b in zip(rep1.records, rep2.records):
        assert np.array_equal(a.tokens, b.tokens)
        assert (a.rid, a.chips, a.arrival_t, a.finish_t, a.first_token_t, a.finished_by) == (
            b.rid, b.chips, b.arrival_t, b.finish_t, b.first_token_t, b.finished_by)


def test_threaded_generations_match_deterministic(model):
    """Thread timing moves placement and admission, never a generation;
    off a card the workers own no stream."""
    trace = _trace(model[0], n=6)
    det = tserving.AsyncFleetRouter(_engines(model, 3), tserving.FleetConfig(n_chips=3),
                                    deterministic=True)
    rep1 = det.serve(trace, clock=tclock.VirtualClock())
    thr = tserving.AsyncFleetRouter(_engines(model, 3), tserving.FleetConfig(n_chips=3))
    rep2 = thr.serve(trace)
    assert rep2.n_requests == len(trace)
    for r in trace:
        assert np.array_equal(rep1.tokens_of(r.rid), rep2.tokens_of(r.rid)), r.rid
    assert _ChipWorker(None, [0], torch.device("cpu")).stream is None


# ---------------------------------------------------------------- streaming


def test_streaming_consumers_see_retired_sequences(model):
    router = tserving.AsyncFleetRouter(_engines(model, 2), tserving.FleetConfig(n_chips=2))
    trace = _trace(model[0], n=6, key=9)
    router.start()
    streams = [router.submit_stream(r) for r in trace]
    collected: dict[int, list[int]] = {}

    def consume(s):
        collected[s.rid] = [tok for tok in s]

    consumers = [threading.Thread(target=consume, args=(s,)) for s in streams]
    for t in consumers:
        t.start()
    rep = router.join()
    for t in consumers:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert rep.n_requests == len(trace)
    for rec in rep.records:
        assert collected[rec.rid] == list(rec.tokens)
    for s in streams:
        assert s.done and s.record is not None and s.record.rid == s.rid


def test_streaming_deterministic_session(model):
    router = tserving.AsyncFleetRouter(_engines(model, 2), tserving.FleetConfig(n_chips=2),
                                       deterministic=True)
    router.start(clock=tclock.VirtualClock())
    streams = [router.submit_stream(r) for r in _trace(model[0], n=4)]
    rep = router.join()
    assert rep.n_requests == 4
    for rec in rep.records:
        s = next(x for x in streams if x.rid == rec.rid)
        assert s.tokens() == list(rec.tokens) and s.done


# ------------------------------------------------ backpressure and misuse


def test_submit_sheds_at_fleet_cap(model):
    router = tserving.AsyncFleetRouter(
        _engines(model, 2), tserving.FleetConfig(n_chips=2),
        tserving.AsyncConfig(queue_cap=2, shed_policy="shed"), deterministic=True)
    router.start(clock=tclock.VirtualClock())
    router.submit(_req(1))
    router.submit(_req(2))
    with pytest.raises(tserving.QueueFull):
        router.submit(_req(3))
    rep = router.join()
    assert {r.rid for r in rep.records} == {1, 2}


def _raised(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error")


def test_session_misuse_is_refused_as_the_reference(model):
    """The same misuse on the reference's router (digital engines too) and
    on the port's: the same exception types and messages."""
    jcfg = JModelConfig(name="t", family="dense", n_kv_heads=2).smoke()
    jparams = j_lm_init(jax.random.PRNGKey(0), jcfg)
    jrouter = jserving.AsyncFleetRouter(
        [jserving.ServingEngine(jcfg, JAnalogConfig(), jparams,
                                jserving.ServingConfig(n_slots=2, s_max=S_MAX))
         for _ in range(2)], jserving.FleetConfig(n_chips=2), deterministic=True)
    trouter = tserving.AsyncFleetRouter(_engines(model, 2), tserving.FleetConfig(n_chips=2),
                                        deterministic=True)
    seen = {}
    for name, router, serving, clk in (("jax", jrouter, jserving, jclock),
                                       ("port", trouter, tserving, tclock)):
        req = lambda rid, n=4, budget=2: serving.Request(
            rid=rid, prompt=np.arange(1, n + 1, dtype=np.int32), max_new_tokens=budget)
        out = [_raised(lambda: router.submit(req(1)))]
        router.start(clock=clk.VirtualClock())
        out.append(_raised(lambda: router.start()))
        out.append(_raised(lambda: router.serve([req(1)])))
        out.append(_raised(lambda: router.submit(req(9, n=9, budget=S_MAX))))
        router.submit(req(1))
        out.append(_raised(lambda: router.submit(req(1))))
        seen[name] = out
    assert seen["port"] == seen["jax"]
    # the port's session then serves what it accepted and closes
    assert trouter.join().n_requests == 1
    assert _raised(trouter.join) == seen["port"][0]


# ------------------------------------------------- threaded refresh storm


def test_threaded_refresh_storm_conserves_rids(model):
    cfg, params = model
    router = tserving.AsyncFleetRouter.build(
        params, ACFG, cfg, SCFG, tserving.FleetConfig(n_chips=2, refresh_steps=2),
        key=prng.PRNGKey(3), src_params=params)
    trace = _trace(cfg, n=8, key=13)
    rep = router.serve(trace, force_refresh={4: 0})
    assert {r.rid for r in rep.records} == {r.rid for r in trace}
    assert len(rep.records) == len(trace)
    budget_of = {r.rid: r.max_new_tokens for r in trace}
    for rec in rep.records:
        assert rec.n_new == budget_of[rec.rid] and rec.ttft_s >= 0.0
    assert rep.reprograms == 1 and rep.program_events_delta == 0
    kinds = [e["kind"] for e in rep.events]
    assert kinds.count("drain") == 1 and kinds.count("reprogram") == 1


# ------------------------------------- thread-safe launch counts and loads


def test_launch_counts_are_exact_under_threads():
    """``build.bump`` is how every kernel wrapper counts a launch: 16
    threads, with the interpreter switching every microsecond, lose none."""
    class Owner:
        launches = 0
        by_design = {"decode": 0, "prefill": 0}

    n_threads, per = 16, 2000

    def work():
        for i in range(per):
            build.bump(Owner, "launches")
            build.bump(Owner, "by_design", ("decode", "prefill")[i % 2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert Owner.launches == n_threads * per
    assert Owner.by_design == {"decode": n_threads * per // 2, "prefill": n_threads * per // 2}


def test_each_library_is_built_and_loaded_once_under_threads(monkeypatch):
    builds = []

    def fake_build(names):
        builds.append(names)
        time.sleep(0.01)  # long enough for every thread to arrive
        return {n: f"/nonexistent/{n}.so" for n in names}

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_LOADED", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.load("x"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert builds == [("x",)]
    assert len(got) == 8 and len({id(lib) for lib in got}) == 1
