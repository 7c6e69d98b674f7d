"""The hooks the fleet router drives an ``EngineRun`` through.

``on_token`` streams every token as it reaches the host (the first at
admission, then one per decode step), ``on_retire`` every record; ``evict``
frees a live slot and its pages without recording a retirement, and the
run still conserves its slots and pages; with ``track_events=False`` the
run leaves the program-event check to its owner; ``live`` and ``elapsed``
read the run.
"""

import numpy as np
import pytest

from repro_torch import clock as tclock
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig
from repro_torch.models import lm as tlm
from repro_torch.models.common import ModelConfig

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

S_MAX = 24
CONFIGS = {
    "rectangular": tserving.ServingConfig(n_slots=2, s_max=S_MAX),
    "paged": tserving.ServingConfig(n_slots=2, s_max=S_MAX, paged=True, page_size=4,
                                    prefill_buckets=(8, 16)),
}


@pytest.fixture(scope="module")
def chip():
    cfg = ModelConfig(name="t", family="dense", n_kv_heads=2).smoke()
    params = tlm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    program = tengine.compile_program(params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                      device="cpu")
    return cfg, params, program


def _engine(chip, layout):
    cfg, params, program = chip
    return tserving.ServingEngine.for_program(program, cfg, CONFIGS[layout], ref_params=params,
                                              device="cpu")


def _trace(cfg, n=5):
    return tserving.poisson_trace(prng.PRNGKey(3), n, vocab=cfg.vocab, rate=400.0,
                                  prompt_lens=(4, 8), new_tokens=(3, 7))


def _drive(run):
    while run.has_work:
        run.admit_arrived()
        if run.n_active == 0:
            run.idle_wait()
            continue
        run.decode_step()


@pytest.mark.parametrize("layout", sorted(CONFIGS))
def test_on_token_streams_each_records_tokens(chip, layout):
    eng = _engine(chip, layout)
    streamed: dict[int, list[int]] = {}
    retired = []
    run = eng.start_run(clock=tclock.VirtualClock(),
                        on_token=lambda rid, tok: streamed.setdefault(rid, []).append(tok),
                        on_retire=retired.append)
    trace = _trace(chip[0])
    run.submit(trace)
    _drive(run)
    rep = run.finish()
    assert [r.rid for r in retired] == [r.rid for r in rep.records]
    assert sorted(streamed) == sorted(r.rid for r in trace)
    for rec in rep.records:
        assert streamed[rec.rid] == rec.tokens.tolist()
        assert all(isinstance(t, int) for t in streamed[rec.rid])
    # the hooks observe: the run's tokens are the run without them
    plain = _engine(chip, layout).run(trace, clock=tclock.VirtualClock())
    for rec in rep.records:
        assert np.array_equal(plain.tokens_of(rec.rid), rec.tokens)


@pytest.mark.parametrize("layout", sorted(CONFIGS))
def test_evict_frees_slot_and_pages_without_a_retirement(chip, layout):
    eng = _engine(chip, layout)
    retired = []
    run = eng.start_run(clock=tclock.VirtualClock(), on_retire=retired.append)
    trace = _trace(chip[0], n=3)
    run.submit(trace)
    while run.n_active < 2:
        run.admit_arrived()
    run.decode_step()
    assert run.elapsed > 0.0
    live = run.live()
    assert [slot for slot, _, _ in live] == [0, 1]
    slot, req, tokens = live[0]
    assert tokens == run.slots[slot].tokens and tokens is not run.slots[slot].tokens
    pages_before = run.pool.allocator.n_in_use if layout == "paged" else None
    got_req, got_tokens = run.evict(slot)
    assert got_req is req and got_tokens == tokens
    assert run.slots[slot] is None and run.n_active == 1
    if layout == "paged":
        assert run.pool.allocator.n_in_use < pages_before
        assert slot not in run.pool.owned
    with pytest.raises(ValueError, match="holds no live request"):
        run.evict(slot)
    _drive(run)
    rep = run.finish()  # conservation: every page back, nothing leaked
    assert req.rid not in {r.rid for r in rep.records}
    assert [r.rid for r in retired] == [r.rid for r in rep.records]
    assert {r.rid for r in rep.records} == {r.rid for r in trace} - {req.rid}


def test_untracked_run_leaves_the_event_check_to_its_owner(chip):
    """A programming event during a run (a sibling chip's refresh, say)
    fails a tracked run's finish and passes an untracked one's."""
    trace = _trace(chip[0], n=2)
    for track in (True, False):
        run = _engine(chip, "rectangular").start_run(
            clock=tclock.VirtualClock(), track_events=track,
            on_token=lambda rid, tok: tengine.record_program_event())
        run.submit(trace)
        _drive(run)
        if track:
            with pytest.raises(RuntimeError, match="programming events"):
                run.finish()
        else:
            assert run.finish().program_events_delta == 0
