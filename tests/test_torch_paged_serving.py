"""Port parity: paged KV serving with bucketed prefill.

One JAX-programmed artifact (smoke tinyllama, ``tile_rows=32``) and one
request trace made with numpy serve through the port and the reference:

* the port's paged engine (bucketed padded prefill, page-table decode, lazy
  page growth) gives bitwise the tokens of its rectangular engine at page
  sizes 4, 5 and 16 (5 divides no prompt length), and of serving alone
  when the pool is smaller than the rectangle;
* the port's paged tokens equal the reference's paged tokens under virtual
  clocks, with the same allocator high-water mark and prefill shapes, and
  the digital-reference counters within 1e-5 (f32 logits summed in other
  orders);
* freeing a slot zeroes its pages and leaves every other slot's pages
  bitwise untouched;
* the engine and the CLI refuse what the reference refuses, with the
  errors ``tests/test_serving_engine.py`` pins (type and matched text),
  and a CLI run with ``--kv-page-size`` prints the tokens of the run
  without it.
"""

import dataclasses
import re

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
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch import convert
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

from test_torch_traces import numpy_trace

S_MAX = 48


def _jreq(r):
    return jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            arrival_t=r.arrival_t)



@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_get_smoke("tinyllama-1.1b")
    tcfg = t_get_smoke("tinyllama-1.1b")
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jprog = jengine.compile_program(
        jparams, JAnalogConfig(tile_rows=32).infer(b_adc=8), jax.random.PRNGKey(42)
    )
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    trace = numpy_trace(
        1, 7, vocab=tcfg.vocab, rate=400.0,
        prompt_lens=(4, 9, 16, 23, 33), new_tokens=(3, 10),
    )
    tprog = tstore.load_program(path, device="cpu")
    rect = tserving.ServingEngine.for_program(
        tprog, tcfg, tserving.ServingConfig(n_slots=3, s_max=S_MAX), device="cpu"
    ).run(trace, clock=tclock.VirtualClock())
    return dict(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams, jprog=jprog, tprog=tprog, trace=trace,
        tparams=convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                          device="cpu"),
        rect=rect,
    )


def _paged(s, **kw):
    cfg = tserving.ServingConfig(n_slots=kw.pop("n_slots", 3), s_max=kw.pop("s_max", S_MAX),
                                 paged=True, **kw)
    return tserving.ServingEngine.for_program(s["tprog"], s["tcfg"], cfg, device="cpu")


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_paged_bit_identical_to_rect_across_page_sizes(setup, page_size):
    s = setup
    eng = _paged(s, page_size=page_size, prefill_batch=2)
    launches = fa.flash_attention.launches
    rep = eng.run(s["trace"], scheduler=tserving.BucketedScheduler(),
                  clock=tclock.VirtualClock())
    assert fa.flash_attention.launches == launches  # the CPU runs the plain version
    for r in s["trace"]:
        assert np.array_equal(rep.tokens_of(r.rid), s["rect"].tokens_of(r.rid)), (page_size, r.rid)
    assert rep.n_prefill_traces <= len(eng.prefill_buckets)
    assert rep.n_prefill_traces < s["rect"].n_prefill_traces
    assert rep.peak_pages_in_use > 0
    assert rep.program_events_delta == 0
    assert "mode=bucketed" in rep.summary() and "prefill_traces=" in rep.summary()


def test_paged_long_prompts_flat_memory(setup):
    """Prompts the rectangle could not afford at this memory, served from a
    pool smaller than the rectangular cache, bitwise as served alone."""
    s = setup
    s_virt, n_pages = 384, 26  # 25 usable pages * 16 = 400 rows vs 2 * 384
    trace = numpy_trace(
        2, 4, vocab=s["tcfg"].vocab,
        prompt_lens=(16, 150, 300), new_tokens=(3, 6),
    )
    rep = _paged(s, n_slots=2, s_max=s_virt, page_size=16, n_pages=n_pages,
                 prefill_batch=2).run(trace, scheduler=tserving.BucketedScheduler(),
                                      clock=tclock.VirtualClock())
    solo = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(n_slots=1, s_max=s_virt), device="cpu"
    ).run(trace, clock=tclock.VirtualClock())
    for r in trace:
        assert np.array_equal(rep.tokens_of(r.rid), solo.tokens_of(r.rid)), r.rid
    rect_bytes = 2 * 2 * 2 * s_virt * s["tcfg"].n_kv_heads * s["tcfg"].hd * 4
    assert rep.peak_kv_bytes < rect_bytes
    assert rep.peak_pages_in_use <= n_pages - 1


def test_paged_tokens_match_reference_paged(setup):
    s = setup
    kw = dict(n_slots=3, s_max=S_MAX, paged=True, page_size=5, prefill_batch=2)
    jrep = jserving.ServingEngine.for_program(
        s["jprog"], s["jcfg"], jserving.ServingConfig(**kw), ref_params=s["jparams"],
    ).run([_jreq(r) for r in s["trace"]], scheduler=jserving.BucketedScheduler(),
          clock=jclock.VirtualClock())
    trep = tserving.ServingEngine.for_program(
        s["tprog"], s["tcfg"], tserving.ServingConfig(**kw), ref_params=s["tparams"],
        device="cpu",
    ).run(s["trace"], scheduler=tserving.BucketedScheduler(), clock=tclock.VirtualClock())
    for r in s["trace"]:
        assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), r.rid
    assert trep.peak_pages_in_use == jrep.peak_pages_in_use
    assert trep.n_prefill_traces == jrep.n_prefill_traces
    assert trep.peak_kv_bytes == jrep.peak_kv_bytes
    assert (trep.n_steps, trep.slot_steps) == (jrep.n_steps, jrep.slot_steps)
    assert trep.counters["decisions"] == jrep.counters["decisions"]
    assert abs(trep.counters["top1"] - jrep.counters["top1"]) <= 1e-5
    assert abs(trep.counters["logit_mse"] - jrep.counters["logit_mse"]) <= 1e-5


def test_paged_view_and_decode_match_the_rectangle(setup):
    """A paged slot cache gathers to exactly the rectangle's rows, and one
    decode step over it writes the same rows and gives the same logits."""
    s = setup
    cfg = s["tcfg"]
    params = s["tparams"]
    dig = TAnalogConfig()
    prompt = torch.arange(11)[None] % cfg.vocab
    pre = tlm.init_lm_cache(cfg, 1, 16, torch.float32, stacked=False, device="cpu")
    _, pre = tlm.lm_forward(params, {"tokens": prompt}, dig, cfg, cache=pre, last_token_only=True)
    rect = tlm.init_lm_cache(cfg, 2, S_MAX, torch.float32, stacked=False, per_slot=True,
                             device="cpu")
    rect_src = tlm.init_lm_cache(cfg, 1, S_MAX, torch.float32, stacked=False, device="cpu")
    _, rect_src = tlm.lm_forward(params, {"tokens": prompt}, dig, cfg, cache=rect_src,
                                 last_token_only=True)
    tlm.write_cache_slot(rect, rect_src, 1)
    paged = tlm.init_lm_cache(cfg, 2, S_MAX, torch.float32, stacked=False, paged=True,
                              page_size=5, n_pages=12, device="cpu")
    tlm.write_cache_slot_paged(paged, pre, 1, 0, np.array([7, 3, 9, 0]), 11)
    for pc, rc in zip(tlm.cache_layers(paged), tlm.cache_layers(rect)):
        view = tattn.paged_view(pc)
        assert torch.equal(view.k[1, :11], rc.k[1, :11])
        assert torch.equal(view.length, rc.length)
    tok = torch.tensor([[5], [17]])
    lr, rect = tlm.lm_forward(params, {"tokens": tok}, dig, cfg, cache=rect)
    lp, paged = tlm.lm_forward(params, {"tokens": tok}, dig, cfg, cache=paged)
    assert torch.equal(lp[1], lr[1])
    for pc, rc in zip(tlm.cache_layers(paged), tlm.cache_layers(rect)):
        assert torch.equal(tattn.paged_view(pc).v[1, :12], rc.v[1, :12])
    with pytest.raises(NotImplementedError, match="decode-only"):
        tlm.lm_forward(params, {"tokens": prompt[:, :2].expand(2, 2)}, dig, cfg, cache=paged)


def test_paged_free_leaves_other_slots_pages_untouched(setup):
    s = setup
    cfg, params = s["tcfg"], s["tparams"]
    paged = tlm.init_lm_cache(cfg, 2, 16, torch.float32, stacked=False, paged=True,
                              page_size=4, n_pages=8, device="cpu")

    def prefill_src(shift):
        single = tlm.init_lm_cache(cfg, 1, 8, torch.float32, stacked=False, device="cpu")
        toks = (torch.arange(8) + shift) % cfg.vocab
        _, c = tlm.lm_forward(params, {"tokens": toks[None]}, TAnalogConfig(), cfg,
                              cache=single, last_token_only=True)
        return c

    tlm.write_cache_slot_paged(paged, prefill_src(0), 0, 0, np.array([1, 2]), 8)
    tlm.write_cache_slot_paged(paged, prefill_src(3), 1, 0, np.array([3, 4]), 8)
    before = [tuple(t.clone() for t in (c.k, c.v, c.table, c.length))
              for c in tlm.cache_layers(paged)]
    tlm.free_cache_slot_paged(paged, 0, np.array([1, 2, 0, 0]))
    for (k0, v0, tab0, len0), c in zip(before, tlm.cache_layers(paged)):
        assert not c.k[1:3].any() and not c.v[1:3].any()  # slot 0's pages zeroed
        assert torch.equal(c.k[3:5], k0[3:5]) and torch.equal(c.v[3:5], v0[3:5])
        assert torch.equal(c.table[1], tab0[1]) and int(c.length[1]) == int(len0[1]) == 8
        assert not c.table[0].any() and int(c.length[0]) == 0


def _same_error(make_j, make_t, match: str):
    """Both raise the same exception type, with ``match`` in its text."""
    kinds = []
    for make in (make_j, make_t):
        with pytest.raises((ValueError, NotImplementedError), match=match) as info:
            make()
        kinds.append(info.type)
    assert kinds[0] is kinds[1], kinds


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=0), "page_size"), (dict(prefill_batch=0), "prefill_batch"),
    (dict(n_pages=1), "at least 2 pages"), (dict(fused_decode=True), "pick one"),
], ids=lambda a: ",".join(a) if isinstance(a, dict) else None)
def test_paged_config_validation_matches_reference(kw, match):
    _same_error(lambda: jserving.ServingConfig(n_slots=1, s_max=16, paged=True, **kw),
                lambda: tserving.ServingConfig(n_slots=1, s_max=16, paged=True, **kw), match)


@pytest.mark.parametrize("change,match", [
    (dict(family="ssm", ssm_state=16), "position-free"),
    (dict(family="hybrid", block_pattern=("rec", "rec", "attn")), "position-free"),
    (dict(frontend="audio_frames"), "feature-fed"),
], ids=lambda a: a.get("family", a.get("frontend")) if isinstance(a, dict) else None)
def test_paged_engine_validation_matches_reference(setup, change, match):
    s = setup
    jcfg = dataclasses.replace(s["jcfg"], **change)
    tcfg = dataclasses.replace(s["tcfg"], **change)
    jparams = s["jparams"] if "frontend" in change else jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    cfg_kw = dict(n_slots=1, s_max=16, paged=True)
    _same_error(
        lambda: jserving.ServingEngine(jcfg, JAnalogConfig(), jparams,
                                       jserving.ServingConfig(**cfg_kw)),
        lambda: tserving.ServingEngine(tcfg, TAnalogConfig(), s["tparams"],
                                       tserving.ServingConfig(**cfg_kw), device="cpu"),
        match,
    )


def test_paged_run_rejects_infeasible_and_feature_requests(setup):
    s = setup
    tight = dict(n_slots=1, s_max=48, paged=True, page_size=8, n_pages=3)  # 16 rows
    roomy = dict(n_slots=1, s_max=48, paged=True, page_size=8)
    for cfg_kw, req_kw, match in (
        (tight, dict(prompt=np.arange(20), max_new_tokens=10), "never be admitted"),
        (roomy, dict(prompt=np.arange(4), max_new_tokens=2,
                     features={"audio_frames": np.zeros((1, 2, 4))}), "paged mode"),
    ):
        _same_error(
            lambda: jserving.ServingEngine(
                s["jcfg"], JAnalogConfig(), s["jparams"], jserving.ServingConfig(**cfg_kw),
            ).run([jserving.Request(rid=0, **req_kw)]),
            lambda: tserving.ServingEngine(
                s["tcfg"], TAnalogConfig(), s["tparams"], tserving.ServingConfig(**cfg_kw),
                device="cpu",
            ).run([tserving.Request(rid=0, **req_kw)]),
            match,
        )


def _rejects(module, argv) -> bool:
    ap = module.build_parser()
    try:
        module.validate_args(ap, ap.parse_args(argv))
    except SystemExit:
        return True
    return False


@pytest.mark.parametrize("argv", [
    ["--kv-page-size", "8"],
    ["--request-trace", "3", "--kv-page-size", "8"],
    ["--request-trace", "3", "--kv-page-size", "0"],
    ["--request-trace", "3", "--kv-pages", "9"],
    ["--request-trace", "3", "--kv-page-size", "4", "--kv-pages", "9"],
    ["--request-trace", "3", "--prefill-buckets", "8,16"],
    ["--request-trace", "3", "--kv-page-size", "4", "--prefill-buckets", "8,16"],
    ["--request-trace", "3", "--kv-page-size", "4", "--prefill-buckets", "8,x"],
    ["--request-trace", "3", "--kv-page-size", "4", "--prefill-buckets", "0,16"],
    ["--request-trace", "3", "--kv-page-size", "4", "--prefill-buckets", ","],
    ["--analog", "--request-trace", "3", "--kv-page-size", "4", "--fused-decode"],
], ids=lambda a: " ".join(a))
def test_validate_args_paging_flags_match_reference(argv):
    assert _rejects(tserve, argv) == _rejects(jserve, argv)


def test_cli_paged_prints_the_tokens_of_the_rectangular_run(capsys):
    # --tokens 12: budgets 8..12, so the printed longest request is unique
    argv = ["--device", "cpu", "--analog", "--request-trace", "3", "--batch", "2",
            "--prompt-len", "8", "--tokens", "12", "--seed", "1"]
    outs = []
    # a 9-page pool holds back admissions (more steps), never the tokens
    for extra in ([], ["--kv-page-size", "4"], ["--kv-page-size", "5", "--kv-pages", "9",
                                                "--prefill-buckets", "4,8"]):
        tserve.main(argv + extra)
        outs.append(capsys.readouterr().out)
    grab = lambda out, pat: re.search(pat, out, re.M).group(1)
    for out in outs[1:]:
        assert "mode=bucketed" in out and "prefill_traces=" in out
        for pat in (r"^generated token ids \(longest request\): (.*)$",
                    r"^accuracy_vs_digital_ref: (.*)$",
                    r"requests=(\d+ tokens=\d+)"):
            assert grab(out, pat) == grab(outs[0], pat), pat
