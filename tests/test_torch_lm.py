"""Port parity: the dense LM forward, caches and the program phase.

Smoke tinyllama with ``tile_rows=32``, so the programmed MVMs run the
multi-tile branch (K = 64 spans 2 crossbar tiles, w2's K = 128 spans 4).
The same prompts go through the JAX reference and the port -- digital from
the same params (``convert.params_from_numpy``), pcm_programmed from the
same JAX-programmed artifact. Tolerances: logits within ``atol=1e-4`` (f32;
the two frameworks sum matmuls in different orders) and greedy tokens
identical, over prefill and 8 decode steps of a per-slot cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core import pcm as jpcm
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch import prng
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core import pcm as tpcm
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.models import lm as tlm

S_MAX = 40
N_DECODE = 8
PROMPT_LENS = (7, 12, 5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_get_smoke("tinyllama-1.1b")
    tcfg = t_get_smoke("tinyllama-1.1b")
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jprog = jengine.compile_program(
        jparams, JAnalogConfig(tile_rows=32).infer(b_adc=8),
        jax.random.PRNGKey(1),
    )
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"
    )
    tprog = tstore.load_program(path, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jprog=jprog,
                tparams=tparams, tprog=tprog, prompts=prompts)


def _serve_jax(params, acfg, cfg, prompts):
    """Prefill each prompt alone into a slot, then N_DECODE greedy steps."""
    b = len(prompts)
    slots = jlm.init_lm_cache(cfg, b, S_MAX, cfg.dtype, stacked=False, per_slot=True)
    pre, cur = [], []
    for i, p in enumerate(prompts):
        cache = jlm.init_lm_cache(cfg, 1, S_MAX, cfg.dtype)
        logits, cache = jlm.lm_forward(params, {"tokens": jnp.asarray(p)[None]},
                                       acfg, cfg, cache=cache, last_token_only=True)
        slots = jlm.write_cache_slot(slots, jlm.unstack_cache(cache), i)
        pre.append(np.asarray(logits[0, -1]))
        cur.append(int(jnp.argmax(logits[0, -1])))
    steps, toks = [], [cur]
    tok = jnp.asarray(cur, jnp.int32)[:, None]
    for _ in range(N_DECODE):
        logits, slots = jlm.lm_forward(params, {"tokens": tok}, acfg, cfg, cache=slots)
        steps.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok[:, 0]).tolist())
    return np.stack(pre), np.stack(steps), np.asarray(toks), slots


def _serve_torch(params, acfg, cfg, prompts):
    b = len(prompts)
    slots = tlm.init_lm_cache(cfg, b, S_MAX, cfg.dtype, stacked=False,
                              per_slot=True, device="cpu")
    pre, cur = [], []
    for i, p in enumerate(prompts):
        cache = tlm.init_lm_cache(cfg, 1, S_MAX, cfg.dtype, device="cpu")
        logits, cache = tlm.lm_forward(params, {"tokens": torch.from_numpy(p).long()[None]},
                                       acfg, cfg, cache=cache, last_token_only=True)
        slots = tlm.write_cache_slot(slots, tlm.unstack_cache(cache), i)
        pre.append(logits[0, -1].numpy())
        cur.append(int(logits[0, -1].argmax()))
    steps, toks = [], [cur]
    tok = torch.tensor(cur)[:, None]
    for _ in range(N_DECODE):
        logits, slots = tlm.lm_forward(params, {"tokens": tok}, acfg, cfg, cache=slots)
        steps.append(logits[:, -1].numpy())
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        toks.append(tok[:, 0].tolist())
    return np.stack(pre), np.stack(steps), np.asarray(toks), slots


@pytest.mark.parametrize("mode", ["digital", "pcm_programmed"])
def test_prefill_and_decode_match_reference(setup, mode):
    s = setup
    if mode == "digital":
        jargs = (s["jparams"], JAnalogConfig())
        targs = (s["tparams"], TAnalogConfig())
    else:
        jargs = (s["jprog"].params, s["jprog"].cfg)
        targs = (s["tprog"].params, s["tprog"].cfg)
    j_pre, j_steps, j_toks, _ = _serve_jax(*jargs, s["jcfg"], s["prompts"])
    t_pre, t_steps, t_toks, _ = _serve_torch(*targs, s["tcfg"], s["prompts"])
    np.testing.assert_allclose(t_pre, j_pre, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_steps, j_steps, atol=1e-4, rtol=0)
    assert np.array_equal(t_toks, j_toks)


def test_write_and_reset_cache_slot_match_reference(setup):
    s = setup
    _, _, _, jslots = _serve_jax(s["jparams"], JAnalogConfig(), s["jcfg"], s["prompts"][:2])
    _, _, _, tslots = _serve_torch(s["tparams"], TAnalogConfig(), s["tcfg"], s["prompts"][:2])
    jslots = jlm.reset_cache_slot(jslots, 0)
    tslots = tlm.reset_cache_slot(tslots, 0)
    for jc, tc in zip(jslots[0], tslots[0]):
        jc, tc = jc[0], tc[0]
        assert np.array_equal(tc.length.numpy(), np.asarray(jc.length))
        assert tc.length.tolist() == [0, PROMPT_LENS[1] + N_DECODE]
        assert not tc.k[0].any() and not tc.v[0].any()
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-4, rtol=0)


def _ulp_close(a, b):
    np.testing.assert_array_max_ulp(np.asarray(a, np.float32), np.asarray(b, np.float32), maxulp=1)


def test_compile_program_noise_off_matches_reference(setup):
    s = setup
    off = dict(programming_noise=False, drift=False, read_noise=False)
    jprog = jengine.compile_program(
        s["jparams"], JAnalogConfig(tile_rows=32, pcm=jpcm.PCMConfig(**off)).infer(),
        jax.random.PRNGKey(2), b_adc_overrides={"blocks/*/ffn/*": 6},
    )
    before = tengine.program_event_count()
    tprog = tengine.compile_program(
        s["tparams"], TAnalogConfig(tile_rows=32, pcm=tpcm.PCMConfig(**off)).infer(),
        prng.PRNGKey(2), b_adc_overrides={"blocks/*/ffn/*": 6},
        device="cpu",
    )
    assert tengine.program_event_count() - before == len(jprog.plans) == 8
    assert dataclasses.asdict(tprog.cfg) == dataclasses.asdict(jprog.cfg)
    for path in jprog.plans:
        jp, tp = jprog.plans[path], tprog.plans[path]
        assert (tp.k, tp.n, tp.spec.b_adc) == (jp.k, jp.n, jp.spec.b_adc)
    jb, tb = jprog.params.blocks[0], tprog.params.blocks[0]
    for kind, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                       ("ffn", "w1"), ("ffn", "w3"), ("ffn", "w2")):
        _ulp_close(tb[kind][name]["w"], jb[kind][name]["w"])
        _ulp_close(tb[kind][name]["out_scale_buf"], jb[kind][name]["out_scale_buf"])
        assert ("b_adc_buf" in tb[kind][name]) == (kind == "ffn")
    _ulp_close(tprog.params.lm_head["w"], jprog.params.lm_head["w"])
    _ulp_close(tprog.params.lm_head["out_scale_buf"], jprog.params.lm_head["out_scale_buf"])
    for path, jst in jprog.state.items():
        for name in ("g_pos", "g_neg", "gt_sum", "w_scale"):
            _ulp_close(tprog.state[path][name], jst[name])
        for name in ("q_pos", "q_neg"):  # g^0.65: pow differs in the last ulps
            np.testing.assert_allclose(tprog.state[path][name].numpy(),
                                       np.asarray(jst[name]), rtol=1e-6)


def test_compile_program_noise_on_follows_the_model(setup):
    """Programming noise is drawn through the RNG bridge: its std over
    devices well inside the [0, 1.2] clip is sigma_P within 10%."""
    s = setup
    cfg = TAnalogConfig(tile_rows=32).infer(b_adc=8)
    prog = tengine.compile_program(s["tparams"], cfg, prng.PRNGKey(0), device="cpu")
    z = []
    for path, st in prog.state.items():
        blk = s["tparams"].lm_head if path == "lm_head" else s["tparams"].blocks[0][
            path.split("/")[2]][path.split("/")[3]]
        w = torch.minimum(torch.maximum(blk["w"], blk["w_clip_buf"][..., :1, None]),
                          blk["w_clip_buf"][..., 1:, None])
        scale = w.abs().amax(dim=(-2, -1), keepdim=True) + 1e-12
        g_t = (w / scale).clamp(min=0.0)
        keep = (g_t > 0.2) & (g_t < 1.0)
        sigma = tpcm.programming_noise_sigma(g_t)
        z.append(((st["g_pos"] - g_t) / sigma)[keep])
    z = torch.cat(z)
    assert z.numel() > 2000
    assert abs(float(z.std()) - 1.0) < 0.10
    # the program is served as is: the same key gives the same chip
    again = tengine.compile_program(s["tparams"], cfg, prng.PRNGKey(0), device="cpu")
    assert torch.equal(again.params.lm_head["w"], prog.params.lm_head["w"])
    key = prog.state["lm_head"]["key"]
    assert key.dtype == torch.int64 and key.shape == (2,)


def test_last_index_picks_each_rows_position(setup):
    """Right-padded rows: ``last_index`` selects each row's real last token."""
    s = setup
    toks = np.random.default_rng(3).integers(0, s["jcfg"].vocab, size=(3, 9)).astype(np.int32)
    last = np.array([8, 3, 5], np.int32)
    want, _ = jlm.lm_forward(s["jprog"].params, {"tokens": jnp.asarray(toks)},
                             s["jprog"].cfg, s["jcfg"], last_token_only=True,
                             last_index=jnp.asarray(last))
    got, _ = tlm.lm_forward(s["tprog"].params, {"tokens": torch.from_numpy(toks).long()},
                            s["tprog"].cfg, s["tcfg"], last_token_only=True,
                            last_index=torch.from_numpy(last))
    assert got.shape == (3, 1, s["tcfg"].vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
