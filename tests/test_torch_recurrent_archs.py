"""Port parity: the SSM (mamba2-2.7b) and hybrid (recurrentgemma-9b) LMs.

Each at its reference smoke config (``get_smoke``), and recurrentgemma also
at 5 layers -- one (rec, rec, attn) group and a 2-layer tail, the published
config's 38 = 12 x 3 + 2 in small:

* ``lm_init`` through the RNG bridge: every leaf bitwise but mamba2's
  ``dt_bias`` (torch's ``exp``; within 2e-4, see ``test_torch_ssm.py``);
  ``params_from_numpy`` checks each family's own projections and refuses
  another arch's tree.
* the digital forward on the reference's params at S = 40 (past the smoke
  window 32 and the SSD chunk 16): logits within 1e-5 relative L2 (torch's
  exp, softplus, sigmoid and cumsum differ from XLA's by ulps, and the
  einsums contract in other orders).
* a prefill into the stacked cache then 30 decode steps on the list
  layout -- recurrentgemma's attention cache is a 32-row rolling buffer,
  so the steps write past the window, after a prefill shorter (20) and
  longer (40) than it -- every step's logits within 1e-5 relative L2 of
  JAX's.
* a chip JAX programmed and saved (``tile_rows=32``), loaded by the port on
  its template (``load_program(params_like=)``, tail included): the
  prefill logits bitwise JAX's. The recurrent ops' ulps do not show: every
  MVM's DAC quantizes its input to 2^7 - 1 levels, and no ulp moves a code
  across a level at these inputs.
* one recurrent layer's ADC bits overridden (``b_adc_overrides``), the
  chip programmed by both packages from one key, aged a day, saved by each
  and loaded by the other: every leaf bitwise, the digital leaves (conv,
  A_log, D, dt_bias, lambda_p, norm scales) passed through unprogrammed.
  The program walk takes each dict in its order, and a tail block's dicts
  keep the reference's init order (unsorted), so the tail's layers draw
  the reference's keys.
* a ``resample_read_noise`` chip: its refresh bitwise JAX's, and a forward
  redrawing every read noise within 1e-4 of JAX's logits.
* the digital serving engine against the full-forward oracle (the growing
  sequence re-run through ``lm_forward``), as ``test_serving_engine.py``
  holds the reference's.
* the serving CLIs: one JAX run (``--analog --request-trace 2
  --save-program DIR``) and the port's ``--analog`` and ``--load-program
  DIR`` runs print the same summary counts and tokens.
* paging (``--kv-page-size``, ``init_lm_cache(paged=True)``) and fused
  decode (``--fused-decode``, ``ServingConfig(fused_decode=True)``) are
  refused by both packages with the reference's words.
* B3's training form with the window: its gradient against ``jax.grad`` of
  the reference's ``chunked_attention`` (the backward is the plain
  version's VJP, so it takes the window), within 1e-5 relative L2.
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
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.core import engine as jengine
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch import convert, prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
CONFIGS = [("mamba2-2.7b", None), ("recurrentgemma-9b", None), ("recurrentgemma-9b", 5)]
RTOL = 1e-5
CLI = ["--request-trace", "2", "--batch", "2", "--prompt-len", "8", "--tokens", "4"]
OVERRIDE = {"mamba2-2.7b": "blocks/0/ssm/in_proj", "recurrentgemma-9b": "blocks/0/rec/a_gate"}
SEP = "/"


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _flat_bitwise(jtree, ttree, skip=()):
    want = jstore._flatten(jtree)
    got = {k: v.numpy() for k, v in tstore._flatten(ttree).items()}
    assert set(want) == set(got)
    for k, w in want.items():
        if any(k.endswith(s) for s in skip):
            continue
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


def _toks(rng, b, s):
    return rng.integers(0, 256, (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: f"{c[0]}-{c[1] or 'smoke'}")
def arch(request, tmp_path_factory):
    name, n_layers = request.param
    jcfg, tcfg = j_get_smoke(name), t_get_smoke(name)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    tp_j = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    acfg = dict(tile_rows=32)
    jprog = jengine.compile_program(jp, janalog.AnalogConfig(**acfg).infer(b_adc=8),
                                    jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tp_j=tp_j, jprog=jprog,
                path=path, acfg=acfg)


def test_init_and_bridge_match_reference(arch):
    _flat_bitwise(arch["jp"], arch["tp"], skip=("dt_bias",))
    _flat_bitwise(arch["jp"], arch["tp_j"])
    for (k, w), (_, g) in zip(sorted(jstore._flatten(arch["jp"]).items()),
                              sorted(tstore._flatten(arch["tp"]).items())):
        if k.endswith("dt_bias"):
            np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=0)
    assert tlm.block_period(arch["tcfg"]) == jlm.block_period(arch["jcfg"])
    other = t_get_smoke("recurrentgemma-9b" if arch["name"] == "mamba2-2.7b" else "mamba2-2.7b")
    with pytest.raises(ValueError, match="do not match"):
        convert.params_from_numpy(jax.tree.map(np.asarray, arch["jp"]), other, device="cpu")


def test_forward_matches_reference(arch):
    toks = _toks(np.random.default_rng(1), 2, 40)
    want, _ = jlm.lm_forward(arch["jp"], {"tokens": jnp.asarray(toks)}, janalog.AnalogConfig(),
                             arch["jcfg"])
    got, _ = tlm.lm_forward(arch["tp_j"], {"tokens": torch.from_numpy(toks).long()},
                            tanalog.AnalogConfig(), arch["tcfg"])
    assert got.shape == want.shape and _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("prompt", [20, 40])
def test_cached_decode_past_the_window_matches_reference(arch, prompt):
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    rng = np.random.default_rng(prompt)
    toks = _toks(rng, 2, prompt)
    s_max = 96
    jc = jlm.init_lm_cache(jcfg, 2, s_max, jnp.float32)
    tc = tlm.init_lm_cache(tcfg, 2, s_max, torch.float32, device="cpu")
    digital_j, digital_t = janalog.AnalogConfig(), tanalog.AnalogConfig()
    want, jc = jlm.lm_forward(arch["jp"], {"tokens": jnp.asarray(toks)}, digital_j, jcfg,
                              cache=jc, last_token_only=True)
    got, tc = tlm.lm_forward(arch["tp_j"], {"tokens": torch.from_numpy(toks).long()},
                             digital_t, tcfg, cache=tc, last_token_only=True)
    assert _rel(got.numpy(), want) <= RTOL
    jc, tc = jlm.unstack_cache(jc), tlm.unstack_cache(tc)
    if jcfg.family == "hybrid":
        rows = {c.k.shape[1] for c in tlm.kv_layers(tc)}
        assert rows == {jcfg.local_window}  # the rolling buffer
    for step in range(30):
        tok = _toks(rng, 2, 1)
        want, jc = jlm.lm_forward(arch["jp"], {"tokens": jnp.asarray(tok)}, digital_j, jcfg,
                                  cache=jc)
        got, tc = tlm.lm_forward(arch["tp_j"], {"tokens": torch.from_numpy(tok).long()},
                                 digital_t, tcfg, cache=tc)
        assert _rel(got.numpy(), want) <= RTOL, step


def test_jax_chip_serves_bitwise_logits(arch):
    loaded = tstore.load_program(arch["path"], params_like=arch["tp"], device="cpu")
    assert len(loaded.params.tail) == len(arch["jprog"].params.tail)
    for s in (9, 40):
        toks = _toks(np.random.default_rng(s), 2, s)
        want, _ = jlm.lm_forward(arch["jprog"].params, {"tokens": jnp.asarray(toks)},
                                 arch["jprog"].cfg, arch["jcfg"], last_token_only=True)
        got, _ = tlm.lm_forward(loaded.params, {"tokens": torch.from_numpy(toks).long()},
                                loaded.cfg, arch["tcfg"], last_token_only=True)
        assert np.array_equal(got.numpy(), np.asarray(want)), s


def test_program_override_age_and_artifacts_both_ways(arch, tmp_path):
    overrides = {OVERRIDE[arch["name"]]: 6}
    jprog = jengine.compile_program(
        arch["jp"], janalog.AnalogConfig(**arch["acfg"]).infer(b_adc=8, t_seconds=3600.0),
        jax.random.PRNGKey(7), b_adc_overrides=overrides)
    # the program walk follows each dict's order: the port's own params keep
    # the reference's (a tail block's dicts in init order, not sorted, as a
    # pass through jax.tree.map would leave them); mamba2's carry JAX's
    # dt_bias (it has no tail)
    src = arch["tp_j"] if arch["name"] == "mamba2-2.7b" else arch["tp"]
    tprog = tengine.compile_program(
        src, tanalog.AnalogConfig(**arch["acfg"]).infer(b_adc=8, t_seconds=3600.0),
        prng.PRNGKey(7), b_adc_overrides=overrides, device="cpu")
    _flat_bitwise(jprog.params, tprog.params)
    assert tengine.plan_bit_overrides(tprog) == jengine.plan_bit_overrides(jprog) == overrides
    # the digital leaves pass through unprogrammed
    mixer = "ssm" if arch["name"] == "mamba2-2.7b" else "rec"
    digital = ("conv_w", "A_log", "dt_bias") if mixer == "ssm" else ("conv_w", "lambda_p")
    for leaf in digital:
        assert torch.equal(tprog.params.blocks[0][mixer][leaf], src.blocks[0][mixer][leaf])
    jaged, taged = jengine.age_program(jprog, 86400.0), tengine.age_program(tprog, 86400.0)
    _flat_bitwise(jaged.params, taged.params)
    tstore.save_program(str(tmp_path / "port"), taged)
    jloaded = jstore.load_program(str(tmp_path / "port"), params_like=arch["jp"])
    _flat_bitwise(jloaded.params, taged.params)
    jstore.save_program(str(tmp_path / "jax"), jaged)
    tloaded = tstore.load_program(str(tmp_path / "jax"), params_like=arch["tp"], device="cpu")
    _flat_bitwise(jaged.params, tloaded.params)
    assert tengine.plan_bit_overrides(tloaded) == overrides


def test_refresh_and_resampled_read_noise_as_the_reference(arch):
    """A chip with ``resample_read_noise``: its refresh
    (``launch/steps.py::refresh_program``) bitwise JAX's, and a forward
    that redraws every read noise from the call's key within 1e-4 of JAX's
    logits (the draws bitwise; the recurrent ops' ulps), unlike the frozen
    chip's."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps as tsteps

    src = arch["tp_j"] if arch["name"] == "mamba2-2.7b" else arch["tp"]
    kw = dict(tile_rows=32, resample_read_noise=True)
    jprog = jengine.compile_program(arch["jp"], janalog.AnalogConfig(**kw).infer(b_adc=8),
                                    jax.random.PRNGKey(3))
    tprog = tengine.compile_program(src, tanalog.AnalogConfig(**kw).infer(b_adc=8),
                                    prng.PRNGKey(3), device="cpu")
    jfresh = jsteps.refresh_program(jprog, arch["jp"], jax.random.PRNGKey(9))
    tfresh = tsteps.refresh_program(tprog, src, prng.PRNGKey(9))
    _flat_bitwise(jfresh.params, tfresh.params)
    toks = _toks(np.random.default_rng(6), 2, 12)
    want, _ = jlm.lm_forward(jprog.params, {"tokens": jnp.asarray(toks)}, jprog.cfg,
                             arch["jcfg"], rng=jax.random.PRNGKey(10))
    got, _ = tlm.lm_forward(tprog.params, {"tokens": torch.from_numpy(toks).long()}, tprog.cfg,
                            arch["tcfg"], rng=prng.PRNGKey(10))
    frozen, _ = tlm.lm_forward(tprog.params, {"tokens": torch.from_numpy(toks).long()},
                               tprog.cfg, arch["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert not torch.equal(got, frozen)


def test_digital_engine_matches_full_forward_oracle(arch):
    cfg = arch["tcfg"]
    served = tserving.ServingEngine(cfg, tanalog.AnalogConfig(), arch["tp"],
                                    tserving.ServingConfig(n_slots=3, s_max=48), device="cpu")
    reqs = [tserving.Request(rid=0, prompt=np.arange(9) % cfg.vocab, max_new_tokens=5),
            tserving.Request(rid=1, prompt=np.arange(4) % cfg.vocab, max_new_tokens=6)]
    rep = served.run(reqs)
    for req in reqs:
        toks, want = list(req.prompt), []
        for _ in range(req.max_new_tokens):
            lg, _ = tlm.lm_forward(arch["tp"], {"tokens": torch.tensor([toks])},
                                   tanalog.AnalogConfig(), cfg)
            want.append(int(lg[0, -1].argmax()))
            toks.append(want[-1])
        assert rep.tokens_of(req.rid).tolist() == want, req.rid


def _summary_and_tokens(out: str):
    summary = re.search(r"^serving: .*requests=(\d+) tokens=(\d+) steps=(\d+)", out, re.M)
    tokens = re.search(r"^generated token ids \(longest request\): (.*)$", out, re.M)
    assert summary and tokens, out
    return summary.groups(), tokens.group(1)


@pytest.mark.parametrize("name", ARCHS)
def test_cli_tokens_match_the_reference(name, tmp_path, capsys, monkeypatch):
    saved = str(tmp_path / "saved")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name, "--analog", *CLI,
                                      "--save-program", saved])
    jserve.main()
    want = _summary_and_tokens(capsys.readouterr().out)
    for argv in (["--analog"], ["--load-program", saved]):
        tserve.main(["--device", "cpu", "--arch", name, *argv, *CLI])
        assert _summary_and_tokens(capsys.readouterr().out) == want, argv


def _cli_error(module, argv, capsys) -> str:
    ap = module.build_parser()
    with pytest.raises(SystemExit):
        module.validate_args(ap, ap.parse_args(argv))
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("flags", [["--kv-page-size", "4"], ["--analog", "--fused-decode"]])
def test_paging_and_fused_refusals_are_the_reference(name, flags, capsys):
    argv = ["--arch", name, "--request-trace", "2", *flags]
    assert _cli_error(tserve, argv, capsys) == _cli_error(jserve, argv, capsys)


@pytest.mark.parametrize("name", ARCHS)
def test_engine_refusals_are_the_reference(name):
    jcfg, tcfg = j_get_smoke(name), t_get_smoke(name)
    for make in (lambda: jlm.init_lm_cache(jcfg, 1, 16, jnp.float32, stacked=False, paged=True),
                 lambda: tlm.init_lm_cache(tcfg, 1, 16, torch.float32, stacked=False,
                                           paged=True, device="cpu")):
        with pytest.raises(ValueError, match="position-free"):
            make()
    jprog = jengine.compile_program(jlm.lm_init(jax.random.PRNGKey(0), jcfg),
                                    janalog.AnalogConfig().infer(b_adc=8), jax.random.PRNGKey(1))
    tprog = tengine.compile_program(tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu"),
                                    tanalog.AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                    device="cpu")
    msgs = []
    for serving, prog, cfg, kw in ((jserving, jprog, jcfg, {}),
                                   (tserving, tprog, tcfg, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="no grid-step lowering") as info:
            serving.ServingEngine.for_program(
                prog, cfg, serving.ServingConfig(n_slots=2, s_max=16, fused_decode=True), **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_windowed_training_form_gradient_matches_jax_grad():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 80, n, 16)).astype(np.float32) for n in (4, 1, 1))
    g = rng.standard_normal((2, 80, 4, 16)).astype(np.float32)
    kw = dict(q_chunk=16, kv_chunk=32, causal=True, window=32)

    def loss(q, k, v):
        return jnp.sum(jattn.chunked_attention(q, k, v, **kw) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    calls = tops.attention_backward_calls
    o = tops.flash_attention_ste(tq, tk, tv, **kw)
    (o * torch.from_numpy(g)).sum().backward()
    assert tops.attention_backward_calls == calls + 1
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert _rel(got.numpy(), w) <= RTOL
    # the model's route: chunked_attention under autograd is the training form
    tq2 = torch.from_numpy(q).requires_grad_()
    o2 = tattn.chunked_attention(tq2, torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert o2.requires_grad and torch.equal(o2, o.detach())
