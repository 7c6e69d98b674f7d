"""Port parity: the vision (paligemma-3b) and audio (musicgen-large) LMs.

Each at its reference smoke config (``get_smoke``): paligemma prepends 8
image patches, projected by the analog ``extras/patch_proj``, to its
tokens; musicgen reads precomputed frame embeddings and emits 4 codebooks
through a ``vocab * 4`` head.

* the port registers the reference's ten LMs in its order;
* ``lm_init`` through the RNG bridge bitwise the reference's (the fifth
  key draws ``patch_proj``, the head is ``vocab * max(n_codebooks, 1)``
  wide), ``params_from_numpy`` checks both and refuses the other arch's
  tree; the digital forward within ``atol=1e-4``: paligemma with and
  without patches, musicgen's (B, S, 4, V) logits;
* a chip JAX programmed and saved (``tile_rows=32``, one layer's ADC bits
  overridden: paligemma's ``patch_proj``, musicgen's head), loaded by the
  port: paligemma's patch-fed prefill logits bitwise JAX's, through
  ``lm_forward`` and through ``ServingEngine``'s prefill of each request
  with its own ``features``; musicgen through ``launch/steps.py``'s ``make_prefill_step``
  and 3 ``make_serve_step`` calls, fed fresh frames: logits bitwise and
  every step's (B, 4) codes JAX's (the reference's serve step jitted);
* the program walk puts ``extras/patch_proj`` after ``lm_head``: that
  chip programmed by the port from the same key bitwise JAX's, both aged
  a day, saved by each and loaded by the other, every leaf bitwise;
  ``build_fused_plan`` leaves ``extras/`` out; a ``resample_read_noise``
  chip redraws ``patch_proj``'s read noise first under the call's key,
  then the head's, each draw bitwise JAX's at the reference's key;
* the serving CLIs (each request its own patches through the engine):
  paligemma's ``--analog`` and ``--load-program`` runs print the JAX
  CLI's tokens; musicgen's CLI and engine refusals, the
  feature-fed ``--request-trace`` and paged engine refusals, are the
  reference's words;
* the port engine's fused decode (B2's plain version on the CPU) serves
  paligemma's per-layer tokens;
* one stage-1 and one stage-2 ``make_train_step`` against the
  reference's jitted step: paligemma with patches in stage 1 (the prefix
  carries no loss), musicgen with (B, S, 4) labels in stage 2 (its analog
  MVMs and the codebook head's NLL); the loss within 1e-5 (1e-4 in stage
  2) relative and the grad norm within 1e-4, as ``test_torch_lm_archs.py``.
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
from repro import configs as jconfigs
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.core import engine as jengine
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch import convert, prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.core import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.training import optim as toptim

VLM, AUDIO = "paligemma-3b", "musicgen-large"
ARCHS = (VLM, AUDIO)
TRAIN = dict(eta=0.1, b_adc=6, quant_noise_p=0.5)
CLI = ["--batch", "2", "--prompt-len", "8", "--tokens", "4"]
CHIP = dict(tile_rows=32)  # every projection spans several crossbar tiles
OVERRIDE = {VLM: {"extras/patch_proj": 6}, AUDIO: {"lm_head": 6}}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _flat_bitwise(jtree, ttree):
    want = jstore._flatten(jtree)
    got = {k: v.numpy() for k, v in tstore._flatten(ttree).items()}
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


def _inputs(cfg, seed: int, b: int, s: int) -> dict:
    """A batch of ``cfg``'s inputs as numpy: frames for the audio family,
    else tokens (and image patches for the vision family)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def built() -> dict:
    return {}


def _build(name, built, tmp_path_factory) -> dict:
    """Both packages' params of ``name`` and the chip JAX programmed (one
    layer's bits overridden), saved and the port loaded; each arch once per
    module."""
    if name in built:
        return built[name]
    jcfg, tcfg = j_get_smoke(name), t_get_smoke(name)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    jprog = jengine.compile_program(
        jp, janalog.AnalogConfig(**CHIP).infer(b_adc=8, t_seconds=3600.0),
        jax.random.PRNGKey(7), b_adc_overrides=OVERRIDE[name])
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    tprog = tstore.load_program(path, params_like=tp, device="cpu")
    built[name] = dict(name=name, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jprog=jprog, tprog=tprog)
    return built[name]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, built, tmp_path_factory):
    return _build(request.param, built, tmp_path_factory)


@pytest.fixture(scope="module")
def vlm(built, tmp_path_factory):
    return _build(VLM, built, tmp_path_factory)


def test_registry_is_the_references():
    assert list(tconfigs.LM_ARCHS) == list(jconfigs.LM_ARCHS)
    for name in jconfigs.LM_ARCHS:
        for get in (jconfigs.get, jconfigs.get_smoke):
            want = dataclasses.asdict(get(name))
            got = dataclasses.asdict(getattr(tconfigs, get.__name__)(name))
            assert str(got.pop("dtype")).split(".")[-1] == want.pop("dtype").__name__
            assert got == want, name


def test_init_bitwise_and_forward_matches(arch):
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    _flat_bitwise(arch["jp"], arch["tp"])
    bridged = convert.params_from_numpy(jax.tree.map(np.asarray, arch["jp"]), tcfg, device="cpu")
    _flat_bitwise(arch["jp"], bridged)
    other = t_get_smoke(AUDIO if arch["name"] == VLM else VLM)
    with pytest.raises(ValueError, match="do not match"):
        convert.params_from_numpy(jax.tree.map(np.asarray, arch["jp"]), other, device="cpu")
    batch = _inputs(jcfg, 0, 2, 9)
    cases = [batch] + ([{"tokens": batch["tokens"]}] if "patches" in batch else [])
    for b in cases:
        want, _ = jlm.lm_forward(arch["jp"], _j(b), janalog.AnalogConfig(), jcfg)
        got, _ = tlm.lm_forward(arch["tp"], _t(b), tanalog.AnalogConfig(), tcfg)
        n = 9 + (jcfg.num_patches if "patches" in b else 0)
        shape = (2, n, 4, jcfg.vocab) if jcfg.n_codebooks else (2, n, jcfg.vocab)
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_jax_chip_serves_bitwise(arch):
    jcfg, tcfg, jprog, tprog = arch["jcfg"], arch["tcfg"], arch["jprog"], arch["tprog"]
    if arch["name"] == VLM:
        batch = _inputs(jcfg, 1, 2, 9)
        want, _ = jlm.lm_forward(jprog.params, _j(batch), jprog.cfg, jcfg, last_token_only=True)
        got, _ = tlm.lm_forward(tprog.params, _t(batch), tprog.cfg, tcfg, last_token_only=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
        # the engine's feature-fed prefill: each request alone, with its own
        # patches (JAX's engine's tokens are held by the CLI test below)
        served = tserving.ServingEngine.for_program(
            tprog, tcfg, tserving.ServingConfig(n_slots=2, s_max=32), device="cpu")
        for i in range(2):
            req = tserving.Request(rid=i, prompt=batch["tokens"][i], max_new_tokens=4,
                                   features={"patches": batch["patches"][i:i + 1]})
            tok, logits, _ = served.prefill(served.params, served.acfg, req)
            assert np.array_equal(logits.numpy(), np.asarray(want)[i:i + 1, -1])
            assert int(tok[0]) == int(np.asarray(want)[i, -1].argmax())
        return
    b, s, steps = 2, 6, 3
    frames = _inputs(jcfg, 2, b, s + steps)["frames"]
    jc = jlm.init_lm_cache(jcfg, b, s + steps, jnp.float32)
    tc = tlm.init_lm_cache(tcfg, b, s + steps, torch.float32, device="cpu")
    want, jc = jsteps.make_prefill_step(jcfg, jprog.cfg)(
        jprog.params, {"frames": jnp.asarray(frames[:, :s])}, jc, jax.random.PRNGKey(3))
    got, tc = tsteps.make_prefill_step(tcfg, tprog.cfg, device="cpu")(
        tprog.params, {"frames": frames[:, :s]}, tc, prng.PRNGKey(3))
    assert got.shape == (b, 1, 4, jcfg.vocab)
    assert np.array_equal(got.numpy(), np.asarray(want))
    jstep = jax.jit(jsteps.make_serve_step(jcfg, jprog.cfg))
    tstep = tsteps.make_serve_step(tcfg, tprog.cfg, device="cpu")
    for i in range(steps):
        row = frames[:, s + i:s + i + 1]
        want, jc = jstep(jprog.params, {"frames": jnp.asarray(row)}, jc, jax.random.PRNGKey(4))
        got, tc = tstep(tprog.params, {"frames": row}, tc, prng.PRNGKey(4))
        assert got.shape == (b, 4) and got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), i


def test_program_walk_and_artifacts_both_ways(arch, tmp_path):
    overrides = OVERRIDE[arch["name"]]
    (layer,) = overrides
    jprog = arch["jprog"]
    tprog = tengine.compile_program(
        arch["tp"], tanalog.AnalogConfig(**CHIP).infer(b_adc=8, t_seconds=3600.0),
        prng.PRNGKey(7), b_adc_overrides=overrides, device="cpu")
    _flat_bitwise(jprog.params, tprog.params)
    assert list(tprog.plans) == list(jprog.plans)
    assert list(tprog.plans)[-1] == layer  # patch_proj programs after the lm_head
    assert tengine.plan_bit_overrides(tprog) == jengine.plan_bit_overrides(jprog) == overrides
    jaged, taged = jengine.age_program(jprog, 86400.0), tengine.age_program(tprog, 86400.0)
    _flat_bitwise(jaged.params, taged.params)
    tstore.save_program(str(tmp_path / "port"), taged)
    jloaded = jstore.load_program(str(tmp_path / "port"), params_like=arch["jp"])
    _flat_bitwise(jloaded.params, taged.params)
    jstore.save_program(str(tmp_path / "jax"), jaged)
    tloaded = tstore.load_program(str(tmp_path / "jax"), params_like=arch["tp"], device="cpu")
    _flat_bitwise(jaged.params, tloaded.params)
    assert tengine.plan_bit_overrides(tloaded) == overrides
    if arch["name"] == VLM:
        plan = tengine.build_fused_plan(tprog)
        assert plan.n_groups == arch["tcfg"].n_layers


def test_resampled_read_noise_keys_as_the_reference(vlm):
    """A chip compiled with ``resample_read_noise``: ``extras/patch_proj``
    carries its read buffers, and a patch-fed forward redraws them first,
    at counter 1 of the lm_head's context (the head at counter 2), as the
    reference's ``AnalogCtx`` counts: both MVMs' drawn weights bitwise
    JAX's ``resample_read`` at those keys."""
    tcfg = vlm["tcfg"]
    prog = tengine.compile_program(
        vlm["tp"], tanalog.AnalogConfig(**CHIP, resample_read_noise=True).infer(b_adc=8),
        prng.PRNGKey(3), device="cpu")
    drawn = []

    def record(x_q, w, r_adc, plan, **kw):
        drawn.append(w)
        return tengine.execute_mvm(x_q, w, r_adc, plan, **kw)

    tlm.lm_forward(prog.params, _t(_inputs(tcfg, 8, 2, 6)), prog.cfg, tcfg,
                   rng=prng.PRNGKey(10), mvm=record)
    assert len(drawn) == 7 * tcfg.n_layers + 2
    # jitted, as the reference draws it in a served forward (XLA fuses the FMA)
    draw = jax.jit(jengine.resample_read)
    for got, node, counter in ((drawn[0], prog.params.extras["patch_proj"], 1),
                               (drawn[-1], prog.params.lm_head, 2)):
        buf = {k: jnp.asarray(v.numpy()) for k, v in node["read_buf"].items()}
        want = draw(jax.random.fold_in(jax.random.PRNGKey(10), counter), buf)
        assert np.array_equal(got.numpy(), np.asarray(want)), counter
        assert not torch.equal(got, node["w"])


def _tokens_line(out: str):
    tokens = re.search(r"^generated token ids \(first sequence\): (.*)$", out, re.M)
    counts = re.search(r"top1_agreement=(\S+) .* decisions=(\d+)", out)
    assert tokens and counts, out
    return tokens.group(1), counts.groups()


def test_cli_tokens_match_the_reference(tmp_path, capsys, monkeypatch):
    saved = str(tmp_path / "saved")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", VLM, "--analog", *CLI,
                                      "--save-program", saved])
    jserve.main()
    want = _tokens_line(capsys.readouterr().out)
    for argv in (["--analog"], ["--load-program", saved]):
        tserve.main(["--device", "cpu", "--arch", VLM, *argv, *CLI])
        assert _tokens_line(capsys.readouterr().out) == want, argv


def _main_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().err.strip().splitlines()[-1]


def test_refusals_are_the_reference(arch, capsys, monkeypatch):
    name, jcfg, tcfg = arch["name"], arch["jcfg"], arch["tcfg"]
    argv = ["--arch", name, "--analog", *CLI]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    if name == AUDIO:
        want = _main_error(lambda _: jserve.main(), argv, capsys)
        assert "multi-codebook decoders" in want
        assert _main_error(tserve.main, ["--device", "cpu", *argv], capsys) == want
    # feature-fed archs serve the rectangle path only
    trace = ["--arch", name, "--request-trace", "2"]
    errs = []
    for module in (jserve, tserve):
        ap = module.build_parser()
        with pytest.raises(SystemExit):
            module.validate_args(ap, ap.parse_args(trace))
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "needs the rectangle path" in errs[0]
    for config, match in ((dict(n_slots=2, s_max=32), "multi-codebook"),
                          (dict(n_slots=2, s_max=32, paged=True), "feature-fed")):
        if (match == "multi-codebook") != (name == AUDIO):
            continue
        msgs = []
        for pkg, params, kw in ((jserving, arch["jp"], {}), (tserving, arch["tp"], {"device": "cpu"})):
            cfg = jcfg if pkg is jserving else tcfg
            with pytest.raises(NotImplementedError, match=match) as info:
                pkg.ServingEngine(cfg, (janalog if pkg is jserving else tanalog).AnalogConfig(),
                                  params, pkg.ServingConfig(**config), **kw)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_fused_decode_serves_the_per_layer_tokens(vlm):
    cfg, prog = vlm["tcfg"], vlm["tprog"]
    batch = _inputs(cfg, 5, 3, 7)
    tokens = []
    for fused in (False, True):
        served = tserving.ServingEngine.for_program(
            prog, cfg, tserving.ServingConfig(n_slots=2, s_max=24, fused_decode=fused),
            device="cpu")
        reqs = [tserving.Request(rid=i, prompt=batch["tokens"][i, : 7 - 2 * i], max_new_tokens=5,
                                 features={"patches": batch["patches"][i:i + 1]})
                for i in range(3)]
        rep = served.run(reqs)
        tokens.append([rep.tokens_of(i).tolist() for i in range(3)])
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("name,stage", [(VLM, 1), (AUDIO, 2)])
def test_train_step_matches_reference(name, stage, built, tmp_path_factory):
    arch = _build(name, built, tmp_path_factory)
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    if stage == 1:
        jacfg, tacfg = janalog.AnalogConfig(), tanalog.AnalogConfig()
    else:
        jacfg = janalog.AnalogConfig().train(**TRAIN)
        tacfg = tanalog.AnalogConfig().train(**TRAIN)
    batch = _inputs(jcfg, 6, 2, 12)
    labels = (2, 12, jcfg.n_codebooks) if jcfg.n_codebooks else (2, 12)
    batch["labels"] = np.random.default_rng(7).integers(0, jcfg.vocab, labels).astype(np.int32)
    jo = joptim.OptimizerConfig(lr=1e-2, total_steps=10, warmup=0)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jacfg, jo))
    _, _, jm = jstep(arch["jp"], joptim.init(jo, arch["jp"]), _j(batch), jax.random.PRNGKey(1))
    to = toptim.OptimizerConfig(lr=1e-2, total_steps=10, warmup=0)
    tstep = tsteps.make_train_step(tcfg, tacfg, to)
    _, _, tm = tstep(arch["tp"], toptim.init(to, arch["tp"]), _t(batch), prng.PRNGKey(1))
    rtol = 1e-5 if stage == 1 else 1e-4
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=rtol)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)


def test_step_makers_cast_the_weights_once(built, tmp_path_factory, monkeypatch):
    """The step makers execute a bf16 config's fp32 chip from a copy cast
    once per params object, shared by the prefill and the serve step
    handed the same object and freed with them: logits and codes bitwise
    the per-call cast's (``lm_forward`` on the fp32 params)."""
    arch = _build(AUDIO, built, tmp_path_factory)
    cfg = dataclasses.replace(arch["tcfg"], dtype=torch.bfloat16)
    params, acfg = arch["tprog"].params, arch["tprog"].cfg
    casts = []
    cast = tengine.cast_weights
    monkeypatch.setattr(tengine, "cast_weights", lambda p, d: casts.append(d) or cast(p, d))
    b, s, steps = 2, 6, 2
    frames = torch.from_numpy(_inputs(cfg, 5, b, s + steps)["frames"]).to(torch.bfloat16)
    prefill = tsteps.make_prefill_step(cfg, acfg, device="cpu")
    step = tsteps.make_serve_step(cfg, acfg, device="cpu")
    cache = tlm.init_lm_cache(cfg, b, s + steps, torch.bfloat16, device="cpu")
    want_cache = tlm.init_lm_cache(cfg, b, s + steps, torch.bfloat16, device="cpu")
    got, cache = prefill(params, {"frames": frames[:, :s]}, cache, prng.PRNGKey(3))
    want, want_cache = tlm.lm_forward(params, {"frames": frames[:, :s]}, acfg, cfg,
                                      cache=want_cache, last_token_only=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for i in range(steps):
        row = {"frames": frames[:, s + i:s + i + 1]}
        got, cache = step(params, row, cache, prng.PRNGKey(4))
        logits, want_cache = tlm.lm_forward(params, row, acfg, cfg, cache=want_cache)
        assert torch.equal(got, logits[:, -1].argmax(-1).to(torch.int32)), i
    assert casts == [torch.bfloat16] and len(tsteps._CASTS) == 1
    other = params._replace(extras=dict(params.extras))  # a new params object
    step(other, {"frames": frames[:, -1:]}, cache, prng.PRNGKey(4))
    assert casts == [torch.bfloat16] * 2
    del prefill, step
    assert len(tsteps._CASTS) == 0
