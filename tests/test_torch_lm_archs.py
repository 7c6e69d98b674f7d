"""Port parity: the other dense LMs (llama3.2-3b, olmo-1b, qwen2-72b) and
``cfg.remat``.

Each arch at its reference smoke config (``get_smoke``; qwen2 carries qkv
biases, olmo non-parametric norms, every one its own ``rope_theta``):

* ``lm_init`` through the RNG bridge bitwise the reference's, and the
  digital forward's logits within ``atol=1e-4`` (the frameworks sum their
  f32 matmuls in other orders);
* a chip JAX programmed and saved (``tile_rows=32``, so every projection
  spans several crossbar tiles) loaded by the port on its template
  (``load_program(params_like=)``): the prefill logits bitwise JAX's;
* the serving CLIs: one JAX CLI run (``--analog --request-trace 2
  --save-program DIR``) and the port's ``--analog`` and ``--load-program
  DIR`` runs print the same summary counts and tokens; qwen2's
  ``--fused-decode`` is refused by both CLIs (qkv biases), the others'
  accepted by both;
* one stage-1 (digital) and one stage-2 (``analog_train``, quant noise on)
  step of ``launch/steps.py::make_train_step`` against the reference's
  jitted step: the loss within 1e-5 (1e-4 in stage 2) relative and the
  grad norm within 1e-4 (the bounds of ``tests/test_torch_lm_train.py``);
  every updated element within 1e-5 (relative, over 1) but at most 0.1%
  of a leaf's, those within 2 lr: Adam's first step moves an element by
  lr g / (|g| + eps), so where |g| is a few eps the frameworks' 1e-6
  relative gradient rounding moves it by up to 2 lr (olmo's smoke wk:
  one element of 4096, |g| 5.7e-8, 1.3e-3 apart; its gradients agree
  within 1.2e-6 relative L2); qwen2's key bias, whose gradient is 0 up to
  rounding, within 2 lr everywhere;
* ``cfg.remat``: the loss and every gradient leaf of a stage-2 step with
  weight noise and keep masks on are bitwise those without it (dense and
  MoE), and the recompute shows in the plain version's call count (each
  group's MVMs run twice) while the backward recomputes once.
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
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.core import engine as jengine
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.training import optim as toptim
from repro_torch.training.loop import value_and_grad

ARCHS = ("llama3.2-3b", "olmo-1b", "qwen2-72b")
TRAIN = dict(eta=0.1, b_adc=6, quant_noise_p=0.5)
LR = 1e-2
CLI = ["--request-trace", "2", "--batch", "2", "--prompt-len", "8", "--tokens", "4"]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, tmp_path_factory):
    name = request.param
    jcfg, tcfg = j_get_smoke(name), t_get_smoke(name)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    jprog = jengine.compile_program(jp, janalog.AnalogConfig(tile_rows=32).infer(b_adc=8),
                                    jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jprog=jprog, path=path,
                toks=toks)


def test_init_bitwise_and_forward_matches(arch):
    jleaves = jax.tree.leaves(arch["jp"])
    tleaves = tree_lib.leaves(arch["tp"])
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    want, _ = jlm.lm_forward(arch["jp"], {"tokens": jnp.asarray(arch["toks"])},
                             janalog.AnalogConfig(), arch["jcfg"])
    got, _ = tlm.lm_forward(arch["tp"], {"tokens": torch.from_numpy(arch["toks"]).long()},
                            tanalog.AnalogConfig(), arch["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_jax_chip_serves_bitwise_logits(arch):
    loaded = tstore.load_program(arch["path"], params_like=arch["tp"], device="cpu")
    if arch["tcfg"].nonparametric_ln:
        assert loaded.params.blocks[0]["norm1"] == {}
    want, _ = jlm.lm_forward(arch["jprog"].params, {"tokens": jnp.asarray(arch["toks"])},
                             arch["jprog"].cfg, arch["jcfg"], last_token_only=True)
    got, _ = tlm.lm_forward(loaded.params, {"tokens": torch.from_numpy(arch["toks"]).long()},
                            loaded.cfg, arch["tcfg"], last_token_only=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _summary_and_tokens(out: str):
    summary = re.search(r"^serving: .*requests=(\d+) tokens=(\d+) steps=(\d+)", out, re.M)
    tokens = re.search(r"^generated token ids \(longest request\): (.*)$", out, re.M)
    assert summary and tokens, out
    return summary.groups(), tokens.group(1)


def test_cli_tokens_match_the_reference(arch, tmp_path, capsys, monkeypatch):
    saved = str(tmp_path / "saved")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch["name"], "--analog", *CLI,
                                      "--save-program", saved])
    jserve.main()
    want = _summary_and_tokens(capsys.readouterr().out)
    for argv in (["--analog"], ["--load-program", saved]):
        tserve.main(["--device", "cpu", "--arch", arch["name"], *argv, *CLI])
        assert _summary_and_tokens(capsys.readouterr().out) == want, argv


def _rejects(module, argv) -> bool:
    ap = module.build_parser()
    try:
        module.validate_args(ap, ap.parse_args(argv))
    except SystemExit:
        return True
    return False


@pytest.mark.parametrize("name", ARCHS)
def test_fused_decode_refusal_is_the_reference(name):
    argv = ["--arch", name, "--analog", "--fused-decode", "--request-trace", "2"]
    assert _rejects(tserve, argv) == _rejects(jserve, argv) == (name == "qwen2-72b")


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_reference(arch, stage):
    if stage == 1:
        jacfg, tacfg = janalog.AnalogConfig(), tanalog.AnalogConfig()
    else:
        jacfg = janalog.AnalogConfig().train(**TRAIN)
        tacfg = tanalog.AnalogConfig().train(**TRAIN)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, arch["jcfg"].vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jo = joptim.OptimizerConfig(lr=LR, total_steps=10, warmup=0)
    jstep = jax.jit(jsteps.make_train_step(arch["jcfg"], jacfg, jo))
    jp, _, jm = jstep(arch["jp"], joptim.init(jo, arch["jp"]),
                      jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    to = toptim.OptimizerConfig(lr=LR, total_steps=10, warmup=0)
    tstep = tsteps.make_train_step(arch["tcfg"], tacfg, to)
    tp, _, tm = tstep(arch["tp"], toptim.init(to, arch["tp"]),
                      {k: torch.as_tensor(v) for k, v in batch.items()}, prng.PRNGKey(1))
    rtol = 1e-5 if stage == 1 else 1e-4
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=rtol)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, got), want in zip(tree_lib.flatten_with_path(tp), jax.tree.leaves(jp),
                                 strict=True):
        name = tree_lib.path_name(path)
        d = np.abs(got.numpy() - np.asarray(want))
        far = d > 1e-5 * (1.0 + np.abs(np.asarray(want)))
        # the key bias's gradient is 0 up to rounding (a per-query constant
        # on every score leaves the softmax unchanged): Adam scales each
        # framework's rounding noise to its own update, within 2 lr
        share = 1.0 if name.endswith("attn/wk/b") else 1e-3
        assert far.mean() <= share and d.max() <= 2 * LR + 1e-6, (name, int(far.sum()), d.max())


def _step(params, cfg, acfg, batch):
    plain = lambda: tref.analog_mvm_ref.calls + tengine.tile_matmul_quant.calls
    calls, back = plain(), tops.backward_calls
    (loss, _), grads = value_and_grad(
        lambda p: tlm.lm_loss(p, batch, acfg, cfg, rng=prng.PRNGKey(5)), params)
    return loss, grads, plain() - calls, tops.backward_calls - back


@pytest.mark.parametrize("name", ["olmo-1b", "phi3.5-moe-42b-a6.6b"])
def test_remat_changes_no_value(name):
    cfg = dataclasses.replace(t_get_smoke(name), n_layers=4)
    acfg = tanalog.AnalogConfig(tile_rows=32).train(**TRAIN)  # keep masks on every MVM
    params = tlm.lm_init(prng.PRNGKey(2), cfg, device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12))) for k in ("tokens", "labels")}
    off = _step(params, cfg, acfg, batch)
    on = _step(params, dataclasses.replace(cfg, remat=True), acfg, batch)
    assert torch.equal(on[0], off[0])
    g_off, g_on = tree_lib.leaves(off[1]), tree_lib.leaves(on[1])
    assert len(g_on) == len(g_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    # the recompute runs every group's MVMs again (the lm_head is outside
    # the groups); the backward still recomputes each MVM once
    per_group = (off[2] - 1) // cfg.n_layers
    assert on[2] == off[2] + cfg.n_layers * per_group
    assert on[3] == off[3]


def test_chunked_program_is_the_one_pass_chip(monkeypatch):
    """A member larger than ``engine._CHUNK`` elements is programmed, drifted
    and read row chunk by row chunk (qwen2-72b's 1.25 B-weight lm_head on a
    card); the chip is bitwise the one-pass chip, which
    ``tests/test_torch_program_phase.py`` holds bitwise to the reference's.
    Here every member above 2,048 weights is split (the lm_head in 8
    chunks, w1 in 4, wq in 2), with drift, read noise, the GDC and the read
    buffers on."""
    key = prng.PRNGKey(11)
    assert torch.equal(prng.normal(key, (7, 5))[2:5], prng.normal(key, (3, 5), offset=10))
    tcfg = t_get_smoke("qwen2-72b")
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    acfg = tanalog.AnalogConfig(tile_rows=32, resample_read_noise=True).infer(t_seconds=3600.0)
    one_pass = tengine.compile_program(tp, acfg, prng.PRNGKey(4), device="cpu")
    monkeypatch.setattr(tengine, "_CHUNK", 2048)
    chunked = tengine.compile_program(tp, acfg, prng.PRNGKey(4), device="cpu")
    for a, b in ((one_pass.params, chunked.params), (one_pass.state, chunked.state),
                 (tengine.age_program(one_pass, 86400.0).params,
                  tengine.age_program(chunked, 86400.0).params)):
        fa, fb = tstore._flatten(a), tstore._flatten(b)
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
