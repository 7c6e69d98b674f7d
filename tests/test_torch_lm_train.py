"""LM training in the port against the reference, on the CPU
(``models/lm.py::lm_loss``, ``kernels/ops.py::flash_attention_ste``,
``launch/steps.py::make_train_step``):

* ``lm_loss`` and its gradients at tinyllama-1.1b's smoke config against
  ``jax.value_and_grad(repro.models.lm.lm_loss)`` from the same params
  (``lm_init(PRNGKey(0))`` through the RNG bridge, bitwise the
  reference's), batch and key: digital, the loss within 1e-5 relative and
  each gradient leaf within 1e-4 relative L2; ``analog_train`` (b_adc 6,
  p = 0.5), every weight-noise draw and quant-noise mask bitwise the
  reference's from the reference's own key schedule, the loss within
  ``STAGE2_RTOL`` and each leaf within 1e-4 relative L2;
* ``make_train_step`` at ``accum_steps`` 1 and 4, digital and
  ``analog_train``, against the reference's jitted step: the metrics'
  keys, the loss within 1e-5 (1e-4 in ``analog_train``) relative, the
  updated params within 1e-4 relative L2; and the reference's own test of
  accumulation (``tests/test_train_step_features.py``) on the port: accum
  4 equals accum 1 to 1e-5 in the loss, rtol 2e-3 / atol 2e-5 in params;
* B3's training form on the CPU: its output bitwise the plain version's,
  its gradients bitwise autograd of ``flash_attention_ref`` and within
  1e-5 (relative to the largest) of ``jax.vjp`` of the reference's
  ``chunked_attention``; one counted recompute per backward; with grad off
  ``chunked_attention`` does not take the training form;
* the reference's fault: ``refresh_clip_ranges`` walks dicts only, so on
  an ``LMParams`` it returns the tree unchanged and after a two-stage run
  every LM ``w_clip_buf`` is still [-1, 1] -- in both packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.core import noise as jnoise
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import ModelConfig as JModelConfig
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro.training.loop import TrainConfig as JTrainConfig
from repro.training.loop import run_two_stage as jrun
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.core import noise as tnoise
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.common import ModelConfig
from repro_torch.training import optim as toptim
from repro_torch.training.loop import TrainConfig as TTrainConfig
from repro_torch.training.loop import run_two_stage as trun
from repro_torch.training.loop import value_and_grad

#: the stage-2 loss bound (the CNN CLI's, ``tests/test_torch_train_loop.py``)
STAGE2_RTOL = 3e-4
ARCH = "tinyllama-1.1b"
TRAIN = dict(eta=0.1, b_adc=6, quant_noise_p=0.5)


def _cfgs(mode: str):
    if mode == "digital":
        return janalog.AnalogConfig(), tanalog.AnalogConfig()
    return janalog.AnalogConfig().train(**TRAIN), tanalog.AnalogConfig().train(**TRAIN)


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = j_get_smoke(ARCH), t_get_smoke(ARCH)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, batch=batch)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_init_bitwise(smoke):
    leaves = jax.tree.leaves(smoke["jp"])
    assert len(leaves) == len(tree_lib.leaves(smoke["tp"]))
    for a, b in zip(leaves, tree_lib.leaves(smoke["tp"])):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def _reference_keys(rng, n_groups: int, per_group: int, head: int) -> list:
    """The keys the reference's forward hands its analog layers, from its
    own ``AnalogCtx``: group g counts from ``fold_in(rng, g)``, the lm_head
    from ``rng``."""
    keys = []
    for g in range(n_groups):
        ctx = janalog.AnalogCtx(cfg=None, gain_s=None, key=jax.random.fold_in(rng, g))
        keys += [ctx.next_key() for _ in range(per_group)]
    ctx = janalog.AnalogCtx(cfg=None, gain_s=None, key=rng)
    return keys + [ctx.next_key() for _ in range(head)]


@pytest.mark.parametrize("mode", ["digital", "analog_train"])
def test_lm_loss_and_grads_match_reference(smoke, mode, monkeypatch):
    jacfg, tacfg = _cfgs(mode)
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    key = jax.random.PRNGKey(3)
    f = jax.jit(jax.value_and_grad(
        lambda p, b, k: jlm.lm_loss(p, b, jacfg, jcfg, rng=k), has_aux=True))
    (jl, jm), jg = f(smoke["jp"], jax.tree.map(jnp.asarray, smoke["batch"]), key)

    draws = []
    inject, bernoulli = tnoise.inject, prng.bernoulli

    def tap_inject(k, w, eta, w_min, w_max):
        out = inject(k, w, eta, w_min, w_max)
        draws.append(("w", k, (w.detach(), w_min.detach(), w_max.detach()), out.detach()))
        return out

    def tap_bernoulli(k, p, shape):
        out = bernoulli(k, p, shape)
        draws.append(("mask", k, (p, tuple(shape)), out))
        return out

    monkeypatch.setattr(tnoise, "inject", tap_inject)
    monkeypatch.setattr(prng, "bernoulli", tap_bernoulli)
    tb = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    (tl, tm), tg = value_and_grad(
        lambda p: tlm.lm_loss(p, tb, tacfg, tcfg, rng=prng.PRNGKey(3)), smoke["tp"])

    assert list(tm) == list(jm) == ["loss", "ppl_proxy"]
    assert float(tm["ppl_proxy"]) == pytest.approx(float(jm["ppl_proxy"]), rel=1e-4)
    rtol = 1e-5 if mode == "digital" else STAGE2_RTOL
    assert float(tl) == pytest.approx(float(jl), rel=rtol)
    jleaves = jax.tree.leaves(jg)
    for (path, g), want in zip(tree_lib.flatten_with_path(tg), jleaves, strict=True):
        assert _rel(g.numpy(), want) <= 1e-4, (tree_lib.path_name(path), _rel(g.numpy(), want))

    if mode == "digital":
        assert draws == []
        return
    # 7 projections x 3 draws a group, the lm_head's 3: every key is the
    # reference's, every draw bitwise the reference's draw from it
    n_groups = tcfg.n_layers
    assert len(draws) == 21 * n_groups + 3
    want_keys = _reference_keys(key, n_groups, 21, 3)
    jinject = jax.jit(lambda k, w, lo, hi: jnoise.inject(k, w, TRAIN["eta"], lo, hi))
    for (kind, k, args, out), wk in zip(draws, want_keys, strict=True):
        assert k.numpy().astype(np.uint32).tobytes() == np.asarray(wk).tobytes()
        if kind == "mask":
            p, shape = args
            want = jax.random.bernoulli(wk, p, shape)
        else:
            w, w_min, w_max = (jnp.asarray(a.numpy()) for a in args)
            want = jinject(wk, w, w_min, w_max)
        assert out.numpy().tobytes() == np.asarray(want).tobytes(), kind


def _acc_cfg(model_config, dtype):
    return model_config(name="acc", family="dense", n_layers=2, d_model=32, n_heads=2,
                         n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, remat=False,
                         dtype=dtype, attn_chunk_q=16, attn_chunk_kv=16)


@pytest.fixture(scope="module")
def acc_case():
    jcfg, tcfg = _acc_cfg(JModelConfig, jnp.float32), _acc_cfg(ModelConfig, torch.float32)
    key = jax.random.PRNGKey(1)
    batch = {"tokens": np.asarray(jax.random.randint(key, (8, 16), 0, jcfg.vocab)),
             "labels": np.asarray(jax.random.randint(key, (8, 16), 0, jcfg.vocab))}
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch,
                jp=jlm.lm_init(jax.random.PRNGKey(0), jcfg),
                tp=tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu"))


def _port_step(case, acfg, accum: int):
    ocfg = toptim.OptimizerConfig(lr=1e-2, total_steps=10, warmup=0)
    step = tsteps.make_train_step(case["tcfg"], acfg, ocfg, accum_steps=accum)
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    return step(case["tp"], toptim.init(ocfg, case["tp"]), batch, prng.PRNGKey(1))


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("mode", ["digital", "analog_train"])
def test_train_step_matches_reference(acc_case, mode, accum):
    jacfg, tacfg = _cfgs(mode)
    ocfg = joptim.OptimizerConfig(lr=1e-2, total_steps=10, warmup=0)
    jstep = jax.jit(jsteps.make_train_step(acc_case["jcfg"], jacfg, ocfg, accum_steps=accum))
    jp, jo, jm = jstep(acc_case["jp"], joptim.init(ocfg, acc_case["jp"]),
                       jax.tree.map(jnp.asarray, acc_case["batch"]), jax.random.PRNGKey(1))
    tp, to, tm = _port_step(acc_case, tacfg, accum)
    assert list(tm) == sorted(jm)
    assert ("ppl_proxy" in tm) == (accum == 1)
    rtol = 1e-5 if mode == "digital" else 1e-4
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=rtol)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert int(to.step) == int(jo.step) == 1
    for (path, got), want in zip(tree_lib.flatten_with_path(tp), jax.tree.leaves(jp),
                                 strict=True):
        assert _rel(got.numpy(), want) <= 1e-4, tree_lib.path_name(path)


def test_grad_accumulation_matches_full_batch(acc_case):
    outs = {a: _port_step(acc_case, tanalog.AnalogConfig(), a) for a in (1, 4)}
    assert abs(float(outs[1][2]["loss"]) - float(outs[4][2]["loss"])) < 1e-5
    for a, b in zip(tree_lib.leaves(outs[1][0]), tree_lib.leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)


def test_accumulation_shares_one_noise_key(acc_case, monkeypatch):
    """Every microbatch draws from the step's key, as the reference's scan
    body does: the 4 microbatches repeat one key sequence."""
    keys = []
    inject = tnoise.inject

    def tap(k, *a):
        keys.append(k.numpy().tobytes())
        return inject(k, *a)

    monkeypatch.setattr(tnoise, "inject", tap)
    _port_step(acc_case, tanalog.AnalogConfig().train(**TRAIN), 4)
    per = len(keys) // 4
    assert per == 7 * 2 + 1 and keys == keys[:per] * 4


@pytest.mark.parametrize("chunks", [(16, 32), (64, 64), (8, 16)])
def test_flash_attention_ste_on_the_cpu(chunks):
    qc, kc = chunks
    rng = np.random.default_rng(qc)
    b, s, h, kv, d = 2, 40, 4, 2, 16
    q, g = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, kv, d)).astype(np.float32) for _ in range(2))
    jo, vjp = jax.vjp(
        lambda q, k, v: jattn.chunked_attention(q, k, v, q_chunk=qc, kv_chunk=kc, causal=True),
        *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(g))

    ts = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    rs = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    calls0, back0 = tref.flash_attention_ref.calls, tops.attention_backward_calls
    o = tops.flash_attention_ste(*ts, causal=True, q_chunk=qc, kv_chunk=kc)
    assert tref.flash_attention_ref.calls == calls0 + 1  # the forward: the plain version
    tg = torch.autograd.grad(o, ts, torch.tensor(g))
    assert tops.attention_backward_calls == back0 + 1
    assert tref.flash_attention_ref.calls == calls0 + 1  # the recompute is not counted there
    ro = tref.flash_attention_ref(*rs, True, q_chunk=qc, kv_chunk=kc)
    rg = torch.autograd.grad(ro, rs, torch.tensor(g))
    assert torch.equal(o, ro)
    assert all(torch.equal(a, c) for a, c in zip(tg, rg))
    assert np.abs(o.detach().numpy() - np.asarray(jo)).max() <= 1e-5 * np.abs(jo).max()
    for a, want in zip(tg, jg):
        want = np.asarray(want)
        assert np.abs(a.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_chunked_attention_takes_the_training_form_only_under_grad():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(1, 12, 4, 16)).astype(np.float32))
    k, v = (torch.tensor(rng.normal(size=(1, 12, 2, 16)).astype(np.float32)) for _ in range(2))
    plain = tattn.chunked_attention(q, k, v, q_chunk=16, kv_chunk=32)
    assert plain.grad_fn is None
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert tattn.chunked_attention(qg, k, v, q_chunk=16, kv_chunk=32).grad_fn is None
    qg = q.clone().requires_grad_()
    out = tattn.chunked_attention(qg, k, v, q_chunk=16, kv_chunk=32)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)


def test_refresh_clip_ranges_leaves_lm_ranges_as_the_reference(smoke):
    """The reference fault pinned: its stage-1 refresh never changes an LM
    layer's clip range, so both packages train every layer at [-1, 1]."""
    assert janalog.refresh_clip_ranges(smoke["jp"]) is smoke["jp"]
    assert tanalog.refresh_clip_ranges(smoke["tp"]) is smoke["tp"]
    run = dict(stage1_steps=3, stage2_steps=1, lr=3e-3, log_every=1, clip_refresh_every=1)
    pipe = dict(kind="lm", global_batch=2, seq_len=8, vocab=smoke["jcfg"].vocab)
    jloss = lambda p, b, a, r: jlm.lm_loss(p, b, a, smoke["jcfg"], rng=r)
    tloss = lambda p, b, a, r: tlm.lm_loss(p, b, a, smoke["tcfg"], rng=r)
    jp, _ = jrun(jloss, smoke["jp"], jpipe.iterate(jpipe.PipelineConfig(**pipe)),
                 JTrainConfig(**run))
    tp, _ = trun(tloss, smoke["tp"], tpipe.iterate(tpipe.PipelineConfig(**pipe)),
                 TTrainConfig(**run))
    bufs = {"jax": [np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]
                    if "w_clip_buf" in jax.tree_util.keystr(p)],
            "port": [x.numpy() for p, x in tree_lib.flatten_with_path(tp)
                     if "w_clip_buf" in p]}
    for name, got in bufs.items():
        assert len(got) == 8, name  # 7 stacked projections and the lm_head
        for buf in got:
            assert np.array_equal(buf.reshape(-1, 2), np.tile([-1.0, 1.0], (buf.size // 2, 1)))
