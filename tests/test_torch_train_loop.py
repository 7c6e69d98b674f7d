"""The paper's two-stage training in the port against the reference, on
the CPU (``data/pipeline.py``, ``training/loop.py``, the training half of
``checkpoint/store.py``, ``launch/train.py``):

* data batches bitwise for each (seed, step, host);
* ``run_two_stage`` on ``tests/test_training_method.py``'s TINY CNN and on
  a variant with a depthwise conv (trained through ``depthwise_densify``),
  stage 1 = stage 2 = 6 steps, every step logged: each ``loss`` and
  ``grad_norm`` within 1e-4 relative, the final leaves within 1e-4
  relative L2;
* checkpoints: the reference's restored by the port and the port's by the
  reference, bitwise; a resume at the end runs nothing more; a resume
  after the stage boundary does what the reference does -- its
  checkpoints hold params only, so it restarts the stage-1 optimizer and
  trains on in stage 1 (digital) -- in both packages alike;
* the CLI, ``--arch analognet-kws --device cpu --stage1 2 --stage2 2
  --batch 4``, against the reference's ``main()``: the same lines and
  metric keys; stage 1's losses within 1e-6 relative and stage 2's within
  ``CLI_STAGE2_RTOL``. At AnalogNet-KWS's full width a few DAC/ADC codes
  flip between the two packages' fp32 summation orders (the repo's ADC
  tolerance model); from the same state one stage-2 step agrees to 1e-7
  in the loss and 5e-7 in the weight gradients, but Adam's first steps
  carry the flipped codes' gradient into the weights: measured 1.2e-4 at
  the last step. The same run from the weights and data of seeds 1-5,
  every step logged, is held to the same bounds (over seeds 0-5 the
  worst stage-2 reading was 1.80e-4, at seed 5's last step).
"""

import contextlib
import io
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.checkpoint import store as jstore
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import analognet as jan
from repro.training.loop import TrainConfig as JTrainConfig
from repro.training.loop import run_two_stage as jrun
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store as tstore
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import analognet as tan
from repro_torch.training.loop import TrainConfig as TTrainConfig
from repro_torch.training.loop import run_two_stage as trun

#: stage-2 loss tolerance of the full-width CLI run (module docstring)
CLI_STAGE2_RTOL = 3e-4
RUN = dict(stage1_steps=6, stage2_steps=6, eta=0.1, b_adc=6, lr=5e-3, log_every=1,
           ckpt_every=4)


def _tiny(m, depthwise: bool):
    convs = [m.ConvSpec("c1", 3, 3, 1, 12, 2)]
    if depthwise:
        convs.append(m.ConvSpec("dw", 3, 3, 12, 12, 1, depthwise=True))
    convs.append(m.ConvSpec("c2", 3, 3, 12, 16, 2))
    return m.CNNConfig(name="tiny_kws", input_hw=(16, 8), in_channels=1, convs=tuple(convs),
                       n_classes=4, fc_width=16)


def _pipe(m):
    return m.PipelineConfig(kind="kws", global_batch=32, n_classes=4, input_hw=(16, 8),
                            channels=1)


def _jflat(tree) -> dict:
    return jstore._flatten(tree)


def _tflat(tree) -> dict:
    return {tree_lib.path_name(p, "::"): v.detach().numpy()
            for p, v in tree_lib.flatten_with_path(tree)}


def _assert_bitwise(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("cfg", [
    dict(kind="kws", global_batch=8, n_classes=12, input_hw=(49, 10), channels=1),
    dict(kind="vww", global_batch=4, n_classes=2, input_hw=(20, 20), channels=3, seed=3),
    dict(kind="lm", global_batch=6, seq_len=16, vocab=97, host_index=1, host_count=2),
])
def test_batches_bitwise(cfg):
    jc, tc = jpipe.PipelineConfig(**cfg), tpipe.PipelineConfig(**cfg)
    for step in (0, 1, 57):
        want, got = jpipe.batch_at(jc, step), tpipe.batch_at(tc, step)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes()
    it_j, it_t = jpipe.iterate(jc, 5), tpipe.iterate(tc, 5)
    for _ in range(3):
        a, b = next(it_j), next(it_t)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "depthwise"])
def tiny_runs(request, tmp_path_factory):
    depthwise = request.param
    root = tmp_path_factory.mktemp("dw" if depthwise else "dense")
    jcfg, tcfg = _tiny(jan, depthwise), _tiny(tan, depthwise)
    jloss = lambda p, b, a, r: jan.cnn_loss(p, b, a, jcfg, rng=r)
    tloss = lambda p, b, a, r: tan.cnn_loss(p, b, a, tcfg, rng=r)
    jp, jh = jrun(jloss, jan.cnn_init(jax.random.PRNGKey(0), jcfg), jpipe.iterate(_pipe(jpipe)),
                  JTrainConfig(**RUN, ckpt_dir=str(root / "jax")))
    tp0 = tan.cnn_init(prng.PRNGKey(0), tcfg, device="cpu")
    tp, th = trun(tloss, tp0, tpipe.iterate(_pipe(tpipe)),
                  TTrainConfig(**RUN, ckpt_dir=str(root / "port")))
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, jloss=jloss, tloss=tloss, jp=jp, jh=jh,
                tp=tp, th=th, tp0=tp0)


def test_two_stage_matches_reference(tiny_runs):
    jh, th = tiny_runs["jh"], tiny_runs["th"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(12))
    assert [h["stage"] for h in th] == [h["stage"] for h in jh] == [1] * 6 + [2] * 6
    for a, b in zip(jh, th):
        assert list(a) == list(b)
        for k in ("loss", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=1e-4), (a["step"], k)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)
    want, got = _jflat(tiny_runs["jp"]), _tflat(tiny_runs["tp"])
    assert list(want) == list(got)
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert rel <= 1e-4, (k, rel)
    # stage 2 trained the ranges and S, and froze the clip ranges it set
    assert float(tiny_runs["tp"]["gain_s"]) != 1.0
    assert float(tiny_runs["tp"]["c1"]["r_adc"]) != 1.0


def test_checkpoints_cross_restore_bitwise(tiny_runs):
    root = tiny_runs["root"]
    for d in ("jax", "port"):
        assert tstore.latest_step(str(root / d)) == jstore.latest_step(str(root / d)) == 12
        assert sorted(p.name for p in (root / d).iterdir()) == [
            "step_00000005", "step_00000009", "step_00000012"]
        assert tstore.read_meta(str(root / d), 12)["final"] is True
    # the reference's checkpoint in the port, the port's in the reference
    got = tstore.restore(str(root / "jax"), 12, tiny_runs["tp0"])
    _assert_bitwise(_jflat(tiny_runs["jp"]), _tflat(got))
    jlike = jan.cnn_init(jax.random.PRNGKey(0), tiny_runs["jcfg"])
    back = jstore.restore(str(root / "port"), 12, jlike)
    _assert_bitwise(_tflat(tiny_runs["tp"]), _jflat(back))


def test_resume_at_the_end_runs_nothing(tiny_runs):
    params, hist = trun(tiny_runs["tloss"], tiny_runs["tp0"], tpipe.iterate(_pipe(tpipe)),
                        TTrainConfig(**RUN, ckpt_dir=str(tiny_runs["root"] / "port")))
    assert hist == []
    _assert_bitwise(_tflat(tiny_runs["tp"]), _tflat(params))


def test_resume_after_the_boundary_as_the_reference(tiny_runs):
    root = tiny_runs["root"]
    hists = {}
    for d in ("jax", "port"):
        resume = root / f"resume_{d}"
        shutil.copytree(root / d / "step_00000009", resume / "step_00000009")
        if d == "jax":
            _, hists[d] = jrun(tiny_runs["jloss"],
                               jan.cnn_init(jax.random.PRNGKey(0), tiny_runs["jcfg"]),
                               jpipe.iterate(_pipe(jpipe), 9),
                               JTrainConfig(**RUN, ckpt_dir=str(resume)))
        else:
            _, hists[d] = trun(tiny_runs["tloss"], tiny_runs["tp0"],
                               tpipe.iterate(_pipe(tpipe), 9),
                               TTrainConfig(**RUN, ckpt_dir=str(resume)))
    jh, th = hists["jax"], hists["port"]
    # steps 9..11 run in stage 1: the reference's resume never flips to stage 2
    assert [(h["step"], h["stage"]) for h in th] == [(h["step"], h["stage"]) for h in jh] == [
        (9, 1), (10, 1), (11, 1)]
    for a, b in zip(jh, th):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    # the restarted stage-1 optimizer: its first step's cosine warm-up LR
    assert th[0]["lr"] == pytest.approx(jh[0]["lr"], rel=1e-6)


def _lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_cli_matches_reference(monkeypatch):
    args = ["--arch", "analognet-kws", "--stage1", "2", "--stage2", "2", "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *args])
    out_j = io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jtrain.main()
    out_t = io.StringIO()
    with contextlib.redirect_stdout(out_t):
        ttrain.main([*args, "--device", "cpu"])
    jl, tl = _lines(out_j.getvalue()), _lines(out_t.getvalue())
    assert [list(m) for m in tl] == [list(m) for m in jl]
    assert [(m["step"], m["stage"]) for m in tl] == [(m["step"], m["stage"]) for m in jl] == [
        (0, 1), (3, 2)]
    for a, b in zip(jl, tl):
        rtol = 1e-6 if a["stage"] == 1 else CLI_STAGE2_RTOL
        assert b["loss"] == pytest.approx(a["loss"], rel=rtol)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)
    assert out_t.getvalue().splitlines()[-1].startswith("done: 2 log points; final loss ")


def _kws_setup(m, an, pipe_mod, key, seed: int, **kw):
    cfg = m.get("analognet-kws")
    pipe = pipe_mod.PipelineConfig(kind="kws", global_batch=4, n_classes=cfg.n_classes,
                                   input_hw=cfg.input_hw, channels=cfg.in_channels, seed=seed)
    return (an.cnn_init(key, cfg, **kw), lambda p, b, a, r: an.cnn_loss(p, b, a, cfg, rng=r),
            pipe_mod.iterate(pipe))


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_cli_setup_matches_reference_across_seeds(seed):
    """The CLI's run (AnalogNet-KWS at full width, stage 1 = stage 2 = 2,
    batch 4, its TrainConfig) from other weights and data, every step
    logged: stage 1's losses within 1e-6 relative, stage 2's within
    ``CLI_STAGE2_RTOL``. Over seeds 0-5 the first stage-2 step read at
    most 1.55e-5 and the second 1.80e-4 (seed 5)."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    run = dict(stage1_steps=2, stage2_steps=2, eta=0.1, b_adc=8, lr=3e-3, log_every=1)
    p, loss, batches = _kws_setup(jconfigs, jan, jpipe, jax.random.PRNGKey(seed), seed)
    _, jh = jrun(loss, p, batches, JTrainConfig(**run))
    p, loss, batches = _kws_setup(tconfigs, tan, tpipe, prng.PRNGKey(seed), seed, device="cpu")
    _, th = trun(loss, p, batches, TTrainConfig(**run))
    assert [(h["step"], h["stage"]) for h in th] == [(h["step"], h["stage"]) for h in jh] == [
        (0, 1), (1, 1), (2, 2), (3, 2)]
    for a, b in zip(jh, th):
        rtol = 1e-6 if a["stage"] == 1 else CLI_STAGE2_RTOL
        assert b["loss"] == pytest.approx(a["loss"], rel=rtol), (a["step"], a["loss"], b["loss"])


def test_cli_refuses_an_lm_arch(capsys):
    """Every registered arch is a choice, as in the reference's CLI; the
    frames-fed audio decoder, which the reference's CLI fails with
    ``KeyError: 'frames'``, is refused before a step (the other families
    train: ``tests/test_torch_lm_train_cli.py``,
    ``tests/test_torch_train_families_cli.py``)."""
    from repro_torch import configs as tconfigs

    choices = next(a.choices for a in ttrain.build_parser()._actions if a.dest == "arch")
    assert sorted(choices) == sorted(tconfigs.ALL_ARCHS)
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "musicgen-large", "--device", "cpu"])
    assert "KeyError: 'frames'" in capsys.readouterr().err
