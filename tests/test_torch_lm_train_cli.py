"""The LM branch of the port's training CLI against the reference's, on the
CPU (``launch/train.py::lm_setup``, the training half of
``checkpoint/store.py`` on an ``LMParams`` tree, and
``examples/train_lm_e2e_torch.py``):

* ``--arch tinyllama-1.1b --stage1 3 --stage2 2 --batch 2 --seq 16`` (the
  smoke config) with ``--ckpt-dir``: the same JSON lines and keys as the
  reference CLI's, stage 1's losses within 1e-5 relative and stage 2's
  within ``STAGE2_RTOL``, the same ``done:`` line shape;
* the two runs' checkpoints (stacked-blocks ``LMParams``): each restores in
  the other package bitwise, under the same names; a resume at the final
  step runs no step and gives the checkpoint's params bitwise;
* the example trains 4 steps and prints the reference example's lines,
  its losses within the same bounds.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store as tstore
from repro_torch.launch import train as ttrain
from repro_torch.training.loop import TrainConfig, run_two_stage

REPO = Path(__file__).resolve().parents[1]
#: the stage-2 loss bound (``tests/test_torch_lm_train.py``)
STAGE2_RTOL = 3e-4
ARGS = ["--arch", "tinyllama-1.1b", "--stage1", "3", "--stage2", "2", "--batch", "2",
        "--seq", "16"]


def _lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_cli")
    out_j, out_t = io.StringIO(), io.StringIO()
    argv = sys.argv
    sys.argv = ["repro.launch.train", *ARGS, "--ckpt-dir", str(root / "jax")]
    try:
        with contextlib.redirect_stdout(out_j):
            jtrain.main()
    finally:
        sys.argv = argv
    with contextlib.redirect_stdout(out_t):
        ttrain.main([*ARGS, "--device", "cpu", "--ckpt-dir", str(root / "port")])
    return dict(root=root, jax=out_j.getvalue(), port=out_t.getvalue())


def _check_lines(jl: list, tl: list):
    assert [list(m) for m in tl] == [list(m) for m in jl]
    assert [(m["step"], m["stage"]) for m in tl] == [(m["step"], m["stage"]) for m in jl]
    for a, b in zip(jl, tl):
        rtol = 1e-5 if a["stage"] == 1 else STAGE2_RTOL
        assert b["loss"] == pytest.approx(a["loss"], rel=rtol), a["step"]
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)


def test_cli_matches_reference(cli_runs):
    jl, tl = _lines(cli_runs["jax"]), _lines(cli_runs["port"])
    assert [(m["step"], m["stage"]) for m in jl] == [(0, 1), (4, 2)]
    assert set(jl[0]) >= {"loss", "ppl_proxy", "grad_norm", "lr", "step", "stage", "wall_s"}
    _check_lines(jl, tl)
    last = cli_runs["port"].splitlines()[-1]
    assert last.startswith("done: 2 log points; final loss ")
    assert cli_runs["jax"].splitlines()[-1].startswith("done: 2 log points; final loss ")


def _jflat(tree) -> dict:
    return jstore._flatten(tree)


def _tflat(tree) -> dict:
    return {tree_lib.path_name(p, "::"): v.detach().numpy()
            for p, v in tree_lib.flatten_with_path(tree)}


def _assert_bitwise(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_lm_checkpoints_cross_restore_bitwise(cli_runs):
    root = cli_runs["root"]
    jlike = jlm.lm_init(jax.random.PRNGKey(0), j_get_smoke("tinyllama-1.1b"))
    tlike, _, _ = ttrain.lm_setup("tinyllama-1.1b", True, 2, 16, "cpu")
    for d in ("jax", "port"):
        assert tstore.latest_step(str(root / d)) == jstore.latest_step(str(root / d)) == 5
        assert sorted(p.name for p in (root / d).iterdir()) == ["step_00000001",
                                                                "step_00000005"]
        assert tstore.read_meta(str(root / d), 5)["final"] is True
        for step in (1, 5):
            # the same checkpoint restored by both packages: the same leaves
            _assert_bitwise(_jflat(jstore.restore(str(root / d), step, jlike)),
                            _tflat(tstore.restore(str(root / d), step, tlike)))
    # stacked blocks: one (L, ...) leaf per projection, as the reference names it
    names = list(_tflat(tstore.restore(str(root / "port"), 5, tlike)))
    assert "blocks::0::attn::wq::w" in names and "blocks::0::attn::wq::w_clip_buf" in names


def test_resume_at_the_final_step_runs_nothing(cli_runs):
    ckpt = str(cli_runs["root"] / "port")
    params, loss_fn, batches = ttrain.lm_setup("tinyllama-1.1b", True, 2, 16, "cpu")
    saved = tstore.restore(ckpt, 5, params)
    got, hist = run_two_stage(loss_fn, params, batches,
                              TrainConfig(stage1_steps=3, stage2_steps=2, ckpt_dir=ckpt))
    assert hist == []
    _assert_bitwise(_tflat(saved), _tflat(got))


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_e2e_torch", REPO / "examples" / "train_lm_e2e_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_as_the_reference():
    spec = importlib.util.spec_from_file_location(
        "train_lm_e2e", REPO / "examples" / "train_lm_e2e.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    out_j, out_t = io.StringIO(), io.StringIO()
    argv = sys.argv
    sys.argv = ["train_lm_e2e.py", "--steps", "4"]
    try:
        with contextlib.redirect_stdout(out_j):
            jmod.main()
    finally:
        sys.argv = argv
    with contextlib.redirect_stdout(out_t):
        _example().main(["--steps", "4", "--device", "cpu"])
    j, t = out_j.getvalue().splitlines(), out_t.getvalue().splitlines()
    assert t[0] == j[0]  # the parameter count
    _check_lines(_lines(out_j.getvalue()), _lines(out_t.getvalue()))
    assert t[-1].startswith("loss ") and t[-1].endswith(("(OK)", "(NO IMPROVEMENT)"))
    first, last = (float(x) for x in t[-1].split()[1:4:2])
    jfirst, jlast = (float(x) for x in j[-1].split()[1:4:2])
    assert (first, last) == pytest.approx((jfirst, jlast), rel=STAGE2_RTOL)
    assert np.sign(last - first) == np.sign(jlast - jfirst)
