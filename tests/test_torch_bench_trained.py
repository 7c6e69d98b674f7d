"""The port's trained-model benchmark rows against the reference's, on the
CPU: Table 1 (``bench.table1_ablation``), Fig. 7 (``bench.fig7_drift``,
with its artifact round-trip row), Fig. 9 (``bench.fig9_micronet``),
Appendix C (``bench.appxC_heuristic``) and ``serve_drift_24h``
(``bench.pipeline.drift_lifecycle_row``).

The protocol is cut in this process by monkeypatching both packages'
``common`` modules (the files stay as they are): every model trains
``STEPS`` + ``STEPS`` steps (a stage of 0 stays 0) in the port, once per
distinct call, and both packages evaluate the same trained params -- the
reference gets them bitwise as jax arrays -- over ``N_DRAWS`` chips of
``N_BATCHES`` batch of 64 images. The training itself is held against the
reference in ``tests/test_torch_train_loop.py``; here each bench's rows,
chips, aging and evaluation are. Row names and every non-float token are
equal; each float (an accuracy, its std, a drop or a gap) within
``MAX_FLIPS`` flipped images out of the images behind it, twice that for a
difference of two accuracies, plus the rows' 3-decimal rounding: a chip
programmed from the same weights and key is bitwise the reference's, and
an image flips only where an fp32 sum order moves an ADC code (measured:
at most 1 image per accuracy).
"""

import re

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from benchmarks import common as jcommon
from repro_torch.bench import common as tcommon

STEPS = 2
N_DRAWS, N_BATCHES = 2, 1
#: flipped images allowed per accuracy (module docstring)
MAX_FLIPS = 2
FLOAT = re.compile(r"[-+]?\d+\.\d+")


@pytest.fixture(scope="module")
def cut():
    train, trained = tcommon.train_model, {}

    def port_train(cfg, *, stage1=60, stage2=60, device="cpu", **kw):
        key = (cfg.name, min(stage1, STEPS), min(stage2, STEPS), tuple(sorted(kw.items())))
        if key not in trained:
            trained[key] = train(cfg, stage1=key[1], stage2=key[2], device="cpu", **kw)
        return trained[key]

    def jax_train(cfg, **kw):
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), port_train(cfg, **kw))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "train_model", port_train)
        mp.setattr(jcommon, "train_model", jax_train)
        for mod in (tcommon, jcommon):
            ev = mod.eval_accuracy
            mp.setattr(mod, "eval_accuracy", lambda *a, _ev=ev, **k: _ev(
                *a, **{**k, "n_batches": N_BATCHES, "n_draws": N_DRAWS}))
        yield


def _check_rows(got: list, want: list, images: int):
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    tol = MAX_FLIPS / images + 5e-4
    for g, w in zip(got, want):
        name, _, derived = g.split(",", 2)
        if name.endswith("_wall"):
            continue  # a time
        w_derived = w.split(",", 2)[2]
        assert FLOAT.sub("#", derived) == FLOAT.sub("#", w_derived), name
        for a, b in zip(FLOAT.findall(derived), FLOAT.findall(w_derived)):
            assert abs(float(a) - float(b)) <= 2 * tol, (name, derived, w_derived)


@pytest.mark.parametrize("bench", ["table1_ablation", "fig7_drift", "fig9_micronet",
                                   "appxC_heuristic"])
def test_trained_bench_rows_match_reference(cut, bench):
    import importlib

    got = importlib.import_module(f"repro_torch.bench.{bench}").run(fast=True, device="cpu")
    want = importlib.import_module(f"benchmarks.{bench}").run(fast=True)
    images = N_DRAWS * N_BATCHES * 64
    if bench == "fig7_drift":
        images = 2 * 4 * 64  # its fast protocol: 2 chips of 4 batches (its own count)
        assert got[-1].startswith("fig7_artifact_roundtrip,0.00,bit_exact=True_ages=5_acc=")
    _check_rows(got, want, images)


def test_serve_drift_24h_matches_reference(cut):
    from benchmarks import pipeline_bench as jpb
    from repro_torch.bench import pipeline as tpb

    got = tpb.drift_lifecycle_row(True, "cpu")
    want = jpb._drift_lifecycle_row(jcommon.KWS_BENCH, True)
    assert got.split(",")[0] == want.split(",")[0] == "serve_drift_24h"
    assert got.endswith("_chips=4_program_events=0")
    # agreement over 16 batches of 64 images, a mean over 4 chips
    _check_rows([got], [want], 16 * 64)


def test_bench_cli(capsys):
    from repro_torch.bench import appxC_heuristic

    with pytest.raises(SystemExit):
        tcommon.bench_main(appxC_heuristic.run, appxC_heuristic.__doc__, ["--fast", "--full"])
    assert "mutually exclusive" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcommon.bench_main(appxC_heuristic.run, appxC_heuristic.__doc__, ["--fast"])
