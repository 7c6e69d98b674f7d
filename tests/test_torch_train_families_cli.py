"""The port's training CLI on the SSM, hybrid and vision LMs, against the
reference's ``lm_setup`` + ``run_two_stage`` run in this process on the
same arguments (the reference CLI's body, each arch once per module):

* ``--arch A --device cpu --batch 2 --seq 16 --stage1 1 --stage2 1`` for
  mamba2-2.7b, recurrentgemma-9b and paligemma-3b (their smoke configs;
  paligemma's token stream carries no image, as the reference's
  ``lm_setup`` feeds it): the JSON lines' steps and stages the
  reference's, the final loss within 1e-5 relative;
* musicgen-large is refused before any step, with the reason: the
  reference's ``lm_setup`` feeds tokens only, and its CLI fails that arch
  with ``KeyError: 'frames'``.
"""

import contextlib
import io
import json
import threading

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro.launch import train as jtrain
from repro.training.loop import TrainConfig as JTrainConfig
from repro.training.loop import run_two_stage as jrun
from repro_torch.launch import train as ttrain

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b", "paligemma-3b")
ARGS = ["--device", "cpu", "--batch", "2", "--seq", "16", "--stage1", "1", "--stage2", "1"]
#: the reference CLI's defaults for the rest of its TrainConfig
RUN = dict(stage1_steps=1, stage2_steps=1, eta=0.1, b_adc=8, lr=3e-3)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def reference() -> dict:
    """Each arch's history from the reference's CLI body, run once, the
    three side by side in threads of this process (XLA compiles the
    steps with the GIL released)."""
    out = {}

    def run(arch):
        params, loss_fn, batches = jtrain.lm_setup(arch, True, 2, 16)
        _, out[arch] = jrun(loss_fn, params, batches, JTrainConfig(**RUN))

    threads = [threading.Thread(target=run, args=(a,)) for a in ARCHS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(out) == set(ARCHS)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_final_loss_is_the_references(arch, reference):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(["--arch", arch, *ARGS])
    lines = buf.getvalue().splitlines()
    got = [json.loads(x) for x in lines if x.startswith("{")]
    want = reference[arch]
    assert [(m["step"], m["stage"]) for m in got] == [(m["step"], m["stage"]) for m in want]
    assert got[-1]["stage"] == 2
    assert got[-1]["loss"] == pytest.approx(want[-1]["loss"], rel=LOSS_RTOL)
    assert lines[-1].startswith(f"done: {len(want)} log points; final loss ")


def test_cli_refuses_the_frames_fed_decoder(capsys):
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "musicgen-large", *ARGS])
    err = capsys.readouterr().err
    assert "KeyError: 'frames'" in err and "lm_setup feeds tokens only" in err
