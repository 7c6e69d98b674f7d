"""Port parity: the serving CLI (``repro_torch.launch.serve``).

* ``validate_args`` rejects exactly what the reference's rejects, for the
  flags the port has.
* On the CPU, a ``--load-program --request-trace 3`` run prints the same
  tokens with and without ``--fused-decode``, and the same tokens as the
  reference CLI serving the same artifact: both draw the trace from
  ``PRNGKey(7)``, the port through its RNG bridge.
"""

import os
import re
import sys

import jax
import numpy as np
import pytest

from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.launch import serve as tserve

SHAPE = ["--batch", "2", "--prompt-len", "8", "--tokens", "6"]


def _rejects(module, argv) -> bool:
    ap = module.build_parser()
    try:
        module.validate_args(ap, ap.parse_args(argv))
    except SystemExit:
        return True
    return False


@pytest.mark.parametrize("argv", [
    [],
    ["--request-trace", "3"],
    ["--request-trace", "0"],
    ["--arrival-rate", "5"],
    ["--request-trace", "4", "--arrival-rate", "5"],
    ["--fused-decode"],
    ["--analog", "--fused-decode"],
    ["--load-program", "x", "--fused-decode", "--request-trace", "2"],
    ["--analog", "--b-adc", "4", "--t-hours", "1", "--no-ref-check"],
    ["--b-adc", "5"],
], ids=lambda a: " ".join(a) or "defaults")
def test_validate_args_rejects_what_the_reference_rejects(argv):
    assert _rejects(tserve, argv) == _rejects(jserve, argv)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_get_smoke("tinyllama-1.1b")
    prog = jengine.compile_program(
        jlm.lm_init(jax.random.PRNGKey(0), cfg),
        JAnalogConfig(tile_rows=32).infer(b_adc=6), jax.random.PRNGKey(3),
    )
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, prog)
    return path


def _summary_and_tokens(out: str):
    summary = re.search(r"^serving: .*requests=(\d+) tokens=(\d+) steps=(\d+)", out, re.M)
    tokens = re.search(r"^generated token ids \(longest request\): (.*)$", out, re.M)
    assert summary and tokens, out
    return summary.groups(), tokens.group(1)


def test_cli_tokens_fused_unfused_and_reference(artifact, capsys, monkeypatch):
    argv = ["--load-program", artifact, "--request-trace", "3", *SHAPE]
    runs = []
    for extra in ([], ["--fused-decode"]):
        tserve.main(["--device", "cpu", *argv, *extra])
        runs.append(_summary_and_tokens(capsys.readouterr().out))
    assert runs[0] == runs[1]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    assert _summary_and_tokens(capsys.readouterr().out) == runs[0]


def _other_model(artifact: str) -> str:
    """The artifact with one programmed leaf cut to another width: a chip
    of another model."""
    import shutil

    path = artifact + "_other"
    if not os.path.exists(path):
        shutil.copytree(artifact, path)
        with np.load(os.path.join(artifact, "arrays.npz")) as data:
            arrays = dict(data)
        arrays["params::lm_head::w"] = arrays["params::lm_head::w"][:, :7]
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
    return path


def test_cli_refuses_what_it_cannot_serve(artifact, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--load-program", artifact, "--b-adc", "8"])
    assert "does not match the loaded artifact" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--load-program", artifact, "--resample-read-noise"])
    assert "carries no read buffers" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not match the model"):
        tserve.main(["--device", "cpu", "--load-program", _other_model(artifact)])
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--kv-page-size", "8"])
