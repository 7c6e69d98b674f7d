"""The port's serving CLI through the drift lifecycle, against JAX's CLI.

``--analog --request-trace 6 --arrival-rate 100 --drift-schedule
25,3600,86400 --refresh-below 1.0`` (then with ``--resample-read-noise``,
and the port also with ``--fused-decode``) prints the same tokens, the same
``drift_age``/``drift_event`` lines, the same refresh count and counters as
the reference CLI: ``--seed 0`` draws the reference CLI's weights, chip,
trace and engine key through the RNG bridge. Both run on a clock that
advances only while the engine idles, so admission does not depend on the
host's speed. A chip saved after such a run reloads and ages bitwise, and
both CLIs refuse an artifact of another model with the same message.
"""

import re
import sys

import jax
import numpy as np
import pytest

from repro import clock as jclock
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch.checkpoint import store as tstore
from repro_torch.launch import serve as tserve

LIFECYCLE = ["--analog", "--request-trace", "6", "--arrival-rate", "100", "--batch", "2",
             "--prompt-len", "8", "--tokens", "6", "--drift-schedule", "25,3600,86400",
             "--refresh-below", "1.0"]


def _virtual_clocks(monkeypatch):
    monkeypatch.setattr(jclock, "SYSTEM", jclock.VirtualClock())
    monkeypatch.setattr(tclock, "SYSTEM", tclock.VirtualClock())


def _observed(out: str) -> dict:
    summary = re.search(r"^serving: .*requests=(\d+) tokens=(\d+) steps=(\d+).*"
                        r"reprograms=(\d+) program_events_delta=(\d+)", out, re.M)
    assert summary, out
    counters = re.search(r"^accuracy_vs_digital_ref: (.*)$", out, re.M)
    return dict(
        summary=summary.groups(),
        drift=re.findall(r"^drift_(?:age|event) .*$", out, re.M),
        counters=counters and counters.group(1),
        tokens=re.search(r"^generated token ids \(longest request\): (.*)$", out, re.M).group(1),
    )


def _jax_cli(argv, capsys, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    return _observed(capsys.readouterr().out)


def _port_cli(argv, capsys) -> dict:
    tserve.main(["--device", "cpu", *argv])
    return _observed(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--resample-read-noise"]], ids=["frozen", "resample"])
def test_lifecycle_cli_matches_the_reference(extra, capsys, monkeypatch):
    _virtual_clocks(monkeypatch)
    want = _jax_cli(LIFECYCLE + extra, capsys, monkeypatch)
    assert want["drift"] and int(want["summary"][3]) >= 1  # the schedule refreshed the chip
    for fused in ([], ["--fused-decode"]):
        got = _port_cli(LIFECYCLE + extra + fused, capsys)
        assert got == want, fused


def _schedule_lines(out: str) -> dict:
    """The schedule run's drift lines without their host timings, the
    logit MSE apart (a float sum, compared within 1e-5 relative)."""
    untimed = re.sub(r"prefill=\S+ decode=\S+ ", "", out)
    return dict(
        drift=re.findall(r"^drift_\w+ .*$", re.sub(r"logit_mse=\S+", "", untimed), re.M),
        mse=[float(x) for x in re.findall(r"^drift_age .*logit_mse=(\S+)", untimed, re.M)],
        tokens=re.search(r"^generated token ids \(first sequence\): (.*)$", out, re.M).group(1),
    )


@pytest.mark.parametrize("extra", [[], ["--fused-decode"]], ids=["per_layer", "fused"])
def test_schedule_without_a_trace_matches_the_reference(extra, capsys, monkeypatch):
    """The schedule served as one rectangle of requests per age: the same
    ages, chip ages after the refresh, refresh decisions, counters and
    tokens as the reference CLI."""
    argv = ["--analog", "--batch", "2", "--prompt-len", "8", "--tokens", "4",
            "--drift-schedule", "25,3600,86400", "--refresh-below", "1.0"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = _schedule_lines(capsys.readouterr().out)
    assert any(line.startswith("drift_event") for line in want["drift"])
    tserve.main(["--device", "cpu", *argv, *extra])
    got = _schedule_lines(capsys.readouterr().out)
    assert got.pop("mse") == pytest.approx(want.pop("mse"), rel=1e-5)
    assert got == want


def test_saved_lifecycle_chip_reloads_and_ages(tmp_path, capsys, monkeypatch):
    _virtual_clocks(monkeypatch)
    path = str(tmp_path / "chip")
    argv = LIFECYCLE + ["--no-ref-check", "--save-program", path]
    argv.remove("--refresh-below")
    argv.remove("1.0")
    got = _port_cli(argv, capsys)
    assert got["summary"][3] == "0"
    prog = tstore.load_program(path, device="cpu")
    assert prog.age_history == (25.0, 3600.0, 86400.0)
    jprog = jstore.load_program(path)
    assert jprog.age_history == prog.age_history
    # the reference CLI serves the saved chip aged to 30 days, as the port does
    later = ["--load-program", path, "--t-hours", str(30 * 24), "--request-trace", "3",
             "--batch", "2", "--prompt-len", "8", "--tokens", "4"]
    assert _port_cli(later, capsys) == _jax_cli(later, capsys, monkeypatch)


def test_both_clis_refuse_another_models_chip_with_the_same_message(tmp_path, monkeypatch):
    cfg4 = j_get_smoke("tinyllama-1.1b")
    cfg4 = type(cfg4)(**{**cfg4.__dict__, "n_layers": 4})
    prog = jengine.compile_program(jlm.lm_init(jax.random.PRNGKey(0), cfg4),
                                   JAnalogConfig().infer(), jax.random.PRNGKey(42))
    path = str(tmp_path / "four_layers")
    jstore.save_program(path, prog)
    argv = ["--load-program", path, "--request-trace", "2", "--batch", "2",
            "--prompt-len", "8", "--tokens", "2"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(ValueError) as jerr:
        jserve.main()
    with pytest.raises(ValueError) as terr:
        tserve.main(["--device", "cpu", *argv])
    assert "does not match the model" in str(jerr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("argv", [
    ["--save-program", "x"],
    ["--analog", "--b-adc-overrides", "lm_head=8"],
    ["--b-adc-overrides", "lm_head=8"],
    ["--load-program", "x", "--b-adc-overrides", "lm_head=8"],
    ["--resample-read-noise"],
    ["--analog", "--resample-read-noise"],
    ["--drift-schedule", "fig7"],
    ["--analog", "--drift-schedule", "fig7"],
    ["--analog", "--refresh-below", "0.9"],
    ["--analog", "--drift-schedule", "fig7", "--refresh-below", "0.9", "--no-ref-check"],
    ["--analog", "--drift-schedule", "fig7", "--refresh-below", "0.9"],
], ids=lambda a: " ".join(a))
def test_validate_args_on_the_lifecycle_flags(argv):
    def rejects(module):
        ap = module.build_parser()
        try:
            module.validate_args(ap, ap.parse_args(argv))
        except SystemExit:
            return True
        return False

    assert rejects(tserve) == rejects(jserve)
