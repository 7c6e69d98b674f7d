"""The port's serving CLI with ``--fleet``, against JAX's CLI.

``--fleet 3`` programs three chips through the RNG bridge (chip ``c`` from
``fold_in(PRNGKey(42), c)``) and prints the reference CLI's fleet summary,
counters and tokens; both run on a virtual clock, so routing does not
depend on the host's speed. ``--fleet 3 --async`` over replicas of one
saved chip prints the reference's tokens and counters (replicas are
identical, so thread timing moves placement but no generation). Both CLIs
refuse the same flag combinations with the same message, and ``--fleet 1``
is the single-engine path.
"""

import re
import sys

import pytest

from repro import clock as jclock
from repro.launch import serve as jserve
from repro_torch import clock as tclock
from repro_torch.launch import serve as tserve

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TRACE = ["--request-trace", "6", "--arrival-rate", "200", "--batch", "2", "--prompt-len", "8",
         "--tokens", "4"]


def _jax_cli(argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    return capsys.readouterr().out


def _port_cli(argv, capsys) -> str:
    tserve.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def _lines(out: str, *prefixes) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def _untimed(out: str) -> list[str]:
    """What a fleet run printed, less host seconds and rates and the tick
    count (which thread timing moves)."""
    lines = _lines(out, "fleet: chips", "accuracy_vs_digital_ref:", "generated token ids",
                   "async fleet:")
    return [re.sub(r" (ticks|tokens_per_s|p95_ms|p95_ttft_ms|wall|min_window_agreement)=\S+",
                   "", ln) for ln in lines]


def test_fleet_cli_matches_the_reference(capsys, monkeypatch):
    monkeypatch.setattr(jclock, "SYSTEM", jclock.VirtualClock())
    monkeypatch.setattr(tclock, "SYSTEM", tclock.VirtualClock())
    argv = ["--analog", *TRACE, "--fleet", "3", "--agreement-slo", "0.01"]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    keep = ("fleet: chips", "accuracy_vs_digital_ref:", "generated token ids")
    assert _lines(got, *keep) == _lines(want, *keep)
    assert _lines(got, "programmed 3 independent chip draws")
    assert "fleet: chips=3 requests=6 " in got and "program_events_delta=0" in got


def test_async_fleet_cli_over_replicas_matches_the_reference(tmp_path, capsys, monkeypatch):
    chip = str(tmp_path / "chip")
    _port_cli(["--analog", "--batch", "2", "--prompt-len", "8", "--tokens", "2",
               "--save-program", chip], capsys)
    argv = ["--load-program", chip, *TRACE, "--fleet", "3", "--async", "--queue-cap", "16"]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    assert _untimed(got) == _untimed(want)
    assert _lines(got, "fleet: 3 replicas of the loaded chip draw")
    assert _lines(got, "async fleet: workers=3 queue_cap=16 ")
    assert "fleet: chips=3 requests=6 " in got and "program_events_delta=0" in got


#: the reference CLI's fleet refusals whose flags the port has
REFUSALS = {
    "fleet_zero_chips": ["--fleet", "0"],
    "fleet_without_trace": ["--analog", "--fleet", "2"],
    "fleet_without_analog_or_artifact": ["--fleet", "2", "--request-trace", "4"],
    "fleet_with_drift_schedule": ["--analog", "--fleet", "2", "--request-trace", "4",
                                  "--drift-schedule", "25,3600"],
    "fleet_with_save_program": ["--analog", "--fleet", "2", "--request-trace", "4",
                                "--save-program", "/nonexistent/x"],
    "agreement_slo_without_fleet": ["--analog", "--request-trace", "3",
                                    "--agreement-slo", "0.5"],
    "agreement_slo_on_fleet_of_one": ["--analog", "--fleet", "1", "--request-trace", "3",
                                      "--agreement-slo", "0.5"],
    "agreement_slo_with_no_ref_check": ["--analog", "--fleet", "2", "--request-trace", "4",
                                        "--agreement-slo", "0.5", "--no-ref-check"],
    "agreement_slo_out_of_range": ["--analog", "--fleet", "2", "--request-trace", "4",
                                   "--agreement-slo", "1.5"],
    "async_without_fleet": ["--analog", "--request-trace", "3", "--async"],
    "async_on_fleet_of_one": ["--analog", "--fleet", "1", "--request-trace", "3", "--async"],
    "queue_cap_without_async": ["--analog", "--fleet", "2", "--request-trace", "4",
                                "--queue-cap", "8"],
    "queue_cap_zero": ["--analog", "--fleet", "2", "--request-trace", "4", "--async",
                       "--queue-cap", "0"],
    "fused_decode_with_fleet": ["--analog", "--fleet", "2", "--request-trace", "4",
                                "--fused-decode"],
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_cli_refuses_as_the_reference(name, capsys, monkeypatch):
    errors = []
    for run in (lambda: _jax_cli(REFUSALS[name], capsys, monkeypatch),
                lambda: _port_cli(REFUSALS[name], capsys)):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2, name
        err = capsys.readouterr().err
        errors.append([ln.split(": error: ", 1)[1] for ln in err.splitlines()
                       if ": error: " in ln])
    want, got = errors
    assert got == want and len(got) == 1, name


def test_fleet_of_one_is_the_single_engine_path(capsys):
    argv = ["--analog", *TRACE[:-2], "--tokens", "4"]
    outs = [_port_cli(argv + extra, capsys) for extra in ([], ["--fleet", "1"])]
    for out in outs:
        assert "fleet:" not in out and "serving: mode=continuous requests=6" in out
    stable = lambda out: _lines(out, "generated token ids", "accuracy_vs_digital_ref:")
    assert stable(outs[0]) == stable(outs[1])
