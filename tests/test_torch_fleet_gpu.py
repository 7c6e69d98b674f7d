"""A threaded fleet on the card: one worker thread and one CUDA stream per
chip, against the deterministic single-threaded driver.

Marked ``gpu``: skips on a host without a CUDA device. It imports only the
port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fleet_gpu.py

Two replicas of one chip (tinyllama-1.1b's widths, depth 2, the digital
lockstep on) serve one trace deterministically and then threaded on two
streams:

* every request's tokens are the deterministic run's (B1's rows are bitwise
  independent of M, so placement and batching are inert);
* each run's launch counts -- B1 by design, B3, the row kernels -- are
  exactly what its own prefills and decode steps launch one at a time, so
  no count is lost when two threads launch at once.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

DEPTH = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts() -> dict:
    from repro_torch.kernels import analog_mvm, decode_rows, flash_attention

    return {"b1": analog_mvm.analog_mvm.launches,
            "b1_designs": dict(analog_mvm.analog_mvm.design_launches),
            "b3": flash_attention.flash_attention.launches,
            "rows": dict(decode_rows.launches)}


def _reset() -> None:
    from repro_torch.kernels import analog_mvm, decode_rows, flash_attention

    analog_mvm.analog_mvm.launches = 0
    analog_mvm.analog_mvm.design_launches = dict.fromkeys(analog_mvm.DESIGNS, 0)
    flash_attention.flash_attention.launches = 0
    decode_rows.launches.update(dict.fromkeys(decode_rows.launches, 0))


def _expected(rep, trace, n_layers: int) -> dict:
    """What the run's work launches one launch at a time: each admission
    prefills once on its chip (layer projections at M = prompt length,
    lm_head at M = 1) and once digitally (B3 per layer both times); each
    decode step runs every projection at M = 8 and the row kernels per
    layer, chip and digital lockstep."""
    from repro_torch.kernels import analog_mvm

    per = 7 * n_layers + 1
    design = lambda m: "decode" if m <= analog_mvm.DECODE_MAX_M else "prefill"
    by_rid = {r.rid: r for r in trace}
    steps = sum(r.n_steps for r in rep.per_chip)
    designs = dict.fromkeys(analog_mvm.DESIGNS, 0)
    for rec in rep.records:
        designs[design(by_rid[rec.rid].prompt.size)] += per - 1
        designs["decode"] += 1
    designs["decode"] += per * steps
    rows = {"norm": 2 * n_layers + 1, "rope": n_layers, "attn": n_layers, "gate": n_layers}
    return {"b1": per * (len(rep.records) + steps), "b1_designs": designs,
            "b3": 2 * n_layers * len(rep.records),
            "rows": {k: 2 * v * steps for k, v in rows.items()}}


def test_threaded_fleet_on_streams_matches_deterministic(cuda):
    from repro_torch import clock, prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import (AsyncFleetRouter, FleetConfig, ServingConfig,
                                     poisson_trace)

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=DEPTH)
    params = lm_init(prng.PRNGKey(0), cfg, device=cuda)
    program = engine.compile_program(params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                     device=cuda)
    trace = poisson_trace(prng.PRNGKey(7), 8, vocab=cfg.vocab, rate=50.0,
                          prompt_lens=(16, 32, 64), new_tokens=(8, 16))
    router = AsyncFleetRouter.from_program(
        program, cfg, ServingConfig(n_slots=8, s_max=128), FleetConfig(n_chips=2),
        ref_params=params)
    reports, counts = {}, {}
    for mode in ("deterministic", "threaded"):
        torch.cuda.synchronize()
        _reset()
        det = mode == "deterministic"
        reports[mode] = router.serve(trace, deterministic=det,
                                     clock=clock.VirtualClock() if det else None)
        torch.cuda.synchronize()
        counts[mode] = _counts()
    workers = router.async_cfg.workers or 2
    assert workers == 2
    for r in trace:
        assert reports["threaded"].tokens_of(r.rid).tolist() == \
            reports["deterministic"].tokens_of(r.rid).tolist(), r.rid
    for mode, rep in reports.items():
        assert rep.n_requests == len(trace) and rep.program_events_delta == 0
        assert counts[mode] == _expected(rep, trace, DEPTH), mode
