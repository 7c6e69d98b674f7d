"""Sec. 5.2: the layer-serial pipeline never stalls the array (cycle
simulator), and the program-once serving rows; port copy of
``benchmarks/pipeline_bench.py``.

The ``pipeline_*`` rows are the modelled AON-CiM accelerator's (its
latency, not the card's) and equal the reference's string for string. The
``serve_*`` rows time repeated analog inference of the scaled
``KWS_BENCH`` (32 images) on ``--device`` -- (a) per-call ``pcm_infer``,
which re-simulates the whole PCM program/drift/read chain inside every
forward, and (b) a compiled CiMProgram, programmed once and executed many
times, at b_adc 8 and swept over 4/6/8 with top-1 agreement against the
digital forward on a fixed probe batch. Inputs and chips draw from the
reference's keys. ``serve_drift_24h`` is the paper's accuracy-after-24 h
claim on the serving artifact: a model trained on ``--device`` programmed
into several chips at 25 s, each aged to 24 h in place (no programming
event: asserted), top-1 agreement with the digital forward read at both
ages.

    PYTHONPATH=src python -m repro_torch.bench.pipeline [--device cpu] [--fast]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.bench import common
from repro_torch.bench.common import KWS_BENCH, csv_row, time_call
from repro_torch.core import engine
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.pipeline_sim import PipelineConfig, simulate
from repro_torch.data.pipeline import batch_at
from repro_torch.device import resolve_device
from repro_torch.models.analognet import (
    analognet_kws_config,
    analognet_vww_config,
    cnn_apply,
    cnn_init,
    crossbar_transforms,
    layer_shapes,
)


def pipeline_rows() -> list[str]:
    rows = []
    for name, cfg in (("kws", analognet_kws_config()), ("vww", analognet_vww_config())):
        shapes = layer_shapes(cfg)
        for bits in (8, 6, 4):
            rep = simulate(shapes, bits)
            slow = simulate(shapes, bits, PipelineConfig(digital_clock_hz=100e6))
            rows.append(csv_row(
                f"pipeline_{name}_{bits}b", rep.latency_s * 1e6,
                f"stall={rep.stall_fraction*100:.1f}%"
                f"_at100MHz={slow.stall_fraction*100:.1f}%"))
    return rows


def _agreement(logits: torch.Tensor, ref: torch.Tensor) -> float:
    return float((logits.argmax(-1) == ref).float().mean())


def serving_rows(fast: bool, device) -> list[str]:
    dev = resolve_device(device)
    cfg = KWS_BENCH
    acfg = AnalogConfig().infer(b_adc=8, t_seconds=86400.0)
    params = cnn_init(prng.PRNGKey(0), cfg, device=dev)
    x = prng.normal(prng.PRNGKey(1).to(dev), (32,) + cfg.input_hw + (cfg.in_channels,))
    iters = 3 if fast else 10
    transforms = crossbar_transforms(cfg)
    key2 = prng.PRNGKey(2).to(dev)

    us_percall = time_call(lambda: cnn_apply(params, x, acfg, cfg, rng=key2), iters=iters)
    program = engine.compile_program(params, acfg, key2, transforms=transforms, device=dev)
    us_prog = time_call(lambda: cnn_apply(program.params, x, program.cfg, cfg), iters=iters)
    rows = [
        csv_row("serve_percall_pcm", us_percall, "reprograms_every_forward"),
        csv_row("serve_programmed_pcm", us_prog,
                f"program_once_speedup={us_percall / max(us_prog, 1e-9):.2f}x"),
    ]
    xp = prng.normal(prng.PRNGKey(3).to(dev), (32,) + cfg.input_hw + (cfg.in_channels,))
    ref = cnn_apply(params, xp, AnalogConfig(), cfg).argmax(-1)
    for bits in (4, 6, 8):
        prog = engine.compile_program(params, AnalogConfig().infer(b_adc=bits, t_seconds=86400.0),
                                      key2, transforms=transforms, device=dev)
        us = time_call(lambda: cnn_apply(prog.params, xp, prog.cfg, cfg), iters=iters)
        agree = _agreement(cnn_apply(prog.params, xp, prog.cfg, cfg), ref)
        rows.append(csv_row(f"serve_programmed_pcm_b{bits}", us,
                            f"top1_agreement_vs_digital={agree:.4f}"))
    return rows


def drift_lifecycle_row(fast: bool, device) -> str:
    """serve_drift_24h: the paper's accuracy-after-24 h claim on the exact
    serving artifact (the reference's ``_drift_lifecycle_row``).

    A briefly trained model (trained logit margins: a random net's near-tie
    argmax makes agreement meaningless) is programmed into N chips at 25 s;
    each chip ages to 24 h in place (``engine.age_program``: drift-only
    re-evaluation, the program-event delta is part of the row and must be
    0). Top-1 agreement with the digital forward on 16 held-out batches is
    read at both ages; the time is one forward of the last aged chip over
    them.
    """
    dev = resolve_device(device)
    cfg = KWS_BENCH
    params = common.train_model(cfg, stage1=60, stage2=60, eta=0.1, b_adc=8, device=dev)
    pipe = common.pipe_for(cfg)
    xp = torch.cat([torch.as_tensor(batch_at(pipe, 50_000 + i)["x"], device=dev)
                    for i in range(16)])
    ref = cnn_apply(params, xp, AnalogConfig(), cfg).argmax(-1)
    acfg = AnalogConfig().infer(b_adc=8, t_seconds=25.0)
    transforms = crossbar_transforms(cfg)
    n_chips = 4 if fast else 8
    a25, a24 = [], []
    us = 0.0
    delta = 0  # program events during any chip's age/eval window: must be 0
    for c in range(n_chips):
        prog = engine.compile_program(params, acfg, prng.PRNGKey(c).to(dev),
                                      transforms=transforms, device=dev)
        events0 = engine.program_event_count()
        run = lambda p, _c=prog.cfg: cnn_apply(p, xp, _c, cfg)
        a25.append(_agreement(run(prog.params), ref))
        aged = engine.age_program(prog, 86400.0)
        a24.append(_agreement(run(aged.params), ref))
        if c == n_chips - 1:
            us = time_call(run, aged.params, iters=3)
        delta += engine.program_event_count() - events0
    assert delta == 0, f"drift aging reprogrammed the chip ({delta} events)"
    m25, m24 = sum(a25) / len(a25), sum(a24) / len(a24)
    return csv_row(
        "serve_drift_24h", us,
        f"top1_t25s={m25:.4f}_top1_t24h={m24:.4f}_drop={m25 - m24:.4f}_chips={n_chips}"
        f"_program_events={delta}")


def run(fast: bool = False, device="cuda") -> list[str]:
    return pipeline_rows() + serving_rows(fast, device) + [drift_lifecycle_row(fast, device)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true", help="3 timed calls a row, not 10; serve_drift_24h over 4 chips, not 8")
    args = ap.parse_args(argv)
    for r in run(args.fast, args.device):
        print(r)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
