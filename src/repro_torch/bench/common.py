"""Shared helpers of the port's benchmarks, counterpart of
``benchmarks/common.py``: the scaled benchmark CNNs (the same layer
tables), the accuracy substrate -- :func:`train_model` (the two-stage
method on the synthetic task), :func:`eval_program_accuracy` (one
programmed chip) and :func:`eval_accuracy` (the paper's N-chips protocol)
-- the CSV row format and a timer.

With these a model trained on the card is programmed with
``compile_program(..., transforms=crossbar_transforms(cfg))`` and evaluated
at 25 s and aged to 24 h, the paper's own flow: the rows of Table 1, Fig.
7, Fig. 9, Appendix C (``bench.table1_ablation``, ``fig7_drift``,
``fig9_micronet``, ``appxC_heuristic``) and ``bench.pipeline``'s
``serve_drift_24h``. :func:`bench_main` is their command line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch import prng
from repro_torch.core.analog import AnalogConfig
from repro_torch.data.pipeline import PipelineConfig, batch_at, iterate
from repro_torch.device import resolve_device
from repro_torch.models.analognet import (
    CNNConfig,
    ConvSpec,
    cnn_apply,
    cnn_init,
    cnn_loss,
    crossbar_transforms,
)
from repro_torch.training.loop import TrainConfig, run_two_stage

# scaled AnalogNet-KWS-like model (dense 3x3 convs) and its depthwise twin
KWS_BENCH = CNNConfig(
    name="bench_kws_dense",
    input_hw=(16, 8),
    in_channels=1,
    convs=(
        ConvSpec("c1", 3, 3, 1, 16, 2),
        ConvSpec("c2", 3, 3, 16, 24, 2),
        ConvSpec("c3", 3, 3, 24, 24, 1),
    ),
    n_classes=8,
    fc_width=24,
)

KWS_BENCH_DW = CNNConfig(
    name="bench_kws_depthwise",
    input_hw=(16, 8),
    in_channels=1,
    convs=(
        ConvSpec("c1", 3, 3, 1, 16, 2),
        ConvSpec("dw2", 3, 3, 16, 16, 2, depthwise=True),
        ConvSpec("pw2", 1, 1, 16, 24, 1),
        ConvSpec("dw3", 3, 3, 24, 24, 1, depthwise=True),
        ConvSpec("pw3", 1, 1, 24, 24, 1),
    ),
    n_classes=8,
    fc_width=24,
)

VWW_BENCH = CNNConfig(
    name="bench_vww_dense",
    input_hw=(24, 24),
    in_channels=3,
    convs=(
        ConvSpec("stem", 3, 3, 3, 12, 2),
        ConvSpec("b1e", 3, 3, 12, 32, 2),
        ConvSpec("b1p", 1, 1, 32, 16, 1),
        ConvSpec("b2e", 3, 3, 16, 48, 2),
        ConvSpec("b2p", 1, 1, 48, 24, 1),
    ),
    n_classes=2,
    fc_width=24,
)

VWW_BENCH_BNECK = CNNConfig(
    name="bench_vww_bottleneck",
    input_hw=(24, 24),
    in_channels=3,
    convs=(
        ConvSpec("stem", 3, 3, 3, 12, 2),
        ConvSpec("bneck1", 1, 1, 12, 3, 1),  # the narrow layers the paper
        ConvSpec("bneck2", 3, 3, 3, 12, 1),  # removes (Fig. 3 right)
        ConvSpec("b1e", 3, 3, 12, 32, 2),
        ConvSpec("b1p", 1, 1, 32, 16, 1),
        ConvSpec("b2e", 3, 3, 16, 48, 2),
        ConvSpec("b2p", 1, 1, 48, 24, 1),
    ),
    n_classes=2,
    fc_width=24,
)


def pipe_for(cfg: CNNConfig, batch: int = 64) -> PipelineConfig:
    return PipelineConfig(
        kind="kws",
        global_batch=batch,
        n_classes=cfg.n_classes,
        input_hw=cfg.input_hw,
        channels=cfg.in_channels,
    )


def train_model(
    cfg: CNNConfig,
    *,
    stage1: int = 60,
    stage2: int = 60,
    eta: float = 0.1,
    b_adc: int = 8,
    quant_noise_p: float = 0.5,
    lr: float = 5e-3,
    seed: int = 0,
    device="cuda",
):
    """``cfg`` trained by the two-stage method from ``cnn_init(PRNGKey(seed))``
    on ``device``; returns its params."""
    pipe = pipe_for(cfg)

    def loss_fn(p, b, acfg, rng):
        return cnn_loss(p, b, acfg, cfg, rng=rng)

    params0 = cnn_init(prng.PRNGKey(seed), cfg, device=device)
    tcfg = TrainConfig(
        stage1_steps=stage1, stage2_steps=stage2, eta=eta, b_adc=b_adc,
        quant_noise_p=quant_noise_p, lr=lr, log_every=1_000_000,
    )
    params, _ = run_two_stage(loss_fn, params0, iterate(pipe), tcfg)
    return params


def _protocol_accuracy(params, cfg: CNNConfig, analog_cfg, rng, n_batches: int) -> float:
    """Mean accuracy over the shared eval protocol (fixed batches 50k+i),
    on the device of ``params``."""
    pipe = pipe_for(cfg)
    dev = params["gain_s"].device
    accs = []
    with torch.no_grad():
        for i in range(n_batches):
            b = batch_at(pipe, 50_000 + i)
            x = torch.as_tensor(b["x"], device=dev)
            y = torch.as_tensor(b["y"], device=dev).long()
            logits = cnn_apply(
                params, x, analog_cfg, cfg,
                rng=prng.fold_in(rng, i) if analog_cfg.needs_rng else None,
            )
            accs.append(float((logits.argmax(-1) == y).float().mean()))
    return float(np.mean(accs))


def eval_program_accuracy(program, cfg: CNNConfig, *, n_batches: int = 4) -> float:
    """Accuracy of one compiled chip (frozen conductances, no per-call key)."""
    dev = program.params["gain_s"].device
    return _protocol_accuracy(program.params, cfg, program.cfg, prng.PRNGKey(0).to(dev),
                              n_batches)


def eval_accuracy(
    params,
    cfg: CNNConfig,
    analog_cfg: AnalogConfig,
    *,
    n_batches: int = 4,
    n_draws: int = 3,
    seed: int = 123,
) -> tuple[float, float]:
    """(mean, std) accuracy over PCM noise draws (the paper uses 25 runs).

    For ``pcm_infer`` each draw programs one chip (``compile_program``
    through the crossbar transforms, on the params' device) and evaluates
    every batch against its frozen conductances -- the paper's N-chips
    protocol; other modes evaluate directly.
    """
    from repro_torch.core import engine

    dev = resolve_device(params["gain_s"].device)
    accs = []
    for d in range(n_draws):
        rng = prng.PRNGKey(seed + d).to(dev)
        if analog_cfg.mode == "pcm_infer":
            program = engine.compile_program(
                params, analog_cfg, rng, transforms=crossbar_transforms(cfg), device=dev
            )
            accs.append(eval_program_accuracy(program, cfg, n_batches=n_batches))
        else:
            accs.append(_protocol_accuracy(params, cfg, analog_cfg, rng, n_batches))
    return float(np.mean(accs)), float(np.std(accs))


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.2f},{derived}"


def time_call(fn, *args, iters: int = 3, clock: clock_lib.Clock = clock_lib.SYSTEM) -> float:
    """Microseconds per call of ``fn(*args)`` on ``clock`` (the host's), after
    one warm-up call; on a card each call ends in a synchronize, so the time
    is the device's work, not its enqueue."""

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    fn(*args)
    sync()
    t0 = clock.now()
    for _ in range(iters):
        fn(*args)
        sync()
    return (clock.now() - t0) / iters * 1e6


def bench_main(run, doc: str, argv=None) -> int:
    """Command line of a trained-model benchmark: ``--fast`` (the default,
    the reference's reduced protocol) or ``--full``, and ``--device``
    (default ``cuda``); prints ``run``'s rows, then the wall seconds on
    stderr."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="the reduced protocol (also the default)")
    ap.add_argument("--full", action="store_true", help="the complete protocol")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.fast and args.full:
        ap.error("--fast and --full are mutually exclusive")
    t0 = clock_lib.SYSTEM.now()
    for r in run(fast=not args.full, device=resolve_device(args.device)):
        print(r, flush=True)
    print(f"wall_s={clock_lib.SYSTEM.now() - t0:.1f}", file=sys.stderr)
    return 0
