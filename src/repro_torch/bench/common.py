"""Shared helpers of the port's benchmarks, counterpart of
``benchmarks/common.py``: the scaled benchmark CNNs (the same layer
tables), the CSV row format and a timer.

The rows that need a trained model (the accuracy experiments: Table 1,
Fig. 7, Fig. 9, Appendix C, ``serve_drift_24h``) wait for the training
slice.
"""

from __future__ import annotations

import torch

from repro_torch import clock as clock_lib
from repro_torch.models.analognet import CNNConfig, ConvSpec

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
