"""Figure 8: layer-wise TOPS and TOPS/W scatter for both AnalogNets.

Reproduced trends: (a) larger layers amortize DAC/ADC cost -> higher TOPS and
TOPS/W; (b) at equal size, taller aspect ratios are more efficient (fewer
ADC conversions per MAC).

Port copy of ``benchmarks/fig8_layerwise.py``: the same rows, string for string
(every figure is the modelled AON-CiM accelerator's, not the card's).
Run: ``PYTHONPATH=src python -m repro_torch.bench.fig8_layerwise``."""

from __future__ import annotations

import numpy as np

from repro_torch.bench.common import csv_row
from repro_torch.core import aoncim
from repro_torch.models.analognet import analognet_kws_config, analognet_vww_config, layer_shapes


def run(fast: bool = False) -> list[str]:
    rows = []
    kws = layer_shapes(analognet_kws_config())
    vww = layer_shapes(analognet_vww_config())
    split = aoncim.calibrate(kws, vww, bits=8)
    pts = []
    for model, shapes in (("kws", kws), ("vww", vww)):
        for lp in aoncim.model_perf(shapes, 8, split).layers:
            rows.append(csv_row(
                f"fig8_{model}_{lp.layer.name}", lp.latency_s * 1e6,
                f"weights={lp.layer.weights}_tops={lp.tops:.4f}"
                f"_topsw={lp.tops_per_w:.2f}_aspect={lp.layer.rows/max(lp.layer.cols,1):.1f}"))
            pts.append((lp.layer.weights, lp.tops_per_w))
    # trend check: rank-correlate size vs TOPS/W
    w = np.array([p[0] for p in pts], float)
    e = np.array([p[1] for p in pts], float)
    rho = np.corrcoef(np.argsort(np.argsort(w)), np.argsort(np.argsort(e)))[0, 1]
    rows.append(csv_row("fig8_size_efficiency_rank_corr", 0.0, f"rho={rho:.2f}"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
