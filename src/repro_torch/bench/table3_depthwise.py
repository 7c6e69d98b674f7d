"""Table 3 / Appendix D: MicroNet-KWS-S depthwise deployment trade-off.

Utilization vs crossbar size (paper: 9% / 40% / 66% at 1024x512 / 128x128 /
64x64) and the inference/s cost of the sequential group-GEMM splitting
(paper: 4122 / 1467 / 642).

Port copy of ``benchmarks/table3_depthwise.py``: the same rows, string for string
(every figure is the modelled AON-CiM accelerator's, not the card's).
Run: ``PYTHONPATH=src python -m repro_torch.bench.table3_depthwise``."""

from __future__ import annotations

from repro_torch.bench.common import csv_row
from repro_torch.core import aoncim
from repro_torch.core.crossbar import map_layers
from repro_torch.models.micronet import micronet_kws_s_config, micronet_layer_shapes

PAPER = {(1024, 512): (0.09, 4122), (128, 128): (0.40, 1467), (64, 64): (0.66, 642)}


def run(fast: bool = False) -> list[str]:
    rows = []
    cfg = micronet_kws_s_config()
    for (r, c), (pu, pinf) in PAPER.items():
        shapes = micronet_layer_shapes(cfg, r, c)
        m = map_layers(shapes, r, c)
        perf = aoncim.model_perf(shapes, 8, array_rows=r, array_cols=c)
        rows.append(csv_row(
            f"table3_micronet_{r}x{c}", perf.latency_s * 1e6,
            f"util={m.utilization*100:.1f}%(paper {pu*100:.0f}%)"
            f"_infs={perf.inf_per_s:.0f}(paper {pinf})_arrays={m.n_arrays}"))
    # the headline per-layer number: DW layer utilization ~ 1/112 = 0.9%
    dw = micronet_layer_shapes(cfg, 1024, 512, split_depthwise=False)
    dw_layer = next(s for s in dw if s.name.startswith("dw"))
    rows.append(csv_row(
        "table3_dw_layer_local_utilization", 0.0,
        f"{dw_layer.nnz/dw_layer.weights*100:.2f}%_paper=0.9%"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
