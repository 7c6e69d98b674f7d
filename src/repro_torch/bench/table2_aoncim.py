"""Table 2: AON-CiM accelerator summary -- peak and per-model TOPS, TOPS/W,
inf/s, uJ/inf at 8/6/4-bit activations, against the paper's numbers.

Port copy of ``benchmarks/table2_aoncim.py``: the same rows, string for string
(every figure is the modelled AON-CiM accelerator's, not the card's).
Run: ``PYTHONPATH=src python -m repro_torch.bench.table2_aoncim``."""

from __future__ import annotations

from repro_torch.bench.common import csv_row
from repro_torch.core import aoncim
from repro_torch.models.analognet import analognet_kws_config, analognet_vww_config, layer_shapes

PAPER = {
    ("peak", 8): (2.0, 13.55), ("peak", 6): (7.71, 45.55), ("peak", 4): (26.21, 112.44),
    ("kws", 8): (0.6, 8.58), ("kws", 6): (2.29, 26.76), ("kws", 4): (7.8, 57.39),
    ("vww", 8): (0.076, 4.37), ("vww", 6): (0.29, 12.82), ("vww", 4): (0.98, 25.69),
}


def run(fast: bool = False) -> list[str]:
    rows = []
    kws = layer_shapes(analognet_kws_config())
    vww = layer_shapes(analognet_vww_config())
    split = aoncim.calibrate(kws, vww, bits=8)
    rows.append(csv_row(
        "table2_energy_split", 0.0,
        f"adc={split.adc_frac:.2f}/row={split.row_frac:.2f}/dig={split.dig_frac:.2f}"))
    for bits in (8, 6, 4):
        pt, pw = aoncim.peak_tops(bits), aoncim.PEAK_TOPS_PER_W[bits]
        ref_t, ref_w = PAPER[("peak", bits)]
        rows.append(csv_row(
            f"table2_peak_{bits}b", aoncim.T_CIM[bits] * 1e6,
            f"tops={pt:.2f}(paper {ref_t})_topsw={pw:.2f}(paper {ref_w})"))
        for name, shapes in (("kws", kws), ("vww", vww)):
            p = aoncim.model_perf(shapes, bits, split)
            ref_t, ref_w = PAPER[(name, bits)]
            rows.append(csv_row(
                f"table2_{name}_{bits}b", p.latency_s * 1e6,
                f"tops={p.tops:.3f}(paper {ref_t})_topsw={p.tops_per_w:.2f}"
                f"(paper {ref_w})_infs={p.inf_per_s:.0f}_uj={p.uj_per_inf:.2f}"))
    # Table 2 also quotes 8b inf/s + uJ/inf: KWS 7762 / 8.22, VWW 1063 / 15.6
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
