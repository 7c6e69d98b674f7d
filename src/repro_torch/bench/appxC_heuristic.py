"""Appendix C: heuristic DAC/ADC scaling against trained ranges; port copy
of ``benchmarks/appxC_heuristic.py``.

The paper: trained ranges "would otherwise need to be computed by
sub-optimal empirical rules (see Appendix)". This quantifies the gap on the
scaled KWS task: a model with stage-2-trained ranges against the same
weights with ranges reset by the Appendix C heuristics
(``core.heuristic_ranges.calibrate_model_ranges``), both evaluated on the
PCM chain at low bitwidth, where the paper says the gap appears.

    PYTHONPATH=src python -m repro_torch.bench.appxC_heuristic [--fast|--full] [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.bench import common
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.core.crossbar import im2col
from repro_torch.core.heuristic_ranges import calibrate_model_ranges
from repro_torch.data.pipeline import batch_at
from repro_torch.models.analognet import conv_apply


def _collect_sample_acts(params, cfg):
    """One digital forward, recording each conv layer's im2col input (and
    the FC's pooled input)."""
    x = torch.as_tensor(batch_at(common.pipe_for(cfg), 77)["x"], device=params["gain_s"].device)
    ctx = AnalogCtx(cfg=AnalogConfig(), gain_s=params["gain_s"])
    acts = {}
    h = x
    with torch.no_grad():
        for spec in cfg.convs:
            acts[spec.name] = im2col(h, spec.kh, spec.kw, spec.stride, "SAME")
            h = conv_apply(params[spec.name], h, spec, ctx)
        acts["fc"] = h.mean(dim=(1, 2))
    return acts


def run(fast: bool = False, device="cuda") -> list[str]:
    rows = []
    s = 30 if fast else 60
    for bits in ((4,) if fast else (8, 6, 4)):
        trained = common.train_model(common.KWS_BENCH, stage1=s, stage2=s, eta=0.1, b_adc=bits,
                                     device=device)
        # the heuristic variant: the same weights, ranges reset by Appendix C's rules
        heur = calibrate_model_ranges(trained, _collect_sample_acts(trained, common.KWS_BENCH))
        pcm = AnalogConfig().infer(b_adc=bits, t_seconds=86400.0)
        a_tr, s_tr = common.eval_accuracy(trained, common.KWS_BENCH, pcm)
        a_he, s_he = common.eval_accuracy(heur, common.KWS_BENCH, pcm)
        rows.append(common.csv_row(
            f"appxC_kws_{bits}b", 0.0,
            f"trained={a_tr:.3f}+-{s_tr:.3f}_heuristic={a_he:.3f}+-{s_he:.3f}"
            f"_gap={a_tr-a_he:+.3f}"))
    return rows


if __name__ == "__main__":
    raise SystemExit(common.bench_main(run, __doc__))
