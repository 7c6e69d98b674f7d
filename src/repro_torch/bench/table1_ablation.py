"""Table 1: accuracy after 24 h of PCM drift across training methods; port
copy of ``benchmarks/table1_ablation.py``.

Rows (per task): baseline (no re-training) / noise injection only / noise
injection + ADC-DAC constraints [/ VWW with the bottleneck layers re-added].
Columns: 8/6/4-bit activations. The scaled protocol of ``bench.common``:
the models train on ``--device`` (on a card every stage-2 analog MVM is a
B1 launch), each accuracy is the mean +- std over chips programmed from
the reference's keys.

    PYTHONPATH=src python -m repro_torch.bench.table1_ablation [--fast|--full] [--device cpu]
"""

from __future__ import annotations

from repro_torch import clock as clock_lib
from repro_torch.bench import common
from repro_torch.core.analog import AnalogConfig


def run(fast: bool = False, device="cuda") -> list[str]:
    rows: list[str] = []
    s1, s2 = (30, 30) if fast else (60, 60)
    t24h = 86400.0

    def train(cfg, **kw):
        return common.train_model(cfg, device=device, **kw)

    tasks = [("kws", common.KWS_BENCH), ("vww", common.VWW_BENCH)]
    for task, cfg in tasks:
        t0 = clock_lib.SYSTEM.now()
        # three training regimes
        p_base = train(cfg, stage1=s1 + s2, stage2=0, eta=0.0)
        # "noise injection only" (Joshi et al.): weight noise but no DAC/ADC
        # quantizers in the training graph (b_adc 16, ~65k levels: a no-op);
        # it meets the low-bit converters only at deployment
        p_noise = train(cfg, stage1=s1, stage2=s2, eta=0.1, b_adc=16, quant_noise_p=1.0)
        # the full method: noise + trained DAC/ADC ranges + quant noise
        variants = {bits: train(cfg, stage1=s1, stage2=s2, eta=0.1, b_adc=bits,
                                quant_noise_p=0.5)
                    for bits in (8, 6, 4)}
        for bits in (8, 6, 4):
            pcm = AnalogConfig().infer(b_adc=bits, t_seconds=t24h)
            a_base, s_base = common.eval_accuracy(p_base, cfg, pcm)
            a_noise, s_noise = common.eval_accuracy(p_noise, cfg, pcm)
            a_full, s_full = common.eval_accuracy(variants[bits], cfg, pcm)
            rows.append(common.csv_row(
                f"table1_{task}_{bits}b_baseline", 0.0, f"acc={a_base:.3f}+-{s_base:.3f}"))
            rows.append(common.csv_row(
                f"table1_{task}_{bits}b_noise_only", 0.0, f"acc={a_noise:.3f}+-{s_noise:.3f}"))
            rows.append(common.csv_row(
                f"table1_{task}_{bits}b_noise_adcdac", 0.0, f"acc={a_full:.3f}+-{s_full:.3f}"))
        rows.append(common.csv_row(f"table1_{task}_wall", (clock_lib.SYSTEM.now() - t0) * 1e6,
                                   "train+eval"))

    # VWW bottleneck ablation (Table 1's last row): the same training, a worse arch
    p_bneck = train(common.VWW_BENCH_BNECK, stage1=s1, stage2=s2, eta=0.1, b_adc=6,
                    quant_noise_p=0.5)
    pcm6 = AnalogConfig().infer(b_adc=6, t_seconds=t24h)
    a_b, s_b = common.eval_accuracy(p_bneck, common.VWW_BENCH_BNECK, pcm6)
    rows.append(common.csv_row("table1_vww_6b_with_bottlenecks", 0.0,
                               f"acc={a_b:.3f}+-{s_b:.3f}"))
    return rows


if __name__ == "__main__":
    raise SystemExit(common.bench_main(run, __doc__))
