"""Figure 9 / Appendix A: depthwise models collapse on PCM CiM; port copy of
``benchmarks/fig9_micronet.py``.

Trains the scaled dense AnalogNet-style model and its depthwise-separable
twin with the same HW-aware method on ``--device``, then evaluates both on
the PCM chain aged one year: the depthwise model (densified diagonal
mapping, zero cells sharing bitlines) degrades more at low bitwidth -- the
motivating result for AnalogNets' dense-conv design rule.

    PYTHONPATH=src python -m repro_torch.bench.fig9_micronet [--fast|--full] [--device cpu]
"""

from __future__ import annotations

from repro_torch.bench import common
from repro_torch.core.analog import AnalogConfig


def run(fast: bool = False, device="cuda") -> list[str]:
    rows = []
    s1, s2 = (30, 30) if fast else (60, 60)
    bit_list = (8, 4) if fast else (8, 6, 4)
    models = {"dense": common.KWS_BENCH, "depthwise": common.KWS_BENCH_DW}
    trained = {
        name: {bits: common.train_model(cfg, stage1=s1, stage2=s2, eta=0.1, b_adc=bits,
                                        quant_noise_p=0.5, device=device)
               for bits in bit_list}
        for name, cfg in models.items()
    }
    for bits in bit_list:
        for name, cfg in models.items():
            acc_fp, _ = common.eval_accuracy(trained[name][bits], cfg, AnalogConfig())
            pcm = AnalogConfig().infer(b_adc=bits, t_seconds=365 * 86400.0)
            acc_pcm, std = common.eval_accuracy(trained[name][bits], cfg, pcm)
            rows.append(common.csv_row(
                f"fig9_{name}_{bits}b", 0.0,
                f"fp={acc_fp:.3f}_pcm1y={acc_pcm:.3f}+-{std:.3f}_drop={acc_fp-acc_pcm:.3f}"))
    return rows


if __name__ == "__main__":
    raise SystemExit(common.bench_main(run, __doc__))
