"""Figure 7: accuracy over PCM drift time at several training-noise levels;
port copy of ``benchmarks/fig7_drift.py``.

Sweeps eta in {2%, 10%, 20%} and the evaluation age in {25 s, 1 h, 1 d,
1 mo, 1 y} at 8/6/4-bit activations on the scaled KWS task; the reproduced
claims are (a) accuracy decays on a log-time scale, faster at lower
bitwidth, and (b) a tuned eta > 0 beats eta = 0 at late ages.

Each simulated chip is compiled once (``engine.compile_program`` at 25 s,
on the params' device) and then aged in place through the Fig. 7 schedule
with ``engine.age_program`` -- the drift re-evaluation the serving path
uses, never reprogramming, asserted with the program-event counter. The
final aged chip round-trips through the cim-program artifact (save, load,
params bitwise and the same ``age_history``), so the figure and the
deployable artifact are the same object.

    PYTHONPATH=src python -m repro_torch.bench.fig7_drift [--fast|--full] [--device cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.bench import common
from repro_torch.checkpoint import store
from repro_torch.core import engine
from repro_torch.core.analog import AnalogConfig
from repro_torch.models.analognet import crossbar_transforms


def _artifact_roundtrip_row(program, cfg) -> str:
    """Save the final aged chip, reload it, prove it bitwise at that age."""
    with tempfile.TemporaryDirectory(prefix="fig7_chip_") as pdir:
        store.save_program(pdir, program)
        loaded = store.load_program(pdir, device=program.params["gain_s"].device)
    bit_exact = all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(program.params),
                                                      tree_lib.leaves(loaded.params)))
    assert bit_exact, "reloaded aged chip is not bit-identical"
    assert loaded.age_history == program.age_history, (loaded.age_history,
                                                       program.age_history)
    acc = common.eval_program_accuracy(loaded, cfg)
    return common.csv_row(
        "fig7_artifact_roundtrip", 0.0,
        f"bit_exact={bit_exact}_ages={len(loaded.age_history)}_acc={acc:.3f}")


def run(fast: bool = False, device="cuda") -> list[str]:
    rows: list[str] = []
    s1, s2 = (30, 30) if fast else (60, 60)
    etas = (0.0, 0.1) if fast else (0.0, 0.02, 0.1, 0.2)
    bit_list = (8, 4) if fast else (8, 6, 4)
    n_chips = 2 if fast else 3
    cfg = common.KWS_BENCH
    transforms = crossbar_transforms(cfg)
    schedule = engine.DriftSchedule.fig7()
    program = None
    for bits in bit_list:
        acfg = AnalogConfig().infer(b_adc=bits, t_seconds=schedule.times[0])
        for eta in etas:
            params = common.train_model(cfg, stage1=s1, stage2=s2, eta=eta, b_adc=bits,
                                        quant_noise_p=0.5, device=device)
            dev = params["gain_s"].device
            accs: dict[str, list[float]] = {n: [] for n in schedule.labels}
            for c in range(n_chips):
                # program once per chip; every later age re-evaluates the
                # same devices (drift only: the counter proves it)
                program = engine.compile_program(params, acfg, prng.PRNGKey(123 + c).to(dev),
                                                 transforms=transforms, device=dev)
                events0 = engine.program_event_count()
                for tname, t in zip(schedule.labels, schedule.times):
                    if t != program.t_seconds:
                        program = engine.age_program(program, t)
                    accs[tname].append(common.eval_program_accuracy(program, cfg))
                assert engine.program_event_count() == events0, (
                    "drift evaluation reprogrammed the chip")
            for tname in schedule.labels:
                a = np.asarray(accs[tname])
                rows.append(common.csv_row(f"fig7_kws_{bits}b_eta{int(eta*100)}_{tname}", 0.0,
                                           f"acc={a.mean():.3f}+-{a.std():.3f}"))
    rows.append(_artifact_roundtrip_row(program, cfg))
    return rows


if __name__ == "__main__":
    raise SystemExit(common.bench_main(run, __doc__))
