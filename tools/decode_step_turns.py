#!/usr/bin/env python3
"""Per-layer decode ms per step of this checkout of the port against a
parent checkout's, in turns, on one NVIDIA card.

    python3 tools/decode_step_turns.py --parent DIR [--archs tinyllama-1.1b:22 olmo-1b:16]
                                       [--rounds 1] [--seed 0] [--out FILE]

For each ``ARCH:LAYERS`` the parent's ``DIR/src`` and this checkout's
``src`` serve in turns (parent, change, change, parent; ``--rounds``
times), each run a process of its own that imports ``repro_torch`` from
its tree: the arch at its published width on its first LAYERS layers,
weights drawn from
``--seed``, programmed (b_adc 8) and serving a Poisson trace through
``ServingEngine`` at 8 slots, per layer. tinyllama-1.1b runs
``chip_smoke.py`` phase 4's setting (16 requests, s_max 512, the digital
lock-step on); every other arch phase 17's (8 requests, s_max 256, no
lock-step, the chip's state dropped after programming). Each run prints
one JSON line (ms per decode step, tokens/s, decode steps, seconds); the
last line holds, per arch, each tree's readings, their least and their
median, and the card's name and power limit as ``nvidia-smi`` gives
them. Each tree builds its kernels into its own ``build`` directory.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (requests, prompt lengths, new tokens, s_max, lock-step) of each setting
PHASE4 = (16, (16, 32, 64, 128, 256), (16, 64), 512, True)
PHASE17 = (8, (16, 32, 64, 128), (8, 16), 256, False)


def run(arch: str, layers: int, seed: int) -> dict:
    """One tree's serve (the ``repro_torch`` on ``sys.path``)."""
    import dataclasses

    import torch

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServingConfig, ServingEngine, poisson_trace

    n, prompts, new, s_max, lockstep = PHASE4 if arch == "tinyllama-1.1b" else PHASE17
    cfg = dataclasses.replace(get(arch), n_layers=layers)
    params = lm_init(prng.PRNGKey(seed), cfg, device="cuda")
    program = engine.compile_program(params, AnalogConfig().infer(b_adc=8),
                                     prng.PRNGKey(seed + 1), device="cuda")
    if lockstep:
        kw = dict(ref_params=params, src_params=params)
    else:
        program, kw = dataclasses.replace(program, state={}), {}
        del params
    served = ServingEngine.for_program(program, cfg, ServingConfig(n_slots=8, s_max=s_max),
                                       device="cuda", **kw)
    trace = poisson_trace(prng.PRNGKey(seed + 7), n, vocab=cfg.vocab, rate=50.0,
                          prompt_lens=prompts, new_tokens=new)
    served.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=4)])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = served.run(trace)
    torch.cuda.synchronize()
    return {"arch": arch, "layers": layers, "src": sys.path[0],
            "ms_per_decode_step": rep.t_decode / max(rep.n_steps, 1) * 1e3,
            "tokens_per_s": rep.tokens_per_s, "decode_steps": rep.n_steps,
            "serve_s": time.perf_counter() - t0}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the parent checkout (its src is imported)")
    ap.add_argument("--archs", nargs="+", default=["tinyllama-1.1b:22", "olmo-1b:16"])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="also write the last line here")
    ap.add_argument("--run", nargs=3, metavar=("SRC", "ARCH", "LAYERS"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        sys.path.insert(0, str(Path(args.run[0]).resolve()))
        print(json.dumps(run(args.run[1], int(args.run[2]), args.seed)), flush=True)
        return 0
    trees = {"parent": args.parent.resolve() / "src", "change": ROOT / "src"}
    summary = {"card": card(), "seed": args.seed, "archs": {}}
    for spec in args.archs:
        arch, layers = spec.split(":")
        readings = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent") * args.rounds:
            proc = subprocess.run([sys.executable, __file__, "--seed", str(args.seed), "--run",
                                   str(trees[name]), arch, layers],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": name, **rec}), flush=True)
            readings[name].append(rec["ms_per_decode_step"])
        least = {k: min(v) for k, v in readings.items()}
        median = {k: statistics.median(v) for k, v in readings.items()}
        summary["archs"][spec] = {
            "readings_ms": readings, "parent_ms": least["parent"], "change_ms": least["change"],
            "change_over_parent": least["change"] / least["parent"],
            "parent_median_ms": median["parent"], "change_median_ms": median["change"],
            "median_change_over_parent": median["change"] / median["parent"]}
    line = json.dumps(summary)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
