"""Serving launcher of the port, the subset of ``repro.launch.serve`` that is
ported so far.

``python -m repro_torch.launch.serve --analog --request-trace 16 [--fused-decode | --kv-page-size 16]``

Serves the reduced (smoke) config of ``--arch`` through
``repro_torch.serving.ServingEngine`` on ``--device`` (default ``cuda``;
``cpu`` runs the plain versions of the kernels):

* default: a rectangle batch of ``--batch`` requests of ``--prompt-len``
  tokens and ``--tokens`` new tokens each;
* ``--request-trace N``: N variable-length requests through the continuous
  scheduler over ``--batch`` slots, all queued at t = 0 or spaced by Poisson
  arrivals at ``--arrival-rate`` requests/s.

``--analog`` programs the PCM chip once (``engine.compile_program``, draws
from ``--seed``; t = ``--t-hours``, ADC at ``--b-adc`` bits) and serves it;
``--load-program DIR`` serves a saved cim-program artifact instead (for
example one written by the reference CLI's ``--save-program``), at its own
age. ``--fused-decode`` runs every decode step of the chip as one launch of
the fused kernel. ``--kv-page-size P`` serves the trace over the paged KV
cache (pools of P-token pages, ``--kv-pages`` of them) with bucketed
prefill (``--prefill-buckets``) and length-sorted admission; it prints
``mode=bucketed`` and ``prefill_traces=``, and the same tokens as the run
without it. Analog serving also reports greedy top-1 agreement and
logit MSE against the digital model built from ``--seed``
(``--no-ref-check`` skips it); for an artifact programmed from other
weights those counters compare two different models.

Weights, the rectangle prompts and the trace come from ``--seed``: the
trace from ``numpy.random.default_rng(seed + 7)``, so the reference CLI
served the same requests prints the same tokens. Fleets, meshes, drift
schedules and ``--save-program`` are not ported yet, and their flags do not
exist here.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.core import engine
from repro_torch.core import pcm as pcm_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.quant import SUPPORTED_B_ADC
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import (
    BucketedScheduler,
    Request,
    ServingConfig,
    ServingEngine,
    poisson_trace,
)


def trace_prompt_buckets(prompt_len: int) -> tuple[int, ...]:
    """Variable prompt-length buckets for --request-trace (the reference's)."""
    return tuple(sorted({max(1, (prompt_len * k) // 4) for k in (1, 2, 3, 4)}))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(configs.LM_ARCHS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the chip's draws and the workload")

    g = ap.add_argument_group(
        "serving", "workload shape and the request-level engine")
    g.add_argument("--batch", type=int, default=4)
    g.add_argument("--prompt-len", type=int, default=32)
    g.add_argument("--tokens", type=int, default=32)
    g.add_argument("--request-trace", type=int, default=None, metavar="N",
                   help="continuous batching: serve N variable-length "
                        "requests (prompts bucketed up to --prompt-len, "
                        "budgets up to --tokens) through the request-level "
                        "scheduler over --batch decode slots")
    g.add_argument("--arrival-rate", type=float, default=None, metavar="R",
                   help="Poisson arrivals at R requests/s for "
                        "--request-trace (default: all queued at t=0)")
    g.add_argument("--no-ref-check", action="store_true",
                   help="skip the digital-reference accuracy counters")

    g = ap.add_argument_group(
        "paging", "paged KV cache + bucketed prefill (over --request-trace)")
    g.add_argument("--kv-page-size", type=int, default=None, metavar="P",
                   help="paged KV cache: serve --request-trace over a "
                        "shared pool of P-token pages per layer instead "
                        "of per-slot s_max rectangles; prompts prefill "
                        "right-padded to a bucket grid (one prefill shape "
                        "per bucket) and admission is length-sorted")
    g.add_argument("--kv-pages", type=int, default=None, metavar="N",
                   help="page-pool size for --kv-page-size (default: the "
                        "rectangle-equivalent slots*ceil(s_max/P)+1; pass "
                        "less to serve long prompts at flat memory)")
    g.add_argument("--prefill-buckets", default=None, metavar="SPEC",
                   help="comma list of prefill pad lengths for "
                        "--kv-page-size (default: geometric 32*2^k grid "
                        "up to s_max)")

    g = ap.add_argument_group(
        "analog program", "program-once PCM deployment and its artifact")
    g.add_argument("--analog", action="store_true",
                   help="serve through the PCM deployment (program-once)")
    g.add_argument("--t-hours", type=float, default=24.0,
                   help="PCM drift time for --analog")
    g.add_argument("--b-adc", type=int, default=None,
                   choices=list(SUPPORTED_B_ADC),
                   help="ADC bitwidth for analog serving (default 8); with "
                        "--load-program it must match the artifact")
    g.add_argument("--fused-decode", action="store_true",
                   help="execute the whole programmed decode step as ONE "
                        "launch of the fused Hopper kernel (its plain "
                        "version on --device cpu)")
    g.add_argument("--load-program", default=None, metavar="DIR",
                   help="serve a saved chip draw (implies --analog)")
    return ap


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Reject mutually-inconsistent flag combinations with clear errors
    (the reference's rules for the flags ported here)."""
    if args.request_trace is not None and args.request_trace < 1:
        ap.error("--request-trace needs at least one request")
    if args.request_trace is not None:
        frontend = configs.get_smoke(args.arch).frontend
        if frontend in ("audio_frames", "vision_patches"):
            ap.error(f"--request-trace serves token prompts; the "
                     f"{frontend} frontend ({args.arch}) needs the "
                     "rectangle path")
    if args.arrival_rate is not None and args.request_trace is None:
        ap.error("--arrival-rate paces a --request-trace (pass both)")
    if args.kv_page_size is not None and args.request_trace is None:
        ap.error("--kv-page-size is the paged request-level path "
                 "(pass --request-trace)")
    if args.kv_page_size is not None and args.kv_page_size < 1:
        ap.error("--kv-page-size must be >= 1")
    if args.kv_page_size is not None:
        family = configs.get_smoke(args.arch).family
        if family in ("ssm", "hybrid"):
            ap.error(f"--kv-page-size pages attention KV caches; the "
                     f"{family} family ({args.arch}) carries position-free "
                     "recurrent state that right-padded bucketed prefill "
                     "would corrupt")
    if args.fused_decode:
        if not (args.analog or args.load_program):
            ap.error("--fused-decode executes a compiled chip's per-layer "
                     "plans as one grid (add --analog or --load-program)")
        if args.kv_page_size is not None:
            ap.error("--fused-decode owns one stacked slot cache; it does "
                     "not compose with the paged KV cache "
                     "(--kv-page-size)")
        fused_cfg = configs.get_smoke(args.arch)
        if fused_cfg.family in ("ssm", "hybrid", "moe"):
            ap.error(f"--fused-decode fuses the dense attention+FFN layer "
                     f"walk; the {fused_cfg.family} family ({args.arch}) "
                     "has recurrent or MoE blocks with no grid-step "
                     "lowering")
        if fused_cfg.qkv_bias:
            ap.error(f"--fused-decode executes bias-free projections; "
                     f"{args.arch} programs qkv biases the fused grid "
                     "cannot apply")
    if args.kv_pages is not None and args.kv_page_size is None:
        ap.error("--kv-pages sizes the --kv-page-size pool (pass both)")
    if args.prefill_buckets is not None and args.kv_page_size is None:
        ap.error("--prefill-buckets shapes --kv-page-size prefill "
                 "(pass both)")
    if args.prefill_buckets is not None:
        try:
            buckets = [int(x) for x in args.prefill_buckets.split(",") if x]
        except ValueError:
            ap.error(f"bad --prefill-buckets {args.prefill_buckets!r} "
                     "(want a comma list of integers)")
        if not buckets or min(buckets) < 1:
            ap.error("--prefill-buckets needs positive lengths")


def main(argv: Optional[list[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_args(ap, args)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    b_adc = 8 if args.b_adc is None else args.b_adc
    cfg = configs.get_smoke(args.arch)
    analog = args.analog or args.load_program is not None
    t0_seconds = args.t_hours * 3600.0
    acfg = AnalogConfig()
    if analog:
        acfg = AnalogConfig().infer(b_adc=b_adc, t_seconds=t0_seconds)

    params = lm.lm_init(torch.Generator(dev).manual_seed(args.seed), cfg, device=dev)
    ref_params = params
    program = None
    if args.load_program is not None:
        t0 = time.time()
        program = store.load_program(args.load_program, device=dev)
        if args.b_adc is not None and program.cfg.b_adc != args.b_adc:
            ap.error(
                f"--b-adc {args.b_adc} does not match the loaded artifact "
                f"(compiled at b_adc={program.cfg.b_adc}); bitwidths are "
                "baked into a program's quant plans at compile time"
            )
        if program.t_seconds != t0_seconds:
            ap.error(
                f"--t-hours {args.t_hours} asks for an age of "
                f"{pcm_lib.format_age(t0_seconds)}, the artifact is at "
                f"{pcm_lib.format_age(program.t_seconds)}: aging a loaded "
                "chip comes with the drift slice"
            )
        print(f"loaded programmed chip ({program.n_layers} layers, "
              f"b_adc={program.cfg.b_adc}, "
              f"t={pcm_lib.format_age(program.t_seconds)}, "
              f"age_history={len(program.age_history)} entries) "
              f"in {time.time()-t0:.2f}s from {args.load_program}")
    elif analog:
        t0 = time.time()
        program = engine.compile_program(
            params, acfg, torch.Generator(dev).manual_seed(args.seed + 42),
            device=dev,
        )
        print(f"programmed {program.n_layers} analog layers once "
              f"in {time.time()-t0:.2f}s (b_adc={b_adc}, "
              f"t={pcm_lib.format_age(t0_seconds)})")
    if program is not None:
        params, acfg = program.params, program.cfg

    b, s = args.batch, args.prompt_len
    ref_check = analog and not args.no_ref_check
    served = ServingEngine(
        cfg, acfg, params,
        ServingConfig(
            n_slots=b, s_max=s + args.tokens,
            paged=args.kv_page_size is not None,
            page_size=args.kv_page_size if args.kv_page_size is not None else 16,
            n_pages=args.kv_pages,
            prefill_buckets=(
                tuple(int(x) for x in args.prefill_buckets.split(",") if x)
                if args.prefill_buckets else None
            ),
            ref_check=not args.no_ref_check,
            fused_decode=args.fused_decode,
        ),
        program=program, ref_params=ref_params if ref_check else None,
        device=dev,
    )

    def fmt_counters(m):
        c = m.counters
        return (f"top1_agreement={c['top1']:.4f} "
                f"logit_mse={c['logit_mse']:.6e} "
                f"decisions={c['decisions']}")

    if args.request_trace is not None:
        trace = poisson_trace(
            np.random.default_rng(args.seed + 7), args.request_trace,
            vocab=cfg.vocab, rate=args.arrival_rate,
            prompt_lens=trace_prompt_buckets(s),
            new_tokens=(max(1, min(8, args.tokens)), args.tokens),
        )
        report = served.run(
            trace, scheduler=BucketedScheduler() if args.kv_page_size else None
        )
        print(report.summary())
        if ref_check:
            print(f"accuracy_vs_digital_ref: {fmt_counters(report)}")
        longest = max(report.records, key=lambda r: r.n_new)
        print("generated token ids (longest request):",
              longest.tokens[: min(16, longest.n_new)].tolist())
        return

    toks = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab, size=(b, s))
    m = served.run([Request(rid=i, prompt=toks[i], max_new_tokens=args.tokens)
                    for i in range(b)])
    per_tok = m.t_decode / max(m.n_steps, 1) * 1e3
    print(f"arch={cfg.name} analog={analog} mode={acfg.mode} "
          f"b_adc={acfg.b_adc} prefill={m.t_prefill*1e3:.1f}ms "
          f"decode={per_tok:.2f}ms/token")
    if ref_check:
        print(f"accuracy_vs_digital_ref: {fmt_counters(m)}")
    seq0 = m.tokens_of(0)
    print("generated token ids (first sequence):",
          seq0[: min(16, seq0.size)].tolist())


if __name__ == "__main__":
    main(sys.argv[1:])
