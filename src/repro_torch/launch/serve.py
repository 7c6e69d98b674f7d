"""Serving launcher of the port, the subset of ``repro.launch.serve`` that is
ported so far.

``python -m repro_torch.launch.serve --analog --request-trace 16 [--fused-decode | --kv-page-size 16]``

Serves the reduced (smoke) config of ``--arch`` through
``repro_torch.serving.ServingEngine`` on ``--device`` (default ``cuda``;
``cpu`` runs the plain versions of the kernels):

* default: a rectangle batch of ``--batch`` requests of ``--prompt-len``
  tokens and ``--tokens`` new tokens each (a vision arch's requests each
  carry their own image patches, drawn from the rectangle's data key, and
  ``s_max`` grows by ``num_patches``; a multi-codebook arch is refused:
  serve it through ``launch.steps.make_prefill_step`` / ``make_serve_step``);
* ``--request-trace N``: N variable-length requests through the continuous
  scheduler over ``--batch`` slots, all queued at t = 0 or spaced by Poisson
  arrivals at ``--arrival-rate`` requests/s.

``--analog`` programs the PCM chip once (``steps.program_for_serving``;
t = ``--t-hours``, ADC at ``--b-adc`` bits, per-layer bits from
``--b-adc-overrides``) and serves it; ``--load-program DIR`` serves a saved
cim-program artifact instead (refused if it does not fit the model), aged
to ``--t-hours`` when it is younger. ``--save-program DIR`` writes the chip
(after serving, when it aged en route). ``--resample-read-noise`` redraws
the read noise per MVM. ``--fused-decode`` runs every decode step of the
chip as one launch of the fused kernel. ``--kv-page-size P`` serves the
trace over the paged KV cache (pools of P-token pages, ``--kv-pages`` of
them) with bucketed prefill (``--prefill-buckets``) and length-sorted
admission; it prints ``mode=bucketed`` and ``prefill_traces=``, and the
same tokens as the run without it.

Drift lifecycle: ``--drift-schedule 25,3600,86400`` (or ``fig7``) serves
ONE chip at every age of the schedule, aging it in place (zero programming
events); ``--refresh-below X`` reprograms it from the source weights when
top-1 agreement drops below X. With ``--request-trace`` the schedule is a
``serving.DriftPolicy``: the chip ages between decode steps of one run, and
``drift_age``/``drift_event`` lines report it.

Fleet serving: ``--fleet N`` spreads the ``--request-trace`` across N
chips behind a ``serving.FleetRouter``: N independent draws (chip ``c``
from ``fold_in(PRNGKey(seed + 42), c)``), or N replicas of a
``--load-program`` artifact sharing its tensors. ``--agreement-slo X``
dispatches to the least-loaded chip whose recent top-1 agreement clears X.
``--fleet 1`` serves through the single-engine path, as if ``--fleet`` were
not given. ``--async`` serves the fleet through the threaded front end (one
worker thread, and on a card one CUDA stream, per chip; admission bounded
by ``--queue-cap``) and prints an ``async fleet:`` line.

Analog serving also reports greedy top-1 agreement and logit MSE against
the digital model (``--no-ref-check`` skips it). Every draw comes from the
RNG bridge with the reference CLI's keys offset by ``--seed``: weights,
rectangle prompts and the engine's key from ``split(PRNGKey(seed), 3)``,
the chip from ``PRNGKey(seed + 42)``, the trace from ``PRNGKey(seed + 7)``,
refresh ``n`` from ``fold_in(PRNGKey(seed + 43), n)``. At ``--seed 0`` a
run prints the reference CLI's tokens.

Sharded serving: ``--mesh-model N`` programs (or loads) the chip TP-sharded
over N ranks and serves it over that mesh (``launch.mesh.
make_serving_mesh``; every family the engine serves). Start one process a
device: ``torchrun --nproc-per-node N -m repro_torch.launch.serve
--mesh-model N ...``; every rank runs the CLI and rank 0 prints. Its tokens
are the unsharded run's.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Optional

from repro_torch import configs, prng
from repro_torch.checkpoint import store
from repro_torch.core import engine
from repro_torch.core import pcm as pcm_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.engine import DriftSchedule
from repro_torch.core.quant import SUPPORTED_B_ADC
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.serving import (
    AsyncConfig,
    AsyncFleetRouter,
    BucketedScheduler,
    ChipClock,
    DriftPolicy,
    FleetConfig,
    FleetRouter,
    Request,
    ServingConfig,
    ServingEngine,
    poisson_trace,
)


def parse_b_adc_overrides(text: str) -> dict:
    """Parse 'pattern=bits,pattern=bits' into an overrides dict."""
    out = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        pat, sep, bits = item.partition("=")
        if not sep or not bits.strip().isdigit():
            raise ValueError(
                f"bad --b-adc-overrides entry {item!r} "
                "(want pattern=bits with integer bits)"
            )
        out[pat.strip()] = int(bits)
    return out


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
    g.add_argument("--b-adc-overrides", default=None, metavar="SPEC",
                   help="mixed-precision: comma list of pattern=bits over "
                        "layer paths, e.g. 'lm_head=8,blocks/*=4'")
    g.add_argument("--resample-read-noise", action="store_true",
                   help="resample PCM 1/f read noise per MVM from stored "
                        "pre-read conductances (default: frozen draw, "
                        "bit-exact executes)")
    g.add_argument("--mesh-model", type=int, default=0,
                   help="shard programming+serving with this TP degree")
    g.add_argument("--save-program", default=None, metavar="DIR",
                   help="persist the programmed chip artifact")
    g.add_argument("--load-program", default=None, metavar="DIR",
                   help="serve a saved chip draw (implies --analog)")

    g = ap.add_argument_group("drift", "drift-lifecycle serving over one chip")
    g.add_argument("--drift-schedule", default=None, metavar="SPEC",
                   help="age ONE programmed chip across these ages (comma "
                        "list of seconds, or 'fig7') and re-emit the "
                        "accuracy counters at each age; overrides --t-hours")
    g.add_argument("--refresh-below", type=float, default=None, metavar="X",
                   help="reprogram the chip from the source weights when "
                        "top-1 agreement at an age of the --drift-schedule "
                        "drops below X")

    g = ap.add_argument_group("fleet", "N programmed chips behind one router")
    g.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="serve the --request-trace across N independent "
                        "chip draws (or N replicas of a --load-program "
                        "artifact) behind serving.FleetRouter; --fleet 1 "
                        "is the single-engine path")
    g.add_argument("--agreement-slo", type=float, default=None, metavar="X",
                   help="fleet SLO: dispatch to the least-loaded chip "
                        "whose recent top-1 agreement clears X, and record "
                        "the worst aggregate-agreement window")
    g.add_argument("--async", dest="use_async", action="store_true",
                   help="serve the fleet through the threaded front end "
                        "(one worker thread, and on a card one CUDA "
                        "stream, per chip) instead of the synchronous "
                        "tick loop")
    g.add_argument("--queue-cap", type=int, default=None, metavar="N",
                   help="async backpressure: cap on fleet-wide queued "
                        "work; submissions block at the cap (default 64)")
    return ap


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Reject mutually-inconsistent flag combinations with clear errors
    (the reference's rules for the flags ported here)."""
    if args.save_program and not (args.analog or args.load_program):
        ap.error("--save-program needs a compiled program (add --analog)")
    if args.b_adc_overrides and args.load_program:
        ap.error("--b-adc-overrides applies at program-compile time "
                 "(use with --analog, not --per-call/--load-program)")
    if args.b_adc_overrides and not args.analog:
        ap.error("--b-adc-overrides needs --analog")
    if args.resample_read_noise and not (args.analog or args.load_program):
        ap.error("--resample-read-noise needs a compiled program "
                 "(--analog or --load-program, without --per-call)")
    if args.drift_schedule and not (args.analog or args.load_program):
        ap.error("--drift-schedule needs a compiled program "
                 "(--analog or --load-program)")
    if args.refresh_below is not None and not args.drift_schedule:
        ap.error("--refresh-below is the --drift-schedule refresh policy "
                 "(pass both)")
    if args.refresh_below is not None and args.no_ref_check:
        ap.error("--refresh-below triggers on the top-1 agreement counter "
                 "(drop --no-ref-check)")
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
        if args.fleet is not None and args.fleet > 1:
            ap.error("--fused-decode is not threaded through the fleet "
                     "path (serve one chip)")
        if args.mesh_model:
            ap.error("--fused-decode runs the decode step in one single-"
                     "device kernel; sharded serving keeps the per-layer "
                     "path")
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
    if args.fleet is not None and args.fleet < 1:
        ap.error("--fleet needs at least one chip")
    if args.fleet is not None and args.request_trace is None:
        ap.error("--fleet spreads a request trace across chips "
                 "(pass --request-trace)")
    if args.fleet is not None and args.fleet > 1:
        if not (args.analog or args.load_program):
            ap.error("--fleet programs N independent chip draws "
                     "(add --analog, or --load-program for replicas)")
        if args.drift_schedule:
            ap.error("--drift-schedule is the single-chip lifecycle path; "
                     "fleet chips age on their own clocks")
        if args.save_program:
            ap.error("--save-program persists ONE chip; a fleet is N "
                     "draws (save a single-chip run, then --fleet with "
                     "--load-program for replicas)")
    if args.use_async and (args.fleet is None or args.fleet < 2):
        ap.error("--async drives the fleet front end (pass --fleet >= 2)")
    if args.queue_cap is not None:
        if not args.use_async:
            ap.error("--queue-cap configures the --async admission queue "
                     "(pass --async)")
        if args.queue_cap < 1:
            ap.error("--queue-cap needs at least one slot")
    if args.agreement_slo is not None:
        if args.fleet is None or args.fleet < 2:
            ap.error("--agreement-slo gates fleet dispatch "
                     "(pass --fleet >= 2)")
        if args.no_ref_check:
            ap.error("--agreement-slo compares against the digital "
                     "reference (drop --no-ref-check)")
        if not (0.0 <= args.agreement_slo <= 1.0):
            ap.error("--agreement-slo is a top-1-agreement fraction "
                     "in [0, 1]")
    if args.refresh_below is not None and args.load_program:
        print("warning: --refresh-below with --load-program reprograms "
              "from this process's deterministic source weights; if the "
              "artifact was programmed from different weights, a refresh "
              "will rewrite a different model", file=sys.stderr)


def serve_fleet(args, fleet_n, trace, program, params, acfg, cfg, serving_cfg,
                ref_params, src_params, overrides, b_adc, t0_seconds, mesh=None) -> None:
    """The trace across ``fleet_n`` chips behind the router (see
    ``serving/fleet.py`` for dispatch, drain and refresh)."""
    fleet_cfg = FleetConfig(n_chips=fleet_n, agreement_slo=args.agreement_slo)
    router_cls = AsyncFleetRouter if args.use_async else FleetRouter
    key = prng.PRNGKey(args.seed + 42)
    t0 = time.time()
    if program is not None:
        router = router_cls.from_program(
            program, cfg, serving_cfg, fleet_cfg,
            ref_params=ref_params, src_params=src_params, mesh=mesh, rng=key,
        )
        print(f"fleet: {fleet_n} replicas of the loaded chip draw "
              f"in {time.time()-t0:.2f}s")
    else:
        router = router_cls.build(
            params, acfg, cfg, serving_cfg, fleet_cfg, key=key,
            ref_params=ref_params, src_params=src_params, mesh=mesh,
            b_adc_overrides=overrides,
        )
        print(f"programmed {fleet_n} independent chip draws in "
              f"{time.time()-t0:.2f}s (b_adc={b_adc}, "
              f"t={pcm_lib.format_age(t0_seconds)})")
    sched = BucketedScheduler() if args.kv_page_size else None
    if args.use_async:
        # the classmethods construct with the default AsyncConfig; the
        # queue cap is the only knob the CLI exposes
        router.async_cfg = AsyncConfig(queue_cap=args.queue_cap or 64)
        t1 = time.time()
        freport = router.serve(trace, scheduler=sched)
        print(f"async fleet: workers={fleet_n} "
              f"queue_cap={router.async_cfg.queue_cap} "
              f"wall={time.time()-t1:.2f}s "
              f"tokens_per_s={freport.tokens_per_s:.1f}")
    else:
        freport = router.run(trace, scheduler=sched)
    print(freport.summary())
    if ref_params is not None:
        c = freport.counters
        print(f"accuracy_vs_digital_ref: top1_agreement={c['top1']:.4f} "
              f"decisions={c['decisions']}")
    longest = max(freport.records, key=lambda r: r.n_new)
    print("generated token ids (longest request):",
          longest.tokens[: min(16, longest.n_new)].tolist())


def join_mesh(ap: argparse.ArgumentParser, args):
    """``--mesh-model``: join the process group ``torchrun`` started and
    build the serving mesh over it -> (mesh, this rank's device), or (None,
    None) without the flag."""
    if not args.mesh_model:
        return None, None
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    n = args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if n < 1:
        ap.error("--mesh-model needs a TP degree >= 1")
    if world < n and not dist.is_initialized():
        ap.error(f"--mesh-model {n} shards the chip over {n} processes, one a "
                 f"device: start them with torchrun --nproc-per-node {n} -m "
                 f"repro_torch.launch.serve --mesh-model {n} ... (this process "
                 f"has no process group of {n} ranks)")
    try:
        dev = mesh_lib.init_process_group(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    if dist.get_world_size() < n:
        ap.error(f"--mesh-model {n}: the process group has {dist.get_world_size()} "
                 f"ranks; start {n} with torchrun --nproc-per-node {n}")
    return mesh_lib.make_serving_mesh(n), dev


def main(argv: Optional[list[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_args(ap, args)
    mesh, dev = join_mesh(ap, args)
    if mesh is None:
        _main(ap, args, None, None)
        return
    import torch.distributed as dist

    if dist.get_rank() == 0:
        _main(ap, args, mesh, dev)
    else:  # every rank serves; rank 0 prints
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            _main(ap, args, mesh, dev)
    dist.destroy_process_group()


def _main(ap: argparse.ArgumentParser, args, mesh, dev) -> None:
    if dev is None:
        try:
            dev = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(str(e))
    schedule = None
    if args.drift_schedule:
        try:
            schedule = DriftSchedule.parse(args.drift_schedule)
        except ValueError as e:
            ap.error(str(e))
    overrides = None
    if args.b_adc_overrides:
        try:
            overrides = parse_b_adc_overrides(args.b_adc_overrides)
        except ValueError as e:
            ap.error(str(e))
    b_adc = 8 if args.b_adc is None else args.b_adc
    cfg = configs.get_smoke(args.arch)
    if cfg.n_codebooks:
        # musicgen-style decoders emit one token per codebook per step; the
        # request-level engine drives a single token stream
        ap.error(f"--arch {args.arch}: multi-codebook decoders are not "
                 "servable through the token-stream engine")
    analog = args.analog or args.load_program is not None
    # --fleet 1 serves through the single-engine path: one chip needs no router
    fleet_n = args.fleet if args.fleet is not None and args.fleet > 1 else None
    t0_seconds = schedule.times[0] if schedule is not None else args.t_hours * 3600.0
    acfg = AnalogConfig()
    if analog:
        acfg = AnalogConfig().infer(b_adc=b_adc, t_seconds=t0_seconds,
                                    resample_read_noise=args.resample_read_noise)

    # one consumer per subkey: weight init, rectangle prompts, engine rng
    k_init, k_data, k_rng = prng.split(prng.PRNGKey(args.seed), 3)
    params = lm.lm_init(k_init, cfg, device=dev)
    # the digital reference of the accuracy counters, and the source the
    # refresh policy reprograms the chip from
    src_params = ref_params = params
    program = None
    if args.load_program is not None:
        t0 = time.time()
        shardings = None
        if mesh is not None:
            from repro_torch.launch import sharding as shd

            shardings = shd.program_shardings(params, mesh, cfg)
        program = store.load_program(args.load_program, params_like=params,
                                     shardings=shardings, device=dev)
        if args.b_adc is not None and program.cfg.b_adc != args.b_adc:
            ap.error(
                f"--b-adc {args.b_adc} does not match the loaded artifact "
                f"(compiled at b_adc={program.cfg.b_adc}); bitwidths are "
                "baked into a program's quant plans at compile time"
            )
        if args.resample_read_noise and not program.cfg.resample_read_noise:
            ap.error(
                "--resample-read-noise: the loaded artifact carries no "
                "read buffers (compile it with --analog "
                "--resample-read-noise --save-program)"
            )
        if program.t_seconds != t0_seconds:
            # the same chip, advanced to the requested age (recorded in its
            # age_history for a later --save-program)
            program = engine.age_program(program, t0_seconds)
        where = f" onto {mesh.size()}-device mesh" if mesh is not None else ""
        print(f"loaded programmed chip ({program.n_layers} layers, "
              f"b_adc={program.cfg.b_adc}, "
              f"t={pcm_lib.format_age(program.t_seconds)}, "
              f"age_history={len(program.age_history)} entries) "
              f"in {time.time()-t0:.2f}s from {args.load_program}{where}")
    elif analog and fleet_n is None:
        # (a fleet without --load-program programs its N draws itself)
        t0 = time.time()
        program = steps.program_for_serving(
            params, acfg, prng.PRNGKey(args.seed + 42), mesh=mesh, model_cfg=cfg,
            b_adc_overrides=overrides,
        )
        where = f"on {mesh.size()}-device mesh " if mesh is not None else ""
        mixed = f" with {len(overrides)} bitwidth overrides" if overrides else ""
        print(f"programmed {program.n_layers} analog layers once {where}"
              f"in {time.time()-t0:.2f}s (b_adc={b_adc}{mixed}, "
              f"t={pcm_lib.format_age(t0_seconds)})")
    if program is not None:
        params, acfg = program.params, program.cfg
        # schedule and trace runs save AFTER serving (the chip may age en
        # route); everything else saves the compiled or loaded chip
        if args.save_program and schedule is None and args.request_trace is None:
            print(f"saved programmed chip artifact to "
                  f"{store.save_program(args.save_program, program)}")

    b, s = args.batch, args.prompt_len
    s_max = s + args.tokens
    patches = None
    if cfg.frontend == "vision_patches":
        # independent per-request images (sliced per rid below), drawn from
        # the rectangle's data key in the config's dtype
        patches = prng.normal(k_data, (b, cfg.num_patches, cfg.d_model)).to(cfg.dtype)
        s_max += cfg.num_patches
    ref_check = analog and not args.no_ref_check
    serving_cfg = ServingConfig(
        n_slots=b, s_max=s_max,
        paged=args.kv_page_size is not None,
        page_size=args.kv_page_size if args.kv_page_size is not None else 16,
        n_pages=args.kv_pages,
        prefill_buckets=(
            tuple(int(x) for x in args.prefill_buckets.split(",") if x)
            if args.prefill_buckets else None
        ),
        ref_check=not args.no_ref_check,
        fused_decode=args.fused_decode,
    )
    served = None
    if fleet_n is None:
        served = ServingEngine(
            cfg, acfg, params, serving_cfg,
            program=program, ref_params=ref_params if ref_check else None,
            src_params=src_params, mesh=mesh, rng=k_rng, device=dev,
        )

    def fmt_timing(m):
        per_tok = m.t_decode / max(m.n_steps, 1) * 1e3
        return f"prefill={m.t_prefill*1e3:.1f}ms decode={per_tok:.2f}ms/token"

    def fmt_counters(m):
        c = m.counters
        return (f"top1_agreement={c['top1']:.4f} "
                f"logit_mse={c['logit_mse']:.6e} "
                f"decisions={c['decisions']}")

    def print_pass(m):
        print(f"arch={cfg.name} analog={analog} mode={acfg.mode} "
              f"b_adc={acfg.b_adc} {fmt_timing(m)}")
        if ref_check:
            print(f"accuracy_vs_digital_ref: {fmt_counters(m)}")

    if args.request_trace is not None:
        trace = poisson_trace(
            prng.PRNGKey(args.seed + 7), args.request_trace,
            vocab=cfg.vocab, rate=args.arrival_rate,
            prompt_lens=trace_prompt_buckets(s),
            new_tokens=(max(1, min(8, args.tokens)), args.tokens),
        )
        if cfg.family == "moe":
            print("warning: MoE capacity routing pools tokens across the "
                  "decode batch, so continuous-batching generations are "
                  "not bit-identical to solo serving for this family",
                  file=sys.stderr)
        if fleet_n is not None:
            serve_fleet(args, fleet_n, trace, program, params, acfg, cfg, serving_cfg,
                        ref_params if ref_check else None, src_params, overrides, b_adc,
                        t0_seconds, mesh)
            return
        policy = None
        if schedule is not None:
            est_steps = sum(r.max_new_tokens for r in trace) // max(b, 1)
            policy = DriftPolicy(
                schedule, every_steps=max(1, est_steps // max(len(schedule), 1)),
                refresh_below=args.refresh_below,
            )
        report = served.run(
            trace, scheduler=BucketedScheduler() if args.kv_page_size else None,
            drift_policy=policy,
        )
        for ev in report.age_events:
            if ev["kind"] == "age":
                print(f"drift_age step={ev['step']} t={ev['t_wall']:.0f}s "
                      f"({pcm_lib.format_age(ev['t_device'])} device age)")
            else:
                print(f"drift_event step={ev['step']} reprogram: "
                      f"top1_agreement={ev['top1']:.4f} < "
                      f"refresh_below={args.refresh_below}")
        print(report.summary())
        if ref_check:
            print(f"accuracy_vs_digital_ref: {fmt_counters(report)}")
        if args.save_program and program is not None:
            print(f"saved programmed chip artifact to "
                  f"{store.save_program(args.save_program, served.program)}")
        longest = max(report.records, key=lambda r: r.n_new)
        print("generated token ids (longest request):",
              longest.tokens[: min(16, longest.n_new)].tolist())
        return

    def rectangle_requests():
        toks = prng.randint(k_data, (b, s), 0, cfg.vocab).numpy()
        return [Request(rid=i, prompt=toks[i], max_new_tokens=args.tokens,
                        features=None if patches is None else {"patches": patches[i:i + 1]})
                for i in range(b)]

    if schedule is None:
        m = served.run(rectangle_requests())
        print_pass(m)
    else:
        # ONE chip ages in place across the schedule; the program-event
        # counter shows no reprogramming unless the refresh policy fires
        print(f"drift_schedule: ages={','.join(schedule.labels)}"
              + (f" refresh_below={args.refresh_below}"
                 if args.refresh_below is not None else ""))
        events0 = engine.program_event_count()
        chip = ChipClock(served, schedule.times[0], args.refresh_below)
        reprograms = 0
        m = None
        for i, t_age in enumerate(schedule):
            if i > 0:
                chip.age_to(t_age)
            line = f"drift_age t={t_age:.0f}s ({pcm_lib.format_age(t_age)})"
            if chip.refresh_wall is not None:
                line += f" chip_age={pcm_lib.format_age(served.program.t_seconds)}"
            m = served.run(rectangle_requests())
            line += f": {fmt_timing(m)}"
            if ref_check:
                line += " " + fmt_counters(m)
            print(line)
            if chip.wants_refresh(m.counters["top1"]):
                reprograms += 1
                print(f"drift_event t={t_age:.0f}s reprogram: "
                      f"top1_agreement={m.counters['top1']:.4f} < "
                      f"refresh_below={args.refresh_below}; rewriting chip "
                      f"from stored weights (chip age resets to "
                      f"{pcm_lib.format_age(pcm_lib.T_C)})")
                chip.refresh(prng.fold_in(prng.PRNGKey(args.seed + 43), reprograms))
        delta = engine.program_event_count() - events0
        print(f"drift_lifecycle: ages={len(schedule)} "
              f"reprograms={reprograms} program_events_delta={delta} "
              f"final_age={pcm_lib.format_age(served.program.t_seconds)}")
        if args.save_program:
            path = store.save_program(args.save_program, served.program)
            hist = ",".join(pcm_lib.format_age(t) for t in served.program.age_history)
            print(f"saved programmed chip artifact at final age "
                  f"(age_history={hist}) to {path}")
        print_pass(m)
    seq0 = m.tokens_of(0)
    print("generated token ids (first sequence):",
          seq0[: min(16, seq0.size)].tolist())


if __name__ == "__main__":
    main(sys.argv[1:])
