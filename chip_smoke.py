#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

It drives the port's main paths -- program-once, execute-many serving of a
dense LM on one programmed chip, the paper's CNNs programmed and served
through B1, their two-stage training and the LM's, every family sharded
and trained -- and checks every hand-written kernel on
that path against its plain PyTorch version, in phases that either pass or
end the run with a non-zero exit:

1. device: require CUDA, print the card's name and power limit, TF32 off;
2. build: compile the kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time;
3. kernel vs plain: the Hopper ``analog_mvm`` (B1) against
   ``analog_mvm_ref`` at tinyllama-1.1b's projection shapes and every M
   the serving phases launch it at (``b1_served_ms``: 1, 2, 4, 8, 16, 32,
   64, 128, 256), b_adc in {4, 6, 8}, f32 and bf16, per-tile ADC both
   ways, DAC both ways, through the design ``analog_mvm`` picks (and the
   CUDA-core ``gemv`` design too, where it is not the one picked), under
   ``tests/test_kernels.py``'s tolerance model, the worst error per
   design; the tensor-core rows bitwise independent of M, padding rows and
   design; time the kernel, its plain version, ``torch.matmul`` (yardstick
   only) and the CUDA-core design at M = 8 and the prefill Ms, bf16,
   beside the bound; after phase 9, every B1 launch of the serving phases
   must have had its (M, K, N, dtype, design, options) checked here;
4. the slice at full width: tinyllama-1.1b at its published widths with
   random weights from ``--seed``, programmed on the card (t = 24 h, all
   noise on) and serving a Poisson trace of 16 requests through
   ``ServingEngine``; the launch counters prove the path ran the kernels
   (155 B1 launches per forward, decode through B1's decode design and
   prefill through its prefill design; 22 B3 per prefill) and never a
   plain version; one decode step is then re-run through the plain version and
   compared;
5. fused kernel vs plain: from one cache state of that trace, the Hopper
   ``decode_fused`` kernel (one launch per decode step) at full width and
   depths 1, 2 and 22 (stacks sliced from the same chip), every bf16
   projection on its tensor-core MVM item, held phase by phase at every
   layer to its plain ops on its own inputs -- each MVM bitwise B1's
   decode design on the kernel's own DAC codes
   (``kernels/decode_fused_check.py``) -- and end to end to phase 4's
   bound against ``decode_fused_ref``;
6. fused serving: the same trace through ``ServingConfig(fused_decode=True)``;
   the counters prove one ``decode_fused`` launch per decode step, 155
   ``analog_mvm`` launches per prefill and no plain-version call;
7. one decode step at 8 slots three ways (per-layer eager, per-layer
   replayed from a CUDA graph, fused kernel): ms per step, device kernels
   launched, device idle share; then the fused kernel alone by CUDA events
   -- with ``--b2-parent DIR`` in turns with a parent's ``decode_fused.cu``
   built from DIR (parent, change, change, parent), at 8 slots and, on a
   1-slot decoder over the same chip, at 1 -- and where its time goes:
   each phase kind of layer 1, the final row, the lm_head and the logits,
   by launches ended after n phases (``b2_phase_ms``);
8. prefill attention vs plain: the Hopper ``flash_attention`` (kernel B3)
   against ``flash_attention_ref`` at tinyllama-1.1b's heads and every
   shape the serving phases give it (each prompt length of the trace at
   one row, as the per-request prefills run it, and the paged engine's
   (rows, bucket) shapes) plus the 2048-token context, bf16 and f32,
   causal and full (bf16 within one output ulp; at recurrentgemma-9b's
   heads up to ``FA_FLIP_OUTPUTS`` outputs past it, each in a row shown to
   hold a flipped p, ``fa_cases``); real rows bitwise independent of
   right-padding; kernel, plain version, SDPA (yardstick only) and bound
   times; after
   phase 9, every shape the serving phases launched must have been
   checked here;
9. paged serving: the same trace through ``ServingConfig(paged=True,
   page_size=16, prefill_batch=4)`` and ``BucketedScheduler``; the counters
   prove 22 B3 launches per prefill (bucketed and digital), 155 B1 launches
   per bucketed prefill call and decode step, and no plain-version call;
   one prefill call profiled for B3's share of its device time; the trace
   served rectangular and paged in turns on a chip of phase 4's first
   SHALLOW_DEPTH layers; one decode step at 8 slots (no lockstep) per
   layer over the rectangular and over the paged cache, timed in turns and
   profiled;
10. row kernels vs plain: RMSNorm, RoPE, decode attention and the silu
   gate of the per-layer decode (``kernels/decode_rows.py``, B2's
   per-element code from ``csrc/decode_rows_core.cuh``) against today's
   PyTorch ops at the decode step's shapes, within their rounding model
   (1 bf16 ulp, 2 for attention), timed beside the bound and the library
   call where there is one; phase 4 counts their launches per decode
   forward (chip and digital lockstep); with ``--b2-parent DIR`` the
   attention kernel also in turns with the parent's ``decode_rows.cu`` at
   1 slot (``s_max`` 256 and 512) and 8 slots (512), where a pass holds
   one head and two (``c3_attn_turns``);
11. drift lifecycle at full width and depth SHALLOW_DEPTH (2; a chip of
   phase 4's first layers, programmed as phase 4's was): the chip aged to
   25 s, then the trace under a ``DriftPolicy`` (25 s -> 1 h -> 1 d) with
   one refresh, per layer and fused: programming events only from the
   refresh, the implied device ages, the same tokens both ways, the aging
   and refresh seconds and ms per decode step; then B2 on the aged chip,
   one step bitwise the per-layer step; phase 4's whole chip aged once,
   timed;
12. resampled read noise: one full-width decode step with every read draw
   fresh (read buffers for phase 4's chip), per layer and fused, timed and
   bitwise equal; the trace at depth RESAMPLE_DEPTH (1) with resampling
   (the full depth would redraw 2 G weights a step and outrun the time
   limit; depth 1 since the fleet phase joined the run), per layer and
   fused: the same tokens;
13. fleet and async serving at full width (``phase_fleet``): 3 replicas of
   phase 4's chip cut to its first SHALLOW_DEPTH layers (``shallow_chip``;
   at 22 layers the phase took 267-355 s of the run's 1200, most of it
   the host's dispatch under the threads) behind ``FleetRouter`` (sharing
   its tensors), the digital lockstep on, phase 4's trace. A storm on a virtual clock drains
   chip 0 mid-flight and reprograms it: every request retires once with its
   budget, live requests migrate and their remainders are bitwise what a
   1-slot engine over the destination chip serves from the continuation
   alone, the reprogrammed
   chip is the CPU bridge's draw from its key, launches are exactly the
   work's. Then ``AsyncFleetRouter`` deterministic (virtual clock) and
   threaded (a worker thread and a CUDA stream per chip), in turns: the
   same tokens, exact launch counts under threads, tokens/s, latency,
   TTFT, idle share and peak memory of each, and the threaded speedup. The
   B1 and B3 shapes the continuations' prefills launched are then checked
   as phases 3 and 8 check theirs;
14. the paper's CNNs at full width (``phase_cnn``): AnalogNet-KWS and
   AnalogNet-VWW from ``cnn_init(--seed)``, programmed on the card through
   their crossbar transforms with their mappings (b_adc 8, t = 25 s), each
   chip bitwise the CPU bridge's; served through ``cnn_apply`` (every conv
   and the FC one fp32 B1 launch through the ``tiled`` design) as an
   always-on stream of single-image calls and one sweep batch
   (``CNN_TRAFFIC``: KWS 32 and 256, VWW 16 and 64), each layer's ADC
   outputs and the logits held against the plain version on the card;
   images of the sweep served alone bitwise their rows of the sweep;
   aged to 24 h (no programming event) and at b_adc 4, the sweep again;
   ms per inference, B1's launches and device share, the mappings'
   utilization; the stream and the sweep served again in turns through
   the ``gemv`` design (``cnn_serve_turns``); B1 checked at every shape
   launched and timed per forward
   beside the plain version, torch.matmul and the bound, and in turns
   with its parent, the ``gemv`` design (``--b1-parent DIR``: a parent's
   ``analog_mvm.cu`` built from DIR; else this tree's);
15. the paper's two-stage training on the card (``phase_train``):
   (a) B1's training form -- a p = 0.5 quant-noise keep mask in the tiled
   design's epilogue -- against the plain training form at every shape the
   training below launches and a two-tile K = 2048, b_adc 4/6/8, with and
   without a mask (masks bitwise the CPU bridge's); (b) one stage-2 step of
   AnalogNet-KWS at full width, batch 64, card vs CPU: draws and masks
   bitwise, each layer's ADC outputs within the tolerance model, the loss
   and the gradients within their bounds (the range leaves against the
   same step through the plain version on the card); (c) AnalogNet-KWS
   trained through ``launch/train.py``'s functions, 30 + 30 steps at batch
   64 with asynchronous checkpoints, exactly 5 B1 launches (all tiled) and
   5 backward recomputes per stage-2 step, none in stage 1, no plain
   forward call,
   the last stage-1 loss below the first, then a resume from the final
   checkpoint that runs nothing and restores the params bitwise; ms per
   step, one profiled step per stage, peak memory; (d) AnalogNet-VWW, 2 +
   2 steps at batch 16, the same gates; (e) the trained KWS programmed
   through its crossbar transforms and evaluated at 25 s and 24 h beside
   its digital accuracy (reported); B1's training form timed per stage-2
   forward, in turns with its parent as in phase 14;
16. LM training on the card (``phase_lm_train``): (a) B1's bf16 training
   form -- the keep mask in the prefill design's epilogue -- against the plain
   training form at tinyllama-1.1b's projection shapes at M = 64 and 512
   (the tokens of (b) and (c)) and a two-tile K = 2048, b_adc 4/6/8, with
   and without a p = 0.5 mask, under phase 3's bf16 tolerance, unkept
   values within an output ulp, masks bitwise the CPU bridge's, and an
   all-ones mask bitwise the same launch without one; (b) one
   stage-1 and one stage-2 step of tinyllama-1.1b at full width on 2
   layers, 1 x 64 tokens, fp32 and bf16, on the card and on the CPU
   locked to the card's forward values (``training.lockstep``; the CPU
   steps in a child process beside (a) and (d)): masks and the CPU's own
   weight-noise draws bitwise, each B1 output under the ADC tolerance
   model of the CPU's at the same inputs, the loss within 1e-3 of a free
   CPU forward, each gradient leaf within ``lockstep.GRAD_RTOL``, and a
   zeroed or doubled leaf caught by that gate (``--lm-step-readings``
   runs (b) alone at several seeds, the gates reported, for the readings
   the bounds come from); (d) ``serve_drift_24h`` on the card,
   no programming event while aging; (c) tinyllama-1.1b at full width on
   8 of its 22 layers (``LM_RUN``) trained through ``run_two_stage`` with
   the config's remat (each group's forward recomputed in the backward), 3 +
   3 steps at batch 4 x 128 tokens with asynchronous checkpoints: every
   stage-2 step 113 keep-mask ``prefill`` launches (57 forward, 56
   recomputed) and 57 backward recomputes, every step 16 B3 launches (its
   training form; 8 and 8) and 8 backward recomputes, no plain
   forward, finite losses, a resume from the final checkpoint that runs
   nothing and restores the params bitwise; ms per step, one profiled
   step per stage (B1's and B3's share, idle share), peak memory against
   the run without remat; then every B1 key and B3 shape the phase
   launched checked as phases 3 and 8 check theirs, and both training
   forms timed per forward (B1's in turns with its parent, the ``gemv``
   design); (b) runs without remat (its tapes hold each forward call once);
17. the other LMs (``phase_archs``), after the
   earlier phases' chips are freed: olmo-1b and llama3.2-3b at their
   published widths and as deep as the card holds them (olmo-1b whole),
   qwen2-72b at full width on one layer, phi3.5-moe on two layers (one if
   two do not fit), llama4-maverick at its smoke width and depth (its one
   MoE layer of 128 experts is ~16 B weights, past one card): each
   programmed on the card from random weights (``--seed``) and serving a
   Poisson trace of 8 requests at 8 slots per layer (olmo-1b and
   llama3.2-3b also through B2, the same tokens); program seconds, peak
   memory, decode ms per step, tokens/s; exact B1, bank-form and B3
   launch counts and no plain-version call; a prompt's prefill through the
   kernels against the plain version (every MVM through B1 on the plain
   forward's inputs under phase 3's ADC model, an argmax at the plain
   logits' maximum -- their own, or an index tied with it exactly -- the
   logits' rel L2 reported); every MoE family through B1's expert-bank
   form, one launch an
   MoE layer's family; then every new B1 key (the lm_heads' N = 128256,
   50304, 152064 among them) checked as phase 3 checks its own, every
   bank key (E, M, K, N, dtype, design) against its plain version under
   the ADC tolerance model and each expert bitwise the 2-D launch of its
   slice, every new B3 shape at its arch's heads, and the bank form timed
   per MoE layer at phi3.5-moe's decode and prefill shapes beside its
   plain version, ``torch.bmm`` (yardstick only), the 48 2-D launches it
   replaces and the bound. The SSM and hybrid families too: mamba2-2.7b at
   its published width and as deep as the card holds it, and
   recurrentgemma-9b at full width on 5 layers (one (rec, rec, attn)
   group and the published 2-layer tail), served per layer (their SSD and
   RG-LRU steps plain torch ops, as the reference leaves them to XLA; B2
   refuses both), each decode step profiled once (device kernels a step,
   idle share); B3 with the local window and at D = 256 (``b3_window``):
   recurrentgemma's (1, 4096, 16/1, 256) at window 2048 and the smoke
   width's window 32 at S = 96 (kv_chunk 32) against the plain version
   under phase 8's bound, fp32 and bf16; real rows bitwise under
   right-padding; the walk that starts at a block's first live key
   bitwise the walk from key 0; timed at (1, 4096, 16/1, 256) window 2048
   beside the plain version, SDPA with the sliding-window mask (yardstick
   only) and the bound; the row kernels at recurrentgemma's decode shapes
   (hd 256, one KV head, rolling lengths past the 256-row buffer) against
   their plain versions as phase 10 holds its own. The vision and audio
   families: paligemma-3b whole, every request of the trace with its own
   256 image patches (fp32 normals from ``--seed`` cast to bf16; s_max
   grows by the prefix), served per layer and through B2 (head dim 256,
   one KV head), each feature-fed prefill one more B1 launch
   (``patch_proj``); musicgen-large at its published width and as deep as
   the card holds it, served as the reference serves a codebook decoder
   (``codebook_run``): ``launch/steps.py``'s prefill step over 8 rows of
   128 frames, then 16 greedy decode steps of (8, 4) codes, each fed a
   fresh frame row, with exact launch counts, a profiled step and each
   codebook's argmax at the plain forward's maximum; B3 at paligemma's prefill (1, 272,
   8/1, 256), no window, against its plain version and bitwise under
   right-padding, and the row kernels at both archs' decode shapes; budget
   ``ARCH_BUDGET_S``;
18. sharded serving (``phase_mesh``) at world size 1 over NCCL (one card
   holds one rank; the multi-rank semantics are held on the CPU over gloo,
   ``tests/test_torch_distributed.py``), its own store in a temp dir:
   tinyllama-1.1b at full width and depth programmed through
   ``program_for_serving(mesh=make_serving_mesh(1))``, gathered and held
   bitwise to phase 4's chip (every param and state leaf's two exact
   integer checksums, taken right after phase 4); 8 of phase 4's requests
   at 8 slots through ``ServingEngine(mesh=)``, per layer, each cut to its
   first 16 tokens: the prefix of phase 4's tokens, exact B1 (by design), B3 and row-kernel launches, no plain
   call, ms a decode step, tokens/s, collective calls a forward and their
   host-clock share; phi3.5-moe at full width on 2 layers with
   ``moe_dispatch="shard_map"``: at its published capacity factor 1.25 a
   prefill through the kernels against shard_map's own plain version
   (phase 17's check: every MVM under phase 3's model, the argmax at the
   plain logits' maximum) and phase 17's trace served with one bank
   launch a MoE family, ms a decode step; at capacity factor 8 (= E /
   top_k: no token drops) the trace's tokens through shard_map equal the
   einsum path's on the same chip; the sharded chip's artifact (cut to 1
   layer, for the write's time) bitwise the unsharded chip's arrays, and
   ``load_program(shardings=)`` serving the unsharded chip's tokens; a
   mesh with ``fused_decode`` refused in the reference's words; then every
   new B1 key checked as phase 3 checks its own, every new bank key as
   phase 17 does at the 8 bits served. The other families
   (``mesh_family``): mamba2-2.7b on 4 layers, recurrentgemma-9b
   on one (rec, rec, attn) period, paligemma-3b and musicgen-large on 2,
   at full width from ``--seed``, each programmed through the mesh and
   unsharded at one key: the gathered chip's every param and state leaf's
   two integer checksums the unsharded chip's (split leaves gathered one
   at a time, ``program_digest``); 4 of phase 17's requests (paligemma's
   each with its 256 patches) served on both chips per layer, or
   musicgen's 8 x 128-frame rectangle and 8 steps of (8, 4) codes through
   the step makers: the same tokens (codes), B1 launches by design and B3
   and row-kernel launches the unsharded run's, B1 and B3 exact, no plain
   call; AnalogNet-KWS programmed with ``shardings=`` and its crossbar
   transforms (``mesh_cnn``): its gathered chip and mapping phase 14's at
   the same key, its logits on 4 images the unsharded chip's, bitwise;
   these reported against ``MESH_FAMILIES_BUDGET_S``; budget
   ``MESH_BUDGET_S``;
19. sharded training (``phase_train_mesh``) over phase 18's NCCL group:
   phase 16 (b)'s stack (tinyllama-1.1b at full width on 2 layers, drawn
   again from ``--seed``, bitwise 16 (b)'s) takes one stage-1
   (``digital``) and one stage-2 (``analog_train``, LM_TRAIN) step, bf16,
   through ``make_train_step(mesh=)`` at mesh (1, 1): params, optimizer
   state and metrics bitwise the unsharded steps phase 16 (b) took
   (``lm_train_steps``: their digests, kept from phase 16), the same B1
   (by design, the training form) and B3 launches and recomputes, no plain
   call; ms a step against the unsharded one, collective calls a step and
   their share of the host clock; every new B1 key checked as phase 3
   checks its own; then recurrentgemma-9b on one period at full width
   (``train_mesh_hybrid``: its conv gathered in ``train_view``, the
   RG-LRU, the windowed attention's replicated KV head), its own stage-1
   and stage-2 steps unsharded and sharded, with Adafactor: bitwise, the
   same launches, reported against ``TRAIN_MESH_HYBRID_BUDGET_S``; budget
   ``TRAIN_MESH_BUDGET_S``. A world size above 1 on cards is not checked:
   one card holds one rank;
20. training the other families (``phase_train_families``):
   mamba2-2.7b on 2 layers, recurrentgemma-9b on one period and
   paligemma-3b on 2 layers (``TRAIN_FAMILIES``), at full width through
   the CLI's ``lm_setup(n_layers=)``, bf16, 1 x 64 tokens: one stage-1 and
   one stage-2 step each, held as phase 16 (b) holds tinyllama but against
   phase 15 (b)'s control, the same step through the plain versions on
   the card (``plain_on_card``), locked to the card's forward values
   (``training.lockstep``, its tapes on the card): the CPU side would move
   every weight-noise draw of a stack to the host (1.7 B values for
   recurrentgemma's, with its untied 256,000-word head) and take minutes.
   Gates: launches and recomputes exact (every analog layer one
   training-form B1 launch by design a stage-2 forward, every attention
   layer one B3 launch), no plain forward; masks and weight-noise draws
   bitwise; each B1 output under the ADC model of the plain form's (bf16:
   the flip share); the loss within 1e-3 of the control's free forward;
   each gradient leaf within ``lockstep.GRAD_RTOL``; a zeroed or doubled
   leaf caught. Reported: ms a step by stage, device kernels a step and
   the idle share (one untaped step profiled), peak memory. Then B3's
   windowed training form at recurrentgemma's heads (``b3_train_window``:
   (1, 4096, 16/1, 256), window 2048): the forward under phase 8's bound
   with ``fa_flip_rows``' allowance, ``dq``, ``dk``, ``dv`` within twice
   the plain backward's own bf16 rounding of autograd of the plain
   version on the card; budget ``TRAIN_FAMILIES_BUDGET_S``;
21. the dry run against a real step (``phase_dryrun``): over an NCCL
   group of one, mesh (1, 1), tinyllama-1.1b at full width and
   ``DRYRUN_DEPTH`` layers: train 1 x 512 (``digital`` and
   ``analog_train``), prefill 1 x 4096 (``digital``), decode 8 slots
   against a 4096 cache (``digital``) and decode at ``DRYRUN_INFER_DEPTH``
   layers in ``pcm_infer`` (``analog_infer``). Each cell is traced by
   ``launch.dryrun.run_cell`` on fake ``cuda`` tensors (a fake group of
   one), then the same step runs for real on the card under the same
   counter (``analysis.cost``). Gates: (a) the dry run's argument bytes
   are the real inputs' exactly; (b) its FLOPs, bytes and collective
   counts are the real step's exactly; (c) its peak is within
   ``DRYRUN_PEAK_RTOL`` and ``DRYRUN_PEAK_SLACK`` of the growth of
   ``torch.cuda.max_memory_allocated()`` over the real step. Reported: ms
   a step by CUDA events, and ``t_step``, the bottleneck and the roofline
   fraction at the card's published peaks (computed); budget
   ``DRYRUN_BUDGET_S``;
22. report: a JSON line ``{"kernels": [...]}`` (launches from the serving
   phases, the fleet, the CNNs, the training runs and phases 17-20)
   and, last, the device line ``{"ok": true, "device": {...}}``.

The RNG bridge (``repro_torch.prng``): phase 4 draws the weights and
programs the chip through it (the normal draws on the card's kernel
``csrc/prng.cu``) and prints the program seconds beside the parent's
``torch.Generator`` figure; right after phase 4, the bridge on the card =
the bridge on the CPU: layer 0's wk state, programmed again on the CPU
from its key, bitwise the card's, and drifted to 30 days on both, bitwise;
2^22 normals card == CPU. Phase 5 holds B2's K rows and every DAC code
bitwise to the per-layer decode's ops on the card (the row kernels and
the DAC), at depths 1, 2 and 22; phase 6 fails unless fused serving keeps
every request's per-layer tokens.

Phases 4, 6 and 9 prefill through B3 (every prefill forward, the chip's
and the digital lockstep's, runs it once per layer).

Everything it measures is also written to ``--out`` (default
``build/chip_smoke.json``).
Without a card, or outside a checkout, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
FP32_OPS = 67e12  # float32 outside the tensor cores, H100 SXM
#: arithmetic operations of one normal draw in csrc/prng.cu, counted from
#: the source (an FMA as 2): threefry2x32's 20 rounds, key injections and
#: the counter split, 124 integer operations; the uniform, 4; log1p's two
#: branches (both evaluated), 77; erf_inv's polynomial, selects and the
#: final scalings, 41
PRNG_OPS_PER_DRAW = 124 + 4 + 77 + 41
L2_BYTES = 50 * 2**20
DEV = "cuda"  # every phase runs on the card

#: tinyllama-1.1b main-path projections: (name, K, N, launches per forward)
SHAPES = (
    ("wq|wo", 2048, 2048, 2 * 22),
    ("wk|wv", 2048, 256, 2 * 22),
    ("w1|w3", 2048, 5632, 2 * 22),
    ("w2", 5632, 2048, 22),
    ("lm_head", 2048, 32000, 1),
)
LAUNCHES_PER_FORWARD = sum(c for *_, c in SHAPES)  # 155
#: kernel B3 runs once per layer of a prefill forward (tinyllama-1.1b)
FA_LAUNCHES_PER_PREFILL = 22
#: tinyllama-1.1b attention: heads, KV heads, head dim, the config's chunks
FA_HEADS = dict(h=32, kv=4, d=64, q_chunk=512, kv_chunk=1024)
#: at recurrentgemma-9b's heads, the most bf16 outputs of one B3 case past
#: phase 8's bound, each in a row shown to hold a flipped p (``fa_cases``)
FA_FLIP_OUTPUTS = 4
#: a p counts as near a bf16 midpoint within this share of |q| . |k| (over
#: D, scaled) for its key and the row max's: 16 f32 ulps of the magnitude a
#: score's sum rounds at, for either version's order
FA_P_NEAR = 2.0**-20
#: phase 9's engine: paged KV with bucketed prefill
PAGED = dict(n_slots=8, s_max=512, paged=True, page_size=16, prefill_batch=4)
#: the model's published context, checked beside the served shapes
FA_CONTEXT = 2048
#: prompt lengths of the served trace (phases 4, 6 and 9)
PROMPT_LENS = (16, 32, 64, 128, 256)
#: slots of a decode step (the M of every decode-step B1 launch)
SLOTS = 8
#: phase 12's trace with every read noise redrawn per MVM runs at this
#: depth (the full depth would redraw 2 G weights a step)
RESAMPLE_DEPTH = 1
#: phase 9's rectangular and paged serves in turns and phase 11's drift
#: lifecycle run on a chip of phase 4's first SHALLOW_DEPTH layers (at the
#: full depth they took a third of the run once the fleet phase joined it)
SHALLOW_DEPTH = 2
#: the fleet phase (13): 3 replicas of phase 4's chip, 4 ticks down per
#: reprogram; chip 0 is drained at FLEET_DRAIN_TICK, where it holds live
#: requests (routing on a virtual clock follows arrivals and budgets, not
#: tokens: the trace at smoke width drains 2 live requests there)
FLEET = dict(n_chips=3, refresh_steps=4)
FLEET_DRAIN_TICK = 15
#: the profiled window of each async run: (seconds into the run, length)
FLEET_WINDOW_S = (2.0, 0.3)
#: phase 4's program phase before the RNG bridge, with torch.Generator
#: draws: that chip_smoke.py's runs on an H100 80GB HBM3 at 700 W
PARENT_PROGRAM_S = "0.69-0.85"
#: the drift lifecycle's wall ages (phase 11): 25 s, 1 h, 1 d
LIFECYCLE_AGES = (25.0, 3600.0, 86400.0)
#: the CNN phase (14): each of the paper's own models at its published
#: widths, with its always-on stream of single-image calls and one sweep batch
CNN_TRAFFIC = (("analognet-kws", 32, 256), ("analognet-vww", 16, 64))
#: warm calls of the sweep batch timed after its cold first call
CNN_SWEEP_REPS = 5
#: the CNN chips are programmed at t = 25 s and aged to 24 h
CNN_AGES = (25.0, 86400.0)
#: the training phase (15): AnalogNet-KWS at its published widths, 30 + 30
#: steps (and one stage-2 step held card vs CPU), then AnalogNet-VWW briefly
TRAIN_KWS = dict(arch="analognet-kws", batch=64, stage1=30, stage2=30)
TRAIN_VWW = dict(arch="analognet-vww", batch=16, stage1=2, stage2=2)
#: phase 15 (b)'s bounds on one stage-2 step, card vs CPU: the loss, and
#: each gradient leaf (rel L2). A range leaf (``r_adc``, ``gain_s``,
#: ``w_clip_buf``) sums a layer's every quantizer term with cancellation,
#: which a few ADC codes flipped by the order of the fp32 sums move far
#: more: each is held within the bound, or within TRAIN_RANGE_FACTOR times
#: its own distance in the same step through the plain version on the
#: card (the control). On an H100 80GB HBM3 at 700 W the card's distance
#: was at most 1.11 times the control's on every leaf above the bound
#: (fc's ``r_adc`` 0.256 against 0.230, ``w_clip_buf`` 0.407 against 0.371)
TRAIN_STEP_LOSS_RTOL = 1e-3
TRAIN_STEP_GRAD_RTOL = 1e-2
TRAIN_RANGE_FACTOR = 2.0
#: device kernels listed by summed time in each profiled training step
TRAIN_TOP_KERNELS = 8
#: the LM training phase (16): tinyllama-1.1b at full width; (b) one step
#: of each stage on LM_STEP's 2 layers, card vs CPU; (c) run_two_stage on
#: LM_RUN's layers (8 of 22: the whole 22 until phase 19 took its budget
#: out of the script's time limit; (c) took 100-107 s of it at 22), batch
#: and steps, then a resume
LM_ARCH = "tinyllama-1.1b"
LM_STEP = dict(layers=2, batch=1, seq=64)
LM_RUN = dict(layers=8, batch=4, seq=128, stage1=3, stage2=3)
#: the CLI's stage-2 settings
LM_TRAIN = dict(eta=0.1, b_adc=8, quant_noise_p=0.5)
#: phase 19's optimizer (both stages), and its budget, seconds (it fails
#: past it)
LM_MESH_OPT = dict(lr=3e-3, total_steps=10, warmup=1)
TRAIN_MESH_BUDGET_S = 60
#: (c)'s peak before the port applied ``cfg.remat``: this script's runs on
#: an H100 80GB HBM3 at 700 W
LM_PEAK_NO_REMAT = "40.98 GiB above 28.66 GiB"
#: (b)'s CPU steps run in a child process beside the card's work, on this
#: many threads, and are given this long
LM_CPU_THREADS = 8
LM_CPU_TIMEOUT_S = 600
#: (b)'s CPU child draws itself every weight-noise draw of this many
#: values or fewer (wk's and wv's, 2 M of the 154 M) and holds it bitwise
#: to the card's; it takes the others from the card
LM_CPU_DRAW_MAX = 1 << 20

#: the row kernels' plain versions (kernels/decode_rows.py)
ROW_PLAINS = lambda dr: (dr.norm_plain, dr.rope_plain, dr.attention_plain, dr.gate_plain)


#: where the row kernels' functions live in the reference (XLA ops there)
ROW_REPLACES = {
    "norm": "src/repro/models/common.py:160 (rmsnorm_apply, XLA ops; not a TPU kernel)",
    "rope": "src/repro/models/common.py:177 (rope, XLA ops; not a TPU kernel)",
    "attn": "src/repro/models/attention.py:185 (decode_attention, XLA ops; not a TPU kernel)",
    "gate": "src/repro/models/lm.py:80 (mlp_apply's silu gate, XLA ops; not a TPU kernel)",
}
ROW_PER = {
    "norm": "RMSNorm of 8 x 2048; library: F.rms_norm",
    "rope": "q (8, 32, 64) and k (8, 4, 64) rows; library: none",
    "attn": "8 slots x 32 heads against a 512-row cache at random lengths; library: SDPA "
            "with a length mask and enable_gqa",
    "gate": "silu(u) * g over 8 x 5632; library: none (two calls)",
}


def rows_per_forward(cfg) -> dict:
    """Row-kernel launches of one per-layer decode forward."""
    n = cfg.n_layers
    return {"norm": 2 * n + 1, "rope": n, "attn": n, "gate": n}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- helpers


def bf16_ulp(v):
    """One bf16 ulp of |v| (elementwise), for the bf16 output rounding."""
    import torch

    a = v.abs().float().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def time_ms(fn, n_iter: int) -> float:
    """Mean device ms per call over ``n_iter`` calls; ``fn(i)`` launches
    call ``i``. The calls are captured once in a CUDA graph and the replay
    is timed with CUDA events, so a call costing less device time than its
    host-side launch is not timed at the host's pace."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_iter):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n_iter


def turns_ms(run_new, run_old, n_iter: int) -> dict:
    """A redesign against its parent in turns by ``time_ms``: old, new, new,
    old. ``run_old`` launches B1's CUDA-core ``gemv`` design, the parent of
    the tiled design and of the prefill design's training form (a parent's
    build through ``_launch``'s ``lib``, or this tree's own)."""
    o1 = time_ms(run_old, n_iter)
    n1, n2 = time_ms(run_new, n_iter), time_ms(run_new, n_iter)
    o2 = time_ms(run_old, n_iter)
    return {"ms": min(n1, n2), "ms_readings": [n1, n2], "gemv_ms": min(o1, o2),
            "gemv_readings": [o1, o2]}


# --------------------------------------------------------------- phases


def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build() -> tuple:
    """Build every kernel; print the build time and ptxas's registers,
    shared memory and spills per kernel entry."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(p.name for p in paths.values())} in {secs:.2f} s")
    ptxas = {n: build.ptxas_report(p) for n, p in paths.items()}
    for n, entries in ptxas.items():
        for e in entries:
            kind = "bf16" if "bfloat16" in e["entry"] else "f32"
            log(f"ptxas {n} ({kind}): {e.get('used', '?')}; {e.get('spills', 'no spill line')}")
    return secs, ptxas


def compare(y_k, y_p, step: float, n_tiles: int, bf16: bool) -> dict:
    """tests/test_kernels.py's tolerance model, plus one bf16 ulp of |y|
    in bf16. Any differing element is an ADC code flip (the epilogues are
    the same IEEE ops on both sides)."""
    yk, yp = y_k.float(), y_p.float()
    d = (yk - yp).abs()
    ulp = bf16_ulp(yp) if bf16 else 0.0
    tol = 1.01 * step * n_tiles + ulp
    over = (d > 0.5 * step + ulp).float().mean().item()
    ok = bool((d <= tol).all().item()) and over < 0.01 and bool(yk.isfinite().all().item())
    return {"max_abs": d.max().item(), "max_steps": (d / step).max().item(),
            "frac_half_step": over, "flips": int((d > 0).sum().item()),
            "elements": d.numel(), "finite": bool(yk.isfinite().all().item()), "ok": ok}


def b1_served_ms() -> tuple:
    """The M of every B1 launch the serving phases make: a decode step at
    ``SLOTS`` rows; a prefill of one prompt at its exact length (the
    per-request prefills and the 16-token warm-up) runs its layer
    projections at M = length and its lm_head at M = 1 (the last token); a
    bucketed prefill at (rows, bucket) runs them at rows x bucket and at
    rows."""
    from repro_torch.serving.paging import default_buckets, prefill_rows

    ms = {SLOTS, 1, *PROMPT_LENS}
    for b, pb in prefill_rows(default_buckets(PAGED["s_max"]), PAGED["prefill_batch"]).items():
        if b <= max(PROMPT_LENS):
            ms |= {pb * b, pb}
    return tuple(sorted(ms))


def b1_key(m: int, k: int, n: int, dtype, design: str) -> tuple:
    """What a B1 launch is checked and recorded by."""
    return (m, k, n, str(dtype).split(".")[-1], design)


def phase_kernel_vs_plain(torch, gen, ms: tuple) -> dict:
    """B1 against its plain version at every projection shape and every M of
    ``ms``, b_adc 4/6/8, f32 and bf16, per-tile ADC both ways, DAC both ways,
    through the design ``analog_mvm`` picks for the case and, where that is
    a tensor-core design, through the CUDA-core design on the same inputs
    (the kernel bf16 ran on before them); the worst error per design; then
    the row-stability check of the tensor-core designs (``row_stability``)."""
    from repro_torch.kernels import analog_mvm as kernel

    by_design = b1_by_design()
    checked, failures = set(), []
    for name, k, n, _ in SHAPES:
        w32 = torch.randn((k, n), generator=gen, device=DEV) * k**-0.5
        for m in ms:
            x32 = torch.randn((m, k), generator=gen, device=DEV)
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                for per_tile in (True, False):
                    for dac in (True, False):
                        auto = kernel.select_design(dtype, m, k, n, per_tile_adc=per_tile,
                                                    apply_dac=dac)
                        for design in dict.fromkeys((auto, "gemv")):
                            b1_cases(torch, name, x, w, design, per_tile, dac, by_design,
                                     checked, failures)
    torch.cuda.synchronize()
    cases = sum(v["cases"] for v in by_design.values())
    log(f"kernel vs plain: {cases} cases, M in {list(ms)}")
    for d, v in by_design.items():
        log(f"  {d:7s}: {v['cases']} cases, max |d| {v['max_abs']:.3e} ({v['max_steps']:.3f} "
            f"ADC steps), worst share > half a step {v['frac_half_step']:.2e}, flips "
            f"{v['flips']} of {v['elements']}")
    for f in failures[:10]:
        log(f"  FAIL {f}")
    check(not failures, f"{len(failures)} kernel-vs-plain cases out of tolerance")
    return {"cases": cases, "ms": list(ms), "by_design": by_design,
            "checked": sorted(checked), "row_stability": row_stability(torch, gen, kernel)}


def b1_by_design() -> dict:
    """An empty record of B1's worst errors per design, for ``b1_cases``."""
    from repro_torch.kernels import analog_mvm as kernel

    return {d: {"max_abs": 0.0, "max_steps": 0.0, "frac_half_step": 0.0, "flips": 0,
                "elements": 0, "cases": 0} for d in kernel.DESIGNS}


def b1_cases(torch, name, x, w, design, per_tile, dac, by_design, checked, failures) -> None:
    """B1 through ``design`` against its plain version on x (M, K) and w
    (K, N) at b_adc 4, 6 and 8 under ``compare``'s tolerance model: the
    worst error goes into ``by_design``, the case's ``b1_key`` and options
    into ``checked``, a case out of tolerance into ``failures``."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref

    r_adc = torch.tensor(1.5, device=DEV)
    r_dac = torch.tensor(3.0, device=DEV)
    out_scale = torch.tensor(0.97, device=DEV)
    (m, k), n, dtype = x.shape, w.shape[1], x.dtype
    auto = kernel.select_design(dtype, m, k, n, per_tile_adc=per_tile, apply_dac=dac)
    n_tiles = math.ceil(k / 1024) if per_tile else 1
    for bits in (4, 6, 8):
        step = (1.5 + 1e-9) / (2 ** (bits - 1) - 1) * 0.97
        kw = dict(r_dac=r_dac if dac else None, b_adc=bits, r_adc=r_adc,
                  out_scale=out_scale, tile_rows=1024, per_tile_adc=per_tile)
        y_p = analog_mvm_ref(x, w, r_dac, r_adc, out_scale, b_dac=bits + 1, b_adc=bits,
                             tile_rows=1024, per_tile_adc=per_tile, apply_dac=dac)
        y_k = (kernel.analog_mvm(x, w, **kw) if design == auto
               else kernel._launch(design, x, w, **kw))
        check(y_k.dtype == dtype and y_k.shape == (m, n),
              f"{name}: kernel output {y_k.dtype} {tuple(y_k.shape)}")
        r = compare(y_k, y_p, step, n_tiles, dtype == torch.bfloat16)
        worst = by_design[design]
        worst["cases"] += 1
        worst["flips"] += r["flips"]
        worst["elements"] += r["elements"]
        for key in ("max_abs", "max_steps", "frac_half_step"):
            worst[key] = max(worst[key], r[key])
        checked.add(b1_key(m, k, n, dtype, design) + (1024, per_tile, dac, False))
        if not r["ok"]:
            failures.append((name, m, str(dtype), design, bits, per_tile, dac, r))


def b1_train_cases(torch, name, x, w, per_tile, by_design, checked, failures) -> dict:
    """B1's training form -- the design ``analog_mvm`` picks for a keep
    mask (``tiled`` in fp32, ``prefill`` in bf16 above 16 rows) with a p =
    0.5 quant-noise ``keep`` mask drawn by the RNG bridge on the card --
    against the plain
    training form (``analog_mvm_ref(..., keep=...)``) on x and w (fp32 or
    bf16) at b_adc 4, 6 and 8: the kept (ADC'd) values under ``compare``'s
    tolerance model (in bf16 with its one output ulp); where one
    conversion covers all of K, the unkept values (sums in another order)
    within 1e-5 of max |y| in fp32, within one output ulp (+ 1e-6 of max
    |y|) in bf16. The card's masks are checked bitwise against the CPU
    bridge's draw from the same key. Returns the case's worst unkept
    error (relative to max |y|; in bf16 also in output ulps) and whether
    its masks were bitwise; records as ``b1_cases``."""
    from repro_torch import prng
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref, n_tiles

    r_adc = torch.tensor(1.5, device=DEV)
    out_scale = torch.tensor(0.97, device=DEV)
    (m, k), n = x.shape, w.shape[1]
    t = n_tiles(k, 1024, per_tile)
    bf16 = x.dtype == torch.bfloat16
    design = kernel.select_design(x.dtype, m, k, n, per_tile_adc=per_tile, keep=True)
    worst, worst_ulps, masks_ok = 0.0, 0.0, True
    for bits in (4, 6, 8):
        key = prng.fold_in(prng.PRNGKey(m * 7919 + k), bits)
        keep = prng.bernoulli(key.to(DEV), 0.5, (m, t, n))
        masks_ok &= torch.equal(keep.cpu(), prng.bernoulli(key, 0.5, (m, t, n)))
        step = (1.5 + 1e-9) / (2 ** (bits - 1) - 1) * 0.97
        y_k = kernel.analog_mvm(x, w, r_adc=r_adc, out_scale=out_scale, b_adc=bits,
                                per_tile_adc=per_tile, keep=keep)
        y_p = analog_mvm_ref(x, w, None, r_adc, out_scale, b_dac=bits + 1, b_adc=bits,
                             per_tile_adc=per_tile, apply_dac=False, keep=keep)
        check(y_k.dtype == x.dtype and y_k.shape == (m, n),
              f"{name}: kernel output {y_k.dtype} {tuple(y_k.shape)}")
        r = compare(y_k, y_p, step, t, bf16)
        scale = float(y_p.abs().max())
        unkept, unkept_ok = 0.0, True
        if t == 1 and bool((~keep).any()):
            free = ~keep[:, 0, :]
            d = (y_k.float() - y_p.float()).abs()[free]
            unkept = float(d.max()) / max(scale, 1e-30)
            if bf16:
                ulp = bf16_ulp(y_p.float()[free])
                worst_ulps = max(worst_ulps, float((d / ulp).max()))
                unkept_ok = bool((d <= ulp + 1e-6 * scale).all())
            else:
                unkept_ok = unkept <= 1e-5
        worst = max(worst, unkept)
        rec = by_design[design]
        rec["cases"] += 1
        rec["flips"] += r["flips"]
        rec["elements"] += r["elements"]
        for key_ in ("max_abs", "max_steps", "frac_half_step"):
            rec[key_] = max(rec[key_], r[key_])
        checked.add(b1_key(m, k, n, x.dtype, design) + (1024, per_tile, False, True))
        if not r["ok"] or not unkept_ok:
            failures.append((name, m, str(x.dtype), "keep", bits, per_tile, r, unkept))
    check(masks_ok, f"{name}: the card's quant-noise masks are the CPU bridge's, bitwise")
    return {"unkept_rel": worst, "unkept_ulps": worst_ulps, "masks_bitwise": masks_ok,
            "design": design}


def check_launched_b1(torch, gen, keys: list, accuracy: dict, by_design=None) -> dict:
    """Phase 3's comparison, at the same tolerance, for B1 keys a serving
    phase launched that phase 3 did not check (the fleet's migrated
    continuations re-prefill at prompt + prefix tokens, an M no other
    phase serves; the CNNs' fp32 shapes; a training launch with a keep
    mask through ``b1_train_cases``); the keys merged into phase 3's
    record, the worst errors into ``by_design`` (phase 3's by default)."""
    from repro_torch.kernels import analog_mvm as kernel

    by_design = accuracy["by_design"] if by_design is None else by_design
    failures = []
    checked = set(map(tuple, accuracy["checked"]))
    for key in keys:
        m, k, n, dtype, design, tile_rows, per_tile, dac, keep = key
        check(tile_rows == 1024, f"B1 launched at tile_rows {tile_rows}")
        dt = getattr(torch, dtype)
        x = torch.randn((m, k), generator=gen, device=DEV).to(dt)
        w = (torch.randn((k, n), generator=gen, device=DEV) * k**-0.5).to(dt)
        if keep:
            check(not dac and design == kernel.select_design(dt, m, k, n, per_tile_adc=per_tile,
                                                             keep=True),
                  f"B1 training launch at {key}")
            b1_train_cases(torch, f"{k}x{n}", x, w, per_tile, by_design, checked, failures)
        else:
            b1_cases(torch, f"{k}x{n}", x, w, design, per_tile, dac, by_design, checked,
                     failures)
    torch.cuda.synchronize()
    accuracy["checked"] = sorted(checked)
    accuracy["cases"] += 3 * len(keys)
    log(f"kernel vs plain, the keys the serving phases launched that phase 3 had not "
        f"checked ({len(keys)}): {sorted(keys)}; worst per design used "
        f"{ {d: v for d, v in by_design.items() if v['cases']} }; out of tolerance: "
        f"{failures or 'none'}")
    check(not failures, f"{len(failures)} launched B1 cases out of tolerance")
    return {"keys": sorted(keys), "failures": len(failures)}


def row_stability(torch, gen, kernel) -> dict:
    """The tensor-core designs' rows against M and padding, bitwise, at
    every projection shape: the first rows of a 256-row call (prefill
    design; itself held against the plain version) against the same rows
    alone (the decode design up to 16 rows, else the prefill design) and
    right-padded with junk rows to 300 (prefill design)."""
    from repro_torch.kernels.ref import analog_mvm_ref

    dev = "cuda"
    kw = dict(r_adc=torch.tensor(1.5, device=dev), out_scale=torch.tensor(0.97, device=dev),
              b_adc=8)
    step = (1.5 + 1e-9) / 127 * 0.97
    pairs, unequal, full_worst = 0, [], 0.0
    for name, k, n, _ in SHAPES:
        x = torch.randn((256, k), generator=gen, device=dev).bfloat16()
        w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).bfloat16()
        full = kernel.analog_mvm(x, w, **kw)
        r = compare(full, analog_mvm_ref(x, w, None, kw["r_adc"], kw["out_scale"], b_adc=8,
                                         apply_dac=False),
                    step, math.ceil(k / 1024), True)
        check(r["ok"], f"B1 row stability: the 256-row call at {name} against the plain "
                       f"version: {r}")
        full_worst = max(full_worst, r["max_steps"])
        for rows in (1, 2, 4, 8, 16, 32, 64, 100, 128, 129):
            junk = 100 * torch.randn((300 - rows, k), generator=gen, device=dev).bfloat16()
            alone = kernel.analog_mvm(x[:rows].contiguous(), w, **kw)
            padded = kernel.analog_mvm(torch.cat([x[:rows], junk]), w, **kw)[:rows]
            for what, y in (("alone", alone), ("padded", padded)):
                pairs += 1
                if not torch.equal(y, full[:rows]):
                    unequal.append((name, rows, what))
    torch.cuda.synchronize()
    log(f"B1 row stability: {pairs - len(unequal)} of {pairs} (shape, rows, way) bitwise "
        f"equal to the rows of a 256-row prefill-design call (that call within the "
        f"tolerance of the plain version, worst {full_worst:.3f} ADC steps)"
        + (f"; unequal {unequal}" if unequal else ""))
    check(not unequal, "B1 rows bitwise independent of M, padding and design")
    return {"pairs": pairs, "unequal": unequal, "full_call_max_steps": full_worst}


def mvm_bound(m: int, k: int, n: int, esz: int = 2, peak: float = BF16_FLOPS) -> dict:
    """The least time of one (M, K) x (K, N) programmed MVM on the card: x
    and w read once and y written once over the HBM rate, or its 2 M K N
    operations over ``peak`` (the bf16 tensor-core peak; fp32, which must
    not round through TF32, takes the CUDA cores' FP32_OPS), whichever is
    larger."""
    nbytes = (k * n + m * k + m * n) * esz
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bytes": nbytes, "flops": flops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prefill_ms() -> tuple:
    """The M (rows x tokens) of every prefill B1 call that sets phase 9's
    pace: one 256-token prompt, and each (rows x bucket) of the paged
    engine's buckets up to the trace's longest prompt (256)."""
    from repro_torch.serving.paging import default_buckets, prefill_rows

    rows = prefill_rows(default_buckets(PAGED["s_max"]), PAGED["prefill_batch"])
    return tuple(sorted({256} | {pb * b for b, pb in rows.items() if b <= 256}))


def phase_timing(torch, gen, ms: tuple) -> list[dict]:
    """Per projection shape and per M of ``ms`` (8, the decode shape, then
    the prefill Ms), bf16: the kernel (the design ``analog_mvm`` picks), its
    plain version, torch.matmul and the CUDA-core design (``"gemv"``, the
    kernel every bf16 call launched before the tensor-core designs), each
    cycling through enough weight copies to keep the weights out of L2
    (every forward reads every weight once), timed by CUDA-graph replay
    (``time_ms``) in turns (kernel, plain, library, CUDA-core, kernel),
    beside the bound (``mvm_bound``)."""
    from repro_torch.core import engine
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import analog_mvm as kernel

    dev = "cuda"
    r_adc = torch.tensor(1.5, device=dev)
    out_scale = torch.tensor(0.97, device=dev)
    spec = QuantSpec(b_adc=8)
    rows = []
    for name, k, n, per_fwd in SHAPES:
        wbytes = k * n * 2
        copies = max(2, min(256, math.ceil(4 * L2_BYTES / wbytes)))
        ws = [(torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
              for _ in range(copies)]
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            n_iter = max(copies, 40 if m <= 8 else 10)
            run_k = lambda i: kernel.analog_mvm(x, ws[i % copies], r_adc=r_adc,
                                                out_scale=out_scale, b_adc=8)
            run_p = lambda i: engine.tile_matmul_quant(x, ws[i % copies], r_adc, spec,
                                                       1024, True, out_scale)
            run_l = lambda i: torch.matmul(x, ws[i % copies])
            run_c = lambda i: kernel._launch("gemv", x, ws[i % copies], r_adc=r_adc,
                                             out_scale=out_scale, b_adc=8)
            # kernel, plain, library, CUDA-core, kernel: two kernel readings
            ms_k1 = time_ms(run_k, n_iter)
            ms_p = time_ms(run_p, n_iter)
            ms_l = time_ms(run_l, n_iter)
            ms_c = time_ms(run_c, n_iter)
            ms_k2 = time_ms(run_k, n_iter)
            bound = mvm_bound(m, k, n)
            row = {"shape": name, "M": m, "K": k, "N": n, "per_forward": per_fwd,
                   "kind": "decode" if m <= 8 else "prefill",
                   "design": kernel.select_design(x.dtype, m, k, n),
                   "ms": min(ms_k1, ms_k2), "ms_readings": [ms_k1, ms_k2],
                   "plain_ms": ms_p, "library_ms": ms_l, "cuda_core_ms": ms_c,
                   "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                   "weight_copies": copies}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            log(f"time {name:8s} M={m} K={k} N={n} ({row['design']}): kernel {row['ms']:.4f} "
                f"ms ({ms_k1:.4f}/{ms_k2:.4f}), plain {ms_p:.4f} ms, torch.matmul "
                f"{ms_l:.4f} ms, CUDA-core design {ms_c:.4f} ms, bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']}, {row['bound_share']:.1%} of bound; kernel/matmul "
                f"{row['ms'] / ms_l:.2f}x)")
        del ws
    for m in ms:
        part = forward_rows(rows, m)
        tot = {key: sum(r[key] * r["per_forward"] for r in part)
               for key in ("ms", "plain_ms", "library_ms", "cuda_core_ms", "bound_ms")}
        log(f"time per forward ({sum(r['per_forward'] for r in part)} launches) at M={m}: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, torch.matmul {tot['library_ms']:.4f} ms, CUDA-core "
            f"design {tot['cuda_core_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return rows


def forward_rows(rows: list, m: int) -> list:
    """The timing rows of one forward at M = m: a decode step (M = 8) runs
    all 155 projections at M; a prefill runs the 154 layer projections at M
    and its lm_head at the rows' count (not timed here)."""
    return [r for r in rows if r["M"] == m and (m <= 8 or r["shape"] != "lm_head")]


def phase_serve(torch, seed: int) -> dict:
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_rows as dr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServingConfig, ServingEngine, poisson_trace

    cfg = get("tinyllama-1.1b")
    check(cfg.dtype == torch.bfloat16, "tinyllama-1.1b serves in bf16")
    reset_counts()
    t0 = time.perf_counter()
    params = lm_init(prng.PRNGKey(seed), cfg, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = engine.compile_program(
        params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(seed + 1), device="cuda",
    )
    torch.cuda.synchronize()
    t_program = time.perf_counter() - t0
    prng_launches = prng.launches
    n_weights = sum(int(st["g_pos"].numel()) for st in program.state.values())
    log(f"program: {program.n_layers} layer stacks, {n_weights} weights, "
        f"t={program.t_seconds:.0f} s, init {t_init:.2f} s, program {t_program:.2f} s "
        f"through the RNG bridge ({prng_launches} normal-draw kernel launches, init and "
        f"program; the parent's torch.Generator draws took {PARENT_PROGRAM_S} s), "
        f"memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    check(prng_launches > 0, "the program phase drew through the bridge's kernel")
    check(program.n_layers == 8, "7 stacked projections + lm_head")
    check(n_weights == 1_034_420_224, f"projection weights {n_weights}")

    served = ServingEngine.for_program(
        program, cfg, ServingConfig(n_slots=8, s_max=512), ref_params=params,
        src_params=params, device="cuda",
    )
    trace = poisson_trace(prng.PRNGKey(seed + 7), 16, vocab=cfg.vocab, rate=50.0,
                          prompt_lens=PROMPT_LENS, new_tokens=(16, 64))
    # warm-up (CUDA context, cuBLAS handles, first launches): not measured
    served.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=4)])
    torch.cuda.synchronize()

    events0 = engine.program_event_count()
    reset_counts()
    rep = served.run(trace)
    torch.cuda.synchronize()
    launches = kernel.analog_mvm.launches
    designs = dict(kernel.analog_mvm.design_launches)
    fa_launches = fa.flash_attention.launches
    row_launches = dict(dr.launches)
    n_plain = plain_calls()
    events = engine.program_event_count() - events0
    # every decode forward (the chip's and the digital lockstep's) runs the
    # row kernels: 2 norms a layer and the final one, and per layer RoPE,
    # attention and the gate
    rows_expected = {k: v * 2 * rep.n_steps for k, v in rows_per_forward(cfg).items()}

    forwards = rep.n_requests + rep.n_steps  # one prefill per admission
    # every prefill, the chip's and the digital lockstep's, runs B3 per layer
    fa_expected = FA_LAUNCHES_PER_PREFILL * 2 * rep.n_requests
    res = {
        "requests": rep.n_requests, "generated": rep.n_generated,
        "prefills": rep.n_requests,
        "launches": launches, "launches_expected": LAUNCHES_PER_FORWARD * forwards,
        "design_launches": designs,
        "design_launches_expected": b1_designs([(1, q.prompt.size) for q in trace], rep.n_steps),
        "flash_attention_launches": fa_launches,
        "flash_attention_expected": fa_expected,
        "plain_calls": n_plain, "program_events_while_serving": events,
        "row_launches": row_launches, "row_launches_expected": rows_expected,
        "prng_launches": prng_launches, "parent_program_s": PARENT_PROGRAM_S,
        **serve_metrics(rep), "init_s": t_init, "program_s": t_program,
        "kv_bytes": rep.peak_kv_bytes, "n_prefill_traces": rep.n_prefill_traces,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(rep.summary())
    log(f"serve: {rep.n_requests} requests, {rep.n_generated} tokens, {rep.n_steps} "
        f"decode steps, {res['tokens_per_s']:.1f} tokens/s, "
        f"{res['ms_per_decode_step']:.2f} ms/decode step, p50 {res['latency_p50_s']:.3f} s, "
        f"p95 {res['latency_p95_s']:.3f} s, ttft p50 {res['ttft_p50_s']:.3f} s, "
        f"p95 {res['ttft_p95_s']:.3f} s, top1_agreement {res['top1_agreement']:.4f}")
    log(f"counters: analog_mvm launches {launches} (expected "
        f"{res['launches_expected']} = {LAUNCHES_PER_FORWARD} x {forwards} forwards), "
        f"flash_attention launches {fa_launches} (expected {fa_expected} = "
        f"{FA_LAUNCHES_PER_PREFILL} x {2 * rep.n_requests} prefills, chip and digital), "
        f"plain calls {n_plain}, program events {events}")
    log(f"B1 launches by design: {designs} (expected {res['design_launches_expected']}: "
        f"decode steps and prompts of <= {kernel.DECODE_MAX_M} tokens through the decode "
        f"design, longer prefills through the prefill design)")
    check(rep.n_requests == len(trace), "every request retires")
    check(all(r.n_new == q.max_new_tokens for r, q in
              zip(sorted(rep.records, key=lambda r: r.rid), trace)),
          "every request got its budget")
    check(events == 0, "no programming events while serving")
    check(launches == res["launches_expected"], "155 kernel launches per forward")
    check(designs == res["design_launches_expected"],
          "B1: prefill through the prefill design, decode through the decode design")
    check(fa_launches == fa_expected, "22 flash_attention launches per prefill")
    log(f"row kernels (decode_rows): {row_launches} (expected {rows_expected}: per decode "
        f"forward, chip and digital)")
    check(row_launches == rows_expected, "the per-layer decode ran the row kernels")
    check(n_plain == 0, "the main path never ran the plain version")
    res.update(phase_decode_check(torch, served, trace))
    ctx = {"served": served, "trace": trace, "program": program, "params": params,
           "cfg": cfg, "seed": seed, "tokens": {r.rid: r.tokens.tolist() for r in rep.records}}
    return res, ctx


def phase_decode_check(torch, served, trace) -> dict:
    """One decode step from one cache state, through the kernel and through
    the plain version; every MVM of the plain step is also run on the kernel
    with the same inputs to count ADC code flips."""
    from repro_torch.core import engine
    from repro_torch.models.lm import lm_forward, write_cache_slot

    cache = served.new_cache(served.n_slots, per_slot=True)
    cur = torch.zeros((served.n_slots, 1), dtype=torch.int32, device="cuda")
    for slot, req in enumerate(trace[: served.n_slots]):
        tok, _, pcache = served.prefill(served.params, served.acfg, req)
        cache = write_cache_slot(cache, pcache, slot)
        cur[slot, 0] = tok[0]
    clone = lambda c: ([tuple(type(kv)(*(t.clone() for t in kv)) for kv in g)
                        for g in c[0]], c[1])
    cache_p = clone(cache)
    # the digital reference from its own prefills, teacher-forced on the
    # served tokens as the engine's counters are
    cache_d = served.new_cache(served.n_slots, per_slot=True)
    for slot, req in enumerate(trace[: served.n_slots]):
        cache_d = write_cache_slot(
            cache_d, served.prefill(served.ref_params, served._digital, req)[2], slot)

    flips = {"flips": 0, "elements": 0, "calls": 0}

    def plain_and_count(x_q, w, r_adc, plan, *, out_scale=1.0):
        y_p = engine.execute_mvm_plain(x_q, w, r_adc, plan, out_scale=out_scale)
        y_k = engine.execute_mvm(x_q, w, r_adc, plan, out_scale=out_scale)
        flips["flips"] += int((y_k != y_p).sum().item())
        flips["elements"] += y_p.numel()
        flips["calls"] += 1
        return y_p

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits_k, _ = lm_forward(served.params, {"tokens": cur.long()}, served.acfg,
                                 served.cfg, cache=cache)
        torch.cuda.synchronize()
    logits_p, _ = lm_forward(served.params, {"tokens": cur.long()}, served.acfg,
                             served.cfg, cache=cache_p, mvm=plain_and_count)
    logits_d, _ = lm_forward(served.ref_params, {"tokens": cur.long()}, served._digital,
                             served.cfg, cache=cache_d)
    torch.cuda.synchronize()
    lk, lp, ld = (t[:, -1].float() for t in (logits_k, logits_p, logits_d))
    rel = ((lk - lp).norm() / lp.norm().clamp(min=1e-30)).item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum().item())
    # logits saturated at the ADC range tie; argmax takes the first of them
    ties = (lk == lk.amax(-1, keepdim=True)).sum(-1).tolist()
    # what the served top1_agreement reads: the analog step against the
    # digital one -- per-slot logit correlation and the digital rank of the
    # analog pick (0 = the digital argmax)
    zk = (lk - lk.mean(-1, keepdim=True)) / lk.std(-1, keepdim=True).clamp(min=1e-30)
    zd = (ld - ld.mean(-1, keepdim=True)) / ld.std(-1, keepdim=True).clamp(min=1e-30)
    corr = (zk * zd).mean(-1).tolist()
    pick = ld.gather(1, lk.argmax(-1, keepdim=True))
    rank = (ld > pick).sum(-1).tolist()
    res = {"decode_check_rel_l2": rel, "decode_check_greedy_agree": agree,
           "decode_check_max_ties_per_slot": ties,
           "adc_flips": flips["flips"], "adc_outputs_compared": flips["elements"],
           "mvms_compared": flips["calls"],
           "digital_logit_corr_per_slot": corr, "digital_rank_of_analog_pick": rank,
           "digital_greedy_agree": int((lk.argmax(-1) == ld.argmax(-1)).sum().item())}
    res.update(profile_summary(prof))
    log(f"decode check: kernel vs plain logits rel L2 {rel:.3e}, greedy agree "
        f"{agree}/{served.n_slots} (logits tied at the max per slot: {ties}), "
        f"ADC flips {flips['flips']} of {flips['elements']} outputs over "
        f"{flips['calls']} MVMs")
    log(f"analog vs digital, same step: greedy agree {res['digital_greedy_agree']}/"
        f"{served.n_slots}, logit correlation per slot "
        f"{[round(c, 4) for c in corr]}, digital rank of the analog pick {rank}")
    log(f"profile (one decode step): device busy {res['profile_device_ms']} ms, "
        f"analog_mvm kernels {res['profile_kernel_ms']} ms, host wall "
        f"{res['profile_wall_ms']} ms, device kernels launched {res['profile_launches']}, "
        f"device idle share {res['profile_idle_share']}")
    check(flips["calls"] == LAUNCHES_PER_FORWARD, "every MVM of the step compared")
    check(agree >= served.n_slots - 1, "greedy tokens agree on >= 7 of 8 slots")
    check(rel < 0.05, "decode logits close (relative L2 < 5%)")
    return res


# --------------------------------------------------------------- fused decode


def b1_designs(prefills: list, decode_steps: int) -> dict:
    """B1 launches per design expected from prefill forwards of these
    (rows, tokens) and decode steps at 8 slots, each launch through the
    design ``select_design`` picks for its M: a prefill runs its 154 layer
    projections at M = rows x tokens and the lm_head at M = rows (the last
    token's logits only); a decode step runs all 155 at M = 8."""
    from repro_torch.kernels import analog_mvm as kernel

    out = dict.fromkeys(kernel.DESIGNS, 0)
    design = lambda m: "decode" if m <= kernel.DECODE_MAX_M else "prefill"
    for rows, tokens in prefills:
        out[design(rows * tokens)] += LAUNCHES_PER_FORWARD - 1
        out[design(rows)] += 1
    out[design(8)] += LAUNCHES_PER_FORWARD * decode_steps
    return out


def b1_only(design: str, n: int) -> dict:
    """B1 launches by design: ``n`` through ``design``, none through the
    others."""
    from repro_torch.kernels import analog_mvm as kernel

    return {d: n if d == design else 0 for d in kernel.DESIGNS}


def train_design(dtype, m: int) -> str:
    """The design B1's training form (a keep mask, no DAC) runs at M rows
    of the shapes the tensor cores take (tinyllama-1.1b's, the two-tile
    case): ``tiled`` in fp32; in bf16 ``prefill`` above 16 rows, ``gemv``
    up to."""
    from repro_torch.kernels import analog_mvm as kernel

    return kernel.select_design(dtype, m, 2048, 2048, keep=True)


def plain_calls() -> int:
    """Calls of every kernel's plain version since the last reset_counts."""
    from repro_torch.core import engine
    from repro_torch.kernels import decode_rows as dr
    from repro_torch.kernels import ref

    return (ref.analog_mvm_ref.calls + engine.tile_matmul_quant.calls
            + ref.analog_mvm_bank_ref.calls + ref.decode_fused_ref.calls
            + ref.flash_attention_ref.calls + sum(f.calls for f in ROW_PLAINS(dr)))


def reset_counts() -> None:
    """Every kernel's launch count (B1's per design too) and every plain
    version's call count to 0."""
    from repro_torch import prng
    from repro_torch.core import engine
    from repro_torch.kernels import analog_mvm, decode_fused, flash_attention, ops, ref
    from repro_torch.kernels import decode_rows as dr

    analog_mvm.analog_mvm.launches = 0
    analog_mvm.analog_mvm.design_launches = dict.fromkeys(analog_mvm.DESIGNS, 0)
    analog_mvm.analog_mvm_bank.launches = 0
    analog_mvm.analog_mvm_bank.design_launches = dict.fromkeys(analog_mvm.BANK_DESIGNS, 0)
    decode_fused.launches = 0
    flash_attention.flash_attention.launches = 0
    dr.launches.update(dict.fromkeys(dr.launches, 0))
    prng.launches = 0
    ops.backward_calls = 0
    ops.attention_backward_calls = 0
    for fn in (ref.analog_mvm_ref, engine.tile_matmul_quant, ref.analog_mvm_bank_ref,
               ref.decode_fused_ref, ref.flash_attention_ref, *ROW_PLAINS(dr)):
        fn.calls = 0


def fused_cache_from_trace(torch, served, plan, trace):
    """The fused slot cache after prefilling the first n_slots requests,
    and the decode step's input tokens (each prefill's greedy token)."""
    from repro_torch.kernels import decode_fused as df

    cache = df.init_fused_cache(served.cfg, plan.n_groups, served.n_slots,
                                served.s_max, served.cfg.dtype, device=DEV)
    cur = torch.zeros((served.n_slots, 1), dtype=torch.long, device=DEV)
    for slot, req in enumerate(trace[: served.n_slots]):
        tok, _, pcache = served.prefill(served.params, served.acfg, req)
        df.write_fused_slot(cache, pcache, slot)
        cur[slot, 0] = tok[0]
    return cache, cur


def adc_step(dec, row: int, p: int) -> tuple:
    """(ADC step x |out_scale|, crossbar tiles) of projection p (7 = lm_head)."""
    plan = dec.plan.head_plan if p == 7 else dec.plan.proj_plans[p]
    r_adc, _, os_ = dec.tab[row, 0 if p == 7 else p].tolist()
    step = (abs(r_adc) + 1e-9) / (2 ** (plan.spec.b_adc - 1) - 1) * abs(os_)
    span = plan.tile_rows if plan.per_tile_adc and plan.k > plan.tile_rows else plan.k
    return step, math.ceil(plan.k / span)


def first(tree, depth: int):
    """The first ``depth`` members of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: first(v, depth) for k, v in tree.items()}
    return tree[:depth]


def shallow_chip(torch, ctx) -> tuple:
    """(params, cfg, program): phase 4's weights cut to their first
    SHALLOW_DEPTH layers and programmed as phase 4's chip was (b_adc = 8,
    t = 1 d, its key), made once and kept in ``ctx["shallow"]``."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core import engine

    if "shallow" not in ctx:
        params = ctx["params"]._replace(blocks=(first(ctx["params"].blocks[0], SHALLOW_DEPTH),))
        cfg = dataclasses.replace(ctx["cfg"], n_layers=SHALLOW_DEPTH)
        program = engine.compile_program(params, ctx["program"].cfg,
                                         prng.PRNGKey(ctx["seed"] + 1), device=DEV)
        torch.cuda.synchronize()
        ctx["shallow"] = (params, cfg, program)
    return ctx["shallow"]


def phase_fused_check(torch, ctx) -> dict:
    """B2 against decode_fused_ref from one cache state of the served trace,
    at depths 1, 2 and 22 (stacks sliced from the same chip).

    Tolerance, at every depth, in two parts:
    - phase by phase at every layer (kernels/decode_fused_check.py): the
      kernel ends after each MVM phase and every phase is recomputed from
      its own inputs with the per-layer decode's ops on the card (the row
      kernels, the DAC, B1's decode design) -- residual adds, K and V rows
      and every DAC code bitwise, every tensor-core MVM bitwise B1's;
    - end to end against decode_fused_ref, phase 4's whole-step bound:
      logits relative L2 < 5%, greedy tokens equal on >= 7 of 8 slots.
      Past the first MVMs the two sum norms, softmax and attention in
      different orders; a bf16 neighbour is often the neighbouring DAC
      code, and each DAC flip moves about 1% of the next MVM's ADC codes,
      so logit differences cascade with depth."""
    import dataclasses

    from repro_torch.core import engine
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels.decode_fused_check import NAMES, check_phases
    from repro_torch.kernels.ref import decode_fused_ref
    from repro_torch.models.attention import KVCache
    from repro_torch.models.common import embedding_apply

    served, cfg = ctx["served"], ctx["cfg"]
    plan = engine.build_fused_plan(served.program)
    cache, cur = fused_cache_from_trace(torch, served, plan, ctx["trace"])
    lens = cache.length.clone()
    b, d = served.n_slots, cfg.d_model
    idx = lens.clamp(max=served.s_max - 1).long()
    rows = torch.arange(b, device=DEV)
    ulp = lambda v: bf16_ulp(v) if cfg.dtype == torch.bfloat16 else 0.0
    out = {"lengths": lens.tolist()}
    failures = []
    for depth in (1, 2, plan.n_groups):
        params = served.params._replace(blocks=(first(served.params.blocks[0], depth),))
        plan_d = dataclasses.replace(plan, n_groups=depth)
        cfg_d = dataclasses.replace(cfg, n_layers=depth)
        dec = df.FusedDecoder(params, plan_d, cfg_d, served.acfg, b, served.s_max)
        check(dec.items == ("tensor_core",) * 8,
              f"every bf16 tinyllama-1.1b projection runs B2's tensor-core item: {dec.items}")
        t0 = time.perf_counter()
        phases = check_phases(dec, cur, KVCache(cache.k[:depth], cache.v[:depth], lens))
        phases_s = time.perf_counter() - t0
        ck = KVCache(cache.k[:depth].clone(), cache.v[:depth].clone(), lens.clone())
        cp = KVCache(cache.k[:depth].clone(), cache.v[:depth].clone(), lens.clone())
        logits_k, out_k = dec.step(cur, ck)
        head_x_k = dec.xq[0, : b * d].view(b, d).clone()
        taps = {}
        h0 = embedding_apply(params.embed, cur, cfg.dtype)
        logits_p = decode_fused_ref(dec.tab, h0, lens, dec.n1, dec.n2, dec.stacks,
                                    dec.w_head, dec.fin, cp.k, cp.v, plan=plan_d,
                                    cfg=cfg_d, taps=taps)
        torch.cuda.synchronize()
        lk, lp = logits_k[:, -1].float(), logits_p[:, -1].float()
        dl = (lk - lp).abs()
        head_step, _ = adc_step(dec, depth, 7)
        r = {
            "logits_rel_l2": ((lk - lp).norm() / lp.norm().clamp(min=1e-30)).item(),
            "greedy_agree_per_slot": (lk.argmax(-1) == lp.argmax(-1)).tolist(),
            "logits_max_abs": dl.max().item(),
            "logits_max_head_adc_steps": (dl / head_step).max().item(),
            "logits_differing": int((dl > 0).sum().item()),
            "logits_share_over_half_step": (dl > 0.5 * head_step + ulp(lp)).float().mean().item(),
            "head_dac_codes_differing": int((head_x_k != taps["head_x_q"][:, 0]).sum().item()),
            "head_dac_inputs": b * d,
            "lengths_out_ok": bool(torch.equal(out_k.length, lens + 1)),
            "finite": bool(lk.isfinite().all().item()),
            "phases": phases["checks"], "phase_failures": phases["failures"],
            "phases_s": phases_s,
        }
        layer_rows = []
        for g in range(depth):
            for side in ("k", "v"):
                a_ = getattr(ck, side)[g][rows, idx].float()
                p_ = getattr(cp, side)[g][rows, idx].float()
                layer_rows.append(((a_ - p_).abs().max().item(),
                                   int((a_ != p_).sum().item())))
        r["dac_codes_differing_per_layer_path"] = phases["checks"]["dac"]["differing"]
        r["k_row_values_differing_per_layer_path"] = phases["checks"]["k_row"]["differing"]
        # the same readings against the plain torch ops (independent of the
        # device code B2 and the row kernels share): DAC codes under the ADC
        # model, K rows within 2 ulps
        r["dac_codes_differing_plain_ops"] = phases["checks"]["dac_plain"]["differing"]
        r["dac_plain_max_steps"] = phases["checks"]["dac_plain"]["max_steps"]
        r["k_row_values_differing_plain_ops"] = phases["checks"]["k_row_plain"]["differing"]
        r["cache_rows_max_abs"] = max(m for m, _ in layer_rows)
        r["cache_row_values_differing"] = sum(n for _, n in layer_rows)
        r["cache_row_values"] = 2 * depth * b * cfg.n_kv_heads * cfg.hd
        ok = (r["finite"] and r["lengths_out_ok"] and phases["ok"]
              and r["logits_rel_l2"] < 0.05 and sum(r["greedy_agree_per_slot"]) >= b - 1)
        r["pass"] = ok
        out[f"depth_{depth}"] = r
        log(f"fused vs plain, depth {depth}: logits rel L2 {r['logits_rel_l2']:.3e}, "
            f"max |d| {r['logits_max_abs']:.4e} ({r['logits_max_head_adc_steps']:.2f} "
            f"lm_head ADC steps), greedy agree {sum(r['greedy_agree_per_slot'])}/{b} "
            f"{r['greedy_agree_per_slot']}, logits differing {r['logits_differing']} "
            f"of {b * cfg.vocab} (share > half a step {r['logits_share_over_half_step']:.2e}), "
            f"lm_head DAC codes differing {r['head_dac_codes_differing']} of {b * d}, "
            f"cache rows max |d| {r['cache_rows_max_abs']:.4e} "
            f"({r['cache_row_values_differing']} of {r['cache_row_values']} values differ)"
            + ("" if ok else "  FAIL"))
        log(f"  per phase, {depth} layers on the kernel's own inputs ({phases_s:.1f} s): "
            + "; ".join(
                f"{name} {c['differing']}/{c['values']} differ"
                + (f", max {c['max_steps']:.3f} steps (layer {c['layer']}), share > half "
                   f"{c['share_over_half_step']:.2e}" if "max_steps" in c else "")
                + ("" if c["ok"] else " FAIL")
                for name, c in phases["checks"].items()))
        if not ok:
            failures.append(depth)
        out["grid_blocks"] = dec.grid
        out["items"] = dict(zip(NAMES, dec.items))
        out["items_per_phase"] = df.phase_items(
            dec.items, list(plan_d.proj_plans) + [plan_d.head_plan], b, dec.span)
        out["layout"] = dataclasses.asdict(dec.layout)
        out["attn_heads"], out["row_slices"] = dec.attn_heads, dec.row_slices
        del dec, ck, cp
    log(f"fused kernel grid: {out['grid_blocks']} co-resident blocks, MVM items "
        f"{out['items']}, items per phase {out['items_per_phase']}, layout {out['layout']}, "
        f"query heads per attention item {out['attn_heads']}, blocks per slot in a row phase "
        f"{out['row_slices']}; B1 at full depth (measured on one H100): rel L2 2.617e-2, 7 of 8")
    check(not failures, f"fused kernel vs plain out of tolerance at depths {failures}")
    return out


def phase_fused_serve(torch, ctx, per_layer: dict) -> tuple:
    """The trace again, through ServingConfig(fused_decode=True)."""
    from repro_torch.core import engine
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import Request, ServingConfig, ServingEngine

    cfg, trace = ctx["cfg"], ctx["trace"]
    fused = ServingEngine.for_program(
        ctx["program"], cfg, ServingConfig(n_slots=8, s_max=512, fused_decode=True),
        ref_params=ctx["params"], device=DEV,
    )
    fused.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=4)])
    torch.cuda.synchronize()
    events0 = engine.program_event_count()
    reset_counts()
    rep = fused.run(trace)
    torch.cuda.synchronize()
    res = {
        "requests": rep.n_requests, "generated": rep.n_generated,
        "prefills": rep.n_requests,
        "decode_fused_launches": df.launches,
        "analog_mvm_launches": kernel.analog_mvm.launches,
        "analog_mvm_expected": LAUNCHES_PER_FORWARD * rep.n_requests,
        "analog_mvm_design_launches": dict(kernel.analog_mvm.design_launches),
        "analog_mvm_design_expected": b1_designs([(1, q.prompt.size) for q in trace], 0),
        "flash_attention_launches": fa.flash_attention.launches,
        "flash_attention_expected": FA_LAUNCHES_PER_PREFILL * 2 * rep.n_requests,
        "plain_calls": plain_calls(),
        "program_events_while_serving": engine.program_event_count() - events0,
        **serve_metrics(rep),
        "requests_with_per_layer_tokens": sum(
            r.tokens.tolist() == ctx["tokens"][r.rid] for r in rep.records),
    }
    log(rep.summary())
    for name, m in (("per-layer", per_layer), ("fused", res)):
        log(f"serve {name:9s}: {m['tokens_per_s']:.1f} tokens/s, "
            f"{m['ms_per_decode_step']:.2f} ms/decode step, p50 {m['latency_p50_s']:.3f} s, "
            f"p95 {m['latency_p95_s']:.3f} s, ttft p50 {m['ttft_p50_s']:.3f} s, "
            f"p95 {m['ttft_p95_s']:.3f} s, top1_agreement {m['top1_agreement']:.4f}, "
            f"{m['decode_steps']} decode steps")
    log(f"fused counters: decode_fused launches {res['decode_fused_launches']} "
        f"(decode steps {rep.n_steps}), analog_mvm launches {res['analog_mvm_launches']} "
        f"(expected {res['analog_mvm_expected']} = {LAUNCHES_PER_FORWARD} x "
        f"{rep.n_requests} prefills), flash_attention launches "
        f"{res['flash_attention_launches']} (expected {res['flash_attention_expected']}), "
        f"plain calls {res['plain_calls']}, program events "
        f"{res['program_events_while_serving']}; requests with the per-layer run's tokens "
        f"{res['requests_with_per_layer_tokens']}/{rep.n_requests}")
    check(rep.n_requests == len(trace), "every request retires (fused)")
    check(all(r.n_new == q.max_new_tokens for r, q in
              zip(sorted(rep.records, key=lambda r: r.rid), trace)),
          "every request got its budget (fused)")
    check(res["decode_fused_launches"] == rep.n_steps, "one fused launch per decode step")
    check(res["analog_mvm_launches"] == res["analog_mvm_expected"],
          "155 analog_mvm launches per prefill, none in decode")
    check(res["analog_mvm_design_launches"] == res["analog_mvm_design_expected"],
          "B1 designs by prefill length (fused)")
    check(res["flash_attention_launches"] == res["flash_attention_expected"],
          "22 flash_attention launches per prefill (fused)")
    check(res["plain_calls"] == 0, "the fused path never ran a plain version")
    check(res["program_events_while_serving"] == 0, "no programming events (fused)")
    check(res["requests_with_per_layer_tokens"] == rep.n_requests,
          "fused serving keeps every request's per-layer tokens")
    return res, fused


def wall_ms(torch, fn, n: int) -> float:
    """Host ms per call of ``fn`` over n calls, ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


SERVE_METRICS = ("tokens_per_s", "ms_per_decode_step", "prefill_s", "wall_s",
                 "latency_p50_s", "latency_p95_s", "ttft_p50_s", "ttft_p95_s",
                 "top1_agreement", "logit_mse", "occupancy", "decode_steps")


def serve_metrics(rep) -> dict:
    """The end-to-end serving metrics of one ServeReport (SERVE_METRICS)."""
    return {"tokens_per_s": rep.tokens_per_s,
            "ms_per_decode_step": rep.t_decode / max(rep.n_steps, 1) * 1e3,
            "prefill_s": rep.t_prefill, "wall_s": rep.wall,
            "latency_p50_s": rep.latency_s(50), "latency_p95_s": rep.latency_s(95),
            "ttft_p50_s": rep.ttft_s(50), "ttft_p95_s": rep.ttft_s(95),
            # no digital lockstep (phase 17), no agreement counters
            "top1_agreement": (rep.counters or {}).get("top1"),
            "logit_mse": (rep.counters or {}).get("logit_mse"),
            "occupancy": rep.occupancy, "decode_steps": rep.n_steps}


def profiled(torch, fn, kernel: str = "analog_mvm", top: int = 0,
             host_events: bool = True) -> dict:
    """``profile_summary`` of one call of ``fn``; with ``top``, also the
    ``top`` device kernels by summed time (name, ms, launches). Without
    ``host_events`` only the card is traced and the step's wall is the host
    clock's (to the synchronize), and the card's events are read from the
    profiler's raw results (``device_events``): a step of 200 k kernels
    traced with every host op takes minutes to read back, and its
    ``events()`` alone most of a minute."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_events else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = None if host_events else device_events(prof)
    out = profile_summary(prof, kernel, None if host_events else wall_us, dev)
    if top:
        by_name: dict = {}
        for name, start, end in dev or ((e.name, e.time_range.start, e.time_range.end)
                                        for e in prof.events()
                                        if str(e.device_type).endswith("CUDA")):
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (end - start) / 1e3, n + 1)
        out["top_kernels"] = [(name.replace("void at::native::", "")[:100], round(ms, 4), n)
                              for name, (ms, n) in
                              sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


def fused_bound(dec, lens) -> tuple:
    """(bound ms, bound_by) of one fused step: every weight, norm scale and
    table entry read once, the K/V rows this step's lengths attend to read
    once (the new row is not re-read), the new rows, the embedded tokens
    and the logits written or read once, over the HBM rate; the MVM and
    attention operations over the bf16 peak."""
    cfg, b, s = dec.cfg, dec.n_slots, dec.s_max
    esz = dec.w_head.element_size()
    weights = sum(t.numel() for t in dec.stacks) + dec.w_head.numel()
    nv = [min(int(n) + 1, s) for n in lens.tolist()]
    row = cfg.n_kv_heads * cfg.hd
    kv_read = dec.plan.n_groups * sum(n - 1 for n in nv) * row * 2
    kv_write = dec.plan.n_groups * b * row * 2
    small = (dec.tab.numel() + dec.n1.numel() + dec.n2.numel() + dec.fin.numel()) * 4
    nbytes = ((weights + kv_read + kv_write + b * cfg.d_model + b * cfg.vocab) * esz
              + small + 2 * b * 4)
    ops = 2 * b * weights + dec.plan.n_groups * sum(nv) * cfg.n_heads * cfg.hd * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_step_timing(torch, ctx, fused_engine, parent=None) -> dict:
    """One decode step at 8 slots, ref_check off, three ways: the per-layer
    B1 path launched eagerly, the same path replayed from a CUDA graph, and
    the fused kernel. Then the fused kernel alone (in turns with the
    parent's B2 when ``parent`` holds its library), its plain version, its
    bound and the per-phase breakdown (``b2_phase_ms``) of each, for the
    kernels line."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels.ref import decode_fused_ref
    from repro_torch.models.attention import KVCache
    from repro_torch.models.common import embedding_apply
    from repro_torch.models.lm import write_cache_slot

    served, trace = ctx["served"], ctx["trace"]
    dec = fused_engine.decoder
    cache_f, cur = fused_cache_from_trace(torch, fused_engine, dec.plan, trace)
    cache_l = served.new_cache(served.n_slots, per_slot=True)
    for slot, req in enumerate(trace[: served.n_slots]):
        cache_l = write_cache_slot(cache_l, served.prefill(served.params, served.acfg, req)[2], slot)
    lens = cache_f.length.clone()
    # every timed call restarts from the same lengths (rows are rewritten)
    eager = lambda: served.decode(served.params, served.acfg, cur, cache_l)
    fused = lambda: dec.step(cur, KVCache(cache_f.k, cache_f.v, lens))
    res = {"lengths": lens.tolist()}
    graph = None
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            eager()
        replay = graph.replay
        res["graph_captured"] = True
    except Exception as e:  # recorded: the baseline is then not measured
        graph = None
        res["graph_captured"] = False
        res["graph_error"] = f"{type(e).__name__}: {e}"
        log(f"per-layer step did not capture in a CUDA graph: {res['graph_error']}")
        torch.cuda.synchronize()
    ways = [("per_layer_eager", eager), ("per_layer_graph", replay if graph else None),
            ("fused", fused)]
    n = 10
    readings = {name: [] for name, _ in ways}
    for name, fn in ways + ways[::-1]:  # a, b, c, c, b, a
        if fn is not None:
            readings[name].append(wall_ms(torch, fn, n))
    for name, fn in ways:
        if fn is None:
            res[name] = "not measured (no CUDA graph)"
            continue
        prof = profiled(torch, fn)
        res[name] = {"ms_per_step": min(readings[name]), "ms_readings": readings[name],
                     "device_kernels": prof["profile_launches"],
                     "device_busy_ms": prof["profile_device_ms"],
                     "device_idle_share": prof["profile_idle_share"],
                     "host_wall_ms_profiled": prof["profile_wall_ms"]}
        # the profiler slows the host side; against the unprofiled step
        res[name]["device_idle_share_unprofiled"] = (
            1 - prof["profile_device_ms"] / res[name]["ms_per_step"]
            if isinstance(prof["profile_device_ms"], float) else "not measured")
        r = res[name]
        log(f"step {name:16s}: {r['ms_per_step']:.4f} ms/step "
            f"({'/'.join(f'{x:.4f}' for x in r['ms_readings'])}), device kernels "
            f"{r['device_kernels']}, device busy {r['device_busy_ms']} ms, idle share "
            f"{r['device_idle_share']} profiled, {r['device_idle_share_unprofiled']} "
            f"against the unprofiled step")
    del graph
    # the kernel alone: CUDA events around n launches on prepared inputs
    h0 = embedding_apply(dec.params.embed, cur, dec.cfg.dtype).reshape(dec.n_slots, -1).contiguous()
    kv = KVCache(cache_f.k, cache_f.v, lens)
    before = df.launches

    # in turns with the parent's kernel where one was built: parent, change,
    # change, parent (the change alone: two readings)
    ways = [("change", None, dec.grid)]
    if parent is not None:
        ways.insert(0, ("parent", parent, parent_grid(parent, dec)))
    readings = {name: [] for name, *_ in ways}
    for name, lib, grid in ways + ways[::-1]:
        with b2_library(lib):
            readings[name].append(events_ms(torch, lambda: dec._launch(h0, kv, grid), 20))
    kernel_ms = readings["change"]
    h0p = embedding_apply(dec.params.embed, cur, dec.cfg.dtype)
    kc, vc = cache_f.k.clone(), cache_f.v.clone()
    plain_ms = events_ms(torch, lambda: decode_fused_ref(
        dec.tab, h0p, lens, dec.n1, dec.n2, dec.stacks, dec.w_head, dec.fin, kc, vc,
        plan=dec.plan, cfg=dec.cfg), 3)
    breakdown = {name: b2_phase_ms(torch, dec, h0, kv, lib, grid) for name, lib, grid in ways}
    df.launches = before  # timing launches are not main-path launches
    bound, bound_by, nbytes = fused_bound(dec, lens)
    res["kernel"] = {"ms": min(kernel_ms), "ms_readings": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                     "grid_blocks": dec.grid, "phase_ms": breakdown["change"]}
    log(f"fused kernel alone: {min(kernel_ms):.4f} ms/step ({kernel_ms[0]:.4f}/"
        f"{kernel_ms[1]:.4f}), plain version {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by}, {nbytes} bytes), {bound / min(kernel_ms):.1%} of bound, "
        f"grid {dec.grid} blocks")
    if parent is not None:
        p_ms = readings["parent"]
        res["parent_kernel"] = {"ms": min(p_ms), "ms_readings": p_ms,
                                "grid_blocks": ways[0][2], "phase_ms": breakdown["parent"]}
        log(f"fused kernel in turns (parent, change, change, parent): "
            f"{p_ms[0]:.4f} / {kernel_ms[0]:.4f} / {kernel_ms[1]:.4f} / {p_ms[1]:.4f} ms; "
            f"change / parent {min(kernel_ms) / min(p_ms):.3f}")
        res["one_slot"] = b2_one_slot_turns(torch, dec, parent)
    for name, b in breakdown.items():
        log(f"B2 per phase ({name}, layer 1, ms incl. its barrier; {b['barriers_per_step']} "
            f"barriers per step): " + ", ".join(f"{k} {v:.4f}" for k, v in b["phase_ms"].items())
            + f"; layer 0 {b['layer0_ms']:.4f}, layer 1 {b['layer1_ms']:.4f}, "
            f"mvm share of layer 1 {b['mvm_share']:.1%}, whole step {b['step_ms']:.4f}")
    return res


def b2_one_slot_turns(torch, dec, parent) -> dict:
    """One B2 step at 1 slot on ``dec``'s chip and ``s_max`` (a pass of one
    head: the AV grouping sized for full passes leaves half its threads
    idle), by CUDA events in turns with the parent's kernel (parent,
    change, change, parent), over a random cache at lengths of half to
    all of ``s_max``."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models.attention import KVCache
    from repro_torch.models.common import embedding_apply

    before, cfg = df.launches, dec.cfg
    one = df.FusedDecoder(dec.params, dec.plan, cfg, dec.analog_cfg, 1, dec.s_max)
    g = torch.Generator("cuda").manual_seed(1)
    shape = (cfg.n_layers, 1, dec.s_max, cfg.n_kv_heads, cfg.hd)
    kv = KVCache(torch.randn(shape, generator=g, device=DEV).to(cfg.dtype),
                 torch.randn(shape, generator=g, device=DEV).to(cfg.dtype),
                 torch.randint(dec.s_max // 2, dec.s_max - 1, (1,), generator=g, device=DEV,
                               dtype=torch.int32))
    tok = torch.randint(0, cfg.vocab, (1, 1), generator=g, device=DEV)
    h0 = embedding_apply(one.params.embed, tok, cfg.dtype).reshape(1, -1).contiguous()
    ways = {"parent": (parent, parent_grid(parent, one)), "change": (None, one.grid)}
    readings = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        lib, grid = ways[name]
        with b2_library(lib):
            readings[name].append(events_ms(torch, lambda: one._launch(h0, kv, grid), 20))
    df.launches = before  # timing launches are not main-path launches
    res = {"s_max": dec.s_max, "attn_heads": one.attn_heads, "readings_ms": readings,
           "parent_ms": min(readings["parent"]), "change_ms": min(readings["change"])}
    res["cost_us"] = (res["change_ms"] - res["parent_ms"]) * 1e3
    log(f"fused kernel at 1 slot, s_max {dec.s_max} ({one.attn_heads} head(s) an attention "
        f"item), in turns: " + " / ".join(f"{x:.4f}" for x in (
            readings["parent"][0], *readings["change"], readings["parent"][1]))
        + f" ms; change - parent {res['cost_us']:+.2f} us a step")
    del one, kv
    return res


def events_ms(torch, fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: B2's phases in one layer, in launch order (``csrc/decode_fused.cu``)
B2_PHASE_KINDS = ("row_qkv", "mvm_qkv", "attn", "mvm_wo", "row_w13", "mvm_w13", "gate",
                  "mvm_w2")


def b2_phase_ms(torch, dec, h0, kv, lib, grid, reps: int = 30) -> dict:
    """Where one B2 step's time goes. The launch ends after n phases
    (``FusedDecoder._launch(..., phases=n)``) for n = 1..16 (layers 0 and
    1), 8 L, 8 L + 1, 8 L + 2 and the whole step, each timed by CUDA
    events over ``reps`` launches, three sweeps, the least kept. Layer 1's
    differences give each phase kind's ms, its closing grid barrier
    included; then the final row, the lm_head and the logits write."""
    from repro_torch.kernels import decode_fused as df

    per, n_layers = df.PHASES_PER_LAYER, dec.plan.n_groups
    ends = [*range(1, 2 * per + 1), per * n_layers, per * n_layers + 1,
            per * n_layers + 2, 0]
    t = {n: [] for n in ends}
    with b2_library(lib):
        for _ in range(3):
            for n in ends:
                t[n].append(events_ms(torch, lambda: dec._launch(h0, kv, grid, n), reps))
    res = b2_breakdown({n: min(v) for n, v in t.items()}, n_layers, per)
    res["ends_ms"] = {str(n): v for n, v in t.items()}
    return res


def b2_breakdown(best: dict, n_layers: int, per: int) -> dict:
    """``b2_phase_ms``'s table from the least ms of a launch ended after n
    phases (``best[n]``; ``best[0]`` the whole step): layer 1's phase kinds
    by difference, then the final row, the lm_head and the logits write."""
    phase_ms = {k: best[per + i + 1] - best[per + i] for i, k in enumerate(B2_PHASE_KINDS)}
    phase_ms["row_final"] = best[per * n_layers + 1] - best[per * n_layers]
    phase_ms["mvm_lm_head"] = best[per * n_layers + 2] - best[per * n_layers + 1]
    phase_ms["logits"] = best[0] - best[per * n_layers + 2]
    layer1 = best[2 * per] - best[per]
    return {"phase_ms": phase_ms, "barriers_per_step": per * n_layers + 2,
            "layer0_ms": best[per], "layer1_ms": layer1, "step_ms": best[0],
            "mvm_share": sum(phase_ms[k] for k in B2_PHASE_KINDS if k.startswith("mvm"))
            / layer1}


def build_parent(src_dir: Path, names=("decode_fused", "decode_rows")):
    """Start ``nvcc`` on a parent's ``names`` sources (``decode_fused.cu`` and
    ``decode_rows.cu``, or ``analog_mvm.cu``, with their headers beside them)
    into ``build/repro_torch/``, with the port's own flags; returns a
    function that waits for them and loads them as the wrappers' ``_fn`` do:
    ``{"b2": B2's function table, "rows": the attention row kernel's}``, or
    ``{"b1": the gemv design's}``."""
    import ctypes

    from repro_torch.kernels import build

    procs = {}
    for name in names:
        out = build.BUILD_DIR / f"{name}_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        libs = {}
        for name, (out, proc) in procs.items():
            log_text, _ = proc.communicate()
            check(proc.returncode == 0, f"parent {name} build failed:\n{log_text}")
            libs[name] = lib = ctypes.CDLL(str(out))
            getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
            getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if "analog_mvm" in libs:
            fn = libs["analog_mvm"].analog_mvm_launch
            fn.argtypes = [P] * 3 + [I] * 4 + [P] * 3 + [F] * 3 + [I] * 6 + [P] * 2
            fn.restype = I
            return {"b1": (fn, libs["analog_mvm"].analog_mvm_error_string)}
        lib = libs["decode_fused"]
        fn, mb = lib.decode_fused_launch, lib.decode_fused_max_blocks
        fn.argtypes = [P, P, P, I, I, P]
        fn.restype = I
        mb.argtypes = [I, I, I]
        mb.restype = I
        attn = libs["decode_rows"].decode_rows_attn
        attn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, F, I, P]
        attn.restype = I
        return {"b2": (fn, mb, lib.decode_fused_error_string),
                "rows": ({"attn": attn}, libs["decode_rows"].decode_rows_error_string)}

    return finish


@contextlib.contextmanager
def b2_library(lib):
    """Within the block, ``kernels.decode_fused`` launches through ``lib``
    (a parent's library from :func:`build_parent`; None: its own). The
    parent reads the prefix of the launch arguments it knows."""
    from repro_torch.kernels import decode_fused as df

    saved = df._fn()
    if lib is not None:
        df._FN = lib
    try:
        yield
    finally:
        df._FN = saved


def parent_grid(lib, dec) -> int:
    """Blocks of the parent's kernel the card holds at once."""
    import torch

    from repro_torch.kernels import decode_fused as df

    dev = dec.device
    n = lib[1](df._DTYPES[dec.cfg.dtype],
               dev.index if dev.index is not None else torch.cuda.current_device(),
               dec.layout.smem_bytes)
    check(n > 0, f"parent B2 occupancy query failed ({n})")
    return n


# --------------------------------------------------------------- prefill attention


def fa_bound(rows: int, s: int, h: int, kv: int, d: int) -> tuple:
    """(bound ms, bound_by) of one bf16 causal B3 launch: q, k, v read once
    and o written once over the HBM rate, or the QK^T and PV operations the
    causal mask leaves (2 x 2 x D per (row, key) pair it keeps) over the
    bf16 tensor-core peak, whichever is larger."""
    nbytes = rows * s * (2 * h + 2 * kv) * d * 2
    ops = 4 * rows * h * d * (s * (s + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fa_served_shapes(trace) -> list:
    """(rows, S) of every B3 launch the serving phases make: each prompt
    length at one row (the per-request prefills of phases 4, 6 and 9's
    digital lockstep, and the 16-token warm-up) and the paged engine's
    (rows, bucket) shapes (phase 9's bucketed prefill)."""
    from repro_torch.serving.paging import default_buckets, prefill_rows

    exact = {(1, int(r.prompt.size)) for r in trace} | {(1, 16)}
    rows = prefill_rows(default_buckets(PAGED["s_max"]), PAGED["prefill_batch"])
    return sorted(exact | {(pb, b) for b, pb in rows.items()}, key=lambda x: (x[1], x[0]))


def record_fa_shapes() -> set:
    """Record the (rows, S, dtype) of every prefill-attention launch made by
    the model from here on (``chunked_attention``'s calls of the kernel
    wrapper and of its training form); the wrappers and the launch count
    are left as they are."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    seen: set = set()

    def recorder(fn):
        def recorded(q, k, v, **kw):
            seen.add((q.shape[0], q.shape[1], str(q.dtype).split(".")[-1]))
            return fn(q, k, v, **kw)
        return recorded

    attention.flash_attention = recorder(attention.flash_attention)
    ops.flash_attention_ste = recorder(ops.flash_attention_ste)
    return seen


def record_b1_shapes() -> set:
    """Record the ``b1_key`` of every programmed-MVM launch made through the
    model's entry (``kernels.ops.analog_mvm``, which ``execute_mvm`` calls)
    from here on; the wrapper and its launch counts are left as they are."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops

    seen: set = set()
    entry = ops.analog_mvm

    def recorded(x, w, **kw):
        m, k, n = x.numel() // x.shape[-1], w.shape[0], w.shape[1]
        keep = kw.get("keep") is not None
        design = kernel.select_design(
            x.dtype, m, k, n, tile_rows=kw.get("tile_rows", 1024),
            per_tile_adc=kw.get("per_tile_adc", True), apply_dac=kw.get("r_dac") is not None,
            keep=keep)
        seen.add(b1_key(m, k, n, x.dtype, design)
                 + (kw.get("tile_rows", 1024), kw.get("per_tile_adc", True),
                    kw.get("r_dac") is not None, keep))
        return entry(x, w, **kw)

    ops.analog_mvm = recorded
    return seen


def phase_flash_attention(torch, gen, shapes: list) -> dict:
    """Kernel B3 against its plain version at tinyllama-1.1b's heads over
    ``shapes`` (rows, S), bf16 and f32, causal and full; the right-padding
    check; and, per shape in bf16 causal (the prefill's case), the kernel,
    the plain version, SDPA (yardstick only) and the bound.

    Tolerance: f32 max |d| <= 1e-5 * max |o|; bf16 at most one output ulp
    (near zero, ulp(|o|) + 1e-5 * max |o|) with under 1% of outputs
    differing. Padding: a prompt at its exact length and right-padded (pad
    rows x 100) to every larger bucket gives bitwise the same real rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    c = FA_HEADS
    chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launches0 = fa.flash_attention.launches
    cases, failures, rows_out = [], [], []
    for rows, s in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = fa_cases(torch, gen, rows, s, dtype, cases, failures)
            if dtype != torch.bfloat16:
                continue
            # timing, bf16 causal: kernel, plain, SDPA, kernel
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            n_iter = 20 if s <= 512 else 5
            run_k = lambda i: fa.flash_attention(q, k, v, causal=True, **chunks)
            ms_k1 = time_ms(run_k, n_iter)
            ms_p = time_ms(lambda i: flash_attention_ref(q, k, v, True, **chunks), max(2, n_iter // 4))
            ms_l = time_ms(lambda i: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), n_iter)
            ms_k2 = time_ms(run_k, n_iter)
            bound, bound_by = fa_bound(rows, s, c["h"], c["kv"], c["d"])
            row = {"rows": rows, "S": s, "ms": min(ms_k1, ms_k2), "ms_readings": [ms_k1, ms_k2],
                   "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": bound, "bound_by": bound_by}
            row["bound_share"] = bound / row["ms"]
            rows_out.append(row)
            log(f"B3 time rows={rows} S={s:4d} bf16 causal: kernel {row['ms']:.4f} ms "
                f"({ms_k1:.4f}/{ms_k2:.4f}), plain {ms_p:.4f} ms, SDPA {ms_l:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by}, {row['bound_share']:.1%} of bound; kernel/SDPA "
                f"{row['ms'] / ms_l:.1f}x)")
    torch.cuda.synchronize()
    worst_bf16 = max(r["max_ulps"] for r in cases if r["max_ulps"] is not None)
    worst_f32 = max(r["max_abs"] / r["max_abs_o"] for r in cases if r["dtype"] == "float32")
    log(f"B3 vs plain: {len(cases)} cases, bf16 worst {worst_bf16:.3f} ulps, "
        f"{sum(r['over_one_ulp'] for r in cases)} outputs over one ulp (all near zero, "
        f"within the f32 bound), worst share differing "
        f"{max(r['differing'] / r['elements'] for r in cases if r['dtype'] == 'bfloat16'):.2e}; "
        f"f32 worst max|d|/max|o| {worst_f32:.2e}")
    for f in failures[:10]:
        log(f"  FAIL {f}")

    # right-padding: exact length vs every larger bucket, real rows bitwise
    pad = []
    for dtype in (torch.bfloat16, torch.float32):
        for length in (1, 17, 100, 250, 300, 1000):
            q, k, v = (torch.randn((1, length, n, c["d"]), generator=gen, device=DEV).to(dtype)
                       for n in (c["h"], c["kv"], c["kv"]))
            exact = fa.flash_attention(q, k, v, causal=True, **chunks)
            for bucket in (32, 64, 128, 256, 512, 1024, 2048):
                if bucket <= length:
                    continue
                padded = [torch.cat([x, 100 * torch.randn((1, bucket - length, *x.shape[2:]),
                                                          generator=gen, device=DEV).to(dtype)],
                                    dim=1).contiguous() for x in (q, k, v)]
                out = fa.flash_attention(*padded, causal=True, **chunks)
                pad.append({"dtype": str(dtype).split(".")[-1], "length": length,
                            "bucket": bucket, "equal": bool(torch.equal(out[:, :length], exact))})
    n_eq = sum(p["equal"] for p in pad)
    log(f"B3 right-padding: {n_eq} of {len(pad)} (length, bucket) pairs bitwise equal")
    fa.flash_attention.launches = launches0  # check launches are not main-path launches
    check(not failures, f"{len(failures)} B3 cases out of tolerance")
    check(n_eq == len(pad), "B3 real rows bitwise independent of right-padding")
    return {"shapes": list(shapes), "cases": cases, "timing": rows_out, "padding": pad,
            "max_abs_bf16": max(r["max_abs"] for r in cases if r["dtype"] == "bfloat16"),
            "worst_bf16_ulps": worst_bf16, "worst_f32_rel": worst_f32}


def fa_flip_rows(torch, q, k, v, o_k, o_p, over, causal: bool, window, kv_chunk: int,
                 scale: float) -> list:
    """Recompute each output row of ``over`` (a bool mask of B3's bf16
    outputs past phase 8's bound) with the kernel's rounding of p shown:
    the row's exact (f64) p of every live key against the plain version's
    running max at its KV chunk; the keys whose p lies within the two
    versions' f32 error of a bf16 rounding midpoint (``FA_P_NEAR`` of the
    scores' magnitude) are the only ones either version can round the other
    way; a flip of key t moves the row by +-(hi_t - lo_t) v_t alpha_t / l.
    The flips that explain the row are solved for over its D outputs
    (least squares, rounded to -1, 0 or +1) and the row is shown when,
    with them, every output lies within phase 8's bound of the kernel's
    (one ulp of the larger of the two, plus 1e-5 max |o|). Returns one
    record per row."""
    _, s, h, d = q.shape
    g = h // k.shape[2]
    t = torch.arange(s, device=DEV)
    out = []
    for b, i, hh in sorted({tuple(x) for x in over.nonzero()[:, :3].tolist()}):
        qr = q[b, i, hh].double()
        kr, vr = k[b, :, hh // g].double(), v[b, :, hh // g].double()
        sc = (kr @ qr) * d**-0.5  # (S,)
        live = torch.ones(s, dtype=torch.bool, device=DEV)
        if causal:
            live &= t <= i
        if window is not None:
            live &= i - t < window
        sl = torch.where(live, sc, torch.full_like(sc, -math.inf))
        chunk_max = torch.nn.functional.pad(sl, (0, -s % kv_chunk), value=-math.inf)
        chunk_max = chunk_max.reshape(-1, kv_chunk).amax(-1)
        m = torch.cummax(chunk_max, 0).values[t // kv_chunk]  # each key's running max
        x = torch.where(live, torch.exp(sc - m), torch.zeros_like(sc))  # p before rounding
        m_final = sl.max()
        alpha = torch.exp(m - m_final)
        l_sum = (x * alpha).sum()
        u = torch.exp2(torch.floor(torch.log2(x.clamp(min=1e-300))) - 7)  # bf16 spacing at p
        lo = torch.floor(x / u) * u
        mag = (kr.abs() @ qr.abs()) * d**-0.5  # what each score's sum rounds at
        err = FA_P_NEAR * (mag + mag[live].max())  # the key's score and the max's
        near = live & ((x - (lo + u / 2)).abs() <= err * x)
        w = ((u * alpha / l_sum)[near, None] * vr[near]).cpu()  # (C, D): one flip each
        delta = (o_k[b, i, hh] - o_p[b, i, hh]).double().cpu()
        flips = (torch.linalg.lstsq(w.T, delta[:, None]).solution[:, 0].round().clamp(-1, 1)
                 if len(w) else torch.zeros(0, dtype=torch.float64))
        resid = (delta - flips @ w).abs()
        bound = (torch.maximum(bf16_ulp(o_p[b, i, hh]), bf16_ulp(o_k[b, i, hh])).double().cpu()
                 + 1e-5 * scale)
        out.append({"row": (b, i, hh), "candidates": int(near.sum().item()),
                    "flips": int(flips.abs().sum().item()),
                    "outputs_over": int(over[b, i, hh].sum().item()),
                    "max_resid_over_bound": (resid / bound).max().item(),
                    "shown": bool(flips.abs().sum().item() > 0
                                  and (resid <= bound).all().item())})
    return out


def fa_cases(torch, gen, rows: int, s: int, dtype, cases: list, failures: list,
             heads=None, window=None) -> tuple:
    """B3 against its plain version on random (rows, S) operands at
    ``heads`` ({"h", "kv", "d"}, and the chunks; tinyllama-1.1b's by
    default) and local ``window``, causal and full, under phase 8's
    tolerance: each case into ``cases``, a case out of tolerance into
    ``failures``; returns the operands (q, k, v).

    ``over_bound`` counts the bf16 outputs past phase 8's bound. At
    recurrentgemma-9b's heads (``RG_HEADS``) a case may hold up to
    ``FA_FLIP_OUTPUTS`` of them, each in a row that ``fa_flip_rows`` shows
    to be the plain version's row with some p rounded to its other bf16
    neighbour (both versions round p to bf16 before PV, and a p at a bf16
    midpoint rounds as its score's last bits leave it; one such case drew 2
    of 16.8 M outputs past the bound at (1, 4096, 16/1, 256), window 2048,
    full). Every other case, paligemma-3b's at head dim 256 included, is
    held to phase 8's bound alone."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    c = {**FA_HEADS, **(heads or {})}
    chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    q, k, v = (torch.randn((rows, s, n, c["d"]), generator=gen, device=DEV).to(dtype)
               for n in (c["h"], c["kv"], c["kv"]))
    for causal in (True, False):
        o_k = fa.flash_attention(q, k, v, causal=causal, window=window, **chunks)
        o_p = flash_attention_ref(q, k, v, causal, window=window, **chunks)
        r = fa_compare(torch, q, k, v, o_k, o_p, causal, window, c, dtype, rows, s)
        cases.append(r)
        if not r["ok"]:
            failures.append(r)
    return q, k, v


def fa_compare(torch, q, k, v, o_k, o_p, causal: bool, window, c: dict, dtype, rows: int,
               s: int) -> dict:
    """One B3 output ``o_k`` against its plain version's ``o_p`` on the same
    operands under phase 8's bound (``fa_cases``; ``c`` the heads and
    chunks), with ``fa_flip_rows``' allowance at recurrentgemma-9b's heads."""
    flips_allowed = (dtype == torch.bfloat16
                     and all(c[x] == RG_HEADS[x] for x in ("h", "kv", "d")))
    ok_, op_ = o_k.float(), o_p.float()
    dd = (ok_ - op_).abs()
    scale = op_.abs().max().item()
    ulp = bf16_ulp(op_)
    r = {"rows": rows, "S": s, "dtype": str(dtype).split(".")[-1],
         "heads": (c["h"], c["kv"], c["d"]), "window": window,
         "causal": causal, "max_abs": dd.max().item(), "max_abs_o": scale,
         # ulps of the outputs the bound's absolute term does not cover
         "max_ulps": ((dd / ulp)[op_.abs() >= 1e-5 * scale].max().item()
                      if dtype == torch.bfloat16 else None),
         "over_one_ulp": int((dd > ulp).sum().item()),
         "differing": int((dd > 0).sum().item()), "elements": dd.numel(),
         "finite": bool(ok_.isfinite().all().item())}
    if dtype == torch.float32:
        r["ok"] = r["finite"] and r["max_abs"] <= 1e-5 * scale
        return r
    over = dd > ulp + 1e-5 * scale
    r["over_bound"] = int(over.sum().item())
    shown = True
    if r["over_bound"] and flips_allowed and r["over_bound"] <= FA_FLIP_OUTPUTS:
        r["flip_rows"] = fa_flip_rows(torch, q, k, v, ok_, op_, over, causal, window,
                                      c["kv_chunk"], scale)
        shown = all(x["shown"] for x in r["flip_rows"])
        log(f"B3 {r['heads']} rows={rows} S={s} window {window} causal {causal}: "
            f"{r['over_bound']} outputs past phase 8's bound, rows recomputed with "
            f"p flipped: {r['flip_rows']}")
    r["ok"] = (r["finite"] and r["differing"] / r["elements"] < 0.01
               and (r["over_bound"] == 0 or (flips_allowed and shown
                                             and r["over_bound"] <= FA_FLIP_OUTPUTS)))
    return r


def check_launched_fa(torch, gen, shapes: list, flash: dict) -> dict:
    """Phase 8's comparison, at the same tolerance, for (rows, S, dtype)
    shapes a serving phase launched B3 at that phase 8 did not check (a
    migrated continuation prefills prompt + prefix tokens); merged into
    phase 8's record."""
    from repro_torch.kernels import flash_attention as fa

    launches0 = fa.flash_attention.launches
    failures = []
    for rows, s, dtype in shapes:
        fa_cases(torch, gen, rows, s, getattr(torch, dtype), flash["cases"], failures)
    torch.cuda.synchronize()
    fa.flash_attention.launches = launches0  # check launches are not main-path launches
    flash["worst_bf16_ulps"] = max(r["max_ulps"] for r in flash["cases"]
                                   if r["max_ulps"] is not None)
    log(f"B3 vs plain at the shapes the serving phases launched that phase 8 had not checked "
        f"({len(shapes)}): {sorted(shapes)}; out of tolerance: {failures or 'none'}")
    check(not failures, f"{len(failures)} launched B3 cases out of tolerance")
    return {"shapes": sorted(shapes), "failures": len(failures)}


def fa_window_bound(rows: int, s: int, h: int, kv: int, d: int, window) -> tuple:
    """(bound ms, bound_by) of one bf16 causal B3 launch with a local
    ``window`` (None: none): q, k, v read once and o written once over the
    HBM rate, or 4 D operations per query head and live (row, key) pair --
    sum over rows i of min(i + 1, window) keys -- over the bf16
    tensor-core peak, whichever is larger."""
    w = window or s
    pairs = sum(min(i + 1, w) for i in range(s))
    nbytes = rows * s * (2 * h + 2 * kv) * d * 2
    ops = 4 * rows * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def b3_window(torch, gen, flash: dict) -> dict:
    """B3 with the local window and at D = 256 (see the module docstring,
    phase 17): ``B3_WINDOW_CASES`` against the plain version under phase 8's
    bound (fp32 and bf16, causal and full; merged into phase 8's cases), the
    walk from a block's first live key bitwise the walk from key 0, real
    rows bitwise under right-padding (``B3_WINDOW_PADDING``), and the first
    case timed in bf16 beside the plain version, SDPA with the
    sliding-window boolean mask (yardstick only) and the bound. Its
    launches are checks, not main-path launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    launches0 = fa.flash_attention.launches
    failures, skip_equal, pad = [], [], []
    n0 = len(flash["cases"])
    timing = None
    for rows, s, heads, window in B3_WINDOW_CASES:
        c = {**FA_HEADS, **heads}
        chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = fa_cases(torch, gen, rows, s, dtype, flash["cases"], failures,
                               heads=heads, window=window)
            if window is not None:
                for causal in (True, False):
                    walk = [fa._launch(q, k, v, causal=causal, kv_chunk=c["kv_chunk"],
                                       window=window, skip=skip) for skip in (True, False)]
                    skip_equal.append({"rows": rows, "S": s, "d": c["d"], "window": window,
                                       "dtype": str(dtype).split(".")[-1], "causal": causal,
                                       "equal": bool(torch.equal(*walk))})
            if timing is not None or dtype != torch.bfloat16:
                continue
            mask = torch.arange(s, device=DEV)
            mask = mask[:, None] - mask[None, :]
            mask = (mask >= 0) & (mask < (window or s))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            run_k = lambda i: fa.flash_attention(q, k, v, causal=True, window=window, **chunks)
            ms_k1 = time_ms(run_k, 5)
            ms_p = time_ms(lambda i: flash_attention_ref(q, k, v, True, window=window,
                                                         **chunks), 2)
            ms_l = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True), 5)
            ms_k2 = time_ms(run_k, 5)
            bound, bound_by = fa_window_bound(rows, s, c["h"], c["kv"], c["d"], window)
            timing = {"rows": rows, "S": s, "heads": (c["h"], c["kv"], c["d"]),
                      "window": window, "ms": min(ms_k1, ms_k2), "ms_readings": [ms_k1, ms_k2],
                      "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": bound,
                      "bound_by": bound_by}
            timing["bound_share"] = bound / timing["ms"]
            log(f"B3 time rows={rows} S={s} heads {c['h']}/{c['kv']} D={c['d']} window "
                f"{window} bf16 causal: kernel {timing['ms']:.4f} ms ({ms_k1:.4f}/{ms_k2:.4f}), "
                f"plain {ms_p:.4f} ms, SDPA (sliding-window mask) {ms_l:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by}, {timing['bound_share']:.1%} of bound; "
                f"kernel/SDPA {timing['ms'] / ms_l:.2f}x)")
    for heads, window, lengths, buckets in B3_WINDOW_PADDING:
        c = {**FA_HEADS, **heads}
        chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
        for dtype in (torch.bfloat16, torch.float32):
            for length in lengths:
                q, k, v = (torch.randn((1, length, n, c["d"]), generator=gen,
                                       device=DEV).to(dtype) for n in (c["h"], c["kv"], c["kv"]))
                exact = fa.flash_attention(q, k, v, causal=True, window=window, **chunks)
                for bucket in buckets:
                    if bucket <= length:
                        continue
                    padded = [torch.cat([x, 100 * torch.randn(
                        (1, bucket - length, *x.shape[2:]), generator=gen,
                        device=DEV).to(dtype)], dim=1).contiguous() for x in (q, k, v)]
                    out = fa.flash_attention(*padded, causal=True, window=window, **chunks)
                    pad.append({"dtype": str(dtype).split(".")[-1], "d": c["d"],
                                "window": window, "length": length, "bucket": bucket,
                                "equal": bool(torch.equal(out[:, :length], exact))})
    torch.cuda.synchronize()
    fa.flash_attention.launches = launches0
    cases = flash["cases"][n0:]
    flash["worst_bf16_ulps"] = max(r["max_ulps"] for r in flash["cases"]
                                   if r["max_ulps"] is not None)
    n_skip, n_pad = sum(r["equal"] for r in skip_equal), sum(p["equal"] for p in pad)
    log(f"B3 window / D = 256: {len(cases)} cases vs plain "
        f"{[(r['rows'], r['S'], r['heads'], r['window'], r['dtype'], r['causal']) for r in cases]}"
        f", bf16 worst {max(r['max_ulps'] for r in cases if r['max_ulps'] is not None):.3f} "
        f"ulps, fp32 worst max|d|/max|o| "
        f"{max(r['max_abs'] / r['max_abs_o'] for r in cases if r['dtype'] == 'float32'):.2e}; "
        f"out of tolerance {failures or 'none'}; the walk from the first live key == the "
        f"walk from key 0 bitwise in {n_skip} of {len(skip_equal)}; right-padding: {n_pad} of "
        f"{len(pad)} (length, bucket) pairs bitwise equal")
    check(not failures, f"{len(failures)} B3 window / D = 256 cases out of tolerance")
    check(n_skip == len(skip_equal) and skip_equal,
          "B3's walk from the first live key bitwise the walk from key 0")
    check(n_pad == len(pad) and pad, "B3 (window) real rows bitwise independent of padding")
    return {"cases": len(cases), "failures": failures, "skip_equal": skip_equal,
            "padding": pad, "timing": timing,
            "max_abs": max(r["max_abs"] for r in cases)}


def phase_paged_serve(torch, ctx, per_layer: dict) -> dict:
    """The trace again through the paged cache with bucketed prefill:
    ServingConfig(n_slots=8, s_max=512, paged=True, page_size=16,
    prefill_batch=4), BucketedScheduler, digital lockstep on. The counters
    prove B3 and B1 ran every prefill call and decode step and no plain
    version ran; one profiled prefill call gives B3's share of its device
    time; the trace served rectangular and paged in turns (rect, paged,
    paged, rect) on the SHALLOW_DEPTH chip; the exact-length and bucketed
    prefill of the same prompts are compared (reported, not gated); one
    decode step at 8 slots, no digital
    lockstep, over the rectangular slot cache (phase 4's engine) and over the
    paged cache, timed in turns (a, b, b, a) and profiled."""
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import BucketedScheduler, Request, ServingConfig, ServingEngine
    from repro_torch.serving.paging import bucket_for

    cfg, trace = ctx["cfg"], ctx["trace"]
    paged = ServingEngine.for_program(
        ctx["program"], cfg,
        ServingConfig(**PAGED),
        ref_params=ctx["params"], device=DEV,
    )
    calls = []
    prefill_bucket = paged.prefill_bucket

    def counted(toks, last_idx, rng=None):
        calls.append(tuple(toks.shape))
        return prefill_bucket(toks, last_idx, rng)

    paged.prefill_bucket = counted
    paged.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=4)],
              scheduler=BucketedScheduler())
    torch.cuda.synchronize()
    calls.clear()
    events0 = engine.program_event_count()
    reset_counts()
    rep = paged.run(trace, scheduler=BucketedScheduler())
    torch.cuda.synchronize()
    n_calls = len(calls)
    res = {
        "requests": rep.n_requests, "generated": rep.n_generated,
        "prefill_calls": n_calls,
        "prefill_shapes": sorted(set(calls)),
        "n_prefill_traces": rep.n_prefill_traces, "buckets": list(paged.prefill_buckets),
        "peak_pages_in_use": rep.peak_pages_in_use, "page_bytes_all_layers":
            2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.hd * cfg.dtype.itemsize,
        "kv_bytes": rep.peak_kv_bytes, "rect_kv_bytes": per_layer["kv_bytes"],
        "flash_attention_launches": fa.flash_attention.launches,
        "flash_attention_expected": FA_LAUNCHES_PER_PREFILL * (n_calls + rep.n_requests),
        "analog_mvm_launches": kernel.analog_mvm.launches,
        "analog_mvm_expected": LAUNCHES_PER_FORWARD * (n_calls + rep.n_steps),
        "analog_mvm_design_launches": dict(kernel.analog_mvm.design_launches),
        "analog_mvm_design_expected": b1_designs(calls, rep.n_steps),
        "plain_calls": plain_calls(),
        "program_events_while_serving": engine.program_event_count() - events0,
        **serve_metrics(rep),
        "requests_with_per_layer_tokens": sum(
            r.tokens.tolist() == ctx["tokens"][r.rid] for r in rep.records),
    }
    res["kv_bytes_at_peak_pages"] = res["peak_pages_in_use"] * res["page_bytes_all_layers"]
    log(rep.summary())
    # host time drifts over a long process: rectangular and paged serving
    # are compared in turns (rect, paged, paged, rect), on a chip of the
    # first SHALLOW_DEPTH layers
    sparams, scfg, sprog = shallow_chip(torch, ctx)
    shallow = {"rect": (ServingEngine.for_program(
                   sprog, scfg, ServingConfig(n_slots=SLOTS, s_max=512), ref_params=sparams,
                   device=DEV), None),
               "paged": (ServingEngine.for_program(
                   sprog, scfg, ServingConfig(**PAGED), ref_params=sparams, device=DEV),
                   BucketedScheduler)}
    for eng, sched in shallow.values():  # warm-up, not measured
        eng.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=4)],
                scheduler=sched and sched())
    turns = {"rect": [], "paged": []}
    for k in ("rect", "paged", "paged", "rect"):
        eng, sched = shallow[k]
        turns[k].append(serve_metrics(eng.run(trace, scheduler=sched and sched())))
    del shallow
    res["in_turns"] = {k: [{n: m[n] for n in SERVE_METRICS} for m in v]
                       for k, v in turns.items()}
    res["in_turns_depth"] = SHALLOW_DEPTH
    for name, m in [("per-layer", per_layer), ("paged", res)] + [
            (f"{k} {i} d{SHALLOW_DEPTH}", m) for k in ("rect", "paged")
            for i, m in enumerate(turns[k])]:
        log(f"serve {name:9s}: {m['tokens_per_s']:.1f} tokens/s, "
            f"{m['ms_per_decode_step']:.2f} ms/decode step, p50 {m['latency_p50_s']:.3f} s, "
            f"p95 {m['latency_p95_s']:.3f} s, ttft p50 {m['ttft_p50_s']:.3f} s, "
            f"p95 {m['ttft_p95_s']:.3f} s, top1_agreement {m['top1_agreement']:.4f}, "
            f"{m['decode_steps']} decode steps")
    log(f"paged: {n_calls} bucketed prefill calls over shapes {res['prefill_shapes']}, "
        f"prefill traces {rep.n_prefill_traces} (buckets {len(paged.prefill_buckets)}), "
        f"peak pages {rep.peak_pages_in_use} ({res['kv_bytes_at_peak_pages']} B of KV in use "
        f"at the peak; pool {res['kv_bytes']} B; rectangle {res['rect_kv_bytes']} B)")
    log(f"paged counters: flash_attention launches {res['flash_attention_launches']} (expected "
        f"{res['flash_attention_expected']} = {FA_LAUNCHES_PER_PREFILL} x ({n_calls} bucketed + "
        f"{rep.n_requests} digital prefills)), analog_mvm launches {res['analog_mvm_launches']} "
        f"(expected {res['analog_mvm_expected']} = {LAUNCHES_PER_FORWARD} x ({n_calls} + "
        f"{rep.n_steps} decode steps); by design {res['analog_mvm_design_launches']}), "
        f"plain calls {res['plain_calls']}, program events "
        f"{res['program_events_while_serving']}; requests with the per-layer run's tokens "
        f"{res['requests_with_per_layer_tokens']}/{rep.n_requests}")
    check(rep.n_requests == len(trace), "every request retires (paged)")
    check(all(r.n_new == q.max_new_tokens for r, q in
              zip(sorted(rep.records, key=lambda r: r.rid), trace)),
          "every request got its budget (paged)")
    check(rep.n_prefill_traces <= len(paged.prefill_buckets), "prefill shapes <= buckets")
    check(res["flash_attention_launches"] == res["flash_attention_expected"],
          "22 flash_attention launches per prefill (paged)")
    check(res["analog_mvm_launches"] == res["analog_mvm_expected"],
          "155 analog_mvm launches per bucketed prefill and decode step")
    check(res["analog_mvm_design_launches"] == res["analog_mvm_design_expected"],
          "B1: bucketed prefill through the prefill design, decode through the decode design")
    check(res["plain_calls"] == 0, "the paged path never ran a plain version")
    check(res["program_events_while_serving"] == 0, "no programming events (paged)")

    # exact-length vs bucketed prefill of the same prompts (dummy rows as the
    # engine fills them): the logits of the real row, reported
    same = []
    for req in trace[:4]:
        n = int(req.prompt.size)
        sb = bucket_for(n, paged.prefill_buckets)
        pb = paged._pb_of[sb]
        toks = np.tile(np.pad(req.prompt, (0, sb - n)), (pb, 1))
        _, l_b, _ = prefill_bucket(torch.as_tensor(toks, device=DEV),
                                   torch.full((pb,), n - 1, device=DEV))
        _, l_e, _ = paged.prefill(paged.params, paged.acfg, req)
        d = (l_b[0].float() - l_e[0].float()).abs().max().item()
        same.append({"length": n, "bucket": sb, "rows": pb,
                     "bitwise": bool(torch.equal(l_b[0], l_e[0])), "max_abs": d})
    res["exact_vs_bucketed_prefill"] = same
    log(f"exact-length vs bucketed prefill logits: "
        + "; ".join(f"{x['length']}->{x['bucket']}x{x['rows']} "
                    f"{'bitwise' if x['bitwise'] else 'max |d| %.3e' % x['max_abs']}"
                    for x in same))

    # one full-width prefill call profiled: B3's share of its device time
    shares = {}
    for sb in (32, 256):
        pb = paged._pb_of[sb]
        toks = torch.as_tensor(np.tile(trace[0].prompt[:1], (pb, sb)), device=DEV)
        last = torch.full((pb,), sb - 1, device=DEV)
        prefill_bucket(toks, last)
        torch.cuda.synchronize()
        prof = profiled(torch, lambda: prefill_bucket(toks, last), "flash_attention")
        shares[f"{pb}x{sb}"] = prof
        log(f"profile (one bucketed prefill call, {pb} x {sb}): device busy "
            f"{prof['profile_device_ms']} ms, flash_attention kernels {prof['profile_kernel_ms']} "
            f"ms, analog_mvm kernels {prof['profile_mvm_ms']} ms, host wall {prof['profile_wall_ms']} ms, device kernels "
            f"{prof['profile_launches']}, idle share {prof['profile_idle_share']}")
    res["prefill_profile"] = shares

    def step_of(eng, scheduler):
        run = eng.start_run(scheduler=scheduler)
        run.submit([Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                    for r in trace[: eng.n_slots]])
        run.admit_arrived()
        # every timed call rewrites the same rows (the returned cache is dropped)
        return lambda: eng.decode_main(run.cur, run.cache)

    ways = [("rect", step_of(ctx["served"], None)), ("paged", step_of(paged, BucketedScheduler()))]
    readings = {name: [] for name, _ in ways}
    for name, fn in ways + ways[::-1]:
        readings[name].append(wall_ms(torch, fn, 10))
    steps = {}
    for name, fn in ways:
        prof = profiled(torch, fn)
        steps[name] = {"ms_per_step": min(readings[name]), "ms_readings": readings[name],
                       "device_kernels": prof["profile_launches"],
                       "device_busy_ms": prof["profile_device_ms"],
                       "device_idle_share": prof["profile_idle_share"]}
        log(f"decode step {name:5s} (per layer, no lockstep): {steps[name]['ms_per_step']:.4f} "
            f"ms/step ({'/'.join(f'{x:.4f}' for x in readings[name])}), device kernels "
            f"{prof['profile_launches']}, device busy {prof['profile_device_ms']} ms, idle "
            f"share {prof['profile_idle_share']} profiled")
    res["decode_step"] = steps
    return res



# --------------------------------------------------------------- slice 6


def phase_rows(torch, gen, parent=None) -> dict:
    """The row kernels (kernels/decode_rows.py) against their plain versions
    at the decode step's shapes (8 slots, tinyllama-1.1b, bf16, a 512-row
    slot cache), within the plain versions' rounding model: the kernels
    take B2's reduction orders, so a value may sit one bf16 ulp from the
    plain value (norm: torch's mean and rsqrt; attention: torch's score,
    softmax and AV orders, up to two); then kernel, plain version and,
    where one PyTorch call computes the same function, that call, timed
    by CUDA-graph replay, beside the bytes bound; with ``parent`` (the
    parent's attention kernel, :func:`build_parent`) ``c3_attn_turns``."""
    out = row_checks(torch, gen, SLOTS, 2048, 32, 4, 64, 512, 5632)
    if parent is not None:
        out["attn"]["c3_turns"] = c3_attn_turns(torch, gen, parent)
    return out


def row_checks(torch, gen, b, d, h, kv, hd, s, f, lens=None, timed=True,
               what="", p_flip=False) -> dict:
    """:func:`phase_rows`'s checks at b slots, width d, h/kv heads of hd, an
    s-row slot cache and FFN width f; ``lens`` (each slot's length; random
    below s by default) may pass s: a rolling buffer's slots attend to
    min(length, s) rows, at position length - 1. ``timed=False`` skips
    the timings. ``p_flip`` widens the attention's tolerance by one flipped
    p: both versions round p to bf16 before AV, and where p's f32 value
    lies at a bf16 midpoint the two orders of the softmax round it to
    neighbours, which moves an output by up to ulp(p) |v| <= 2^-7 p_max
    v_max of its (slot, head) -- many of its own ulps where its terms
    cancel (at hd 256: 34 ulps at an output of 2.7e-4)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_rows as dr

    bf = torch.bfloat16
    randn = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    x = randn(b, 1, d).to(bf)
    scale = 1 + 0.1 * randn(d)
    q, k = randn(b, 1, h, hd).to(bf), randn(b, 1, kv, hd).to(bf)
    if lens is None:
        pos = torch.randint(0, s - 1, (b,), generator=gen, device=DEV, dtype=torch.int32)
    else:
        pos = torch.tensor(lens, device=DEV, dtype=torch.int32) - 1
    kc, vc = randn(b, s, kv, hd).to(bf), randn(b, s, kv, hd).to(bf)
    lens = pos + 1
    u, g = randn(b, 1, f).to(bf), randn(b, 1, f).to(bf)
    eps = 1e-5
    q_r, _ = dr.rope(q, k, pos, 10000.0)
    mask = (torch.arange(s, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
    qt, kt, vt = q_r.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    att_bytes = sum(min(int(n), s) for n in lens.tolist()) * kv * hd * 2 * 2
    cases = {
        "norm": (lambda: dr.norm(x, scale, eps), lambda: dr.norm_plain(x, scale, eps),
                 lambda: F.rms_norm(x, (d,), scale.to(bf), eps), 2 * x.numel() * 2 + d * 4, 1),
        "rope": (lambda: dr.rope(q, k, pos, 10000.0), lambda: dr.rope_plain(q, k, pos, 10000.0),
                 None, 2 * (q.numel() + k.numel()) * 2 + b * 4, 1),
        "attn": (lambda: dr.attention(q_r, kc, vc, lens),
                 lambda: dr.attention_plain(q_r, kc, vc, lens),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                        enable_gqa=True),
                 att_bytes + 2 * q.numel() * 2 + b * 4, 2),
        "gate": (lambda: dr.gate(u, g), lambda: dr.gate_plain(u, g), None,
                 3 * u.numel() * 2, 1),
    }
    flip = None
    if p_flip:
        live = torch.arange(s, device=DEV)[None, :] < lens.clamp(max=s)[:, None]  # (B, S)
        sc = torch.einsum("bkgd,bskd->bkgs", q_r[:, 0].reshape(b, kv, h // kv, hd).float(),
                          kc.float()) * hd**-0.5
        p_max = torch.softmax(sc.masked_fill(~live[:, None, None], -torch.inf), -1).amax(-1)
        v_max = (vc.float().abs().amax(-1) * live[:, :, None]).amax(1)  # (B, KV)
        flip = (2.0**-7 * p_max * v_max[:, :, None]).reshape(b, 1, h, 1).expand(b, 1, h, hd)
    out = {}
    for name, (kern, plain, lib, nbytes, tol_ulps) in cases.items():
        yk, yp = kern(), plain()
        yk = torch.cat([t.reshape(-1) for t in yk]) if isinstance(yk, tuple) else yk.reshape(-1)
        yp = torch.cat([t.reshape(-1) for t in yp]) if isinstance(yp, tuple) else yp.reshape(-1)
        dd = (yk.float() - yp.float()).abs()
        ulp = bf16_ulp(yp)
        ulps = (dd / ulp).max().item()
        r = {"max_abs_err": dd.max().item(), "max_bf16_ulps": ulps,
             "differing": int((dd > 0).sum().item()), "values": dd.numel(),
             "tolerance_bf16_ulps": tol_ulps}
        r["pass"] = ulps <= tol_ulps and bool(yk.float().isfinite().all().item())
        if name == "attn" and flip is not None:
            r["over_tolerance_ulps"] = int((dd > tol_ulps * ulp).sum().item())
            r["p_flip_bound_max"] = flip.max().item()
            r["pass"] = bool((dd <= tol_ulps * ulp + flip.reshape(-1)).all().item()) and bool(
                yk.float().isfinite().all().item())
        out[name] = r
        line = (f"row kernel {name}{f' ({what})' if what else ''}: max |d| "
                f"{r['max_abs_err']:.3e} ({ulps:.2f} bf16 ulps, {r['differing']} of "
                f"{r['values']} differ; tolerance {tol_ulps}"
                + (f" or one p flip, up to {r['p_flip_bound_max']:.3e}: "
                   f"{r['over_tolerance_ulps']} over {tol_ulps} ulps" if "p_flip_bound_max" in r
                   else "") + ")")
        if timed:
            r.update({"ms": time_ms(lambda i: kern(), 50),
                      "plain_ms": time_ms(lambda i: plain(), 50),
                      "library_ms": time_ms(lambda i: lib(), 50) if lib else None,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
            line += (f", {r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f} us, library "
                     f"{'-' if lib is None else f'{r['library_ms'] * 1e3:.1f} us'}, bound "
                     f"{r['bound_ms'] * 1e3:.2f} us)")
        log(line + ("" if r["pass"] else "  FAIL"))
    check(all(r["pass"] for r in out.values()),
          f"row kernels within their plain versions' model{f' ({what})' if what else ''}")
    return out


def c3_attn_turns(torch, gen, parent) -> list:
    """The attention row kernel against the parent's, by CUDA-graph replay
    in turns (parent, change, change, parent), at tinyllama-1.1b's heads,
    bf16: 1 slot at ``s_max`` 256 and 512 (passes of one head, whose AV
    grouping C3 changed) and 8 slots at 512 (passes of two, unchanged), at
    random lengths of half to all of ``s_max``; whether the two kernels'
    outputs are equal is recorded."""
    from repro_torch.kernels import decode_rows as dr

    h, kv, hd = FA_HEADS["h"], FA_HEADS["kv"], FA_HEADS["d"]
    own, rows = dr._fn(), []
    for slots, s_max in ((1, 256), (1, 512), (SLOTS, 512)):
        q = torch.randn((slots, 1, h, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((slots, s_max, kv, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((slots, s_max, kv, hd), generator=gen, device=DEV).bfloat16()
        lens = torch.randint(s_max // 2, s_max, (slots,), generator=gen, device=DEV,
                             dtype=torch.int32)
        readings, outs = {"parent": [], "change": []}, {}
        for name in ("parent", "change", "change", "parent"):
            dr._FN = parent if name == "parent" else own
            try:
                readings[name].append(time_ms(lambda i: dr.attention(q, k, v, lens), 200) * 1e3)
                outs[name] = dr.attention(q, k, v, lens)
            finally:
                dr._FN = own
        r = {"slots": slots, "s_max": s_max,
             "heads_per_pass": dr.heads_per_pass(h, kv, hd, slots, s_max, dr.sm_count(DEV)),
             "parent_us": min(readings["parent"]), "change_us": min(readings["change"]),
             "readings_us": readings,
             "outputs_equal": bool(torch.equal(outs["parent"], outs["change"]))}
        r["cost_us"] = r["change_us"] - r["parent_us"]
        rows.append(r)
        log(f"row kernel attn at {slots} slot(s), s_max {s_max} ({r['heads_per_pass']} head(s) "
            f"a pass), in turns with the parent's: parent {r['parent_us']:.2f} us, change "
            f"{r['change_us']:.2f} us, cost {r['cost_us']:+.2f} us a launch; outputs equal "
            f"{r['outputs_equal']}")
    return rows


def phase_bridge(torch, ctx) -> dict:
    """Bridge on the card = bridge on the CPU: layer 0's wk of the chip
    programmed in phase 4 (member 0 of the stack, its key from the chip's
    state) is programmed again on the CPU through the plain bridge, and the
    CPU's state must be the card's, bit for bit; then both drift it to 30
    days and the effective weights and GDC scalar must agree bit for bit."""
    from repro_torch import prng
    from repro_torch.core import engine

    program, params = ctx["program"], ctx["params"]
    pcm = program.cfg.pcm
    st = program.state["blocks/0/attn/wk"]
    node = params.blocks[0]["attn"]["wk"]
    key = st["key"][0]
    w = node["w"][0]
    lo, hi = node["w_clip_buf"][0, 0].float(), node["w_clip_buf"][0, 1].float()
    t0 = time.perf_counter()
    cpu = engine._program_2d(key.cpu(), w.cpu(), lo.cpu(), hi.cpu(), pcm)
    cpu_s = time.perf_counter() - t0
    card = {name: st[name][0] for name in ("g_pos", "g_neg", "q_pos", "q_neg", "gt_sum",
                                            "w_scale", "key")}
    res = {"state": {name: bool(torch.equal(cpu[name], card[name].cpu())) for name in card},
           "cpu_program_s": cpu_s, "shape": list(w.shape)}
    t30 = 30 * 86400.0
    t0 = time.perf_counter()
    w_cpu, gdc_cpu = engine._drift_read_2d(cpu, t30, pcm)
    cpu_drift_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_card, gdc_card = engine._drift_read_2d(card, t30, pcm)
    torch.cuda.synchronize()
    res.update(drift_w_eff=bool(torch.equal(w_cpu, w_card.cpu())),
               drift_gdc=bool(torch.equal(gdc_cpu, gdc_card.cpu())),
               cpu_drift_s=cpu_drift_s, card_drift_ms=(time.perf_counter() - t0) * 1e3)
    n = 1 << 22
    a = prng.normal(prng.PRNGKey(ctx["seed"] + 5).to(DEV), (n,))
    res["normal_card_equals_cpu"] = bool(torch.equal(a.cpu(), prng.normal(
        prng.PRNGKey(ctx["seed"] + 5), (n,))))
    shape = (2048, 5632)
    k = prng.PRNGKey(ctx["seed"] + 6).to(DEV)
    buf = torch.empty(shape, dtype=torch.float32, device=DEV)
    k1, k2 = prng.PRNGKey(ctx["seed"] + 6).tolist()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    # the kernel alone (the wrapper reads the key's words back to the host),
    # and the plain version's PyTorch ops on the card, by CUDA events
    res["normal_ms_11.5M"] = events_ms(
        torch, lambda: prng._FN.prng_normal(k1, k2, buf.data_ptr(), 0, buf.numel(), 1, stream()),
        20)
    res["normal_plain_ms_11.5M"] = events_ms(
        torch, lambda: prng.erf_inv(prng.uniform(k, shape, prng._NORMAL_LO, 1.0)) * prng.SQRT2, 2)
    # bytes: 4 written per draw; operations: PRNG_OPS_PER_DRAW, over the
    # card's fp32 rate (integer operations counted at the same rate)
    res["normal_bound_by"] = "operations"
    res["normal_bound_ms_11.5M"] = max(buf.numel() * 4 / HBM_BYTES_PER_S,
                                       buf.numel() * PRNG_OPS_PER_DRAW / FP32_OPS) * 1e3
    check(buf.numel() * PRNG_OPS_PER_DRAW / FP32_OPS > buf.numel() * 4 / HBM_BYTES_PER_S,
          "the normal draw is operation-bound")
    log(f"bridge: layer 0 wk member 0 {tuple(w.shape)}, CPU state == card state "
        f"{res['state']}; drifted to 30 d: w_eff equal {res['drift_w_eff']}, GDC equal "
        f"{res['drift_gdc']} (CPU {cpu_s:.2f} s program + {cpu_drift_s:.2f} s drift, card "
        f"{res['card_drift_ms']:.1f} ms drift); 2^22 normals card == CPU "
        f"{res['normal_card_equals_cpu']}; one 2048 x 5632 normal draw on the card "
        f"{res['normal_ms_11.5M']:.3f} ms (plain version on the card "
        f"{res['normal_plain_ms_11.5M']:.2f} ms, bound "
        f"{res['normal_bound_ms_11.5M']:.4f} ms, {res['normal_bound_by']})")
    check(all(res["state"].values()) and res["drift_w_eff"] and res["drift_gdc"]
          and res["normal_card_equals_cpu"], "the bridge draws the same bits on the card")
    return res


def _lifecycle_run(torch, ctx, fused: bool) -> tuple:
    """One drift-lifecycle run of the trace on a virtual clock: the
    SHALLOW_DEPTH chip aged to the schedule's first age, then DriftPolicy over
    LIFECYCLE_AGES (an age every third of the steps) and one refresh right
    after the first aging; returns (report, engine, timings: each aging,
    the refresh and each decode step of the chip, synchronized). Only the
    engine holds the aged chip, so each aging and the refresh free the chip
    they replace."""
    from repro_torch import clock, prng
    from repro_torch.core import engine
    from repro_torch.core.engine import DriftSchedule
    from repro_torch.serving import DriftPolicy, ServingConfig, ServingEngine

    params, cfg, program = shallow_chip(torch, ctx)
    trace = ctx["trace"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program25 = engine.age_program(program, LIFECYCLE_AGES[0])
    torch.cuda.synchronize()
    first_age_s = time.perf_counter() - t0
    eng = ServingEngine.for_program(
        program25, cfg, ServingConfig(n_slots=SLOTS, s_max=512, fused_decode=fused),
        ref_params=params, src_params=params, rng=prng.PRNGKey(ctx["seed"] + 3),
        device=DEV,
    )
    del program25
    times = {"age_s": [first_age_s], "refresh_s": [], "step_s": []}

    def timed(fn, key):
        def wrapper(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    eng.age_to = timed(eng.age_to, "age_s")
    eng.refresh = timed(eng.refresh, "refresh_s")
    eng.decode_main = timed(eng.decode_main, "step_s")
    est = sum(r.max_new_tokens for r in trace) // SLOTS
    policy = DriftPolicy(DriftSchedule(LIFECYCLE_AGES), every_steps=max(1, est // 3))
    events0 = engine.program_event_count()
    reset_counts()
    # a virtual clock: admission, and so the step at which each request sees
    # each age, depends on the step count alone, the same per layer and
    # fused (on the host's clock the slower path admits at other steps)
    run = eng.start_run(drift_policy=policy, clock=clock.VirtualClock())
    run.submit(trace)
    refreshed = False
    while run.has_work:
        run.admit_arrived()
        if run.n_active == 0:
            if not run.queue:
                break
            run.idle_wait()
            continue
        run.decode_step()
        if not refreshed and run.age_events:
            run.refresh_chip(prng.fold_in(eng.rng, 7_000_000 + run.steps))
            refreshed = True
    rep = run.finish()
    torch.cuda.synchronize()
    times["events"] = engine.program_event_count() - events0
    return rep, eng, times


def phase_drift_lifecycle(torch, ctx) -> dict:
    """Phase 4's trace at full width on the SHALLOW_DEPTH chip under a
    DriftPolicy (25 s -> 1 h -> 1 d) with one refresh, per layer and fused:
    zero programming events outside the refresh, the ages and device ages
    the policy implies, the same tokens both ways; then B2 serves the aged
    chip: one step from the trace's cache state is bitwise the per-layer
    step on the same chip. Phase 4's whole chip is aged once, timed (the
    fleet phase times a whole chip's refresh)."""
    from repro_torch.core import engine
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models.attention import KVCache
    from repro_torch.models.lm import lm_forward

    gc.collect()
    torch.cuda.empty_cache()
    out = {"memory_gib_before": torch.cuda.memory_allocated() / 2**30,
           "depth": SHALLOW_DEPTH}
    log(f"drift lifecycle: {out['memory_gib_before']:.1f} GiB allocated before it")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aged = engine.age_program(ctx["program"], LIFECYCLE_AGES[0])
    torch.cuda.synchronize()
    out["full_depth_age_s"] = time.perf_counter() - t0
    del aged
    gc.collect()
    torch.cuda.empty_cache()
    log(f"drift lifecycle: phase 4's whole chip aged to {LIFECYCLE_AGES[0]:.0f} s in "
        f"{out['full_depth_age_s']:.2f} s; the lifecycle runs at depth {SHALLOW_DEPTH}")
    reports = {}
    for fused in (False, True):
        name = "fused" if fused else "per_layer"
        rep, eng, times = _lifecycle_run(torch, ctx, fused)
        ages = [(e["t_wall"], e["t_device"]) for e in rep.age_events if e["kind"] == "age"]
        r = {"ms_per_decode_step": 1e3 * sum(times["step_s"]) / max(len(times["step_s"]), 1),
             "decode_steps": rep.n_steps, "requests": rep.n_requests,
             "age_events": rep.age_events, "reprograms": rep.reprograms,
             "program_events": times["events"],
             "program_events_delta": rep.program_events_delta,
             "age_s": times["age_s"], "refresh_s": times["refresh_s"],
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
             "decode_fused_launches": df.launches, "plain_calls": plain_calls(),
             "top1_agreement": rep.counters["top1"]}
        r["pass"] = (rep.reprograms == 1 and rep.program_events_delta == 0
                     and times["events"] == len(eng.program.plans)
                     and ages == [(3600.0, 3600.0), (86400.0, 86400.0 - 3600.0)]
                     and r["plain_calls"] == 0
                     and (not fused or df.launches == rep.n_steps))
        out[name] = r
        reports[name] = rep
        log(f"drift lifecycle {name}: {rep.n_steps} decode steps at "
            f"{r['ms_per_decode_step']:.2f} ms/step (the chip's eager decode, no lockstep), ages "
            f"(wall, device) {ages}, aging (to 25 s, then the policy's) "
            f"{[round(t, 2) for t in times['age_s']]} s, refresh "
            f"{[round(t, 2) for t in times['refresh_s']]} s, reprograms {rep.reprograms}, "
            f"programming events {times['events']} (the refresh's), delta "
            f"{rep.program_events_delta}, top1 {r['top1_agreement']:.4f}"
            + ("" if r["pass"] else "  FAIL"))
        if fused:
            # B2 on the aged and refreshed chip vs the per-layer step on it
            plan = engine.build_fused_plan(eng.program)
            fcache, cur = fused_cache_from_trace(torch, eng, plan, ctx["trace"])
            lcache = ([(KVCache(fcache.k[g].clone(), fcache.v[g].clone(),
                                fcache.length.clone()),) for g in range(plan.n_groups)], ())
            lf, fc = eng.decoder.step(cur, KVCache(fcache.k.clone(), fcache.v.clone(),
                                                   fcache.length.clone()))
            lp, lc = lm_forward(eng.params, {"tokens": cur}, eng.acfg, eng.cfg, cache=lcache)
            torch.cuda.synchronize()
            pk = torch.stack([g[0].k for g in lc[0]])
            out["aged_step_logits_equal"] = bool(torch.equal(lf, lp))
            out["aged_step_k_equal"] = bool(torch.equal(fc.k, pk))
            out["aged_chip_t_seconds"] = eng.program.t_seconds
            log(f"B2 on the aged chip (t = {eng.program.t_seconds:.0f} s): one step bitwise "
                f"the per-layer step: logits {out['aged_step_logits_equal']}, K cache "
                f"{out['aged_step_k_equal']}")
        # the engine and its decoder refer to each other: collect the
        # cycle so the chip it holds leaves the card before the next run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    tok = lambda rep: {r.rid: r.tokens.tolist() for r in rep.records}
    out["requests_same_tokens"] = sum(
        tok(reports["fused"])[rid] == t for rid, t in tok(reports["per_layer"]).items())
    log(f"drift lifecycle: requests with the same tokens per layer and fused "
        f"{out['requests_same_tokens']}/{len(ctx['trace'])}")
    check(out["per_layer"]["pass"] and out["fused"]["pass"], "drift lifecycle")
    check(out["aged_step_logits_equal"] and out["aged_step_k_equal"],
          "B2 serves the aged chip bitwise the per-layer step")
    check(out["requests_same_tokens"] == len(ctx["trace"]),
          "per-layer and fused lifecycles serve the same tokens")
    del ctx["shallow"]  # its last phase
    return out


def phase_resample(torch, ctx) -> dict:
    """Per-MVM read-noise resampling. At full width, one decode step at 8
    slots with every projection's read noise drawn afresh (read buffers
    built for phase 4's chip), per layer and fused, timed, the two steps
    bitwise equal; then, at depth RESAMPLE_DEPTH (the whole trace at full
    depth would redraw 2 G weights per step and outrun the run's time
    limit), the trace served per layer and fused with resampling on a
    virtual clock: the same tokens."""
    import dataclasses

    from repro_torch import clock, prng
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models.attention import KVCache
    from repro_torch.models.lm import lm_forward
    from repro_torch.serving import ServingConfig, ServingEngine

    program, cfg, trace = ctx["program"], ctx["cfg"], ctx["trace"]
    pcm = program.cfg.pcm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_rs = engine._walk(program.params, lambda path, node: {
        **node, "read_buf": engine.read_buffers(program.state[path], program.t_seconds, pcm)})
    torch.cuda.synchronize()
    read_buf_s = time.perf_counter() - t0
    acfg = dataclasses.replace(program.cfg, resample_read_noise=True)
    program_rs = dataclasses.replace(program, params=params_rs, cfg=acfg)
    w = engine.cast_weights(params_rs, cfg.dtype)
    plan = engine.build_fused_plan(program_rs)
    served = ctx["served"]
    fcache, cur = fused_cache_from_trace(torch, served, plan, trace)
    dec = df.FusedDecoder(w, plan, cfg, acfg, SLOTS, 512)
    key = prng.fold_in(prng.PRNGKey(ctx["seed"] + 3), 0)
    res = {"read_buffers_s": read_buf_s}
    lcache = lambda: ([(KVCache(fcache.k[g].clone(), fcache.v[g].clone(),
                                fcache.length.clone()),) for g in range(plan.n_groups)], ())
    fclone = lambda: KVCache(fcache.k.clone(), fcache.v.clone(), fcache.length.clone())
    logits = {}
    for name in ("per_layer", "fused", "per_layer_frozen"):
        caches = [lcache() if name != "fused" else fclone() for _ in range(3)]
        times = []
        for c in caches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "fused":
                lg, _ = dec.step(cur, c, key)
            else:
                lg, _ = lm_forward(w, {"tokens": cur}, acfg, cfg, cache=c,
                                   rng=None if name == "per_layer_frozen" else key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        logits[name] = lg
        res[f"{name}_step_ms"] = min(times)
    res["full_width_steps_equal"] = bool(torch.equal(logits["per_layer"], logits["fused"]))
    res["resampled_differs_from_frozen"] = bool(not torch.equal(logits["per_layer"],
                                                                logits["per_layer_frozen"]))
    log(f"resampled read noise, full width, one step at 8 slots: per layer "
        f"{res['per_layer_step_ms']:.1f} ms, fused {res['fused_step_ms']:.1f} ms (the same "
        f"step with the frozen draw, per layer: {res['per_layer_frozen_step_ms']:.1f} ms; "
        f"read buffers built in {read_buf_s:.2f} s); per layer == fused "
        f"{res['full_width_steps_equal']}, differs from the frozen chip "
        f"{res['resampled_differs_from_frozen']}")
    del dec, w, params_rs, program_rs, fcache
    gc.collect()
    torch.cuda.empty_cache()
    # the trace at a cut depth, resampling every MVM of every step
    depth = RESAMPLE_DEPTH
    res["trace_depth"] = depth
    params2 = ctx["params"]._replace(blocks=(first(ctx["params"].blocks[0], depth),))
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    prog2 = engine.compile_program(params2, AnalogConfig(resample_read_noise=True).infer(
        b_adc=8), prng.PRNGKey(ctx["seed"] + 1), device=DEV)
    toks = {}
    for fused in (False, True):
        eng = ServingEngine.for_program(
            prog2, cfg2, ServingConfig(n_slots=SLOTS, s_max=512, fused_decode=fused),
            rng=prng.PRNGKey(ctx["seed"] + 3), device=DEV)
        events0 = engine.program_event_count()
        reset_counts()
        # a virtual clock: each step's key is fold_in(rng, step), so the
        # tokens depend on the step a request is admitted at (as in phase 11)
        steps_s = []
        decode_main = eng.decode_main

        def timed_step(*a):
            t0 = time.perf_counter()
            out = decode_main(*a)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
            return out

        eng.decode_main = timed_step
        rep = eng.run(trace, clock=clock.VirtualClock())
        torch.cuda.synchronize()
        name = "fused" if fused else "per_layer"
        res[f"trace_{name}"] = {
            "ms_per_decode_step": 1e3 * sum(steps_s) / max(len(steps_s), 1),
            "decode_steps": rep.n_steps, "program_events": engine.program_event_count() - events0,
            "decode_fused_launches": df.launches, "normal_launches": prng.launches}
        toks[name] = {r.rid: r.tokens.tolist() for r in rep.records}
        del eng
        gc.collect()
    res["trace_requests_same_tokens"] = sum(toks["fused"][rid] == t
                                             for rid, t in toks["per_layer"].items())
    log(f"resampled read noise, depth {depth}, the trace: per layer "
        f"{res['trace_per_layer']['ms_per_decode_step']:.2f} ms/step, fused "
        f"{res['trace_fused']['ms_per_decode_step']:.2f} ms/step "
        f"({res['trace_fused']['decode_fused_launches']} fused launches, "
        f"{res['trace_fused']['normal_launches']} normal draws); requests with the same "
        f"tokens {res['trace_requests_same_tokens']}/{len(trace)}")
    check(res["full_width_steps_equal"] and res["resampled_differs_from_frozen"],
          "a resampled step: per layer == fused, and a fresh draw")
    check(res["trace_requests_same_tokens"] == len(trace)
          and res["trace_per_layer"]["program_events"] == 0
          and res["trace_fused"]["program_events"] == 0
          and res["trace_fused"]["decode_fused_launches"] == res["trace_fused"]["decode_steps"],
          "resampled serving: the same tokens per layer and fused, no programming")
    return res



# --------------------------------------------------------------- fleet


def read_counts() -> dict:
    """Every launch count of the fleet's path since the last reset_counts:
    B1 by design, B3, the row kernels, the normal draw and B2."""
    from repro_torch import prng
    from repro_torch.kernels import analog_mvm, decode_fused, flash_attention
    from repro_torch.kernels import decode_rows as dr

    return {"b1_designs": dict(analog_mvm.analog_mvm.design_launches),
            "b3": flash_attention.flash_attention.launches, "rows": dict(dr.launches),
            "prng": prng.launches, "b2": decode_fused.launches}


def fleet_expected(rep, trace, cfg, refresh_draws: int) -> dict:
    """The launches a fleet run's work makes one at a time (``read_counts``'s
    keys): every admission prefills once on its chip (layer projections at
    M = its prompt's length, lm_head at M = 1) and once digitally (B3 per
    layer both times); an admission is a chip's retired record, or a
    request drained live from its first chip (its continuation's prompt is
    longer than the request's); every decode step runs ``cfg``'s
    projections (7 a layer and the lm_head) at M = 8 and the row kernels
    of a forward, chip and digital lockstep; every reprogram draws
    ``refresh_draws`` normals."""
    from repro_torch.kernels import analog_mvm as kernel

    design = lambda m: "decode" if m <= kernel.DECODE_MAX_M else "prefill"
    prompts = [r.n_prompt for chip in rep.per_chip for r in chip.records]
    for rec in rep.records:
        if rec.migrations:
            dest = next(r for r in rep.per_chip[rec.chips[-1]].records if r.rid == rec.rid)
            if dest.n_prompt > rec.n_prompt:
                prompts.append(rec.n_prompt)
    steps = sum(chip.n_steps for chip in rep.per_chip)
    per_forward = MVMS_PER_BLOCK["attn"] * cfg.n_layers + 1
    designs = dict.fromkeys(kernel.DESIGNS, 0)
    for n in prompts:
        designs[design(n)] += per_forward - 1
        designs[design(1)] += 1
    designs[design(SLOTS)] += per_forward * steps
    return {"b1_designs": designs, "b3": 2 * cfg.n_layers * len(prompts),
            "rows": {k: 2 * v * steps for k, v in rows_per_forward(cfg).items()},
            "prng": refresh_draws * rep.reprograms, "b2": 0}


def refresh_draws(torch, program, params) -> int:
    """Normal-draw launches of one full-width reprogram of ``program`` (from
    ``params``): one layer member's programming and evaluation on the card,
    times the chip's member chunks (a member above ``engine._CHUNK`` weights
    draws chunk by chunk: the lm_head in 4) -- a check's launches, not the
    main path's: the count is restored."""
    from repro_torch import prng
    from repro_torch.core import engine
    from repro_torch.core import pcm as pcm_lib

    node = params.blocks[0]["attn"]["wk"]
    before = prng.launches
    st = engine._program_2d(prng.PRNGKey(0).to(DEV), node["w"][0], node["w_clip_buf"][0, 0],
                            node["w_clip_buf"][0, 1], program.cfg.pcm)
    engine._drift_read_2d(st, pcm_lib.T_C, program.cfg.pcm)
    per_member = prng.launches - before
    prng.launches = before
    chunks = sum((int(v["g_pos"].shape[0]) if v["g_pos"].dim() == 3 else 1)
                 * len(engine._chunks(*v["g_pos"].shape[-2:])) for v in program.state.values())
    return per_member * chunks


def refreshed_chip_check(torch, router, rep, params, cfg) -> dict:
    """The refreshed chip is the CPU bridge's draw: its reprogram key,
    ``fold_in(fold_in(router.rng, 8_000_000 + tick), chip)``, walked to
    layer 0's wk (``fold_in`` by walk position, ``split`` by member) and
    programmed and evaluated at t_c on the CPU, bitwise the card's state,
    effective weights and GDC scalar of member 0."""
    from repro_torch import prng
    from repro_torch.core import engine

    ev = next(e for e in rep.events if e["kind"] == "reprogram")
    chip = router.engines[ev["chip"]].program
    path = "blocks/0/attn/wk"
    st, node = chip.state[path], params.blocks[0]["attn"]["wk"]
    key = prng.fold_in(prng.fold_in(router.rng, 8_000_000 + ev["tick"]), ev["chip"])
    k0 = prng.split(prng.fold_in(key, list(chip.state).index(path) + 1), st["g_pos"].shape[0])[0]
    pcm = chip.cfg.pcm
    cpu = engine._program_2d(k0, node["w"][0].cpu(), node["w_clip_buf"][0, 0].float().cpu(),
                             node["w_clip_buf"][0, 1].float().cpu(), pcm)
    w_cpu, gdc_cpu = engine._drift_read_2d(cpu, chip.t_seconds, pcm)
    served = chip.params.blocks[0]["attn"]["wk"]
    res = {name: bool(torch.equal(cpu[name], st[name][0].cpu()))
           for name in ("g_pos", "g_neg", "q_pos", "q_neg", "gt_sum", "w_scale", "key")}
    res["w_eff"] = bool(torch.equal(w_cpu.to(served["w"].dtype), served["w"][0].cpu()))
    res["gdc"] = bool(torch.equal(gdc_cpu, served["out_scale_buf"][0].cpu()))
    res["t_seconds"] = chip.t_seconds
    return res


def profiled_window(torch, fn, start_s: float, window_s: float) -> tuple:
    """Run ``fn`` on a thread of its own (the fleet's threads hang off it)
    and profile the card for ``window_s`` seconds from ``start_s`` into the
    run: the device's idle share over the window is 1 - (union of every
    stream's device activity within it) / its length. Returns (fn's result,
    idle share or "not measured" when the run ended first or the profiler
    saw no device activity)."""
    import threading

    from torch.profiler import ProfilerActivity, profile, record_function

    out, err, done = {}, [], threading.Event()

    def target():
        try:
            out["result"] = fn()
        except BaseException as e:  # re-raised on the calling thread below
            err.append(e)
        finally:
            done.set()

    th = threading.Thread(target=target)
    th.start()
    idle = "not measured"
    if not done.wait(start_s):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("fleet_window"):
                ended = done.wait(window_s)
        if not ended:
            events = prof.events()
            win = next(e for e in events if e.name == "fleet_window")
            lo, hi = win.time_range.start, win.time_range.end
            dev = [e for e in events if str(e.device_type).endswith("CUDA")]
            spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                           for e in dev if e.time_range.end > lo and e.time_range.start < hi)
            log(f"fleet: profiled window {(hi - lo) / 1e3:.1f} ms, device events {len(dev)}, "
                f"{len(spans)} of them in the window")
            if spans:
                busy, cur_s, cur_e = 0.0, *spans[0]
                for a, b in spans[1:]:
                    if a > cur_e:
                        busy += cur_e - cur_s
                        cur_s, cur_e = a, b
                    else:
                        cur_e = max(cur_e, b)
                busy += cur_e - cur_s
                idle = round(1 - busy / max(hi - lo, 1e-9), 4)
    th.join()
    if err:
        raise err[0]
    return out["result"], idle


def phase_fleet(torch, ctx) -> dict:
    """Fleet and async serving at full width: 3 replicas of phase 4's chip
    cut to SHALLOW_DEPTH layers (``shallow_chip``; ``FleetRouter.from_program``:
    they share its tensors) behind one router, engines as phase 4's with the
    digital lockstep, the trace of phase 4.

    (a) Storm, deterministic on a virtual clock: chip 0 is drained at
    FLEET_DRAIN_TICK with live requests, which migrate to its siblings,
    and reprogrammed after ``refresh_steps`` ticks. Gates: every request
    retires once with its budget; >= 1 in-flight migration; one reprogram
    and its programming events only; each migrated remainder bitwise what
    a 1-slot engine over the destination chip serves from the continuation
    alone (the reference's oracle: a head's attention sums do not depend on
    the slot count or s_max); the refreshed chip bitwise
    the CPU bridge's draw from its key; launches exactly the work's
    (``fleet_expected``); no plain version.
    (b) The trace without a refresh through ``AsyncFleetRouter``,
    deterministic on a virtual clock and threaded (one worker thread and
    one CUDA stream per chip) on the host's clock, in turns (det, thr, thr,
    det): every request's tokens equal across the four, launches exactly
    each run's work (no count lost under threads); tokens/s, latency, TTFT,
    wall, the device's idle share over a profiled window and peak memory
    of each.
    (c) The launch counts by kernel, printed and recorded."""
    import numpy as np

    from repro_torch import clock, prng
    from repro_torch.core import engine
    from repro_torch.core import pcm as pcm_lib
    from repro_torch.serving import (AsyncFleetRouter, FleetConfig, FleetRouter, Request,
                                     ServingConfig, ServingEngine)

    params, cfg, program = shallow_chip(torch, ctx)
    trace = ctx["trace"]
    # the lockstep's weights cast to the model's dtype once, so every
    # replica shares them
    ref_params = engine.cast_weights(params, cfg.dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    scfg = ServingConfig(n_slots=SLOTS, s_max=512)
    fcfg = FleetConfig(**FLEET)
    draws = refresh_draws(torch, program, params)
    budget = {r.rid: r.max_new_tokens for r in trace}

    def build(cls):
        router = cls.from_program(program, cfg, scfg, fcfg, ref_params=ref_params,
                                  src_params=params, rng=prng.PRNGKey(ctx["seed"] + 9))
        ptrs = lambda e: (e.params.blocks[0]["attn"]["wq"]["w"].data_ptr(),
                          e.ref_params.blocks[0]["attn"]["wq"]["w"].data_ptr(),
                          e.program.state["blocks/0/attn/wq"]["g_pos"].data_ptr())
        check(len({ptrs(e) for e in router.engines}) == 1
              and ptrs(router.engines[0])[1] == ref_params.blocks[0]["attn"]["wq"]["w"].data_ptr()
              and ptrs(router.engines[0])[2]
              == program.state["blocks/0/attn/wq"]["g_pos"].data_ptr(),
              "the replicas share the chip's state, its cast weights and the lockstep's")
        return router

    def conserved(rep) -> bool:
        return (len(rep.records) == len(trace) and {r.rid for r in rep.records} == set(budget)
                and all(r.n_new == budget[r.rid] for r in rep.records))

    # (a) the storm; chip 0's refresh reads the card's memory around itself
    router = build(FleetRouter)
    gib = lambda b: b / 2**30
    mem = {"before_phase": gib(mem0)}

    def measured(refresh):
        # only the engine refers to the wrapper, so its chip goes with it
        def measured_refresh(key):
            torch.cuda.synchronize()
            mem["peak_before_refresh"] = gib(torch.cuda.max_memory_allocated())
            mem["at_refresh"] = gib(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = refresh(key)
            torch.cuda.synchronize()
            mem["refresh_s"] = time.perf_counter() - t0
            mem["refresh_peak"] = gib(torch.cuda.max_memory_allocated())
            mem["after_refresh"] = gib(torch.cuda.memory_allocated())
            return out
        return measured_refresh

    router.engines[0].refresh = measured(router.engines[0].refresh)
    events0 = engine.program_event_count()
    reset_counts()
    t0 = time.perf_counter()
    rep = router.run(trace, force_refresh={FLEET_DRAIN_TICK: 0}, clock=clock.VirtualClock(),
                     max_ticks=10_000)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t0
    mem["storm_peak"] = max(mem["peak_before_refresh"], gib(torch.cuda.max_memory_allocated()))
    mem["after_storm"] = gib(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    counts, n_plain = read_counts(), plain_calls()
    events = engine.program_event_count() - events0
    expected = fleet_expected(rep, trace, cfg, draws)
    by_rid = {r.rid: r for r in trace}
    migrated = [r for r in rep.records if r.migrations]
    live = []  # (record, destination chip, its record there, prefix length)
    for rec in migrated:
        dest = next(r for r in rep.per_chip[rec.chips[-1]].records if r.rid == rec.rid)
        if dest.n_prompt > rec.n_prompt:
            live.append((rec, rec.chips[-1], dest, dest.n_prompt - rec.n_prompt))
    oracles, solos = [], {}
    t0 = time.perf_counter()
    for rec, chip, dest, k in live:
        if chip not in solos:  # over the destination's chip and its cast weights
            dst = router.engines[chip].program
            solos[chip] = ServingEngine(cfg, dst.cfg, router.engines[chip].params,
                                        ServingConfig(n_slots=1, s_max=scfg.s_max),
                                        program=dst, device=DEV)
        req = by_rid[rec.rid]
        cont = Request(rid=900_000 + rec.rid, max_new_tokens=req.max_new_tokens - k,
                       prompt=np.concatenate([req.prompt, rec.tokens[:k].astype(np.int32)]))
        alone = solos[chip].run([cont]).tokens_of(cont.rid)
        oracles.append({"rid": rec.rid, "chips": list(rec.chips), "prefix": k,
                        "remainder": len(alone),
                        "equal": bool(np.array_equal(alone, dest.tokens))
                        and bool(np.array_equal(rec.tokens[k:], dest.tokens))})
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    mem["oracle_peak"] = gib(torch.cuda.max_memory_allocated())
    mem["after_oracles"] = gib(torch.cuda.memory_allocated())
    bridge = refreshed_chip_check(torch, router, rep, params, cfg)
    refreshed = router.engines[0]
    storm = {"wall_s": storm_s, "virtual_wall_s": rep.wall, "ticks": rep.n_ticks,
             "summary": rep.summary(), "events": rep.events, "windows": rep.windows,
             "min_window_agreement": rep.min_window_agreement,
             "min_down_window_agreement": rep.min_down_window_agreement,
             "top1_agreement": rep.counters["top1"], "migrated": rep.n_migrated,
             "in_flight_migrations": len(live), "oracles": oracles, "oracle_s": oracle_s,
             "refreshed_chip_vs_cpu_bridge": bridge, "program_events": events,
             "launches": counts, "launches_expected": expected, "plain_calls": n_plain,
             "tokens_per_s": rep.n_generated / storm_s, "decode_steps":
             [c.n_steps for c in rep.per_chip], "memory_gib": mem,
             "peak_memory_gib": max(mem["storm_peak"], mem["oracle_peak"])}
    log(f"fleet: storm {rep.summary()}")
    log(f"fleet: storm wall {storm_s:.1f} s ({rep.n_generated / storm_s:.1f} tokens/s on the "
        f"host's clock), decode steps per chip {storm['decode_steps']}, events {rep.events}, "
        f"in-flight migrations {len(live)}, oracles {oracles} ({oracle_s:.1f} s), refreshed "
        f"chip vs CPU bridge {bridge}, programming events {events}, peak memory "
        f"{storm['peak_memory_gib']:.1f} GiB")
    log("fleet: storm memory (GiB allocated): " + ", ".join(
        f"{k} {v:.2f}" if k != "refresh_s" else f"refresh {v:.2f} s" for k, v in mem.items()))
    log(f"fleet: storm launches {counts} (expected {expected}), plain calls {n_plain}")
    check(conserved(rep), "fleet storm: every request retires once with its full budget")
    check(len(live) >= 1, "fleet storm: at least one in-flight migration")
    check(rep.reprograms == 1 and refreshed.reprograms == 1 and rep.program_events_delta == 0
          and events == program.n_layers and [e["kind"] for e in rep.events]
          == ["drain", "reprogram"] and all(e["chip"] == 0 for e in rep.events)
          and refreshed.program.t_seconds == pcm_lib.T_C and refreshed.program.chip_id == 0,
          "fleet storm: chip 0 drained and reprogrammed once; programming events only from it")
    check(all(o["equal"] for o in oracles), "fleet storm: every migrated remainder bitwise "
          "the destination chip's serving of the continuation alone")
    check(all(v for k, v in bridge.items() if k != "t_seconds"),
          "fleet storm: the refreshed chip is the CPU bridge's draw")
    check(counts == expected, "fleet storm: launches exactly the work's")
    check(n_plain == 0, "fleet storm: no plain-version call")
    del router, solos, refreshed
    gc.collect()
    torch.cuda.empty_cache()

    # (b) deterministic against threaded, in turns
    router = build(AsyncFleetRouter)
    runs, tokens = [], []
    for mode in ("deterministic", "threaded", "threaded", "deterministic"):
        det = mode == "deterministic"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rep, idle = profiled_window(
            torch, lambda: router.serve(trace, deterministic=det,
                                        clock=clock.VirtualClock() if det else None),
            *FLEET_WINDOW_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, n_plain = read_counts(), plain_calls()
        expected = fleet_expected(rep, trace, cfg, draws)
        run = {"mode": mode, "wall_s": wall, "tokens_per_s": rep.n_generated / wall,
               "clock": "virtual" if det else "host",
               "latency_p50_s": rep.latency_s(50), "latency_p95_s": rep.latency_s(95),
               "ttft_p50_s": rep.ttft_s(50), "ttft_p95_s": rep.ttft_s(95),
               "idle_share_window": idle, "peak_memory_gib": torch.cuda.max_memory_allocated()
               / 2**30, "ticks": rep.n_ticks, "decode_steps": [c.n_steps for c in rep.per_chip],
               "chips_per_request": [list(r.chips) for r in rep.records],
               "top1_agreement": rep.counters["top1"], "launches": counts,
               "launches_expected": expected, "plain_calls": n_plain,
               "conserved": conserved(rep), "program_events_delta": rep.program_events_delta}
        runs.append(run)
        tokens.append({r.rid: r.tokens.tolist() for r in rep.records})
        log(f"fleet: {mode} wall {wall:.2f} s, {run['tokens_per_s']:.1f} tokens/s, latency "
            f"p50 {run['latency_p50_s']:.3f} / p95 {run['latency_p95_s']:.3f} s and TTFT p50 "
            f"{run['ttft_p50_s']:.3f} / p95 {run['ttft_p95_s']:.3f} s ({run['clock']} clock), "
            f"idle share {idle} (window {FLEET_WINDOW_S}), peak memory "
            f"{run['peak_memory_gib']:.1f} GiB, decode steps per chip {run['decode_steps']}, "
            f"launches {counts} (expected {expected})")
        check(run["conserved"] and rep.program_events_delta == 0 and rep.reprograms == 0,
              f"fleet {mode}: every request retires once with its budget, no programming")
        check(counts == expected, f"fleet {mode}: launches exactly the run's work")
        check(n_plain == 0, f"fleet {mode}: no plain-version call")
    same = sum(all(t[rid] == tokens[0][rid] for t in tokens) for rid in budget)
    det_s = [r["wall_s"] for r in runs if r["mode"] == "deterministic"]
    thr_s = [r["wall_s"] for r in runs if r["mode"] == "threaded"]
    speedup = (sum(det_s) / len(det_s)) / (sum(thr_s) / len(thr_s))
    log(f"fleet: threaded == deterministic tokens for {same} of {len(budget)} requests; "
        f"threaded speedup {speedup:.3f}x (mean deterministic {sum(det_s) / 2:.2f} s over "
        f"mean threaded {sum(thr_s) / 2:.2f} s, host's clock)")
    check(same == len(budget), "fleet: threaded tokens == deterministic tokens")
    del router
    gc.collect()
    torch.cuda.empty_cache()
    total = {"b1_designs": {}, "b3": 0, "rows": {}, "prng": 0}
    for c in [storm["launches"]] + [r["launches"] for r in runs]:
        for k in ("b1_designs", "rows"):
            for name, v in c[k].items():
                total[k][name] = total[k].get(name, 0) + v
        total["b3"] += c["b3"]
        total["prng"] += c["prng"]
    res = {"config": {"n_chips": fcfg.n_chips, "refresh_steps": fcfg.refresh_steps,
                      "drain_tick": FLEET_DRAIN_TICK, "slots": SLOTS, "s_max": 512,
                      "requests": len(trace), "window_s": list(FLEET_WINDOW_S)},
           "refresh_draws": draws, "storm": storm, "runs": runs,
           "requests_same_tokens": same, "threaded_speedup": speedup, "launches": total,
           "memory_before_gib": mem0 / 2**30,
           "peak_memory_gib": max([storm["peak_memory_gib"]]
                                  + [r["peak_memory_gib"] for r in runs])}
    log(f"fleet: launches over the phase {total}; peak memory {res['peak_memory_gib']:.1f} GiB "
        f"(phase 4's chip and the rest held before it: {mem0 / 2**30:.1f} GiB)")
    check(all(total["b1_designs"][d] for d in ("decode", "prefill")) and total["b3"]
          and all(total["rows"].values()) and total["prng"],
          "fleet: the path launched B1 (both designs), B3, every row kernel and the normal draw")
    return res


# --------------------------------------------------------------- slice 8: the CNNs


def cnn_step(layer: dict, bits: int) -> float:
    """One ADC step of a programmed CNN layer's output (its GDC scale in)."""
    return ((abs(float(layer["r_adc"])) + 1e-9) / (2 ** (bits - 1) - 1)
            * float(layer["out_scale_buf"]))


def cnn_forward_check(torch, prog, cfg, x) -> dict:
    """One programmed forward of ``x`` through B1 against the same forward
    through the plain version on the card (``AnalogCtx.mvm`` =
    ``engine.execute_mvm_plain``): every layer's ADC outputs, each layer fed
    the plain chain's input, under ``compare``'s tolerance model (worst ADC
    steps, worst share of outputs more than half a step off); then the
    whole forward's logits: rel L2, max |diff| in the FC's ADC steps, argmax
    agreement, and whether every disagreement is a tie (the plain logits'
    top two within the row's own |diff|)."""
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogCtx, analog_matmul
    from repro_torch.models import analognet as an

    p, bits = prog.params, prog.cfg.b_adc
    ctx_k = AnalogCtx(cfg=prog.cfg, gain_s=p["gain_s"])
    ctx_p = AnalogCtx(cfg=prog.cfg, gain_s=p["gain_s"], mvm=engine.execute_mvm_plain)
    layers, h = {}, x
    for spec in cfg.convs:
        y_k = an.conv_apply(p[spec.name], h, spec, ctx_k, relu=False)
        y_p = an.conv_apply(p[spec.name], h, spec, ctx_p, relu=False)
        layers[spec.name] = compare(y_k, y_p, cnn_step(p[spec.name], bits), 1, False)
        h = torch.relu(y_p)
    fc, pooled = p["fc"], h.mean(dim=(1, 2))
    kw = dict(r_adc=fc["r_adc"], w_min=fc["w_clip_buf"][0], w_max=fc["w_clip_buf"][1],
              out_scale=fc["out_scale_buf"])
    layers["fc"] = compare(analog_matmul(pooled, fc["w"], ctx=ctx_k, **kw),
                           analog_matmul(pooled, fc["w"], ctx=ctx_p, **kw),
                           cnn_step(fc, bits), 1, False)
    logits = an.cnn_apply(p, x, prog.cfg, cfg)
    plain = an.cnn_apply(p, x, prog.cfg, cfg, mvm=engine.execute_mvm_plain)
    d = (logits - plain).abs()
    top_k, top_p = logits.argmax(-1), plain.argmax(-1)
    gap = plain.gather(1, top_p[:, None])[:, 0] - plain.gather(1, top_k[:, None])[:, 0]
    ties_ok = bool(((top_k == top_p) | (gap <= d.max(dim=1).values)).all())
    out = {"layers_ok": all(r["ok"] for r in layers.values()),
           "worst_adc_steps": max(r["max_steps"] for r in layers.values()),
           "worst_share_half_step": max(r["frac_half_step"] for r in layers.values()),
           "logits_rel_l2": float((logits - plain).norm() / plain.norm().clamp(min=1e-30)),
           "logits_max_fc_steps": float(d.max()) / cnn_step(fc, bits),
           "argmax_agreement": float((top_k == top_p).float().mean()),
           "argmax_differs_only_at_ties": ties_ok,
           "finite": bool(logits.isfinite().all()), "shape": list(logits.shape)}
    out["ok"] = (out["layers_ok"] and ties_ok and out["finite"]
                 and out["logits_max_fc_steps"] <= 4.0)
    return out


def cnn_serve(torch, prog, cfg, stream, sweep) -> dict:
    """The phase's traffic on one chip, counted: the always-on stream, one
    image per ``cnn_apply`` call, then the sweep batch: one cold call (the
    first at the sweep's shapes, which allocates its im2col buffers) and
    ``CNN_SWEEP_REPS`` warm calls. Each call is timed on the host clock to
    its synchronize: the stream's median ms per inference, the sweep's cold
    call and its median warm call; B1's launches by design and the plain
    versions' calls of this run only."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models import analognet as an

    def timed(x) -> float:
        t0 = time.perf_counter()
        an.cnn_apply(prog.params, x, prog.cfg, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    reset_counts()
    stream_ms = [timed(stream[i:i + 1]) for i in range(stream.shape[0])]
    cold_ms = timed(sweep)
    warm_ms = [timed(sweep) for _ in range(CNN_SWEEP_REPS)]
    sweep_ms = statistics.median(warm_ms)
    return {"stream_ms_per_inference": statistics.median(stream_ms), "stream_ms": stream_ms,
            "sweep_cold_ms": cold_ms, "sweep_ms_readings": warm_ms, "sweep_ms": sweep_ms,
            "sweep_ms_per_inference": sweep_ms / sweep.shape[0],
            "calls": stream.shape[0] + 1 + CNN_SWEEP_REPS,
            "b1_designs": dict(kernel.analog_mvm.design_launches), "plain_calls": plain_calls()}


def cnn_timing(torch, gen, cfg, batches, parent=None) -> dict:
    """B1 at every programmed-MVM shape of one forward of ``cfg`` at each
    batch, fp32 (TF32 off): the kernel (the tiled design) in turns with its
    parent, the ``gemv`` design (``turns_ms``), then its plain version and
    torch.matmul, timed by CUDA-graph replay, summed over the forward beside
    the bound (``mvm_bound`` at fp32 over the CUDA cores' peak). The weights
    stay in L2 as in serving (the whole model is ~1.3 MB)."""
    from repro_torch.core import engine
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models.analognet import mvm_shapes

    r_adc = torch.tensor(1.5, device=DEV)
    out_scale = torch.tensor(0.97, device=DEV)
    spec = QuantSpec(b_adc=8)
    out = {}
    for batch in batches:
        rows = []
        for name, m, k, n in mvm_shapes(cfg, batch):
            x = torch.randn((m, k), generator=gen, device=DEV)
            w = torch.randn((k, n), generator=gen, device=DEV) * k**-0.5
            n_iter = 20
            kw = dict(r_adc=r_adc, out_scale=out_scale, b_adc=8)
            run_k = lambda i: kernel.analog_mvm(x, w, **kw)
            run_g = lambda i: kernel._launch("gemv", x, w, lib=parent, **kw)
            run_p = lambda i: engine.tile_matmul_quant(x, w, r_adc, spec, 1024, True, out_scale)
            run_l = lambda i: torch.matmul(x, w)
            t = turns_ms(run_k, run_g, n_iter)
            ms_p, ms_l = time_ms(run_p, n_iter), time_ms(run_l, n_iter)
            bound = mvm_bound(m, k, n, esz=4, peak=FP32_OPS)
            rows.append({"layer": name, "M": m, "K": k, "N": n, **t,
                         "design": kernel.select_design(x.dtype, m, k, n),
                         "plain_ms": ms_p, "library_ms": ms_l,
                         "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                         "flops": bound["flops"], "bytes": bound["bytes"]})
        tot = {key: sum(r[key] for r in rows) for key in ("ms", "gemv_ms", "plain_ms",
                                                          "library_ms", "bound_ms", "flops",
                                                          "bytes")}
        t_ops, t_bytes = tot["flops"] / FP32_OPS, tot["bytes"] / HBM_BYTES_PER_S
        tot["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        tot["launches"] = len(rows)
        out[batch] = {"per_forward": tot, "layers": rows}
        log(f"cnn: B1 {cfg.name} at {batch} image(s), one forward ({len(rows)} launches, fp32 "
            f"tiled): kernel {tot['ms']:.4f} ms, its parent (gemv, in turns"
            f"{', the parent build' if parent else ''}) {tot['gemv_ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, torch.matmul {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}, {tot['bound_ms'] / tot['ms']:.1%} of "
            "bound); per layer (ms kernel/gemv/matmul/bound): "
            + ", ".join(f"{r['layer']} {r['ms']:.4f}/{r['gemv_ms']:.4f}/{r['library_ms']:.4f}/"
                        f"{r['bound_ms']:.4f}" for r in rows))
    return out


def phase_cnn(torch, gen, seed: int, accuracy: dict, launched: set, parent=None) -> dict:
    """The paper's CNN path at full width (the models its headline numbers
    come from): AnalogNet-KWS and AnalogNet-VWW (``configs.get``), weights
    from ``cnn_init(prng.PRNGKey(seed))``, each programmed on the card
    through its crossbar transforms with its mapping (b_adc 8, t = 25 s):

    - the bridge: the second conv's block programmed again on the CPU from
      its key, its state, effective weights and GDC bitwise the card's; the
      mapping equal to the packing of the model's own layer table; the
      mappings' utilization printed;
    - serving through ``cnn_apply``, every conv and the FC a B1 launch (the
      fp32 ``tiled`` design): the always-on stream (single-image calls) and
      one sweep batch (``CNN_TRAFFIC``), counted (main path: one launch per
      layer per call, all ``tiled``, no plain version), then held against
      the plain version on the card (``cnn_forward_check``);
    - images of the sweep served alone: their logits bitwise their rows of
      the sweep's (``cnn_alone_vs_sweep``);
    - the chip aged to 24 h (``age_program``: no programming event), the
      sweep served again and held;
    - the sweep at b_adc 4 on a chip programmed at 4 bits, held;
    - one sweep forward and one single-image call profiled: B1's share of
      the device time and the device's idle share;
    - the stream and the sweep served in turns through the tiled design
      and its parent, the ``gemv`` design (``cnn_serve_turns``), host
      clock;
    - B1 at every key this phase added to ``launched`` (the serving
      phases' record, ``record_b1_shapes``) checked as phase 3 checks
      (``check_launched_b1``, the worst errors in a record of the phase's
      own), and timed per forward beside the bound and, in turns, its
      parent (``cnn_timing``)."""
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import crossbar, engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models import analognet as an

    res, before = {"models": {}}, set(launched)
    total = {"tiled": 0, "prng": 0}
    for arch, n_stream, n_sweep in CNN_TRAFFIC:
        cfg = get(arch)
        per = len(cfg.convs) + 1
        acfg = AnalogConfig().infer(b_adc=8, t_seconds=CNN_AGES[0])
        kw = dict(transforms=an.crossbar_transforms(cfg), with_mapping=True)
        reset_counts()
        t0 = time.perf_counter()
        params = an.cnn_init(prng.PRNGKey(seed), cfg, device=DEV)
        prog = engine.compile_program(params, acfg, prng.PRNGKey(seed + 1), device=DEV, **kw)
        torch.cuda.synchronize()
        program_s = time.perf_counter() - t0
        total["prng"] += prng.launches
        # the bridge: one layer (the second conv, walk index 2) programmed
        # again on the CPU from its key, and the mapping packed from the
        # model's own layer table
        t0 = time.perf_counter()
        spec = cfg.convs[1]
        w_cpu = an.cnn_init(prng.PRNGKey(seed), cfg, device="cpu")[spec.name]
        w_eff, gdc, st = engine.program_weight(
            prng.fold_in(prng.PRNGKey(seed + 1), 2), kw["transforms"][spec.name](w_cpu["w"]),
            w_cpu["w_clip_buf"][0], w_cpu["w_clip_buf"][1], acfg.t_seconds, acfg.pcm)
        cpu_s = time.perf_counter() - t0
        card_st = {k: v.cpu() for k, v in prog.state[spec.name].items()}
        same = {"state": card_st.keys() == st.keys()
                and all(torch.equal(card_st[k], st[k]) for k in st),
                "w_eff": torch.equal(prog.params[spec.name]["w"].cpu(), w_eff),
                "gdc": torch.equal(prog.params[spec.name]["out_scale_buf"].cpu(), gdc)}
        table = crossbar.map_layers([crossbar.LayerShape(name, k, n, 1)
                                     for name, _, k, n in an.mvm_shapes(cfg)])
        same["mapping"] = (crossbar.mapping_to_dict(prog.mapping)
                           == crossbar.mapping_to_dict(table))
        util = {"utilization": prog.mapping.utilization, "occupancy": prog.mapping.occupancy,
                "arrays": prog.mapping.n_arrays}
        log(f"cnn: {arch} programmed on the card in {program_s:.2f} s (weights + program "
            f"phase, {prng.launches} normal-draw launches); its {spec.name} programmed again "
            f"on the CPU in {cpu_s:.2f} s; card == CPU bridge: {same}; mapping: "
            f"{len(prog.mapping.placements)} blocks on {util['arrays']} array(s), utilization "
            f"{util['utilization']:.4f}, occupancy {util['occupancy']:.4f}")
        check(all(same.values()), f"cnn {arch}: the card's chip is the CPU bridge's, bitwise")
        if arch == MESH_CNN:  # phase 18 programs it again through shardings=
            res["mesh_reference"] = {"digest": program_digest(torch, prog),
                                     "mapping": crossbar.mapping_to_dict(prog.mapping)}
        shape = cfg.input_hw + (cfg.in_channels,)
        stream = prng.normal(prng.PRNGKey(seed + 2).to(DEV), (n_stream,) + shape)
        sweep = prng.normal(prng.PRNGKey(seed + 3).to(DEV), (n_sweep,) + shape)
        runs = {}

        def serve_and_check(name, chip, stream_x):
            events = engine.program_event_count()
            r = cnn_serve(torch, chip, cfg, stream_x, sweep)
            r["program_events"] = engine.program_event_count() - events
            r["launches_expected"] = b1_only("tiled", per * r["calls"])
            r["check"] = cnn_forward_check(torch, chip, cfg, sweep)
            runs[name] = r
            total["tiled"] += r["b1_designs"]["tiled"]
            c = r["check"]
            log(f"cnn: {arch} {name}: stream {r['stream_ms_per_inference']:.3f} ms per "
                f"inference (median of {stream_x.shape[0]} calls), sweep of {n_sweep} in "
                f"{r['sweep_ms']:.3f} ms (median of {CNN_SWEEP_REPS} warm calls: "
                f"{r['sweep_ms_per_inference']:.4f} ms per inference; the cold first call "
                f"{r['sweep_cold_ms']:.3f} ms; host clock), B1 launches {r['b1_designs']} (expected "
                f"{r['launches_expected']}), plain calls {r['plain_calls']}, programming "
                f"events {r['program_events']}; vs plain: layers within tolerance "
                f"{c['layers_ok']} (worst {c['worst_adc_steps']:.3f} ADC steps, share > half "
                f"a step {c['worst_share_half_step']:.2e}), logits rel L2 "
                f"{c['logits_rel_l2']:.3e}, max {c['logits_max_fc_steps']:.3f} FC steps, "
                f"argmax agreement {c['argmax_agreement']:.4f} (ties only: "
                f"{c['argmax_differs_only_at_ties']})")
            check(r["b1_designs"] == r["launches_expected"] and r["plain_calls"] == 0,
                  f"cnn {arch} {name}: every layer of every call one tiled B1 launch, no plain "
                  "version")
            check(r["program_events"] == 0, f"cnn {arch} {name}: serving programs nothing")
            check(c["ok"], f"cnn {arch} {name}: kernel forward within the plain version's "
                           f"tolerance: {c}")

        serve_and_check("t25s_b8", prog, stream)
        alone = cnn_alone_vs_sweep(torch, prog, cfg, sweep)
        log(f"cnn: {arch} images of the sweep served alone: {alone}")
        check(alone["bitwise"], f"cnn {arch}: an image's logits alone are its logits in the "
                                f"sweep of {n_sweep}, bitwise: {alone}")
        events = engine.program_event_count()
        t0 = time.perf_counter()
        aged = engine.age_program(prog, CNN_AGES[1])
        torch.cuda.synchronize()
        age_s = time.perf_counter() - t0
        age_events = engine.program_event_count() - events
        log(f"cnn: {arch} aged to {CNN_AGES[1]:.0f} s in {age_s:.3f} s, programming events "
            f"{age_events}")
        check(age_events == 0, f"cnn {arch}: aging programs nothing")
        serve_and_check("t24h_b8", aged, stream[:1])
        del aged
        reset_counts()
        prog4 = engine.compile_program(params, AnalogConfig().infer(b_adc=4, t_seconds=CNN_AGES[0]),
                                       prng.PRNGKey(seed + 1), device=DEV, **kw)
        total["prng"] += prng.launches
        serve_and_check("t25s_b4", prog4, stream[:1])
        del prog4
        prof = {"sweep": profiled(torch, lambda: an.cnn_apply(prog.params, sweep, prog.cfg, cfg)),
                "single": profiled(torch, lambda: an.cnn_apply(prog.params, stream[:1], prog.cfg,
                                                                cfg))}
        for name, pr in prof.items():
            if isinstance(pr["profile_device_ms"], float):
                pr["b1_share_of_device"] = pr["profile_kernel_ms"] / max(pr["profile_device_ms"],
                                                                         1e-9)
            log(f"cnn: {arch} one {name} forward profiled: {pr}")
        turns = cnn_serve_turns(torch, prog, cfg, stream, sweep, parent)
        log(f"cnn: {arch} served in turns, the tiled design against its parent (gemv"
            f"{', the parent build' if parent else ''}) on the same chip and images, host "
            f"clock: stream {turns['stream_ms']} ms per inference (median of "
            f"{stream.shape[0]} calls), sweep of {n_sweep} {turns['sweep_ms']} ms (median of "
            f"{CNN_SWEEP_REPS} warm calls); each [first, second] of gemv, tiled, tiled, gemv")
        res["models"][arch] = {"serve_turns": turns, "program_s": program_s, "cpu_program_s": cpu_s,
                               "bridge": same, "mapping": util, "age_s": age_s,
                               "alone_vs_sweep": alone,
                               "runs": runs, "profile": prof, "stream": n_stream,
                               "sweep": n_sweep}
        del prog, params, stream, sweep
    # B1 at every key this phase launched, as phase 3 checks (its own record)
    keys, by_design = sorted(launched - before), b1_by_design()
    res["b1_check"] = {**check_launched_b1(torch, gen, keys, accuracy, by_design),
                       "by_design": by_design}
    log(f"cnn: B1 vs plain at the {len(keys)} keys the phase launched: worst "
        f"{by_design['tiled']}")
    check(bool(keys) and all(key[4] == "tiled" and key[3] == "float32" for key in keys),
          "cnn: every B1 launch fp32 through the tiled design")
    res["timing"] = {arch: cnn_timing(torch, gen, get(arch), (1, n_sweep), parent)
                     for arch, _, n_sweep in CNN_TRAFFIC}
    res["launches"] = total
    check(total["tiled"] > 0 and total["prng"] > 0,
          "cnn: the path launched B1 (tiled) and the normal draw")
    return res


@contextlib.contextmanager
def b1_through(design: str, lib=None, keep_only: bool = False):
    """Within the block, B1 launches made through the model's entry
    (``kernels.ops.analog_mvm``, which ``engine.execute_mvm`` and the STE
    function look up at call time) run ``design`` through ``_launch``
    (``lib``: a parent's ``gemv`` build), uncounted by the serving phases'
    record (``record_b1_shapes``); with ``keep_only``, only the bf16
    training-form launches (a keep mask), the others left as they are."""
    import torch

    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops

    entry = ops.analog_mvm

    def through(x, w, *, r_adc, r_dac=None, out_scale=1.0, bits=8, tile_rows=1024,
                per_tile_adc=True, keep=None):
        if keep_only and (keep is None or x.dtype != torch.bfloat16):
            return entry(x, w, r_adc=r_adc, r_dac=r_dac, out_scale=out_scale, bits=bits,
                         tile_rows=tile_rows, per_tile_adc=per_tile_adc, keep=keep)
        y = kernel._launch(design, x.reshape(-1, x.shape[-1]).contiguous(), w.contiguous(),
                           r_adc=r_adc, r_dac=r_dac, out_scale=out_scale, b_adc=bits,
                           tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                           keep=None if keep is None else keep.contiguous(),
                           lib=lib if design == "gemv" else None)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    ops.analog_mvm = through
    try:
        yield
    finally:
        ops.analog_mvm = entry


def cnn_serve_turns(torch, prog, cfg, stream, sweep, parent=None) -> dict:
    """The always-on stream (one image a call) and the sweep's warm calls
    served in turns through the tiled design and its parent, the ``gemv``
    design (``b1_through``: the same host path to the launch, only the
    design differs): gemv, tiled, tiled, gemv, each call timed on the host
    clock to its synchronize as ``cnn_serve`` times it. Returns, per
    design, the two runs' medians: ms per stream inference and ms per sweep
    call."""
    from repro_torch.models import analognet as an

    def timed(x) -> float:
        t0 = time.perf_counter()
        an.cnn_apply(prog.params, x, prog.cfg, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def run(design) -> tuple:
        with b1_through(design, parent):
            timed(stream[:1])
            timed(sweep)  # warm-up at both shapes
            return (statistics.median(timed(stream[i:i + 1]) for i in range(stream.shape[0])),
                    statistics.median(timed(sweep) for _ in range(CNN_SWEEP_REPS)))

    torch.cuda.synchronize()
    o1, n1, n2, o2 = run("gemv"), run("tiled"), run("tiled"), run("gemv")
    return {"stream_ms": {"gemv": [o1[0], o2[0]], "tiled": [n1[0], n2[0]]},
            "sweep_ms": {"gemv": [o1[1], o2[1]], "tiled": [n1[1], n2[1]]}}


def cnn_alone_vs_sweep(torch, prog, cfg, sweep, images=(0, 1, 100, -1)) -> dict:
    """A few images of ``sweep`` served alone (one image a ``cnn_apply``
    call, as the always-on stream runs) against their rows of the whole
    sweep's logits and of each layer's B1 outputs, bitwise: the tiled
    design's rows depend on neither M nor its tile shape."""
    from repro_torch.core.analog import AnalogCtx
    from repro_torch.models import analognet as an

    p = prog.params
    ctx = AnalogCtx(cfg=prog.cfg, gain_s=p["gain_s"])
    full = an.cnn_apply(p, sweep, prog.cfg, cfg)
    layers_full, h = [], sweep
    for spec in cfg.convs:
        h = an.conv_apply(p[spec.name], h, spec, ctx)
        layers_full.append(h)
    out = {"images": [], "logits_equal": 0, "layers_equal": 0}
    for i in images:
        i = i % sweep.shape[0]
        x = sweep[i:i + 1]
        out["images"].append(i)
        out["logits_equal"] += int(torch.equal(an.cnn_apply(p, x, prog.cfg, cfg), full[i:i + 1]))
        same, h = True, x
        for spec, hf in zip(cfg.convs, layers_full):
            h = an.conv_apply(p[spec.name], h, spec, ctx)
            same &= torch.equal(h, hf[i:i + 1])
        out["layers_equal"] += int(same)
    out["bitwise"] = out["logits_equal"] == out["layers_equal"] == len(images)
    return out


def cnn_entry(cnn: dict) -> dict:
    """The kernels line's B1 CNN entry: the fp32 tiled design's launches on
    the CNN phase's main-path runs, its worst error at the keys launched,
    and its time per AnalogNet-KWS forward at the sweep batch (the other
    forwards beside it), its parent's (``gemv_ms``) in turns."""
    arch, _, n_sweep = CNN_TRAFFIC[0]
    kws = cnn["timing"][arch][n_sweep]["per_forward"]
    return {
        "name": "analog_mvm.tiled",
        "route": "cuda",
        "source": "src/repro_torch/csrc/analog_mvm_f32.cu",
        "replaces": "src/repro/kernels/analog_mvm.py:41",
        "launches": cnn["launches"]["tiled"],
        "max_abs_err": cnn["b1_check"]["by_design"]["tiled"]["max_abs"],
        "ms": kws["ms"],
        "gemv_ms": kws["gemv_ms"],
        "plain_ms": kws["plain_ms"],
        "bound_ms": kws["bound_ms"],
        "bound_by": kws["bound_by"],
        "library_ms": kws["library_ms"],
        "per": f"one AnalogNet-KWS forward at {n_sweep} images, fp32 with TF32 off: "
               f"{kws['launches']} launches (4 convs as im2col GEMMs, the FC); library: "
               "torch.matmul of the same products; gemv_ms: the CUDA-core gemv design (this "
               "design's parent, analog_mvm.cu) on the same inputs, in turns; launches from the "
               "CNN phase's serving runs; forwards: each model at 1 image and at its sweep batch",
        "forwards": {f"{a}@{b}": t["per_forward"] for a, by in cnn["timing"].items()
                     for b, t in by.items()},
        "max_err_adc_steps": cnn["b1_check"]["by_design"]["tiled"]["max_steps"],
        "pass": cnn["b1_check"]["failures"] == 0,
    }


# --------------------------------------------------------------- training


def train_step_check(torch, seed: int) -> dict:
    """Phase 15 (b): one stage-2 step of AnalogNet-KWS at full width,
    ``TRAIN_KWS["batch"]`` images, from the same params (``cnn_init(seed)``
    with the stage boundary's clip refresh, on the CPU, copied to the
    card), batch and key, three ways: on
    the card through B1 (the main path), on the card through the plain
    training form (``engine.execute_mvm_plain``: the control, which
    differs from the CPU only by the order of its fp32 sums) and on the CPU.
    Gates: every weight-noise draw and quant-noise mask bitwise card ==
    CPU; each layer's ADC outputs, fed the CPU chain's input, within
    ``compare``'s tolerance model; the loss within TRAIN_STEP_LOSS_RTOL;
    each gradient leaf within TRAIN_STEP_GRAD_RTOL relative L2, a range
    leaf (a sum over a layer's every quantizer term, with cancellation)
    else within TRAIN_RANGE_FACTOR times the control's own distance from
    the CPU on that leaf."""
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get
    from repro_torch.core import engine, noise
    from repro_torch.core.analog import AnalogConfig, AnalogCtx, analog_matmul, refresh_clip_ranges
    from repro_torch.core.crossbar import conv_weight_as_matrix, im2col
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops
    from repro_torch.models import analognet as an
    from repro_torch.training.loop import value_and_grad

    cfg = get(TRAIN_KWS["arch"])
    acfg = AnalogConfig().train(eta=0.1, b_adc=8, quant_noise_p=0.5)
    b = batch_at(PipelineConfig(kind="kws", global_batch=TRAIN_KWS["batch"],
                                n_classes=cfg.n_classes, input_hw=cfg.input_hw,
                                channels=cfg.in_channels), 0)
    orig_inject, orig_bern = noise.inject, prng.bernoulli
    # one set of params for all three (the clip refresh's std is a reduction,
    # whose order differs between the devices)
    params_cpu = refresh_clip_ranges(an.cnn_init(prng.PRNGKey(seed), cfg, device="cpu"))
    runs = {}
    for name, dev, mvm in (("cpu", "cpu", None), ("card", DEV, None),
                           ("card_plain", DEV, engine.execute_mvm_plain)):
        params = tree_lib.tree_map(lambda t: t.to(dev), params_cpu)
        xb = torch.as_tensor(b["x"], device=dev)
        yb = torch.as_tensor(b["y"], device=dev).long()
        key = prng.fold_in(prng.PRNGKey(0).to(dev), TRAIN_KWS["stage1"])
        draws = []

        def tap_inject(*a, **k):
            out = orig_inject(*a, **k)
            draws.append(out.detach().cpu())
            return out

        def tap_bern(*a, **k):
            out = orig_bern(*a, **k)
            draws.append(out.cpu())
            return out

        def loss_fn(p):
            logits = an.cnn_apply(p, xb, acfg, cfg, rng=key, mvm=mvm).float()
            return -torch.log_softmax(logits, -1).gather(-1, yb[:, None]).mean(), {}

        noise.inject, prng.bernoulli = tap_inject, tap_bern
        try:
            if dev != "cpu":
                torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            (loss, _), grads = value_and_grad(loss_fn, params)
            if dev != "cpu":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            noise.inject, prng.bernoulli = orig_inject, orig_bern
        runs[name] = {"loss": float(loss), "s": secs, "draws": draws,
                      "grads": {tree_lib.path_name(p): g.cpu()
                                for p, g in tree_lib.flatten_with_path(grads)},
                      "b1_launches": kernel.analog_mvm.launches, "plain_calls": plain_calls(),
                      "backward_calls": ops.backward_calls, "params": params}
    cpu, card, ctrl = runs["cpu"], runs["card"], runs["card_plain"]
    per = len(cfg.convs) + 1
    draws_ok = (len(card["draws"]) == len(cpu["draws"]) == 3 * per
                and all(torch.equal(a, c) for a, c in zip(card["draws"], cpu["draws"])))
    # each layer's ADC outputs on the CPU chain's input, card vs CPU
    layers = {}
    p_cpu, p_card = cpu["params"], card["params"]
    kc = prng.fold_in(prng.PRNGKey(0), TRAIN_KWS["stage1"])
    h = torch.as_tensor(b["x"])
    with torch.no_grad():
        for li, spec in enumerate(cfg.convs + ("fc",)):
            outs = {}
            for dev, p in (("cpu", p_cpu), (DEV, p_card)):
                ctx = AnalogCtx(cfg=acfg, gain_s=p["gain_s"], key=kc.to(dev),
                                layer_counter=3 * li)
                hin = h.to(dev)
                if spec == "fc":
                    lp, xin, w2d = p["fc"], hin.mean(dim=(1, 2)), p["fc"]["w"]
                else:
                    lp = p[spec.name]
                    xin = im2col(hin, spec.kh, spec.kw, spec.stride, "SAME")
                    w2d = conv_weight_as_matrix(lp["w"])
                outs[dev] = (analog_matmul(xin, w2d, r_adc=lp["r_adc"], w_min=lp["w_clip_buf"][0],
                                           w_max=lp["w_clip_buf"][1], ctx=ctx), lp)
            y_cpu, lp = outs["cpu"]
            step = (abs(float(lp["r_adc"])) + 1e-9) / (2 ** (acfg.b_adc - 1) - 1)
            name = "fc" if spec == "fc" else spec.name
            layers[name] = compare(outs[DEV][0], y_cpu.to(DEV), step, 1, False)
            if spec != "fc":
                h = torch.relu(y_cpu * lp["bn_scale"] + lp["bn_bias"])
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = {}
    for k, g in cpu["grads"].items():
        d_card, d_ctrl = card["grads"][k] - g, ctrl["grads"][k] - g
        rel = {"card": float(d_card.norm() / g.norm().clamp(min=1e-30)),
               "control": float(d_ctrl.norm() / g.norm().clamp(min=1e-30)),
               "norm": float(g.norm()),
               # a range leaf's gradient sums a layer's every quantizer term
               "kind": ("range" if k.rsplit("/", 1)[-1] in ("r_adc", "gain_s", "w_clip_buf")
                        else "weight")}
        rel["bound"] = (max(TRAIN_STEP_GRAD_RTOL, TRAIN_RANGE_FACTOR * rel["control"])
                        if rel["kind"] == "range" else TRAIN_STEP_GRAD_RTOL)
        grad_rel[k] = rel
    over = {k: v for k, v in grad_rel.items() if v["card"] > v["bound"]}
    out = {"loss": {k: runs[k]["loss"] for k in runs}, "loss_rel": loss_rel,
           "seconds": {k: runs[k]["s"] for k in runs}, "draws": len(card["draws"]),
           "draws_bitwise": draws_ok, "layers": layers, "grad_rel": grad_rel,
           "card_b1_launches": card["b1_launches"], "card_plain_calls": card["plain_calls"],
           "card_backward_calls": card["backward_calls"]}
    log(f"train (b): one stage-2 step of {cfg.name} at {TRAIN_KWS['batch']} images: loss card "
        f"{card['loss']:.7f} CPU {cpu['loss']:.7f} (rel {loss_rel:.2e}), the plain version on the "
        f"card {ctrl['loss']:.7f}; {len(card['draws'])} weight-noise draws and masks bitwise: "
        f"{draws_ok}; B1 launches {card['b1_launches']}, plain forward calls "
        f"{card['plain_calls']}, backward recomputes {card['backward_calls']}; step s "
        f"{ {k: round(v, 3) for k, v in out['seconds'].items()} }")
    log("train (b): layers' ADC outputs card vs CPU: " + ", ".join(
        f"{k} {v['max_steps']:.3f} steps ({v['flips']} differing, share > half a step "
        f"{v['frac_half_step']:.1e})" for k, v in layers.items()))
    log("train (b): gradients, rel L2 card vs CPU (control: the plain version on the card vs "
        "CPU): " + ", ".join(f"{k} {v['card']:.2e} ({v['control']:.2e})"
                             for k, v in grad_rel.items()))
    log(f"train (b): bound {TRAIN_STEP_GRAD_RTOL} on each leaf; on a range leaf max("
        f"{TRAIN_STEP_GRAD_RTOL}, {TRAIN_RANGE_FACTOR} x its control); over: {over or 'none'}")
    check(draws_ok, "train (b): weight-noise draws and quant-noise masks card == CPU, bitwise")
    check(all(v["ok"] for v in layers.values()),
          f"train (b): every layer's ADC outputs within the tolerance model: {layers}")
    check(card["b1_launches"] == per and card["plain_calls"] == 0
          and card["backward_calls"] == per,
          "train (b): one B1 launch per layer forward, no plain forward, one recompute per layer")
    check(loss_rel <= TRAIN_STEP_LOSS_RTOL, f"train (b): loss card vs CPU {loss_rel:.2e}")
    check(not over, f"train (b): gradient leaves over their bound, rel L2 card vs CPU: {over}")
    return out


def train_run(torch, spec: dict, resume: bool) -> dict:
    """Phase 15 (c)/(d): ``spec``'s model trained through
    ``launch.train``'s functions (``cnn_setup`` at the published widths,
    ``run_two_stage``, ``quant_noise_p`` 0.5, every step logged,
    asynchronous checkpoints into ``build/``), each step's B1 launches,
    backward recomputes and plain forward calls counted; ms per step of
    each stage (host clock, each step ending in the metrics' sync); peak
    memory; one stage-1 and one stage-2 step profiled. With ``resume``, a
    second run from the final checkpoint must run nothing and give the
    trained params bitwise. Returns the record (``params``: the trained
    params)."""
    import shutil
    import signal

    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.training import optim
    from repro_torch.training.loop import TrainConfig, run_two_stage, value_and_grad

    arch = spec["arch"]
    ckpt = ROOT / "build" / f"train_{arch}"
    shutil.rmtree(ckpt, ignore_errors=True)
    params, loss_fn, batches = launch.cnn_setup(arch, spec["batch"], DEV)
    cfg_m = get(arch)
    per = len(cfg_m.convs) + 1
    tcfg = TrainConfig(stage1_steps=spec["stage1"], stage2_steps=spec["stage2"],
                       quant_noise_p=0.5, ckpt_dir=str(ckpt), ckpt_every=10, log_every=1)
    steps = []
    handler = signal.getsignal(signal.SIGTERM)  # run_two_stage installs its own
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors
    last = {"t": time.perf_counter(), "b1": 0, "tiled": 0, "back": 0}

    def on_metrics(i, m):
        now = time.perf_counter()  # the metrics' float() synced the step
        tiled = kernel.analog_mvm.design_launches["tiled"]
        steps.append({"step": i, "stage": m["stage"], "loss": m["loss"],
                      "grad_norm": m["grad_norm"], "ms": (now - last["t"]) * 1e3,
                      "b1": kernel.analog_mvm.launches - last["b1"],
                      "tiled": tiled - last["tiled"],
                      "backward": ops.backward_calls - last["back"]})
        last.update(t=now, b1=kernel.analog_mvm.launches, tiled=tiled, back=ops.backward_calls)

    t0 = time.perf_counter()
    try:
        trained, hist = run_two_stage(loss_fn, params, batches, tcfg, on_metrics=on_metrics)
    finally:
        signal.signal(signal.SIGTERM, handler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    plain = plain_calls()
    s1 = [r for r in steps if r["stage"] == 1]
    s2 = [r for r in steps if r["stage"] == 2]
    launches_ok = (all(r["b1"] == 0 and r["backward"] == 0 for r in s1)
                   and all(r["b1"] == r["tiled"] == r["backward"] == per for r in s2)
                   and len(s2) == spec["stage2"])
    finite = all(math.isfinite(r["loss"]) for r in steps)
    out = {"arch": arch, "batch": spec["batch"], "steps": steps, "wall_s": wall,
           "peak_bytes_above_held": peak, "held_bytes": held, "plain_calls": plain, "launches_per_stage2_forward": per,
           "b1_launches": sum(r["b1"] for r in s2), "backward_calls": sum(r["backward"] for r in s2),
           "ms_per_step": {"stage1": statistics.median(r["ms"] for r in s1[1:] or s1),
                           "stage2": statistics.median(r["ms"] for r in s2[1:] or s2)},
           "first_step_ms": {"stage1": s1[0]["ms"], "stage2": s2[0]["ms"]},
           "loss_first_last": {"stage1": (s1[0]["loss"], s1[-1]["loss"]),
                               "stage2": (s2[0]["loss"], s2[-1]["loss"])}}
    # one step of each stage profiled (on the trained params, batch 0)
    b = batch_at(PipelineConfig(kind="kws", global_batch=spec["batch"],
                                n_classes=cfg_m.n_classes, input_hw=cfg_m.input_hw,
                                channels=cfg_m.in_channels), 0)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
    key = prng.fold_in(prng.PRNGKey(0).to(DEV), 1)
    prof = {}
    for stage, acfg in ((1, AnalogConfig()),
                        (2, AnalogConfig().train(eta=0.1, b_adc=8, quant_noise_p=0.5))):
        ocfg = optim.OptimizerConfig(lr=3e-3, total_steps=spec["stage2"], warmup=1)
        state = optim.init(ocfg, trained)

        def one_step():
            _, grads = value_and_grad(lambda p: loss_fn(p, batch, acfg, key), trained)
            optim.update(ocfg, trained, grads, state)

        one_step()  # warm
        pr = profiled(torch, one_step, top=TRAIN_TOP_KERNELS)
        if isinstance(pr["profile_device_ms"], float):
            pr["b1_share_of_device"] = pr["profile_kernel_ms"] / max(pr["profile_device_ms"], 1e-9)
        prof[f"stage{stage}"] = pr
    out["profile"] = prof
    log(f"train ({arch}, batch {spec['batch']}): {spec['stage1']} + {spec['stage2']} steps in "
        f"{wall:.2f} s; ms per step (median, host clock) stage 1 "
        f"{out['ms_per_step']['stage1']:.2f}, stage 2 {out['ms_per_step']['stage2']:.2f} (first "
        f"steps {s1[0]['ms']:.1f} / {s2[0]['ms']:.1f}); B1 launches per stage-2 step "
        f"{sorted({r['b1'] for r in s2})} (want {per}), per stage-1 step "
        f"{sorted({r['b1'] for r in s1})}; backward recomputes {out['backward_calls']}; plain "
        f"forward calls {plain}; peak memory {peak / 2**20:.1f} MiB above the "
        f"{held / 2**30:.2f} GiB earlier phases hold; losses stage 1 "
        f"{s1[0]['loss']:.4f} -> {s1[-1]['loss']:.4f}, stage 2 {s2[0]['loss']:.4f} -> "
        f"{s2[-1]['loss']:.4f}")
    for k, pr in prof.items():
        log(f"train ({arch}): one {k} step profiled: {pr}")
    check(launches_ok, f"train {arch}: {per} B1 launches (all tiled) and {per} backward "
                       "recomputes per stage-2 step, none in stage 1")
    check(plain == 0, f"train {arch}: no plain forward call on the card ({plain})")
    check(finite, f"train {arch}: every loss finite")
    if resume:
        check(s1[-1]["loss"] < s1[0]["loss"],
              f"train {arch}: the last stage-1 loss below the first")
        fresh, _, batches2 = launch.cnn_setup(arch, spec["batch"], DEV)
        try:
            again, hist2 = run_two_stage(loss_fn, fresh, batches2, tcfg)
        finally:
            signal.signal(signal.SIGTERM, handler)
        same = all(torch.equal(a, c) for a, c in zip(tree_lib.leaves(again),
                                                      tree_lib.leaves(trained)))
        out["resume"] = {"steps_run": len(hist2), "params_bitwise": same,
                         "checkpoints": sorted(p.name for p in ckpt.iterdir())}
        log(f"train ({arch}): resumed from {out['resume']['checkpoints']}: {len(hist2)} steps "
            f"run, params bitwise the trained ones: {same}")
        check(not hist2 and same, f"train {arch}: a resume from the final checkpoint runs "
                                  "nothing and restores the trained params bitwise")
    out["params"] = trained
    return out


def train_eval(torch, trained, seed: int) -> dict:
    """Phase 15 (e): the trained AnalogNet-KWS programmed on the card through
    its crossbar transforms (b_adc 8, t = 25 s) and evaluated on the shared
    protocol (``bench.common.eval_program_accuracy``: batches 50000+i) at
    25 s and aged to 24 h, beside its digital accuracy. Reported, not
    gated."""
    from repro_torch import prng
    from repro_torch.bench.common import _protocol_accuracy, eval_program_accuracy
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import analognet as an

    cfg = get(TRAIN_KWS["arch"])
    prog = engine.compile_program(trained, AnalogConfig().infer(b_adc=8, t_seconds=CNN_AGES[0]),
                                  prng.PRNGKey(seed + 1), transforms=an.crossbar_transforms(cfg),
                                  with_mapping=True, device=DEV)
    out = {"digital": _protocol_accuracy(trained, cfg, AnalogConfig(), prng.PRNGKey(0).to(DEV), 4),
           "t25s": eval_program_accuracy(prog, cfg),
           "t24h": eval_program_accuracy(engine.age_program(prog, CNN_AGES[1]), cfg),
           "chance": 1.0 / cfg.n_classes, "batches": 4, "batch": 64}
    log(f"train (e): {cfg.name} after {TRAIN_KWS['stage1']} + {TRAIN_KWS['stage2']} steps: "
        f"accuracy digital {out['digital']:.4f}, programmed chip at 25 s {out['t25s']:.4f}, "
        f"aged to 24 h {out['t24h']:.4f} (chance {out['chance']:.4f}; 4 batches of 64 of the "
        "synthetic task; reported, not gated)")
    return out


def train_timing(torch, gen, shapes: list, dtype, what: str, n_iter: int = 20,
                 parent=None) -> dict:
    """B1's training form at every MVM of one stage-2 forward, ``shapes``
    its (layer, M, K, N, launches a forward), in ``dtype`` with a p = 0.5
    mask: the kernel (the design ``analog_mvm`` picks) in turns with its
    parent, the ``gemv`` design (``turns_ms``), then the plain training
    form and torch.matmul, timed by CUDA-graph replay, summed over the
    forward beside the bound (x, w and the mask read once, y written once,
    over HBM; 2 M K N operations over the peak for the dtype: the CUDA
    cores' fp32, the tensor cores' bf16)."""
    from repro_torch import prng
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref, n_tiles

    r_adc = torch.tensor(1.5, device=DEV)
    one = torch.tensor(1.0, device=DEV)
    esz, peak = (2, BF16_FLOPS) if dtype == torch.bfloat16 else (4, FP32_OPS)
    rows = []
    for i, (name, m, k, n, count) in enumerate(shapes):
        x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=DEV) * k**-0.5).to(dtype)
        t = n_tiles(k, 1024, True)
        keep = prng.bernoulli(prng.fold_in(prng.PRNGKey(i), 1).to(DEV), 0.5, (m, t, n))
        kw = dict(r_adc=r_adc, out_scale=one, b_adc=8, keep=keep)
        run_k = lambda _: kernel.analog_mvm(x, w, **kw)
        run_g = lambda _: kernel._launch("gemv", x, w, lib=parent, **kw)
        run_p = lambda _: analog_mvm_ref(x, w, None, r_adc, one, apply_dac=False, keep=keep)
        run_l = lambda _: torch.matmul(x, w)
        turns = turns_ms(run_k, run_g, n_iter)
        ms_p, ms_l = time_ms(run_p, n_iter), time_ms(run_l, n_iter)
        nbytes = esz * (m * k + k * n + m * n) + m * t * n
        flops = 2 * m * k * n
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        rows.append({"layer": name, "M": m, "K": k, "N": n, "per_forward": count, **turns,
                     "design": kernel.select_design(dtype, m, k, n, keep=True),
                     "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": max(t_b, t_o) * 1e3,
                     "bytes": nbytes, "flops": flops,
                     "bound_by": "bytes" if t_b >= t_o else "operations"})
    tot = {key: sum(r[key] * r["per_forward"] for r in rows)
           for key in ("ms", "gemv_ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")}
    t_o, t_b = tot["flops"] / peak, tot["bytes"] / HBM_BYTES_PER_S
    tot["bound_by"] = "operations" if t_o >= t_b else "bytes"
    tot["launches"] = sum(r["per_forward"] for r in rows)
    designs = sorted({r["design"] for r in rows})
    tot["designs"] = designs
    log(f"train: B1's training form, {what} ({tot['launches']} launches, {dtype}, {designs}, p = "
        f"0.5 masks): kernel {tot['ms']:.4f} ms, its parent (gemv, in turns"
        f"{', the parent build' if parent else ''}) {tot['gemv_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, torch.matmul {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}); per launch (ms kernel/gemv/plain/matmul/"
        "bound): " + ", ".join(
            f"{r['layer']} {r['ms']:.4f}/{r['gemv_ms']:.4f}/{r['plain_ms']:.4f}/"
            f"{r['library_ms']:.4f}/{r['bound_ms']:.4f}" for r in rows))
    return {"per_forward": tot, "layers": rows}


def phase_train(torch, gen, seed: int, accuracy: dict, launched: set, parent=None) -> dict:
    """Phase 15: the paper's two-stage training on the card (see the module
    docstring): (a) B1's training form against the plain training form at
    every training shape, (b) one full-width stage-2 step card vs CPU, (c)
    AnalogNet-KWS trained through the CLI's functions and resumed, (d)
    AnalogNet-VWW briefly, (e) the trained KWS programmed and evaluated;
    then every B1 key the phase launched checked (``check_launched_b1``)
    and B1's training form timed per KWS stage-2 forward, in turns with
    its parent."""
    from repro_torch.configs import get
    from repro_torch.models import analognet as an

    res, before = {}, set(launched)
    by_design = b1_by_design()
    checked, failures = set(map(tuple, accuracy["checked"])), []
    shapes = [(f"{spec['arch']}:{name}", m, k, n) for spec in (TRAIN_KWS, TRAIN_VWW)
              for name, m, k, n in an.mvm_shapes(get(spec["arch"]), spec["batch"])]
    shapes.append(("two tiles", 64, 2048, 96))
    worst_unkept = 0.0
    t0 = time.perf_counter()
    for name, m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=DEV)
        w = torch.randn((k, n), generator=gen, device=DEV) * k**-0.5
        r = b1_train_cases(torch, name, x, w, True, by_design, checked, failures)
        worst_unkept = max(worst_unkept, r["unkept_rel"])
        check(r["design"] == "tiled", f"train (a): {name}'s keep launch ran {r['design']}")
        b1_cases(torch, name, x, w, "tiled", True, False, by_design, checked, failures)
    torch.cuda.synchronize()
    accuracy["checked"] = sorted(checked)
    res["a"] = {"shapes": [s[1:] for s in shapes], "worst": dict(by_design["tiled"]),
                "unkept_rel": worst_unkept, "failures": len(failures),
                "s": time.perf_counter() - t0}
    log(f"train (a): B1's training form (tiled) vs the plain training form at {len(shapes)} "
        f"shapes (M, K, N) {[s[1:] for s in shapes]}, b_adc 4/6/8, with a p = 0.5 mask and "
        f"without: worst {by_design['tiled']}, unkept values within {worst_unkept:.2e} of max "
        f"|y|, masks bitwise the CPU bridge's; out of tolerance: {failures[:5] or 'none'}")
    check(not failures, f"train (a): {len(failures)} B1 training-form cases out of tolerance")
    res["step"] = train_step_check(torch, seed)
    res["kws"] = train_run(torch, TRAIN_KWS, resume=True)
    res["vww"] = train_run(torch, TRAIN_VWW, resume=False)
    res["vww"].pop("params")
    res["eval"] = train_eval(torch, res["kws"].pop("params"), seed)
    keys = sorted(launched - before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy, by_design)
    res["by_design"] = by_design
    res["timing"] = train_timing(
        torch, gen, [(*r, 1) for r in an.mvm_shapes(get(TRAIN_KWS["arch"]), TRAIN_KWS["batch"])],
        torch.float32, f"one analognet-kws stage-2 forward at {TRAIN_KWS['batch']} images",
        parent=parent)
    res["launches"] = {"train": res["kws"]["b1_launches"] + res["vww"]["b1_launches"]}
    return res


def train_entry(train: dict, lm_fp32_launches: int) -> dict:
    """The kernels line's B1 training entry: the fp32 keep-mask launches of
    the training runs (c) and (d) and of phase 16 (b)'s fp32 stage-2 step
    (the tiled design), its worst error at the training shapes, and its
    time per AnalogNet-KWS stage-2 forward, its parent's (``gemv_ms``) in
    turns."""
    t = train["timing"]["per_forward"]
    return {
        "name": "analog_mvm.tiled.train",
        "route": "cuda",
        "source": "src/repro_torch/csrc/analog_mvm_f32.cu",
        "replaces": "src/repro/kernels/analog_mvm.py:41",
        "launches": train["launches"]["train"] + lm_fp32_launches,
        "max_abs_err": train["by_design"]["tiled"]["max_abs"],
        "ms": t["ms"],
        "gemv_ms": t["gemv_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "per": f"one AnalogNet-KWS stage-2 forward at {TRAIN_KWS['batch']} images, fp32 with "
               f"TF32 off, p = 0.5 quant-noise masks: {t['launches']} launches; plain: the "
               "plain training form; library: torch.matmul of the same products; gemv_ms: the "
               "CUDA-core gemv design (this design's parent) on the same inputs, in turns; "
               "launches: the stage-2 steps of the KWS and VWW training runs and phase 16 (b)'s "
               "fp32 stage-2 step",
        "max_err_adc_steps": train["by_design"]["tiled"]["max_steps"],
        "pass": train["b1_checked_after"]["failures"] == 0 and train["a"]["failures"] == 0,
    }


# --------------------------------------------------------------- LM training


def lm_step(torch, params, cfg, stage: int, tape, grad: bool = True) -> dict:
    """Phase 16 (b)'s step: ``lm_loss`` at LM_STEP's batch (the LM
    pipeline's batch 0) on the device ``params`` live on, in stage 1
    (digital) or stage 2 (``analog_train`` at the CLI's settings, keyed as
    ``run_two_stage`` keys the first stage-2 step), inside ``tape``
    (``training.lockstep``: recorded, or locked to another device's tape).
    ``grad``: ``value_and_grad`` (else the loss alone, no graph). Returns
    the loss, the seconds and, with ``grad``, every gradient leaf on the
    host."""
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.training import lockstep
    from repro_torch.training.loop import value_and_grad

    dev = params.gain_s.device
    b = batch_at(PipelineConfig(kind="lm", global_batch=LM_STEP["batch"], seq_len=LM_STEP["seq"],
                                vocab=cfg.vocab), 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    acfg = AnalogConfig() if stage == 1 else AnalogConfig().train(**LM_TRAIN)
    key = prng.fold_in(prng.PRNGKey(0).to(dev), LM_RUN["stage1"]) if acfg.needs_rng else None
    loss_of = lambda p: lm.lm_loss(p, batch, acfg, cfg, rng=key)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = None
    with lockstep.tape(tape):
        if grad:
            (loss, _), g = value_and_grad(loss_of, params)
            grads = {tree_lib.path_name(p): t.cpu() for p, t in tree_lib.flatten_with_path(g)}
        else:
            with torch.no_grad():
                loss, _ = loss_of(params)
        loss = float(loss)
    return {"loss": loss, "s": time.perf_counter() - t0, "grads": grads}


def lm_train_steps(torch, params, cfg, mesh=None, ocfg=None, runs: int = 2) -> dict:
    """Phase 19's steps: from ``params`` (16 (b)'s stack on the card) one
    stage-1 (``digital``) step, then from its params one stage-2
    (``analog_train`` at LM_TRAIN) step, each with a fresh AdamW
    (LM_MESH_OPT, or ``ocfg``), of ``make_train_step`` at LM_STEP's batch in bf16 and
    key ``fold_in(PRNGKey(0), stage - 1)``: unsharded, or with ``mesh``
    the sharded step on the rank's slices in each stage's training layout.
    Each step runs ``runs`` times (2: twice) on the same inputs, the first
    cold (a first collective over a group, first allocations), the second
    warm. Per stage: the digest of the params, optimizer state and metrics
    after the step, whether the runs' digests agree (None for one run),
    the seconds of the first and the last (host clock to a synchronize),
    and the last run's launches and recomputes, and its collective calls
    and their seconds."""
    import dataclasses

    from repro_torch import collectives, prng
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.training import optim

    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    b = batch_at(PipelineConfig(kind="lm", global_batch=LM_STEP["batch"], seq_len=LM_STEP["seq"],
                                vocab=cfg.vocab), 0)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
    ocfg = ocfg or optim.OptimizerConfig(**LM_MESH_OPT)
    out = {}
    for stage, acfg in ((1, AnalogConfig()), (2, AnalogConfig().train(**LM_TRAIN))):
        opt = optim.init(ocfg, params)
        p, o = params, opt
        if mesh is None:
            step = steps.make_train_step(cfg, acfg, ocfg)
        else:
            p_sh = shd.param_shardings(params, mesh, cfg, analog_cfg=acfg)
            o_sh = shd.build_opt_shardings(opt, params, p_sh, mesh)
            step = steps.make_train_step(cfg, acfg, ocfg, mesh=mesh, shardings=(p_sh, o_sh))
            p, o = shd.shard_tree(params, p_sh), shd.shard_tree(opt, o_sh)
        done = []
        for i in range(runs):  # cold, then warm
            if i:  # the cold run's results go first (a full-width stack's memory)
                del new_p, new_o, m
                gc.collect()
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset_stats()
            t0 = time.perf_counter()
            new_p, new_o, m = step(p, o, batch, prng.fold_in(prng.PRNGKey(0).to(DEV), stage - 1))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            coll = dict(collectives.stats)
            counts = {"b1": kernel.analog_mvm.launches,
                      "designs": dict(kernel.analog_mvm.design_launches),
                      "backward": ops.backward_calls, "b3": fa.flash_attention.launches,
                      "attention_backward": ops.attention_backward_calls, "plain": plain_calls()}
            if mesh is not None:
                new_p, new_o = shd.gather_tree(new_p, p_sh), shd.gather_tree(new_o, o_sh)
            done.append((sec, tree_digest(torch, {"params": new_p, "opt": new_o, "metrics": m})))
        out[stage] = {"digest": done[-1][1],
                      "repeats_bitwise": done[0][1] == done[-1][1] if runs > 1 else None,
                      "cold_s": done[0][0], "s": done[-1][0], "counts": counts,
                      "collective_calls": coll["calls"], "collective_s": coll["seconds"],
                      "metrics": {k: float(v) for k, v in m.items()}}
        params = new_p
    return out


def lm_cpu_step(src: Path, out: Path) -> int:
    """Phase 16 (b)'s CPU side, run as a child process (``--lm-cpu-step SRC
    OUT``) beside the card's work: for each of the card's steps saved in
    SRC, the same step on the CPU locked to the card's tape (the weight-
    noise draws of LM_CPU_DRAW_MAX values or fewer drawn here, the rest
    taken from the card) and the loss of a free forward (only the draws
    taken from the card), written to OUT."""
    import dataclasses

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.training import lockstep

    torch.set_num_threads(LM_CPU_THREADS)
    saved = torch.load(src, weights_only=False)
    params, res = saved["params"], {}
    t0 = time.perf_counter()
    for (dtype, stage), card in saved["card"].items():
        cfg = dataclasses.replace(saved["cfg"], dtype=getattr(torch, dtype))
        draw = {i for i, c in enumerate(card.of("noise")) if c["out"].numel() <= LM_CPU_DRAW_MAX}
        locked = lockstep.Tape(lock=card, draw=draw)
        r = lm_step(torch, params, cfg, stage, locked)
        free = lm_step(torch, params, cfg, stage,
                       lockstep.Tape(lock=card, draw=set(), lock_kinds=("noise",)), grad=False)
        locked.lock = None
        res[dtype, stage] = {**r, "tape": locked, "draw": sorted(draw), "free_loss": free["loss"],
                             "free_s": free["s"]}
        if saved["readings"]:  # ``--lm-step-readings``: the free step's gradients, and
            # the locked step on 2 threads (the CPU's own rounding)
            ft = lockstep.Tape(lock=card, draw=set(), lock_kinds=("noise",))
            res[dtype, stage]["free"] = {"grads": lm_step(torch, params, cfg, stage, ft)["grads"],
                                         "mvm": [c["out"] for c in ft.of("mvm")]}
            if stage == 2:
                torch.set_num_threads(2)
                res[dtype, stage]["threads2"] = lm_step(
                    torch, params, cfg, stage, lockstep.Tape(lock=card, draw=set()))["grads"]
                torch.set_num_threads(LM_CPU_THREADS)
    torch.save(res, out)
    print(f"lm cpu step: {time.perf_counter() - t0:.1f} s on {LM_CPU_THREADS} threads", flush=True)
    return 0


def lm_step_start(torch, seed: int, readings: bool = False) -> dict:
    """Start phase 16 (b): the 2-layer full-width stack drawn on the card
    (``lm_init(seed)``), one step of each stage in fp32 (TF32 off) and bf16
    run on the card with their calls taped (the main path: B1 and B3, each
    step's launches and recomputes counted), then the CPU's child process
    (``lm_cpu_step``) started on what they saved and left running."""
    import dataclasses

    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.training import lockstep

    # (b) tapes each call of the step's forward once, in order: remat would
    # run every group's calls again inside the backward
    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_STEP["layers"], remat=False)
    params = lm.lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    card, counts, steps = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for stage in (1, 2):
            reset_counts()
            card[dtype, stage] = lockstep.Tape()
            steps[dtype, stage] = lm_step(
                torch, params, dataclasses.replace(cfg, dtype=getattr(torch, dtype)), stage,
                card[dtype, stage])
            counts[dtype, stage] = {
                "b1": kernel.analog_mvm.launches,
                "designs": dict(kernel.analog_mvm.design_launches),
                "backward": ops.backward_calls, "b3": fa.flash_attention.launches,
                "attention_backward": ops.attention_backward_calls, "plain": plain_calls()}
    # the weight-noise draws do not depend on the activation dtype: one copy
    same = all(torch.equal(a["out"], b["out"]) for a, b in
               zip(card["float32", 2].of("noise"), card["bfloat16", 2].of("noise")))
    if same:
        for a, b in zip(card["float32", 2].of("noise"), card["bfloat16", 2].of("noise")):
            b["out"] = a["out"]
    work = ROOT / "build" / "lm_step"
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"cfg": cfg, "params": tree_lib.tree_map(lambda t: t.cpu(), params), "card": card,
                "readings": readings}, work / "steps.pt")
    log_f = open(work / "cpu_step.log", "w")
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--lm-cpu-step", str(work / "steps.pt"),
         str(work / "cpu_step.pt")], stdout=log_f, stderr=subprocess.STDOUT, cwd=ROOT)
    # while the child runs: phase 19's reference, the unsharded train steps
    train = {"init": tree_digest(torch, {"params": params}),
             **lm_train_steps(torch, params, cfg)}
    del params
    return {"cfg": cfg, "card": card, "steps": steps, "counts": counts, "noise_same": same,
            "child": child, "log": log_f, "work": work, "t0": time.perf_counter(),
            "train_steps": train}


def lm_step_compare(card, cpu: dict, dtype: str) -> dict:
    """One (b) step's forward, call by call: each B1 output (the card's)
    against the CPU's plain training form on the same forward values under
    ``compare``'s ADC tolerance model; each B3 output and each digital
    matmul's against the CPU's (max abs and bf16 ulps, reported); the
    masks and the weight-noise draws the CPU made itself, bitwise."""
    import torch

    bf16 = dtype == "bfloat16"
    out = {"mvm": [], "other": {}}
    tape = cpu["tape"]
    for c, p in zip(card.of("mvm"), tape.of("mvm")):
        r = compare(c["out"], p["out"], p["meta"]["step"], p["meta"]["n_tiles"], bf16)
        # in bf16 each tile's partial is rounded to bf16 before the tile sum:
        # an unquantized partial the two fp32 sum orders round apart moves
        # the output by an ulp of the partial, which can be many ADC steps
        # above the output's own ulp; only the flip share is held there
        r["gate"] = r["finite"] and r["frac_half_step"] < 0.01 if bf16 else r["ok"]
        out["mvm"].append(r)
    for kind in ("attention", "digital"):
        diffs = [(c["out"].float() - p["out"].float()).abs() for c, p in
                 zip(card.of(kind), tape.of(kind))]
        out["other"][kind] = {
            "calls": len(diffs), "max_abs": max((float(d.max()) for d in diffs), default=0.0),
            "max_ulps": max((float((d / bf16_ulp(p["out"])).max()) for d, p in
                             zip(diffs, tape.of(kind))), default=0.0) if bf16 else None}
    drawn = [i for i, c in enumerate(tape.of("noise")) if c["out"] is not None]
    out["draws"] = {"masks": len(card.masks), "masks_bitwise": card.masks == tape.masks,
                    "noise_drawn": len(drawn), "noise_calls": len(card.of("noise")),
                    "noise_values_drawn": sum(tape.of("noise")[i]["out"].numel() for i in drawn),
                    "noise_bitwise": all(torch.equal(card.of("noise")[i]["out"],
                                                     tape.of("noise")[i]["out"]) for i in drawn)}
    return out


def lm_step_check(torch, job: dict, gate: bool = True) -> dict:
    """Phase 16 (b): tinyllama-1.1b at full width on LM_STEP's 2 layers, one
    stage-1 and one stage-2 step in fp32 (TF32 off) and in bf16, on the
    card (B1 and B3, the main path) and on the CPU locked to the card's
    forward values (``training.lockstep``; the child process). Gates:
    per stage-2 forward one B1 launch and one recompute per analog layer,
    per forward one B3 launch and one recompute per layer, no plain
    forward; every quant-noise mask bitwise card == CPU, and every weight-
    noise draw the CPU made (LM_CPU_DRAW_MAX values or fewer); each B1
    output within the ADC tolerance model of the CPU's plain training form
    at the same inputs (in bf16 its flip share alone, see
    ``lm_step_compare``); the loss within TRAIN_STEP_LOSS_RTOL of the
    CPU's free forward (the draws alone taken from the card); each gradient
    leaf within ``lockstep.GRAD_RTOL`` relative L2 of the CPU's; and the gate
    itself fails every leaf zeroed or doubled (``lockstep.planted_faults``).

    Why locked: a free-running stage-2 step is chaotic in its rounding
    (the ``lockstep`` module docstring): free, the card's weight gradients
    read 0.096 (fp32) and 0.14 (bf16) relative L2 from the CPU's, a range
    leaf up to 1.09, whether through B1 and B3 or the plain versions."""
    from repro_torch.training import lockstep

    cfg, child, layers = job["cfg"], job["child"], job["cfg"].n_layers
    t_wait = time.perf_counter()
    try:
        rc = child.wait(timeout=LM_CPU_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        job["log"].close()
    waited = time.perf_counter() - t_wait
    child_log = (job["work"] / "cpu_step.log").read_text()
    check(rc == 0, f"LM step (b): the CPU child exited {rc}: {child_log[-2000:]}")
    cpu = torch.load(job["work"] / "cpu_step.pt", weights_only=False)
    out = {"cpu_seconds": time.perf_counter() - job["t0"], "waited_s": waited,
           "cpu_log": child_log.strip(), "counts": {}, "steps": {},
           "noise_same_across_dtypes": job["noise_same"]}
    per, tokens = 7 * layers + 1, LM_STEP["batch"] * LM_STEP["seq"]
    failed = []
    for (dtype, stage), k in job["steps"].items():
        c, counts = cpu[dtype, stage], job["counts"][dtype, stage]
        # stage 2: every analog layer's keep-mask launch through the design
        # picked for it (tiled in fp32, prefill in bf16)
        n_b1 = 0 if stage == 1 else per
        want = {"b1": n_b1, "designs": b1_only(train_design(getattr(torch, dtype), tokens), n_b1),
                "backward": n_b1, "b3": layers, "attention_backward": layers, "plain": 0}
        bound = lockstep.GRAD_RTOL[dtype]
        fwd = lm_step_compare(job["card"][dtype, stage], c, dtype)
        loss_rel = abs(k["loss"] - c["free_loss"]) / abs(c["free_loss"])
        rel = {n: lockstep.rel_l2(k["grads"][n], g) for n, g in c["grads"].items()}
        over = lockstep.over_bound(k["grads"], c["grads"], bound)
        missed = lockstep.planted_faults(k["grads"], c["grads"], bound)
        worst = {kind: max((v for n, v in rel.items() if lockstep.leaf_kind(n) == kind),
                           default=0.0) for kind in ("weight", "range")}
        mvm_ok = all(r["gate"] for r in fwd["mvm"])
        st = {"loss": {"card": k["loss"], "cpu_free": c["free_loss"], "cpu_locked": c["loss"]},
              "loss_rel": loss_rel, "seconds": {"card": k["s"], "cpu": c["s"],
                                                "cpu_free": c["free_s"]},
              "counts": counts, "forward": fwd, "grad_rel": rel, "worst": worst, "bound": bound,
              "over": over, "faults_missed": missed}
        out["steps"][f"{dtype} stage {stage}"] = st
        if "free" in c:  # ``--lm-step-readings``
            st["free"] = {"grad_rel": {n: lockstep.rel_l2(k["grads"][n], g)
                                       for n, g in c["free"]["grads"].items()},
                          "mvm_rel": [lockstep.rel_l2(a["out"], b) for a, b in
                                      zip(job["card"][dtype, stage].of("mvm"), c["free"]["mvm"])]}
            log(f"lm (b) readings: {dtype} stage {stage}, free step (draws alone locked), rel L2 "
                f"card vs CPU: gradients {st['free']['grad_rel']}; each MVM's output in call "
                f"order {[f'{v:.1e}' for v in st['free']['mvm_rel']]}")
        if "threads2" in c:
            st["threads2"] = {n: lockstep.rel_l2(c["threads2"][n], g) for n, g in c["grads"].items()}
            log(f"lm (b) readings: {dtype} stage {stage}, the CPU's locked step on 2 threads vs "
                f"{LM_CPU_THREADS}: {st['threads2']}")
        log(f"lm (b): {dtype} stage {stage}, {cfg.name} at full width on {layers} layers, "
            f"{LM_STEP['batch']} x {LM_STEP['seq']} tokens: loss card {k['loss']:.7f}, CPU free "
            f"{c['free_loss']:.7f} (rel {loss_rel:.2e}), CPU locked {c['loss']:.7f}; counts "
            f"{counts}; draws {fwd['draws']}; B1 vs the CPU's plain form at the same values, "
            f"worst {max((r['max_steps'] for r in fwd['mvm']), default=0.0):.3f} steps, "
            f"{max((r['frac_half_step'] for r in fwd['mvm']), default=0.0):.2e} beyond half a "
            f"step, all within the model: {mvm_ok}; {fwd['other']}; s card {k['s']:.2f} CPU "
            f"{c['s']:.2f}")
        log(f"lm (b): {dtype} stage {stage} gradients, rel L2 card vs CPU locked (bound "
            f"{bound}): " + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
            + f"; over: {over or 'none'}; planted faults not caught: {missed}")
        checks = [
            (counts == want, f"launches and recomputes {counts}, want {want}"),
            (fwd["draws"]["masks_bitwise"] and fwd["draws"]["noise_bitwise"]
             and fwd["draws"]["masks"] == (0 if stage == 1 else 2 * per)
             and fwd["draws"]["noise_calls"] == (0 if stage == 1 else per)
             and (stage == 1 or fwd["draws"]["noise_drawn"] > 0),
             f"draws and masks card == CPU, bitwise: {fwd['draws']}"),
            (len(fwd["mvm"]) == want["b1"] and mvm_ok,
             "each B1 output within the ADC tolerance model of the CPU's"),
            (loss_rel <= TRAIN_STEP_LOSS_RTOL, f"loss card vs CPU {loss_rel:.2e}"),
            (not over, f"gradient leaves over their bound: {over}"),
            (not missed["zeroed"] and not missed["doubled"],
             f"the gradient gate misses a zeroed or doubled leaf: {missed}")]
        failed += [f"{dtype} stage {stage}: {what}" for ok, what in checks if not ok]
    log(f"lm (b): the CPU child took {out['cpu_seconds']:.1f} s, {waited:.1f} s of it waited "
        f"for; {child_log.strip()}")
    out["failed"] = failed
    check(not gate or not failed, f"lm (b): {failed}")
    return out


def lm_step_gemv_readings(torch, seed: int, card, cpu) -> dict:
    """What the bf16 stage-2 range readings of phase 16 (b) owe to B1's
    design, at ``seed``: ``card`` is the step's card tape through the
    prefill design, ``cpu`` the CPU's tape locked to it.

    (1) The same step on the card with its keep-mask launches through
    ``gemv`` (``b1_through``), locked to ``card``: each MVM's
    output from the same inputs and masks, held against the prefill
    design's and the CPU's (``compare``: flips, share beyond half a step,
    worst ADC steps), and its gradients against the prefill step's (at the
    same forward values the backward, a recompute of the plain form, does
    not see the forward's design). (2) Phase 16 (b) free through ``gemv``
    (the parent's path), its gates reported, not enforced."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.training import lockstep

    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_STEP["layers"], dtype=torch.bfloat16,
                              remat=False)  # as lm_step_start
    params = lm.lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    pre_grads = lm_step(torch, params, cfg, 2, lockstep.Tape(lock=card, draw=set()))["grads"]
    with b1_through("gemv", keep_only=True):
        locked = lockstep.Tape(lock=card, draw=set())
        gemv_grads = lm_step(torch, params, cfg, 2, locked)["grads"]
    del params
    mvm = []
    for c, g, p in zip(card.of("mvm"), locked.of("mvm"), cpu.of("mvm")):
        step, nt = p["meta"]["step"], p["meta"]["n_tiles"]
        mvm.append({"prefill_vs_gemv": compare(c["out"], g["out"], step, nt, True),
                    "prefill_vs_cpu": compare(c["out"], p["out"], step, nt, True),
                    "gemv_vs_cpu": compare(g["out"], p["out"], step, nt, True),
                    "n_tiles": nt, "shape": list(c["out"].shape)})
    tot = lambda pair, key: sum(r[pair][key] for r in mvm)
    out = {"mvm": mvm,
           "flips": {pair: tot(pair, "flips") for pair in mvm[0] if "_vs_" in pair},
           "elements": tot("prefill_vs_cpu", "elements"),
           "worst_steps": {pair: max(r[pair]["max_steps"] for r in mvm)
                           for pair in mvm[0] if "_vs_" in pair},
           "grads_locked_gemv_vs_prefill": {n: lockstep.rel_l2(gemv_grads[n], g)
                                            for n, g in pre_grads.items()},
           "grads_locked_bitwise": all(torch.equal(gemv_grads[n], g)
                                       for n, g in pre_grads.items())}
    log(f"lm (b) readings: seed {seed}, bf16 stage 2 locked to the prefill design's step: "
        f"{len(mvm)} MVMs, {out['elements']} outputs; elements that differ "
        f"{out['flips']}, worst ADC steps {out['worst_steps']}; per MVM (prefill vs gemv, "
        "prefill vs CPU, gemv vs CPU: flips / share beyond half a step): " + ", ".join(
            "/".join(f"{r[pair]['flips']}:{r[pair]['frac_half_step']:.1e}"
                     for pair in ("prefill_vs_gemv", "prefill_vs_cpu", "gemv_vs_cpu"))
            for r in mvm)
        + f"; the card's gradients through gemv vs through prefill at the same forward values: "
          f"bitwise {out['grads_locked_bitwise']}, worst rel L2 "
          f"{max(out['grads_locked_gemv_vs_prefill'].values()):.2e}")
    with b1_through("gemv", keep_only=True):
        job = lm_step_start(torch, seed)
    out["free_through_gemv"] = free = lm_step_check(torch, job, gate=False)
    st = free["steps"]["bfloat16 stage 2"]
    log(f"lm (b) readings: seed {seed}, phase 16 (b) through gemv (the parent's path): bf16 "
        f"stage 2 worst leaves {st['worst']}, range leaves "
        + ", ".join(f"{n} {v:.3e}" for n, v in st["grad_rel"].items()
                    if lockstep.leaf_kind(n) == "range")
        + f"; failed gates (reported): {free['failed'] or 'none'}")
    return out


def lm_step_readings(torch, seeds: list, path: Path) -> int:
    """``--lm-step-readings SEEDS``: phase 16 (b) alone at each seed (the
    params' and the batch's draws), its gates reported, not enforced; the
    first seed's CPU child also takes the free step's gradients and the
    locked stage-2 steps on 2 threads; at the first seed, what the bf16
    readings owe to B1's design (``lm_step_gemv_readings``). Then one bf16
    stage-2 step profiled with the card's events only, the profiler's exit
    and its readback timed. Writes ``path``."""
    from torch.profiler import ProfilerActivity, profile

    phase_device(torch)
    phase_build()
    res = {"seeds": {}}
    for i, seed in enumerate(seeds):
        job = lm_step_start(torch, seed, readings=i == 0)
        res["seeds"][seed] = lm_step_check(torch, job, gate=False)
        log(f"lm (b) readings: seed {seed} failed gates: {res['seeds'][seed]['failed'] or 'none'}")
        if i == 0:
            first = job["card"]["bfloat16", 2], torch.load(
                job["work"] / "cpu_step.pt", weights_only=False)["bfloat16", 2]["tape"]
    res["gemv"] = lm_step_gemv_readings(torch, seeds[0], *first)
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.training import lockstep

    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_STEP["layers"], remat=False)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device=DEV)
    step = lambda: lm_step(torch, params, cfg, 2, lockstep.Tape())
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    wall_us = (t1 - t0) * 1e6
    t2 = time.perf_counter()
    raw = profile_summary(prof, wall_us=wall_us, dev=device_events(prof))
    t3 = time.perf_counter()
    parsed = profile_summary(prof, wall_us=wall_us)
    t4 = time.perf_counter()
    res["profile_readback"] = {"raw": raw, "events": parsed, "raw_s": t3 - t2,
                               "events_s": t4 - t3, "torch": torch.__version__}
    log(f"lm (b) readings: one profiled bf16 stage-2 step, its card events read raw and "
        f"through events(): {res['profile_readback']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["run"] = lm_train_run(torch)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, default=str))
    return 0


def lm_train_run(torch) -> dict:
    """Phase 16 (c): tinyllama-1.1b at full width on LM_RUN's layers
    through ``run_two_stage`` (params and batches from ``launch.train.lm_setup``
    cut to those layers), LM_RUN's batch and steps, every step logged, with
    asynchronous checkpoints into ``build/``; each step's B1 launches (by
    design), B3 launches and both backward recomputes counted. The config
    applies remat: each group's forward runs again in the backward. Gates,
    at L layers: every stage-2 step 2 (7 L) + 1 keep-mask launches through
    the prefill design (7 L + 1 in the forward, the groups' 7 L again in
    the recompute) and 7 L + 1 backward recomputes, none in stage 1; every
    step 2 L B3 launches (L and L) and L backward recomputes; no plain
    forward; finite losses; a
    resume from the final checkpoint runs nothing and restores the params
    bitwise. Reports ms per step by stage
    (host clock, median), one profiled step per stage (device kernels, B1's
    and B3's share, idle share) and the peak memory above what earlier
    phases hold."""
    import shutil
    import signal

    import dataclasses

    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.training import optim
    from repro_torch.training.loop import TrainConfig, run_two_stage, value_and_grad

    from repro_torch.configs import get

    check(get(LM_ARCH).remat, f"lm (c): {LM_ARCH}'s config applies remat")
    ckpt = ROOT / "build" / "train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    params, loss_fn, batches = launch.lm_setup(LM_ARCH, False, LM_RUN["batch"], LM_RUN["seq"],
                                               DEV, n_layers=LM_RUN["layers"])
    run_cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_RUN["layers"])  # remat's peaks
    tcfg = TrainConfig(stage1_steps=LM_RUN["stage1"], stage2_steps=LM_RUN["stage2"],
                       ckpt_dir=str(ckpt), ckpt_every=100, log_every=1, **LM_TRAIN)
    steps = []
    design = train_design(torch.bfloat16, LM_RUN["batch"] * LM_RUN["seq"])
    reads = lambda: {"b1": kernel.analog_mvm.launches,
                     design: kernel.analog_mvm.design_launches[design],
                     "backward": ops.backward_calls, "b3": fa.flash_attention.launches,
                     "attention_backward": ops.attention_backward_calls}
    handler = signal.getsignal(signal.SIGTERM)  # run_two_stage installs its own
    torch.cuda.synchronize()
    reset_counts()
    last = {"t": time.perf_counter(), **reads()}

    def on_metrics(i, m):
        now = time.perf_counter()  # the metrics' float() synced the step
        r = reads()
        steps.append({"step": i, "stage": m["stage"], "loss": m["loss"], "ms": (now - last["t"]) * 1e3,
                      **{k: r[k] - last[k] for k in r}})
        last.update(t=now, **r)

    t0 = time.perf_counter()
    try:
        trained, _ = run_two_stage(loss_fn, params, batches, tcfg, on_metrics=on_metrics)
    finally:
        signal.signal(signal.SIGTERM, handler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plain = plain_calls()
    n_layers = LM_RUN["layers"]
    per = 7 * n_layers + 1
    s1 = [r for r in steps if r["stage"] == 1]
    s2 = [r for r in steps if r["stage"] == 2]
    # remat (the config's, as the reference's): the backward recomputes
    # every group's forward, launching its 7 B1 and 1 B3 kernels a layer again
    # (the lm_head is outside the groups); each MVM and attention is still
    # differentiated once
    b1_step, b3_step = per + (per - 1), 2 * n_layers
    want = {1: {"b1": 0, design: 0, "backward": 0, "b3": b3_step, "attention_backward": n_layers},
            2: {"b1": b1_step, design: b1_step, "backward": per, "b3": b3_step,
                "attention_backward": n_layers}}
    launches_ok = (len(s1) == LM_RUN["stage1"] and len(s2) == LM_RUN["stage2"]
                   and all({k: r[k] for k in want[1]} == want[r["stage"]] for r in steps))
    finite = all(math.isfinite(r["loss"]) for r in steps)
    out = {"arch": LM_ARCH, "batch": LM_RUN["batch"], "seq": LM_RUN["seq"], "steps": steps,
           "wall_s": wall, "plain_calls": plain, "held_bytes": held,
           "peak_bytes_above_held": torch.cuda.max_memory_allocated() - held,
           "b1_launches": sum(r["b1"] for r in s2), "b3_launches": sum(r["b3"] for r in steps),
           # stage 1's second step also carries the host copy of the step-0
           # checkpoint, and each stage's first step is cold
           "ms_per_step": {"stage1": statistics.median(r["ms"] for r in s1[2:] or s1),
                           "stage2": statistics.median(r["ms"] for r in s2[1:] or s2)},
           "first_step_ms": {"stage1": s1[0]["ms"], "stage2": s2[0]["ms"]}}
    log(f"lm (c): {LM_ARCH} at full width on {n_layers} layers, batch {LM_RUN['batch']} x {LM_RUN['seq']} "
        f"tokens, {LM_RUN['stage1']} + {LM_RUN['stage2']} steps in {wall:.2f} s (with "
        f"checkpoints); ms per step (median, host clock) stage 1 "
        f"{out['ms_per_step']['stage1']:.1f}, stage 2 {out['ms_per_step']['stage2']:.1f} "
        f"(first {s1[0]['ms']:.1f} / {s2[0]['ms']:.1f}); per step "
        f"{[{k: r[k] for k in ('stage', 'b1', design, 'backward', 'b3', 'attention_backward')} for r in steps]}; "
        f"plain forward calls {plain}; losses {[round(r['loss'], 4) for r in steps]}; peak "
        f"memory with remat {out['peak_bytes_above_held'] / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB earlier phases hold (without remat, at 22 layers: "
        f"{LM_PEAK_NO_REMAT})")
    check(design == "prefill" and launches_ok,
          f"lm (c): per step launches ({design}) and recomputes, want {want}")
    check(plain == 0, f"lm (c): no plain forward call on the card ({plain})")
    check(finite, "lm (c): every loss finite")
    # a resume from the final checkpoint: nothing runs, the params come back bitwise
    t_resume = time.perf_counter()
    try:
        again, hist2 = run_two_stage(loss_fn, trained, batches, tcfg)
    finally:
        signal.signal(signal.SIGTERM, handler)
    same = all(torch.equal(a, c) for a, c in zip(tree_lib.leaves(again), tree_lib.leaves(trained)))
    out["resume"] = {"steps_run": len(hist2), "params_bitwise": same,
                     "checkpoints": sorted(p.name for p in ckpt.iterdir())}
    log(f"lm (c): resumed from {out['resume']['checkpoints']}: {len(hist2)} steps run, params "
        f"bitwise the trained ones: {same}")
    check(not hist2 and same, "lm (c): a resume from the final checkpoint runs nothing and "
                              "restores the trained params bitwise")
    del again
    shutil.rmtree(ckpt, ignore_errors=True)
    t_profile = time.perf_counter()
    out["seconds"] = {"train": wall, "resume": t_profile - t_resume}
    # one step of each stage profiled (the trained params, batch 0)
    b = batch_at(PipelineConfig(kind="lm", global_batch=LM_RUN["batch"], seq_len=LM_RUN["seq"],
                                vocab=trained.embed["table"].shape[0]), 0)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
    key = prng.fold_in(prng.PRNGKey(0).to(DEV), LM_RUN["stage1"])
    prof = {}
    for stage, acfg in ((1, AnalogConfig()), (2, AnalogConfig().train(**LM_TRAIN))):
        ocfg = optim.OptimizerConfig(lr=3e-3, total_steps=LM_RUN["stage2"], warmup=1)
        state = optim.init(ocfg, trained)

        def one_step():
            _, grads = value_and_grad(lambda p: loss_fn(p, batch, acfg, key), trained)
            optim.update(ocfg, trained, grads, state)

        t_warm = time.perf_counter()
        one_step()  # warm
        torch.cuda.synchronize()
        t_prof = time.perf_counter()
        pr = profiled(torch, one_step, kernel="flash_attention", top=TRAIN_TOP_KERNELS,
                      host_events=False)
        pr["seconds"] = {"warm": t_prof - t_warm, "profiled": time.perf_counter() - t_prof}
        if isinstance(pr["profile_device_ms"], float):
            busy = max(pr["profile_device_ms"], 1e-9)
            pr["b1_share_of_device"] = pr["profile_mvm_ms"] / busy
            pr["b3_share_of_device"] = pr["profile_kernel_ms"] / busy
        prof[f"stage{stage}"] = pr
        del state
    out["profile"] = prof
    out["seconds"]["profile"] = time.perf_counter() - t_profile
    out["peak_bytes_above_held"] = torch.cuda.max_memory_allocated() - held
    for k, pr in prof.items():
        log(f"lm (c): one {k} step profiled (profile_kernel_ms: B3, profile_mvm_ms: B1): {pr}")
    log(f"lm (c): peak memory with the profiled steps {out['peak_bytes_above_held'] / 2**30:.2f} "
        f"GiB above the {held / 2**30:.2f} GiB held; seconds {out['seconds']}")
    # what remat saves in the step itself: one stage-2 forward and backward
    # of the trained params, its peak above what is held before it (the
    # gradients included), with and without remat
    peaks = {}
    for remat in (True, False):
        cfg = dataclasses.replace(run_cfg, remat=remat)
        acfg = AnalogConfig().train(**LM_TRAIN)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, grads = value_and_grad(lambda p: lm.lm_loss(p, batch, acfg, cfg, rng=key), trained)
        torch.cuda.synchronize()
        peaks["remat" if remat else "no_remat"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del grads
    out["stage2_step_peak_gib"] = peaks
    log(f"lm (c): one stage-2 forward and backward alone, peak above what is held before it "
        f"(GiB): {peaks}")
    del trained, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_serve_drift(torch) -> dict:
    """Phase 16 (d): ``bench.pipeline``'s ``serve_drift_24h`` row on the card
    (the scaled KWS trained 60 + 60 steps, 4 chips programmed at 25 s and
    aged to 24 h). Gate: no programming event while aging (asserted inside
    the row, and read from it). Reports top-1 agreement at 25 s and 24 h."""
    from repro_torch.bench import pipeline as bench_pipeline

    t0 = time.perf_counter()
    row = bench_pipeline.drift_lifecycle_row(True, DEV)
    got = re.search(r"top1_t25s=([-\d.]+)_top1_t24h=([-\d.]+)_drop=[-\d.]+_chips=(\d+)"
                    r"_program_events=(-?\d+)$", row)
    check(got is not None, f"lm (d): the row's format: {row}")
    out = {"row": row, "seconds": time.perf_counter() - t0, "top1_t25s": float(got[1]),
           "top1_t24h": float(got[2]), "chips": int(got[3]), "program_events": int(got[4])}
    log(f"lm (d): {row} ({out['seconds']:.1f} s)")
    check(out["program_events"] == 0, f"lm (d): aging reprogrammed a chip: {row}")
    return out


def lm_b3_timing(torch, gen) -> dict:
    """B3's forward at LM_RUN's (rows, S), bf16 causal, tinyllama-1.1b's
    heads: the kernel, the plain version and SDPA by CUDA-graph replay in
    turns, beside the bound, times the 22 launches of a forward; and the
    training form's forward and backward (the plain version's VJP,
    recomputed) per launch, on the host clock to a synchronize."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    c = FA_HEADS
    chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    rows, s = LM_RUN["batch"], LM_RUN["seq"]
    q, k, v = (torch.randn((rows, s, n, c["d"]), generator=gen, device=DEV).bfloat16()
               for n in (c["h"], c["kv"], c["kv"]))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launches0 = fa.flash_attention.launches
    run_k = lambda _: fa.flash_attention(q, k, v, causal=True, **chunks)
    ms_k1 = time_ms(run_k, 20)
    ms_p = time_ms(lambda _: flash_attention_ref(q, k, v, True, **chunks), 5)
    ms_l = time_ms(lambda _: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), 20)
    ms_k2 = time_ms(run_k, 20)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    g = torch.randn_like(q)

    def fwd_bwd():
        o = ops.flash_attention_ste(qg, kg, vg, causal=True, **chunks)
        torch.autograd.grad(o, (qg, kg, vg), g)

    back_ms = wall_ms(torch, fwd_bwd, 5)
    fa.flash_attention.launches = launches0  # timing launches are not main-path launches
    bound, bound_by = fa_bound(rows, s, c["h"], c["kv"], c["d"])
    n = FA_LAUNCHES_PER_PREFILL
    out = {"rows": rows, "S": s, "ms": n * min(ms_k1, ms_k2), "ms_readings": [ms_k1, ms_k2],
           "plain_ms": n * ms_p, "library_ms": n * ms_l, "bound_ms": n * bound,
           "bound_by": bound_by, "forward_backward_ms_per_launch": back_ms}
    log(f"lm: B3 forward at {rows} x {s} tokens, bf16 causal, 22 launches a forward: kernel "
        f"{out['ms']:.4f} ms ({ms_k1:.4f}/{ms_k2:.4f} a launch), plain {out['plain_ms']:.4f} ms, "
        f"SDPA {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({bound_by}); the "
        f"training form's forward + recomputed backward {back_ms:.3f} ms a launch (host clock)")
    return out


def prefill_all_ones_bitwise(torch, x, w) -> bool:
    """The prefill design with an all-ones keep mask against the same launch
    without one (the serving form), bitwise, at b_adc 4 and 8, per-tile ADC
    both ways: the masked epilogue with every mask bit set is the serving
    epilogue."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import n_tiles

    (m, k), n = x.shape, w.shape[1]
    kw = dict(r_adc=torch.tensor(1.5, device=DEV), out_scale=torch.tensor(0.97, device=DEV))
    same = True
    for per_tile in (True, False):
        ones = torch.ones((m, n_tiles(k, 1024, per_tile), n), dtype=torch.uint8, device=DEV)
        for bits in (4, 8):
            a = kernel._launch("prefill", x, w, b_adc=bits, per_tile_adc=per_tile, keep=ones, **kw)
            b = kernel._launch("prefill", x, w, b_adc=bits, per_tile_adc=per_tile, **kw)
            same &= torch.equal(a, b)
    return same


def phase_lm_train(torch, gen, seed: int, accuracy: dict, b1_launched: set,
                   fa_launched: set, flash: dict, parent=None) -> dict:
    """Phase 16: LM training on the card (see the module docstring): (b)'s
    CPU child started first; (a) B1's bf16 training form at every LM
    training shape; (d) ``serve_drift_24h``; (b) one step of each stage
    card vs CPU; (c) tinyllama-1.1b trained on LM_RUN's layers through
    ``run_two_stage`` and resumed; then every B1 key and B3 shape the
    phase launched checked (phases 3 and 8's rules), and both kernels'
    training forms timed."""
    res, laps = {}, {}
    b1_before, fa_before = set(b1_launched), set(fa_launched)
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        laps[name] = time.perf_counter() - t0 - sum(laps.values())

    job = lm_step_start(torch, seed)
    lap("start")
    try:
        by_design = b1_by_design()
        checked, failures = set(map(tuple, accuracy["checked"])), []
        shapes = [(f"{name} M={m}", m, k, n) for m in (LM_STEP["batch"] * LM_STEP["seq"],
                                                        LM_RUN["batch"] * LM_RUN["seq"])
                  for name, k, n, _ in SHAPES]
        shapes.append(("two tiles", 64, 2048, 96))
        worst_ulps, ones_unequal = 0.0, []
        for name, m, k, n in shapes:
            x = torch.randn((m, k), generator=gen, device=DEV).bfloat16()
            w = (torch.randn((k, n), generator=gen, device=DEV) * k**-0.5).bfloat16()
            r = b1_train_cases(torch, name, x, w, True, by_design, checked, failures)
            worst_ulps = max(worst_ulps, r["unkept_ulps"])
            check(r["design"] == "prefill", f"lm (a): {name}'s keep launch ran {r['design']}")
            b1_cases(torch, name, x, w, "prefill", True, False, by_design, checked, failures)
            if not prefill_all_ones_bitwise(torch, x, w):
                ones_unequal.append(name)
        torch.cuda.synchronize()
        accuracy["checked"] = sorted(checked)
        res["a"] = {"shapes": [s[1:] for s in shapes], "worst": dict(by_design["prefill"]),
                    "unkept_ulps": worst_ulps, "failures": len(failures),
                    "all_ones_unequal": ones_unequal, "s": time.perf_counter() - t0}
        log(f"lm (a): B1's bf16 training form (prefill design) vs the plain training form at "
            f"{len(shapes)} shapes (M, K, N) {[s[1:] for s in shapes]}, b_adc 4/6/8, with a p = "
            f"0.5 mask and without: worst {by_design['prefill']}, unkept values within "
            f"{worst_ulps:.3f} output ulps, masks bitwise the CPU bridge's; out of tolerance: "
            f"{failures[:5] or 'none'}; an all-ones mask bitwise the serving launch at "
            f"{len(shapes) - len(ones_unequal)} of {len(shapes)} shapes")
        check(not failures, f"lm (a): {len(failures)} B1 bf16 training-form cases out of "
                            "tolerance")
        check(not ones_unequal, f"lm (a): the prefill design with an all-ones keep mask is "
                                f"bitwise the launch without one, except at {ones_unequal}")
        lap("a")
        res["drift"] = lm_serve_drift(torch)  # while the CPU child runs on
        lap("d")
        res["step"] = lm_step_check(torch, job)
        res["train_steps"] = job["train_steps"]
        lap("b")
    finally:
        if job["child"].poll() is None:
            job["child"].kill()
            job["child"].wait()
        job["log"].close()
    res["run"] = lm_train_run(torch)
    lap("c")
    keys = sorted(b1_launched - b1_before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy, by_design)
    checked_fa = {(r["rows"], r["S"], r["dtype"]) for r in flash["cases"]}
    train_fa = {(LM_STEP["batch"], LM_STEP["seq"], "float32"),
                (LM_STEP["batch"], LM_STEP["seq"], "bfloat16"),
                (LM_RUN["batch"], LM_RUN["seq"], "bfloat16")}
    check(train_fa <= fa_launched, f"lm: B3's training form launched at {sorted(train_fa)}")
    res["b3_checked_after"] = check_launched_fa(
        torch, gen, sorted((fa_launched - fa_before | train_fa) - checked_fa), flash)
    res["b3_max_abs"] = max(r["max_abs"] for r in flash["cases"]
                            if (r["rows"], r["S"], r["dtype"]) in train_fa)
    res["by_design"] = by_design
    lap("checks")
    tokens = LM_RUN["batch"] * LM_RUN["seq"]
    res["b1_timing"] = train_timing(
        torch, gen, [(name, tokens, k, n, count) for name, k, n, count in SHAPES],
        torch.bfloat16, f"one tinyllama-1.1b stage-2 forward at M = {tokens}", n_iter=10,
        parent=parent)
    res["b3_timing"] = lm_b3_timing(torch, gen)
    lap("timing")
    res["seconds"] = laps
    log(f"lm: seconds of phase 16's parts: { {k: round(v, 1) for k, v in laps.items()} }")
    steps = res["step"]["steps"]
    b1_of = lambda dtype: sum(s["counts"]["b1"] for n, s in steps.items() if n.startswith(dtype))
    res["launches"] = {"b1": b1_of("bfloat16") + res["run"]["b1_launches"],
                       "b1_fp32": b1_of("float32"),
                       "b3": sum(s["counts"]["b3"] for s in steps.values())
                       + res["run"]["b3_launches"]}
    return res


def lm_entries(lm: dict, train_mesh: dict, train_families: dict) -> list:
    """The kernels line's entries of phase 16: B1's bf16 training form (the
    prefill design with the keep mask) and B3's training form, with the
    launches of the (b) and (c) runs, of phase 19's sharded steps and of
    phase 20's steps."""
    b1, b3 = lm["b1_timing"]["per_forward"], lm["b3_timing"]
    tokens = LM_RUN["batch"] * LM_RUN["seq"]
    return [{
        "name": "analog_mvm.prefill.train",
        "route": "cuda",
        "source": "src/repro_torch/csrc/analog_mvm_tc.cu",
        "replaces": "src/repro/kernels/analog_mvm.py:41",
        "launches": lm["launches"]["b1"] + train_mesh["b1_launches"]
        + train_families["b1_prefill_launches"],
        "max_abs_err": lm["by_design"]["prefill"]["max_abs"],
        "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"], "library_ms": b1["library_ms"], "gemv_ms": b1["gemv_ms"],
        "per": f"one tinyllama-1.1b stage-2 forward at {tokens} tokens, bf16, p = 0.5 "
               f"quant-noise masks: {b1['launches']} launches; plain: the plain training form; "
               "library: torch.matmul of the same products; gemv_ms: the CUDA-core gemv "
               "design (this form's parent) on the same inputs, in turns; launches: the bf16 "
               "stage-2 steps of phase 16 (b) and (c), phase 19's sharded steps and phase "
               "20's steps (their prefill-design launches)",
        "max_err_adc_steps": lm["by_design"]["prefill"]["max_steps"],
        "pass": lm["a"]["failures"] == 0 and lm["b1_checked_after"]["failures"] == 0,
    }, {
        "name": "flash_attention.train",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": lm["launches"]["b3"] + train_mesh["b3_launches"]
        + train_families["b3_launches"],
        "max_abs_err": lm["b3_max_abs"],
        "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
        "bound_by": b3["bound_by"], "library_ms": b3["library_ms"],
        "per": f"the attention forwards of one tinyllama-1.1b training step at "
               f"{LM_RUN['batch']} x {LM_RUN['seq']} tokens, bf16 causal: 22 launches "
               "(library: scaled_dot_product_attention, is_causal, enable_gqa); the backward "
               "is the plain version's VJP, recomputed; launches: phase 16 (b) and (c), "
               "phase 19's sharded steps and phase 20's steps, both stages",
        "pass": lm["b3_checked_after"]["failures"] == 0,
    }]


def device_events(prof) -> list:
    """(name, start us, end us) of each device event of a finished trace,
    read from the profiler's raw results: no ``FunctionEvent`` is built."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def profile_summary(prof, kernel: str = "analog_mvm", wall_us=None, dev=None) -> dict:
    """Device time of one profiled step from the trace's device events
    (kernels and copies; ``dev``, as ``device_events`` gives them, in place
    of the trace's ``events()``): their busy union, the time of the kernels
    whose name holds ``kernel``, the host wall of the step (the host events'
    span, or ``wall_us`` of a trace without them) and the device's idle
    share of it. 'not measured' when the profiler recorded no device
    activity."""
    host = []
    if dev is None:
        events = prof.events()
        dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if str(e.device_type).endswith("CUDA")]
        host = [e for e in events if str(e.device_type).endswith("CPU")]
    if not dev or not (host or wall_us):
        return {k: "not measured" for k in (
            "profile_device_ms", "profile_kernel_ms", "profile_wall_ms",
            "profile_launches", "profile_idle_share", "profile_mvm_ms")}
    spans = sorted((s, e) for _, s, e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    mvm = sum(e - s for name, s, e in dev if kernel in name)
    b1 = sum(e - s for name, s, e in dev if "analog_mvm" in name)
    wall = wall_us or (max(e.time_range.end for e in host) - min(e.time_range.start for e in host))
    return {"profile_device_ms": round(busy / 1e3, 4),
            "profile_kernel_ms": round(mvm / 1e3, 4),
            "profile_mvm_ms": round(b1 / 1e3, 4),
            "profile_wall_ms": round(wall / 1e3, 4),
            "profile_launches": len(dev),
            "profile_idle_share": round(1 - busy / max(wall, 1e-9), 4)}


# --------------------------------------------------------------- the other LMs and MoE

#: phase 17's archs: (arch, depth, fused). depth None: the published depth,
#: cut to what the card holds; an int: at most that many layers (full
#: width); "smoke": the smoke config's width and depth (float32). fused:
#: the trace served through B2 too
ARCH_RUNS = (("olmo-1b", None, True), ("llama3.2-3b", None, True), ("qwen2-72b", 1, False),
             ("phi3.5-moe-42b-a6.6b", 2, False), ("llama4-maverick-400b-a17b", "smoke", False),
             ("mamba2-2.7b", None, False), ("recurrentgemma-9b", 5, False),
             ("paligemma-3b", None, True), ("musicgen-large", None, False))
#: each arch's Poisson trace and engine (a vision arch's s_max grows by its
#: image prefix: ``num_patches`` rows a request)
ARCH_TRACE = dict(n=8, rate=50.0, prompt_lens=(16, 32, 64, 128), new_tokens=(8, 16))
ARCH_SERVE = dict(n_slots=8, s_max=256)
#: a multi-codebook decoder (musicgen) is served as the reference serves it,
#: through ``launch/steps.py``'s step makers: one prefill of a rectangle of
#: ``rows`` x ``frames`` precomputed frame embeddings, then ``steps`` greedy
#: decode steps, each fed a fresh (rows, 1, d) frame row
CODEBOOK_RUN = dict(rows=8, frames=128, steps=16)
#: phase 17's budget, seconds (it fails past it)
ARCH_BUDGET_S = 300
#: the share of the card's free memory a programmed arch may plan to take
ARCH_MEMORY_SHARE = 0.95
#: B1's bank form timed per MoE layer at phi3.5-moe's shapes: a decode step
#: at 8 slots (M = 8: G = 8 groups of one token, C = 1) and a bucketed
#: 1 x 256 prefill (M = 32: G = 32 groups of 8 tokens, C = 1)
BANK_ARCH, BANK_MS = "phi3.5-moe-42b-a6.6b", (8, 32)
#: 2-D B1 launches of a block kind per forward (its analog linears): q/k/v/o
#: and the FFN; q/k/v/o (and a shared expert's 3; the bank launches apart);
#: the SSM's in/out_proj; the RG-LRU block's five and the FFN
MVMS_PER_BLOCK = {"attn": 7, "moe": 4, "ssm": 2, "rec": 8}
#: B3 with the local window and at D = 256: recurrentgemma-9b's attention
#: (heads, chunks) and the smoke width's (window 32)
RG_HEADS = dict(h=16, kv=1, d=256, q_chunk=512, kv_chunk=1024)
SMOKE_HEADS = dict(h=4, kv=1, d=16, q_chunk=16, kv_chunk=32)
#: paligemma-3b's attention: 8 query heads on one KV head of 256, no window
PALI_HEADS = dict(h=8, kv=1, d=256, q_chunk=512, kv_chunk=1024)
#: (rows, S, heads, window) of the window cases; the first is timed; the
#: last is paligemma's prefill: its 256-patch prefix and a 16-token prompt
B3_WINDOW_CASES = ((1, 4096, RG_HEADS, 2048), (2, 96, SMOKE_HEADS, 32), (1, 1024, RG_HEADS, None),
                   (1, 256 + 16, PALI_HEADS, None))
#: (heads, window, prompt lengths, buckets) of the padding check
B3_WINDOW_PADDING = ((SMOKE_HEADS, 32, (1, 17, 40, 100), (64, 128, 256)),
                     (RG_HEADS, 64, (100, 300), (512, 1024)),
                     (PALI_HEADS, None, (256 + 16, 256 + 100), (512,)))
#: the row kernels at recurrentgemma-9b's decode (8 slots, a 256-row rolling
#: buffer): each slot's length, past the buffer for most
RG_ROW_LENS = (1, 100, 255, 256, 257, 300, 600, 1000)
#: the row kernels at paligemma-3b's decode (8 slots of 512 rows: the
#: 256-patch prefix, a prompt and its budget): each slot's length
PALI_ROW_LENS = (257, 272, 300, 350, 384, 400, 450, 512)


def analog_weights(cfg) -> tuple:
    """(analog weights of ``cfg``, its largest programmed member): every
    layer's q/k/v/o projections and its FFN or expert bank (+ the shared
    expert), an SSM block's in/out_proj, an RG-LRU block's five linears and
    its FFN, the lm_head (``vocab`` columns a codebook) and a vision arch's
    ``patch_proj``."""
    from repro_torch.models.lm import block_period

    d, f = cfg.d_model, cfg.d_ff
    period = block_period(cfg)
    has_attn = bool({"attn", "moe"} & set(period))
    attn = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd if has_attn else 0
    w, d_in = cfg.lru_width or d, cfg.d_inner
    ssm_in = d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads)
    per = {"attn": attn + 3 * d * f,
           "moe": attn + 3 * cfg.n_experts * d * f + (3 * d * f if cfg.shared_expert else 0),
           "ssm": ssm_in + d_in * d,
           "rec": 3 * d * w + 2 * w * w + 3 * d * f}
    layers = [period[i % len(period)] for i in range(cfg.n_layers)]
    head = d * cfg.vocab * max(cfg.n_codebooks, 1)
    extras = d * d if cfg.frontend == "vision_patches" else 0
    largest = max(head, d * f, cfg.n_heads * cfg.hd * d if has_attn else 0,
                  ssm_in if "ssm" in period else 0, w * w if "rec" in period else 0)
    return sum(per[k] for k in layers) + head + extras, largest


def program_bytes(cfg, temp_per: float) -> float:
    """What programming ``cfg`` on the card takes at its peak: the weights
    (4 bytes), their PCM state and effective weights (20), the programming
    temporaries of the largest member's chunk (``temp_per`` a weight,
    measured; ``core/engine.py::_CHUNK``), the embedding table and 2 GiB for
    serving."""
    from repro_torch.core import engine

    n, largest = analog_weights(cfg)
    return (24 * n + temp_per * min(largest, engine._CHUNK) + 4 * cfg.vocab * cfg.d_model
            + 2 * 2**30)


def program_temp_per_weight(torch) -> float:
    """Bytes a weight of one (2048, 8192) member -- one chunk of
    ``core/engine.py::_CHUNK`` -- takes on the card while ``program_weight``
    programs it, beyond the 24 its input, state and effective weights keep."""
    from repro_torch import prng
    from repro_torch.core import engine, pcm

    w = prng.normal(prng.PRNGKey(0).to(DEV), (2048, 8192)) * 0.02
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.program_weight(prng.PRNGKey(1).to(DEV), w, torch.tensor(-1.0, device=DEV),
                                torch.tensor(1.0, device=DEV), 86400.0, pcm.PCMConfig())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out, w
    return max(peak / (2048 * 8192) - 20.0, 0.0)


def arch_config(torch, name: str, depth, temp_per: float):
    """The config phase 17 serves ``name`` at and what was cut: the smoke
    config, or the published widths at the depth asked (None: the
    published one), cut to the deepest that fits the card's free memory."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models.lm import block_period

    full = get(name)
    if depth == "smoke":
        return full.smoke(), "smoke width and depth (float32): one MoE layer of the published " \
                             "128 experts is ~16 B weights, past one card"
    free = torch.cuda.mem_get_info()[0] * ARCH_MEMORY_SHARE
    step = len(block_period(full))
    for n in range(min(depth or full.n_layers, full.n_layers), 0, -step):
        cfg = dataclasses.replace(full, n_layers=n)
        if program_bytes(cfg, temp_per) <= free:
            cut = None if n == full.n_layers else f"depth {n} of {full.n_layers}"
            return cfg, cut
    check(False, f"arch {name}: one layer at full width needs "
                 f"{program_bytes(dataclasses.replace(full, n_layers=step), temp_per) / 2**30:.1f}"
                 f" GiB to program, the card has {free / 2**30:.1f} free")


def moe_forward_launches(cfg, tokens_list: list, decode_steps: int, slots: int) -> dict:
    """B1 launches per forward expected of ``cfg``'s serving: the 2-D
    launches (every dense projection and shared expert, the lm_head) and the
    bank form's by design (3 per MoE layer, at M = groups x capacity of the
    forward's tokens) over prefills of ``tokens_list`` and ``decode_steps``
    steps at ``slots`` slots."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models import moe
    from repro_torch.models.lm import block_period

    period = block_period(cfg)
    kinds = [period[i % len(period)] for i in range(cfg.n_layers)]
    n_moe = kinds.count("moe")
    two_d = (sum(MVMS_PER_BLOCK[k] for k in kinds) + 3 * n_moe * cfg.shared_expert + 1)
    bank = dict.fromkeys(kernel.BANK_DESIGNS, 0)
    for tokens, n in [(t, 1) for t in tokens_list] + [(slots, decode_steps)]:
        if not n_moe:
            continue
        g, _, cap = moe.capacity(cfg, tokens)
        design = kernel.select_design(cfg.dtype, g * cap, cfg.d_model, cfg.d_ff)
        bank[design] += 3 * n_moe * n
    forwards = len(tokens_list) + decode_steps
    attn_layers = kinds.count("attn") + n_moe
    return {"b1": two_d * forwards, "bank": bank, "b3": attn_layers * len(tokens_list)}


def record_bank_shapes() -> set:
    """Record (E, M, K, N, dtype, design) of every bank-form launch made
    through the model's entry (``kernels.ops.analog_mvm_bank``) from here on."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops

    seen: set = set()
    entry = ops.analog_mvm_bank

    def recorded(x, w, **kw):
        e, k, n = w.shape
        m = x.numel() // (e * k)
        seen.add((e, m, k, n, str(x.dtype).split(".")[-1],
                  kernel.select_design(x.dtype, m, k, n, tile_rows=kw.get("tile_rows", 1024),
                                       per_tile_adc=kw.get("per_tile_adc", True))))
        return entry(x, w, **kw)

    ops.analog_mvm_bank = recorded
    return seen


def record_fa_heads() -> set:
    """Record (rows, S, heads, kv heads, head dim, dtype, window) of every
    prefill-attention launch made through the model from here on."""
    from repro_torch.models import attention

    seen: set = set()
    entry = attention.flash_attention

    def recorded(q, k, v, **kw):
        seen.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                  str(q.dtype).split(".")[-1], kw.get("window")))
        return entry(q, k, v, **kw)

    attention.flash_attention = recorded
    return seen


def bank_case(torch, gen, key: tuple, bits_list=(4, 6, 8)) -> dict:
    """The bank form at ``key`` (E, M, K, N, dtype, design) against its plain
    version under phase 3's tolerance model (each expert at its own GDC
    scalar's step) and each expert's slice bitwise the 2-D launch of the same
    design on it; the 2-D launches are checks, not main-path launches."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_bank_ref, n_tiles

    e, m, k, n, dtype, design = key
    dt = getattr(torch, dtype)
    x = torch.randn((e, m, k), generator=gen, device=DEV).to(dt)
    w = (torch.randn((e, k, n), generator=gen, device=DEV) * k**-0.5).to(dt)
    scales = 0.8 + 0.4 * torch.rand((e,), generator=gen, device=DEV)
    r_adc = torch.tensor(1.5, device=DEV)
    launches = kernel.analog_mvm.launches, dict(kernel.analog_mvm.design_launches)
    bank = kernel.analog_mvm_bank.launches, dict(kernel.analog_mvm_bank.design_launches)
    worst = {"max_abs": 0.0, "max_steps": 0.0, "frac_half_step": 0.0, "flips": 0,
             "elements": 0, "ok": True, "unequal_experts": []}
    for bits in bits_list:
        y = kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=scales, b_adc=bits)
        y_p = analog_mvm_bank_ref(x, w, r_adc, scales, b_adc=bits)
        for i in range(e):
            step = (1.5 + 1e-9) / (2 ** (bits - 1) - 1) * float(scales[i])
            r = compare(y[i], y_p[i], step, n_tiles(k, 1024, True), dt == torch.bfloat16)
            worst["ok"] &= r["ok"]
            worst["flips"] += r["flips"]
            worst["elements"] += r["elements"]
            for name in ("max_abs", "max_steps", "frac_half_step"):
                worst[name] = max(worst[name], r[name])
            alone = kernel.analog_mvm(x[i], w[i], r_adc=r_adc, out_scale=scales[i], b_adc=bits)
            if not torch.equal(alone, y[i]):
                worst["unequal_experts"].append((bits, i))
    kernel.analog_mvm.launches, kernel.analog_mvm.design_launches = launches[0], launches[1]
    kernel.analog_mvm_bank.launches = bank[0]
    kernel.analog_mvm_bank.design_launches = bank[1]
    worst["ok"] &= not worst["unequal_experts"]
    return worst


def bank_timing(torch, gen) -> dict:
    """One MoE layer's three families through the bank form at
    ``BANK_ARCH``'s widths (bf16), at each M of ``BANK_MS``: the kernel, the
    plain version, ``torch.bmm`` of the same products (yardstick only), the
    E 2-D launches a family would take one expert at a time, and the bound
    (every weight, input and output moved once at the HBM rate, or 2 E M K
    N operations at the bf16 peak), by CUDA events."""
    from repro_torch.configs import get
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_bank_ref

    cfg = get(BANK_ARCH)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    launches = kernel.analog_mvm.launches, dict(kernel.analog_mvm.design_launches)
    bank = kernel.analog_mvm_bank.launches, dict(kernel.analog_mvm_bank.design_launches)
    out = {}
    for m in BANK_MS:
        fams = []
        for k, n in ((d, f), (d, f), (f, d)):
            x = torch.randn((e, m, k), generator=gen, device=DEV).bfloat16()
            w = (torch.randn((e, k, n), generator=gen, device=DEV) * k**-0.5).bfloat16()
            fams.append((x, w, 0.8 + 0.4 * torch.rand((e,), generator=gen, device=DEV)))
        r_adc = torch.tensor(1.5, device=DEV)
        run_k = lambda i: [kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=s)
                           for x, w, s in fams]
        ms_k1 = time_ms(run_k, 10)
        ms_p = time_ms(lambda i: [analog_mvm_bank_ref(x, w, r_adc, s) for x, w, s in fams], 2)
        ms_l = time_ms(lambda i: [torch.bmm(x, w) for x, w, _ in fams], 10)
        ms_2d = time_ms(lambda i: [kernel.analog_mvm(x[j], w[j], r_adc=r_adc, out_scale=s[j])
                                   for x, w, s in fams for j in range(e)], 5)
        ms_k2 = time_ms(run_k, 10)
        bounds = [mvm_bound(e * m, k, n) for k, n in ((d, f), (d, f), (f, d))]
        # E independent (M, K) x (K, N) products: E K N weights, E M K inputs,
        # E M N outputs -- mvm_bound of (E M, K) x (K, N) counts one weight
        # matrix, so the weights of the other E - 1 experts are added
        extra = 3 * (e - 1) * d * f * 2 / HBM_BYTES_PER_S * 1e3
        t_bytes = sum(b["bytes"] for b in bounds) / HBM_BYTES_PER_S * 1e3 + extra
        t_ops = sum(b["flops"] for b in bounds) / BF16_FLOPS * 1e3
        row = {"M": m, "design": kernel.select_design(torch.bfloat16, m, d, f),
               "launches_per_layer": 3, "ms": min(ms_k1, ms_k2), "ms_readings": [ms_k1, ms_k2],
               "plain_ms": ms_p, "library_ms": ms_l, "loop_2d_ms": ms_2d,
               "loop_2d_launches": 3 * e, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out[m] = row
        log(f"bank: {BANK_ARCH} MoE layer at M = {m} ({row['design']}, 3 launches of E = {e}): "
            f"kernel {row['ms']:.4f} ms ({ms_k1:.4f}/{ms_k2:.4f}), plain {ms_p:.4f}, torch.bmm "
            f"{ms_l:.4f}, the {3 * e} 2-D launches {ms_2d:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of it)")
        del fams
    kernel.analog_mvm.launches, kernel.analog_mvm.design_launches = launches[0], launches[1]
    kernel.analog_mvm_bank.launches = bank[0]
    kernel.analog_mvm_bank.design_launches = bank[1]
    return out


def arch_forward_check(torch, params, acfg, cfg, batch: dict) -> dict:
    """One prompt's prefill (``batch``: its tokens, a vision request's
    patches too, or an audio rectangle row's frames) through the kernels
    and through the plain version (``engine.execute_mvm_plain`` for every
    MVM, a bank's experts one by one), every MVM of the plain forward also
    run through B1 on the same inputs and held to phase 3's ADC tolerance
    model: the worst MVM, the logits' rel L2 (ADC code flips grow with
    depth) and argmax (of each codebook of a multi-codebook head): the
    kernels' argmax must be a maximum of the plain logits -- their own
    argmax, or an index the plain logits tie with it exactly (the lm_head's
    outputs are ADC levels: a wide head ties at its maximum)."""
    from repro_torch.core import engine
    from repro_torch.kernels.ref import n_tiles
    from repro_torch.models.lm import lm_forward

    worst = {"mvms": 0, "failed": 0, "max_steps": 0.0, "frac_half_step": 0.0, "flips": 0,
             "elements": 0}

    def plain_and_compare(x_q, w, r_adc, plan, *, out_scale=1.0):
        y_p = engine.execute_mvm_plain(x_q, w, r_adc, plan, out_scale=out_scale)
        y_k = engine.execute_mvm(x_q, w, r_adc, plan, out_scale=out_scale)
        step = (abs(float(r_adc)) + 1e-9) / (2 ** (plan.spec.b_adc - 1) - 1) * abs(
            float(out_scale))
        r = compare(y_k, y_p, step, n_tiles(plan.k, plan.tile_rows, plan.per_tile_adc),
                    y_k.dtype == torch.bfloat16)
        worst["mvms"] += 1
        worst["failed"] += not r["ok"]
        worst["flips"] += r["flips"]
        worst["elements"] += r["elements"]
        for key in ("max_steps", "frac_half_step"):
            worst[key] = max(worst[key], r[key])
        return y_p

    logits_k, _ = lm_forward(params, batch, acfg, cfg, last_token_only=True)
    logits_p, _ = lm_forward(params, batch, acfg, cfg, last_token_only=True,
                             mvm=plain_and_compare)
    lk, lp = logits_k[0, -1].float(), logits_p[0, -1].float()
    rows_k, rows_p = lk.reshape(-1, lk.shape[-1]), lp.reshape(-1, lp.shape[-1])
    top_k, top_p = rows_k.argmax(-1), rows_p.argmax(-1)
    gap = rows_p.gather(1, top_p[:, None])[:, 0] - rows_p.gather(1, top_k[:, None])[:, 0]
    return {"rel_l2": ((lk - lp).norm() / lp.norm().clamp(min=1e-30)).item(),
            "argmax_equal": bool((top_k == top_p).all()),
            "argmax_agree": f"{int((top_k == top_p).sum())} of {top_k.numel()}",
            "argmax_gap": gap.tolist(), "argmax_at_plain_max": bool((gap == 0).all()),
            "plain_ties_at_max": (rows_p == rows_p.amax(-1, keepdim=True)).sum(-1).tolist(),
            "finite": bool(lk.isfinite().all()), "mvm": worst}


def log_forward_check(name: str, what: str, fc: dict) -> None:
    """Report and gate :func:`arch_forward_check`'s reading of ``name``."""
    log(f"arch {name}: a {what} prefill through the kernels vs the plain version: logits rel "
        f"L2 {fc['rel_l2']:.3e}, argmax equal {fc['argmax_equal']} ({fc['argmax_agree']}; the "
        f"plain logits at the kernels' argmax below their max by {fc['argmax_gap']}, plain "
        f"logits tied at the max {fc['plain_ties_at_max']}); each of its "
        f"{fc['mvm']['mvms']} MVMs through B1 on the plain forward's inputs under phase 3's "
        f"model: {fc['mvm']}")
    check(fc["finite"] and fc["argmax_at_plain_max"] and fc["mvm"]["failed"] == 0
          and fc["mvm"]["mvms"] > 0,
          f"arch {name}: the kernels' prefill against the plain version {fc}")


def decode_profile(torch, served) -> dict:
    """One decode step of ``served`` over all its slots (fresh states, every
    slot stepping) under the profiler: the card's kernels a step, its busy
    time and its idle share of the step's host wall (``profiled``)."""
    tok = torch.zeros((served.n_slots, 1), dtype=torch.int32, device=DEV)
    holder = {"cache": served.decoder.new_cache()}

    def step():
        holder["cache"] = served.decode_main(tok, holder["cache"])[2]

    step()  # warm
    return profiled(torch, step, top=6, host_events=False)


def arch_run(torch, name: str, depth, fused: bool, seed: int, temp_per: float) -> dict:
    """Program ``name`` on the card and serve phase 17's trace (see
    ``phase_archs``)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServingConfig, ServingEngine, poisson_trace

    gc.collect()
    torch.cuda.empty_cache()
    cfg, cut = arch_config(torch, name, depth, temp_per)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = engine.compile_program(params, AnalogConfig().infer(b_adc=8),
                                     prng.PRNGKey(seed + 1), device=DEV)
    torch.cuda.synchronize()
    t_program = time.perf_counter() - t0
    peak_program = torch.cuda.max_memory_allocated() - held
    n_weights = analog_weights(cfg)[0]
    # phase 17 neither ages nor refreshes: the chip's state and source
    # weights are dropped before serving
    program = dataclasses.replace(program, state={})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    trace = poisson_trace(prng.PRNGKey(seed + 7), ARCH_TRACE["n"], vocab=cfg.vocab,
                          rate=ARCH_TRACE["rate"], prompt_lens=ARCH_TRACE["prompt_lens"],
                          new_tokens=ARCH_TRACE["new_tokens"])
    out = {"arch": name, "cut": cut, "n_layers": cfg.n_layers, "dtype": str(cfg.dtype),
           "analog_weights": n_weights, "init_s": t_init, "program_s": t_program,
           "program_peak_gib": peak_program / 2**30,
           "program_estimate_gib": program_bytes(cfg, temp_per) / 2**30}
    if cfg.n_codebooks:
        out.update(codebook_run(torch, name, cut, cfg, program, seed))
        del program
        gc.collect()
        torch.cuda.empty_cache()
        return out
    serve_cfg = dict(ARCH_SERVE, s_max=ARCH_SERVE["s_max"] + cfg.num_patches)
    if cfg.frontend == "vision_patches":
        # every request its own image: fp32 normals from --seed cast to the
        # config's bf16 (the card's runs are not compared with JAX, so they
        # need not be JAX's bf16 draw)
        patches = prng.normal(prng.PRNGKey(seed + 8).to(DEV),
                              (len(trace), cfg.num_patches, cfg.d_model)).to(cfg.dtype)
        trace = [dataclasses.replace(q, features={"patches": patches[i:i + 1]})
                 for i, q in enumerate(trace)]
    out["s_max"] = serve_cfg["s_max"]
    runs = {}
    for mode in ("per_layer", "fused") if fused else ("per_layer",):
        served = ServingEngine.for_program(
            program, cfg, ServingConfig(**serve_cfg, fused_decode=mode == "fused"), device=DEV)
        served.run([Request(rid=-1, prompt=trace[0].prompt[:16], max_new_tokens=2,
                            features=trace[0].features)])  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = served.run(trace)
        torch.cuda.synchronize()
        counts = {"b1": kernel.analog_mvm.launches,
                  "bank": dict(kernel.analog_mvm_bank.design_launches),
                  "b3": fa.flash_attention.launches, "b2": decode_fused.launches,
                  "plain": plain_calls()}
        decode_steps = 0 if mode == "fused" else rep.n_steps
        want = moe_forward_launches(cfg, [int(q.prompt.size) for q in trace], decode_steps,
                                    ARCH_SERVE["n_slots"])
        # a feature-fed prefill runs patch_proj once more
        want["b1"] += sum(q.features is not None for q in trace)
        if mode == "fused":  # the prefills per layer, every decode step one B2 launch
            want["b2"] = rep.n_steps
        else:
            want["b2"] = 0
        runs[mode] = {**serve_metrics(rep), "counts": counts, "want": want,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "tokens": {r.rid: r.tokens.tolist() for r in rep.records},
                      "requests": rep.n_requests, "generated": rep.n_generated}
        log(f"arch {name} ({cut or 'published size'}, {cfg.n_layers} layers, {n_weights} "
            f"analog weights) {mode}: {rep.n_requests} requests, {rep.n_generated} tokens, "
            f"{rep.n_steps} decode steps, {runs[mode]['ms_per_decode_step']:.2f} ms/decode step, "
            f"{runs[mode]['tokens_per_s']:.1f} tokens/s, ttft p50 {runs[mode]['ttft_p50_s']:.3f} s, "
            f"peak memory {runs[mode]['peak_gib']:.1f} GiB; launches {counts} (want {want})")
        check(rep.n_requests == len(trace) and all(
            r.n_new == q.max_new_tokens
            for r, q in zip(sorted(rep.records, key=lambda r: r.rid), trace)),
            f"arch {name} {mode}: every request retires with its budget")
        check(counts["plain"] == 0, f"arch {name} {mode}: no plain-version call")
        check(counts["b1"] == want["b1"] and counts["bank"] == want["bank"]
              and counts["b3"] == want["b3"] and counts["b2"] == want["b2"],
              f"arch {name} {mode}: launches {counts}, want {want}")
        if mode == "per_layer":
            prof = runs[mode]["decode_profile"] = decode_profile(torch, served)
            log(f"arch {name}: one decode step at {served.n_slots} slots profiled: "
                f"{prof['profile_launches']} device kernels, device busy "
                f"{prof['profile_device_ms']} ms of {prof['profile_wall_ms']} ms, idle share "
                f"{prof['profile_idle_share']}; top kernels {prof.get('top_kernels')}")
            out["forward_check"] = arch_forward_check(
                torch, served.params, served.acfg, cfg, served._prefill_inputs(trace[0]))
            log_forward_check(name, f"{trace[0].prompt.size}-token", out["forward_check"])
        del served
    if fused:
        same = runs["fused"]["tokens"] == runs["per_layer"]["tokens"]
        log(f"arch {name}: fused tokens == per-layer tokens: {same}")
        check(same, f"arch {name}: B2 serves the per-layer tokens")
    for r in runs.values():
        r.pop("tokens")
    out["runs"] = runs
    del program
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_probe(torch, n: int = 2000) -> dict:
    """The host's dispatch speed now: us a launch of ``n`` tiny adds on the
    card (to the synchronize), the Python threads alive and the objects the
    garbage collector tracks."""
    import threading

    x = torch.zeros(16, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return {"us_per_launch": round((time.perf_counter() - t0) / n * 1e6, 3),
            "threads": threading.active_count(), "gc_objects": len(gc.get_objects())}


def codebook_run(torch, name: str, cut, cfg, program, seed: int) -> dict:
    """Serve a multi-codebook decoder as the reference serves it (its
    engine and CLI refuse one): ``launch/steps.py``'s ``make_prefill_step``
    over ``CODEBOOK_RUN``'s rectangle of precomputed frame embeddings (fp32
    normals from ``--seed`` cast to bf16), then its greedy
    ``make_serve_step`` calls, each fed a fresh frame row and emitting
    (rows, C) codes. A warm run first, then the counted and timed run
    (host clock, each step to its synchronize): prefill s, decode ms a
    step, codes per second; exact B1 and B3 launch counts and no plain
    call; one decode step profiled; one row's prefill against the plain
    forward (every MVM under phase 3's model, each codebook's argmax). The
    host's speed is read just before the timed run (``host_probe``): the
    step is host-bound, so its time tracks the host's dispatch cost."""
    from repro_torch import prng
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import init_lm_cache

    b, s, n = CODEBOOK_RUN["rows"], CODEBOOK_RUN["frames"], CODEBOOK_RUN["steps"]
    c = cfg.n_codebooks
    # the program's fp32 weights, as a caller holds them: the step makers
    # cast them to the activations' dtype once
    params, acfg = program.params, program.cfg
    frames = prng.normal(prng.PRNGKey(seed + 9).to(DEV), (b, s + n + 1, cfg.d_model)).to(cfg.dtype)
    prefill = make_prefill_step(cfg, acfg, device=DEV)
    step = make_serve_step(cfg, acfg, device=DEV)
    rng = prng.PRNGKey(seed + 10)

    def run() -> tuple:
        # one spare row for the profiled step
        cache = init_lm_cache(cfg, b, s + n + 1, cfg.dtype, device=DEV)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"frames": frames[:, :s]}, cache, rng)
        codes = [logits[:, -1].argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        t_prefill, step_s = time.perf_counter() - t0, []
        for i in range(n):
            t0 = time.perf_counter()
            code, cache = step(params, {"frames": frames[:, s + i:s + i + 1]}, cache, rng)
            codes.append(code)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        return torch.stack(codes, 1), t_prefill, step_s, cache

    run()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe = host_probe(torch)
    reset_counts()
    codes, t_prefill, step_s, cache = run()
    counts = {"b1": kernel.analog_mvm.launches,
              "bank": dict(kernel.analog_mvm_bank.design_launches),
              "b3": fa.flash_attention.launches, "b2": decode_fused.launches,
              "plain": plain_calls()}
    want = moe_forward_launches(cfg, [b * s], n, b)  # one prefill forward, n decode steps
    want["b2"] = 0
    t_decode = sum(step_s)
    emitted = b * c * (n + 1)
    run_ = {"prefill_s": t_prefill, "ms_per_decode_step": t_decode / n * 1e3,
            "ms_per_decode_step_p50": statistics.median(step_s) * 1e3,
            "wall_s": t_prefill + t_decode, "codes": emitted,
            "codes_per_s": emitted / (t_prefill + t_decode),
            "decode_codes_per_s": b * c * n / t_decode,
            "codes_shape": list(codes.shape), "counts": counts, "want": want,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "host_probe": probe}
    log(f"arch {name} ({cut or 'published size'}, {cfg.n_layers} layers) through the step "
        f"makers: a {b} x {s} frame prefill {t_prefill:.3f} s, {n} decode steps "
        f"{run_['ms_per_decode_step']:.2f} ms a step (p50 {run_['ms_per_decode_step_p50']:.2f}),"
        f" {emitted} codes {tuple(codes.shape)}, {run_['codes_per_s']:.1f} codes/s "
        f"({run_['decode_codes_per_s']:.1f} in decode), peak memory {run_['peak_gib']:.1f} GiB; "
        f"launches {counts} (want {want}); host before the run: {probe}")
    check(tuple(codes.shape) == (b, n + 1, c) and bool(((codes >= 0) & (codes < cfg.vocab))
                                                       .all()),
          f"arch {name}: every step emits ({b}, {c}) codes in the vocabulary")
    check(counts["plain"] == 0, f"arch {name}: no plain-version call")
    check(counts["b1"] == want["b1"] and counts["b3"] == want["b3"] and counts["b2"] == 0
          and not any(counts["bank"].values()), f"arch {name}: launches {counts}, want {want}")
    row = frames[:, s + n:s + n + 1]
    prof = run_["decode_profile"] = profiled(
        torch, lambda: step(params, {"frames": row}, cache, rng), top=6, host_events=False)
    prof["host_us_per_kernel"] = (
        (run_["ms_per_decode_step"] - prof["profile_device_ms"]) * 1e3 / prof["profile_launches"]
        if isinstance(prof["profile_launches"], int) else "not measured")
    log(f"arch {name}: one decode step at {b} rows profiled: {prof['profile_launches']} device "
        f"kernels, device busy {prof['profile_device_ms']} ms of {prof['profile_wall_ms']} ms, "
        f"idle share {prof['profile_idle_share']}; the timed steps' host time a kernel "
        f"{prof['host_us_per_kernel']} us; top kernels {prof.get('top_kernels')}")
    fc = arch_forward_check(torch, params, acfg, cfg, {"frames": frames[:1, :s]})
    log_forward_check(name, f"1 x {s}-frame", fc)
    return {"forward_check": fc, "runs": {"steps": run_}}


def phase_archs(torch, gen, seed: int, accuracy: dict, b1_launched: set, flash: dict) -> dict:
    """Phase 17 (see the module docstring): each of ``ARCH_RUNS`` programmed
    and served (``arch_run``), then the new B1 keys, bank keys and B3 shapes
    checked, and the bank form timed."""
    t0 = time.perf_counter()
    b1_before = set(b1_launched)
    bank_seen, fa_seen = record_bank_shapes(), record_fa_heads()
    temp_per = program_temp_per_weight(torch)
    log(f"archs: programming temporaries {temp_per:.1f} bytes a weight of the member being "
        f"programmed (beyond its 24); {torch.cuda.memory_allocated() / 2**30:.2f} GiB held, "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB free")
    res = {"temp_bytes_per_weight": temp_per, "archs": {}}
    for name, depth, fused in ARCH_RUNS:
        res["archs"][name] = arch_run(torch, name, depth, fused, seed, temp_per)
    t_serve = time.perf_counter() - t0
    keys = sorted(b1_launched - b1_before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy)
    heads = sorted(fa_seen, key=str)
    fa_failures = []
    for rows, s, h, kv, d, dtype, window in heads:
        fa_cases(torch, gen, rows, s, getattr(torch, dtype), flash["cases"], fa_failures,
                 heads=dict(h=h, kv=kv, d=d), window=window)
    torch.cuda.synchronize()
    flash["worst_bf16_ulps"] = max(r["max_ulps"] for r in flash["cases"]
                                   if r["max_ulps"] is not None)
    log(f"archs: B3 vs plain at every (rows, S, heads, kv heads, head dim, dtype, window) "
        f"phase 17 "
        f"launched ({len(heads)}): out of tolerance {fa_failures or 'none'}")
    check(not fa_failures, f"archs: {len(fa_failures)} B3 cases out of tolerance")
    res["b3_checked"] = heads
    bank = {}
    for key in sorted(bank_seen):
        bank[key] = bank_case(torch, gen, key)
    torch.cuda.synchronize()
    bad = {k: v for k, v in bank.items() if not v["ok"]}
    worst = max((v["max_abs"] for v in bank.values()), default=0.0)
    log(f"archs: B1's bank form vs its plain version at every key launched (E, M, K, N, dtype, "
        f"design) {sorted(bank)}: worst max |d| {worst:.3e} "
        f"({max((v['max_steps'] for v in bank.values()), default=0.0):.3f} ADC steps), every "
        f"expert bitwise its 2-D launch: {all(not v['unequal_experts'] for v in bank.values())}; "
        f"out of tolerance {list(bad) or 'none'}")
    check(bank and not bad, f"archs: bank form cases out of tolerance or unequal: {bad}")
    check({k[-1] for k in bank} == {"decode", "prefill", "tiled"},
          f"archs: the bank form ran its three designs ({sorted({k[-1] for k in bank})})")
    res["bank_cases"] = {str(k): v for k, v in bank.items()}
    res["bank_max_abs"] = worst
    res["bank_timing"] = bank_timing(torch, gen)
    res["bank_launches"] = sum(sum(r["counts"]["bank"].values())
                               for a in res["archs"].values() for r in a["runs"].values())
    res["b3_launches"] = sum(r["counts"]["b3"] for a in res["archs"].values()
                             for r in a["runs"].values())
    res["b3_window"] = b3_window(torch, gen, flash)
    res["rows_hd256"] = row_checks(torch, gen, SLOTS, 4096, 16, 1, 256, 256, 12288,
                                   lens=RG_ROW_LENS, timed=False, what="recurrentgemma hd 256",
                                   p_flip=True)
    res["rows_paligemma"] = row_checks(torch, gen, SLOTS, 2048, 8, 1, 256, 512, 16384,
                                       lens=PALI_ROW_LENS, timed=False,
                                       what="paligemma hd 256", p_flip=True)
    res["rows_musicgen"] = row_checks(torch, gen, CODEBOOK_RUN["rows"], 2048, 32, 32, 64,
                                      CODEBOOK_RUN["frames"] + CODEBOOK_RUN["steps"] + 1, 8192,
                                      timed=False, what="musicgen 32/32 heads")
    res["seconds"] = {"serve": t_serve, "total": time.perf_counter() - t0}
    log(f"archs: phase 17 took {res['seconds']['total']:.1f} s (serving {t_serve:.1f} s) of its "
        f"{ARCH_BUDGET_S} s budget")
    check(res["seconds"]["total"] <= ARCH_BUDGET_S,
          f"archs: phase 17 within its {ARCH_BUDGET_S} s budget")
    return res


def bank_entry(archs: dict, mesh: dict) -> dict:
    """The kernels line's entry of B1's bank form: phases 17 and 18's MoE
    launches and its timing at phi3.5-moe's decode step."""
    t = archs["bank_timing"][BANK_MS[0]]
    p = archs["bank_timing"][BANK_MS[1]]
    return {
        "name": "analog_mvm.bank",
        "route": "cuda",
        "source": "src/repro_torch/csrc/analog_mvm_tc.cu",
        "replaces": "src/repro/kernels/analog_mvm.py:41 (pallas_call :147, vmapped over the "
                    "experts at src/repro/models/moe.py:120)",
        "launches": archs["bank_launches"] + sum(
            r["counts"]["bank"] for r in mesh["phi3.5"]["runs"].values()),
        "max_abs_err": max([archs["bank_max_abs"]] + [
            v["max_abs"] for v in mesh["bank_cases"].values()]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "loop_2d_ms": t["loop_2d_ms"],
        "prefill": {k: p[k] for k in ("M", "ms", "plain_ms", "library_ms", "loop_2d_ms",
                                      "bound_ms", "bound_by")},
        "per": f"one {BANK_ARCH} MoE layer at a decode step of 8 slots (M = 8 rows an expert, "
               "bf16): "
               "3 launches (w1, w3 4096 x 6400; w2 6400 x 4096) of the decode design over the "
               "16 experts; library: torch.bmm of the same products; loop_2d_ms: the 48 2-D "
               "launches it replaces; prefill: the same at a bucketed 1 x 256 prefill (M = 32, "
               "the prefill design); launches: phases 17 and 18's MoE serving (phi3.5-moe's "
               "decode and prefill designs, llama4-maverick's smoke-width tiled design, "
               "phase 18's shard_map and einsum runs); max_abs_err over every bank key launched",
        "pass": True,
    }


#: phase 18's budget, seconds (it fails past it)
MESH_BUDGET_S = 130
#: phase 18 serves this many of phase 4's requests at 8 slots, each cut to
#: its first MESH_NEW_TOKENS tokens
MESH_REQUESTS = 8
MESH_NEW_TOKENS = 16
#: phase 18's other families at full width, (arch, depth): mamba2-2.7b on 4
#: of its 64 layers, recurrentgemma-9b on one (rec, rec, attn) period,
#: paligemma-3b and musicgen-large on 2 layers; each programmed through the
#: mesh and unsharded at one key, MESH_FAMILY_REQUESTS of phase 17's
#: requests (musicgen: its rectangle, MESH_CODEBOOK_STEPS decode steps)
#: served on both chips; with the CNN's, MESH_FAMILIES_BUDGET_S of the
#: phase's MESH_BUDGET_S (reported; the phase's budget is the gate: two
#: programmings of 2.85 B weights read 36.0-42.5 s across hosts)
MESH_FAMILIES = (("mamba2-2.7b", 4), ("recurrentgemma-9b", 3), ("paligemma-3b", 2),
                 ("musicgen-large", 2))
MESH_FAMILY_REQUESTS, MESH_FAMILY_NEW_TOKENS, MESH_CODEBOOK_STEPS = 4, 8, 8
MESH_FAMILIES_BUDGET_S = 40
#: the CNN phase 18 programs with shardings= and its crossbar transforms,
#: against phase 14's chip of it; the images its logits are held on
MESH_CNN, MESH_CNN_IMAGES = "analognet-kws", 4
#: phase 19's hybrid stack: recurrentgemma-9b on one period at full width,
#: with Adafactor (AdamW's two fp32 moments of its 2.75 B params, with the
#: step's own copies, pass the card's 80 GB); its share of the phase's
#: TRAIN_MESH_BUDGET_S (reported; the phase's budget is the gate)
TRAIN_MESH_HYBRID = ("recurrentgemma-9b", 3)
TRAIN_MESH_HYBRID_BUDGET_S = 15


def tree_digest(torch, trees: dict) -> dict:
    """Two exact integer checksums of every leaf of each named tree (its
    bits as integers: their sum, and their sum weighted by position mod
    65521), with its dtype and shape: equal digests mean the same bits but
    for an astronomically unlikely collision."""
    from repro_torch.checkpoint import store

    out = {}
    for part, tree in trees.items():
        for k, t in store._flatten(tree).items():
            out[f"{part}::{k}"] = t.digest if isinstance(t, _Digest) else leaf_digest(torch, t)
    return out


def leaf_digest(torch, t) -> tuple:
    """One leaf's (dtype, shape, sum, weighted sum) of :func:`tree_digest`."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = t.detach().contiguous().view(-1).view(ints[t.element_size()]).long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return (str(t.dtype), tuple(t.shape), int(v.sum()), int((v * w).sum()))


class _Digest:
    """A leaf already digested (:func:`program_digest`)."""

    __slots__ = ("digest",)

    def __init__(self, digest: tuple):
        self.digest = digest


def chip_digest(torch, program) -> dict:
    """:func:`tree_digest` of a chip's params and state."""
    return tree_digest(torch, {"params": program.params, "state": program.state})


def program_digest(torch, program) -> dict:
    """:func:`chip_digest` of ``program``'s host chip: a sharded chip's split
    leaves all-gathered and digested one at a time (its whole gathered chip
    does not fit beside the shards at full width), the rest as they lie."""
    from repro_torch import collectives
    from repro_torch.core import engine

    if program.mesh is None:
        return chip_digest(torch, program)
    axis, state = program.axis, {}

    def node_fn(path: str, node: dict) -> dict:
        split = node.get("tp")
        if split is None:
            state[path] = program.state[path]
            return node
        new, state[path] = engine._map_layer(node, program.state[path], lambda t, d: _Digest(
            leaf_digest(torch, collectives.all_gather_dim(t, d, split.bounds, axis))))
        return new

    params = engine._walk(program.params, node_fn)
    embed = getattr(params, "embed", None)
    if isinstance(embed, dict) and "tp" in embed:
        split = embed["tp"]
        table = _Digest(leaf_digest(torch, collectives.all_gather_dim(
            embed["table"], -2, split.bounds, axis)))
        params = params._replace(embed={**{k: v for k, v in embed.items() if k != "tp"},
                                        "table": table})
    return tree_digest(torch, {"params": params, "state": state})


def mesh_counts(torch) -> dict:
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_rows as dr
    from repro_torch.kernels import flash_attention as fa

    return {"b1": kernel.analog_mvm.launches, "designs": dict(kernel.analog_mvm.design_launches),
            "bank": kernel.analog_mvm_bank.launches,
            "bank_designs": dict(kernel.analog_mvm_bank.design_launches),
            "b3": fa.flash_attention.launches, "rows": dict(dr.launches), "plain": plain_calls()}


@contextlib.contextmanager
def nccl_mesh():
    """Phases 18 and 19's process group, NCCL at world size 1 over a store
    in a temp dir, and its (data 1, model 1) mesh; the group destroyed and
    the logical rules cleared at the end."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.common import set_logical_rules

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        mesh_lib.init_process_group("cuda", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1, timeout_s=60)
        yield mesh_lib.make_serving_mesh(1)
    finally:
        set_logical_rules({})
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh(torch, gen, seed: int, mesh, chip4: dict, tokens4: dict, trace4: list,
               accuracy: dict, b1_launched: set, checked_banks: set, cnn_reference: dict) -> dict:
    """Phase 18 (see the module docstring), over ``mesh`` (:func:`nccl_mesh`)."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import collectives, prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.launch import steps
    from repro_torch.models.common import set_logical_rules
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServingConfig, ServingEngine

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    acfg = AnalogConfig().infer(b_adc=8)
    res = {}
    b1_before = set(b1_launched)
    bank_seen = record_bank_shapes()
    try:
        res["backend"] = dist.get_backend()
        # (1) tinyllama-1.1b at full width and depth
        cfg = get("tinyllama-1.1b")
        params = lm_init(prng.PRNGKey(seed), cfg, device=DEV)
        collectives.reset_stats()
        t1 = time.perf_counter()
        program = steps.program_for_serving(params, acfg, prng.PRNGKey(seed + 1), mesh=mesh,
                                            model_cfg=cfg)
        torch.cuda.synchronize()
        res["program_s"] = time.perf_counter() - t1
        res["program_collectives"] = collectives.stats["calls"]
        del params
        splits = []
        engine._walk(program.params, lambda path, node: splits.append(node.get("tp")) or node)
        res["layers_split"] = f"{sum(sp is not None for sp in splits)} of {len(splits)}"
        same = program_digest(torch, program) == chip4
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh: tinyllama-1.1b programmed over a {res['backend']} mesh of 1 in "
            f"{res['program_s']:.2f} s ({res['program_collectives']} collective calls; "
            f"{res['layers_split']} layers carry a split); gathered == phase 4's chip, every "
            f"param and state leaf: {same}")
        check(same, "mesh: the sharded chip gathered is bitwise phase 4's chip")
        served = ServingEngine.for_program(program, cfg, ServingConfig(n_slots=SLOTS, s_max=512),
                                           device=DEV)
        check(served.mesh is mesh, "mesh: the engine serves over the chip's mesh")
        # phase 4's first requests, cut to their first MESH_NEW_TOKENS tokens
        # (greedy: the prefix of what phase 4 served them)
        reqs = [dataclasses.replace(q, max_new_tokens=min(q.max_new_tokens, MESH_NEW_TOKENS))
                for q in trace4[:MESH_REQUESTS]]
        served.run([Request(rid=-1, prompt=reqs[0].prompt[:16], max_new_tokens=4)])  # warm
        torch.cuda.synchronize()
        reset_counts()
        collectives.reset_stats()
        rep = served.run(reqs)
        torch.cuda.synchronize()
        counts = mesh_counts(torch)
        coll = dict(collectives.stats)
        forwards = rep.n_requests + rep.n_steps
        want = {"b1": LAUNCHES_PER_FORWARD * forwards,
                "designs": b1_designs([(1, q.prompt.size) for q in reqs], rep.n_steps),
                "b3": FA_LAUNCHES_PER_PREFILL * rep.n_requests,
                "rows": {k: v * rep.n_steps for k, v in rows_per_forward(cfg).items()}}
        tokens = {r.rid: r.tokens.tolist() for r in rep.records}
        same_tokens = tokens == {q.rid: tokens4[q.rid][:q.max_new_tokens] for q in reqs}
        res["tinyllama"] = {
            **serve_metrics(rep), "counts": counts, "want": want, "tokens_equal": same_tokens,
            "seconds": time.perf_counter() - t0,
            "b1_per_decode_step": LAUNCHES_PER_FORWARD,
            "collective_calls": coll["calls"], "collective_calls_per_forward": coll["calls"]
            / forwards, "collective_s": coll["seconds"],
            "collective_host_share": coll["seconds"] / max(rep.t_decode + rep.t_prefill, 1e-9)}
        t = res["tinyllama"]
        log(f"mesh: tinyllama-1.1b served over the mesh: {rep.n_requests} requests, "
            f"{rep.n_generated} tokens, {rep.n_steps} decode steps, "
            f"{t['ms_per_decode_step']:.2f} ms/decode step, {t['tokens_per_s']:.1f} tokens/s; "
            f"{coll['calls']} collective calls ({t['collective_calls_per_forward']:.2f} a "
            f"forward), {coll['seconds'] * 1e3:.1f} ms of host clock, share "
            f"{t['collective_host_share']:.4f}; tokens == phase 4's: {same_tokens}; launches "
            f"b1 {counts['b1']} {counts['designs']} b3 {counts['b3']} plain {counts['plain']} "
            f"(want {want['b1']} {want['designs']} b3 {want['b3']})")
        check(same_tokens, "mesh: phase 4's tokens")
        check(counts["plain"] == 0, "mesh: no plain-version call")
        check(counts["b1"] == want["b1"] and counts["designs"] == want["designs"]
              and counts["b3"] == want["b3"] and counts["rows"] == want["rows"],
              "mesh: phase 4's B1 (155 a forward, by design), B3 and row-kernel launches")
        check(coll["calls"] > 0, "mesh: the sharded forward ran its collectives")
        # (4) a mesh refuses fused decode, in the reference's words
        try:
            ServingEngine.for_program(program, cfg, ServingConfig(n_slots=SLOTS, s_max=64,
                                                                  fused_decode=True), device=DEV)
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        res["fused_refusal"] = refused
        check("sharded serving keeps the per-layer path" in refused,
              f"mesh: fused decode refused with the reference's words ({refused!r})")
        del served, program
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res["phi3.5"] = mesh_moe(torch, seed, mesh, acfg)
        res["phi3.5"]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        res["artifact"] = mesh_artifact(torch, seed, mesh, acfg, tmp, trace4)
        res["artifact"]["seconds"] = time.perf_counter() - t1
        # the other families and the CNN
        t1 = time.perf_counter()
        res["families"] = {name: mesh_family(torch, name, depth, seed, mesh, acfg)
                           for name, depth in MESH_FAMILIES}
        res["cnn"] = mesh_cnn(torch, seed, mesh, cnn_reference)
        res["families_s"] = time.perf_counter() - t1
        log(f"mesh: the other families and the CNN took {res['families_s']:.1f} s against "
            f"their {MESH_FAMILIES_BUDGET_S} s share of the phase's budget (within: "
            f"{res['families_s'] <= MESH_FAMILIES_BUDGET_S}; "
            f"{ {n: round(f['seconds'], 1) for n, f in res['families'].items()} }, "
            f"{MESH_CNN} {res['cnn']['seconds']:.1f})")
    finally:
        set_logical_rules({})
        shutil.rmtree(tmp, ignore_errors=True)
    keys = sorted(b1_launched - b1_before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy)
    t1 = time.perf_counter()
    new_banks = sorted(bank_seen - checked_banks)
    # at the bitwidth the phase served (phase 17 holds its keys at 4, 6, 8)
    banks = {key: bank_case(torch, gen, key, bits_list=(8,)) for key in new_banks}
    bad = [k for k, v in banks.items() if not v["ok"]]
    log(f"mesh: B1's bank form vs its plain version at the new keys {new_banks}: out of "
        f"tolerance {bad or 'none'}")
    check(not bad, f"mesh: bank form cases out of tolerance or unequal: {bad}")
    res["bank_cases"] = {str(k): v for k, v in banks.items()}
    res["checks_s"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"mesh: phase 18 took {res['seconds']:.1f} s of its {MESH_BUDGET_S} s budget "
        f"(tinyllama {res['tinyllama']['seconds']:.1f}, phi3.5-moe "
        f"{res['phi3.5']['seconds']:.1f}, artifact {res['artifact']['seconds']:.1f}, the "
        f"other families and the CNN {res['families_s']:.1f}, the new keys' checks "
        f"{res['checks_s']:.1f})")
    check(res["seconds"] <= MESH_BUDGET_S, f"mesh: phase 18 within its {MESH_BUDGET_S} s budget")
    return res


def phase_train_mesh(torch, gen, seed: int, mesh, reference: dict, accuracy: dict,
                     b1_launched: set, fa_launched: set, flash: dict) -> dict:
    """Phase 19 (see the module docstring): phase 16 (b)'s 2-layer stack
    drawn again from ``seed``, its stage-1 and stage-2 steps through the
    sharded train step over ``mesh`` (:func:`lm_train_steps`), each held
    to 16 (b)'s unsharded step (``reference``): the params, optimizer
    state and metrics bitwise (their digests), the same B1 (by design), B3
    and recompute launches, no plain call; then every new B1 key checked
    as phase 3 checks its own and every new B3 shape as phase 8 does."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.models import lm

    t0 = time.perf_counter()
    b1_before, fa_before = set(b1_launched), set(fa_launched)
    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_STEP["layers"], remat=False)
    params = lm.lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    res = {"init_equal": tree_digest(torch, {"params": params}) == reference["init"]}
    check(res["init_equal"], "train mesh: the stack drawn again is 16 (b)'s")
    got = lm_train_steps(torch, params, cfg, mesh)
    del params
    res["stages"] = {}
    for stage, g in got.items():
        want = reference[stage]
        same = g["digest"] == want["digest"]
        share = g["collective_s"] / g["s"]
        res["stages"][stage] = {
            "ms": g["s"] * 1e3, "unsharded_ms": want["s"] * 1e3, "cold_ms": g["cold_s"] * 1e3,
            "unsharded_cold_ms": want["cold_s"] * 1e3, "counts": g["counts"],
            "unsharded_counts": want["counts"], "bitwise": same,
            "repeats_bitwise": g["repeats_bitwise"], "metrics": g["metrics"],
            "collective_calls": g["collective_calls"], "collective_host_share": share}
        log(f"train mesh: stage {stage} through the sharded step over a (1, 1) NCCL mesh: "
            f"params, optimizer state and metrics == 16 (b)'s unsharded step: {same}, a second "
            f"run == the first: {g['repeats_bitwise']}; warm {g['s'] * 1e3:.2f} ms a step "
            f"(unsharded {want['s'] * 1e3:.2f}), cold {g['cold_s'] * 1e3:.2f} (unsharded "
            f"{want['cold_s'] * 1e3:.2f}); {g['collective_calls']} collective calls, "
            f"{g['collective_s'] * 1e3:.2f} ms of host clock, share {share:.4f}; launches "
            f"{g['counts']} (unsharded {want['counts']}); metrics {g['metrics']}")
        check(same and g["repeats_bitwise"] and want["repeats_bitwise"],
              f"train mesh: stage {stage} bitwise 16 (b)'s unsharded step, each run twice the "
              "same")
        check(g["counts"] == want["counts"] and g["counts"]["plain"] == 0
              and (stage == 1 or g["counts"]["b1"] > 0) and g["counts"]["b3"] > 0,
              f"train mesh: stage {stage}'s B1 and B3 launches the unsharded step's, "
              "no plain call")
        check(g["collective_calls"] > 0, f"train mesh: stage {stage} ran its collectives")
    res["hybrid"] = train_mesh_hybrid(torch, seed, mesh)
    res["b1_launches"] = (sum(g["counts"]["b1"] for g in got.values())
                          + res["hybrid"]["b1_launches"])
    res["b3_launches"] = (sum(g["counts"]["b3"] for g in got.values())
                          + res["hybrid"]["b3_launches"])
    t1 = time.perf_counter()
    keys = sorted(b1_launched - b1_before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy)
    res["b3_new_shapes"] = sorted(fa_launched - fa_before)
    checked_fa = {(r["rows"], r["S"], r["dtype"]) for r in flash["cases"]}
    res["b3_checked_after"] = check_launched_fa(
        torch, gen, sorted(set(res["b3_new_shapes"]) - checked_fa), flash)
    res["checks_s"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"train mesh: phase 19 took {res['seconds']:.1f} s of its {TRAIN_MESH_BUDGET_S} s "
        f"budget ({TRAIN_MESH_HYBRID[0]} {res['hybrid']['seconds']:.1f}, the new keys' checks "
        f"{res['checks_s']:.1f}); new B1 keys {keys or 'none'}, new B3 shapes "
        f"{res['b3_new_shapes'] or 'none'}")
    check(res["seconds"] <= TRAIN_MESH_BUDGET_S,
          f"train mesh: phase 19 within its {TRAIN_MESH_BUDGET_S} s budget")
    return res


def mesh_moe(torch, seed: int, mesh, acfg) -> dict:
    """Phase 18's phi3.5-moe runs (see the module docstring)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.launch import steps
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import ServingConfig, ServingEngine, poisson_trace

    cfg = dataclasses.replace(get(BANK_ARCH), n_layers=2)
    params = lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    t1 = time.perf_counter()
    chip = steps.program_for_serving(params, acfg, prng.PRNGKey(seed + 1), mesh=mesh,
                                     model_cfg=cfg)
    torch.cuda.synchronize()
    out = {"program_s": time.perf_counter() - t1, "capacity_factor": cfg.capacity_factor}
    # no aging or refresh here: the state and source weights go
    chip = dataclasses.replace(chip, state={})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check("tp" in chip.params.blocks[0]["moe"], "mesh: phi3.5-moe's banks carry their split")
    trace = poisson_trace(prng.PRNGKey(seed + 7), ARCH_TRACE["n"], vocab=cfg.vocab,
                          rate=ARCH_TRACE["rate"], prompt_lens=ARCH_TRACE["prompt_lens"],
                          new_tokens=ARCH_TRACE["new_tokens"])
    shard_map = dataclasses.replace(cfg, moe_dispatch="shard_map")
    cast = engine.cast_weights(chip.params, cfg.dtype)
    fc = arch_forward_check(torch, cast, chip.cfg, shard_map,
                            {"tokens": torch.as_tensor(trace[0].prompt, device=DEV)[None].long()})
    del cast
    log_forward_check(f"{BANK_ARCH} shard_map (capacity factor {cfg.capacity_factor})",
                      f"{trace[0].prompt.size}-token", fc)
    out["forward_check"] = fc
    runs = {}
    for name, run_cfg in (("shard_map", shard_map),
                          ("shard_map_cf8", dataclasses.replace(shard_map, capacity_factor=8.0)),
                          ("einsum_cf8", dataclasses.replace(cfg, capacity_factor=8.0))):
        served = ServingEngine.for_program(chip, run_cfg, ServingConfig(**ARCH_SERVE), device=DEV)
        reset_counts()
        rep = served.run(trace)
        torch.cuda.synchronize()
        counts = mesh_counts(torch)
        forwards = rep.n_requests + rep.n_steps
        runs[name] = {**serve_metrics(rep), "counts": counts,
                      "bank_per_forward": counts["bank"] / forwards,
                      "tokens": {r.rid: r.tokens.tolist() for r in rep.records}}
        log(f"mesh: {BANK_ARCH} (2 layers) {name}: {rep.n_requests} requests, {rep.n_steps} "
            f"decode steps, {runs[name]['ms_per_decode_step']:.2f} ms/decode step, "
            f"{runs[name]['tokens_per_s']:.1f} tokens/s; launches b1 {counts['b1']} bank "
            f"{counts['bank']} {counts['bank_designs']} b3 {counts['b3']} plain "
            f"{counts['plain']} ({forwards} forwards)")
        check(counts["plain"] == 0, f"mesh: {name}: no plain-version call")
        check(counts["bank"] == 3 * cfg.n_layers * forwards,
              f"mesh: {name}: one bank launch a MoE family a forward")
        del served
    same = runs["shard_map_cf8"]["tokens"] == runs["einsum_cf8"]["tokens"]
    log(f"mesh: {BANK_ARCH} at capacity factor 8 (no drops): shard_map tokens == einsum "
        f"tokens: {same}")
    check(same, "mesh: shard_map serves the einsum path's tokens where no token drops")
    for r in runs.values():
        r.pop("tokens")
    out["runs"] = runs
    del chip
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_artifact(torch, seed: int, mesh, acfg, tmp: str, trace4: list) -> dict:
    """Phase 18's artifact: tinyllama-1.1b at full width on 1 layer, the
    sharded chip saved and held array by array against the unsharded chip
    (what its artifact holds), loaded with ``shardings=`` and served."""
    import dataclasses

    import numpy as np

    from repro_torch import prng
    from repro_torch.checkpoint import store
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=1)
    params = lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    host = engine.compile_program(params, acfg, prng.PRNGKey(seed + 1), device=DEV)
    sharded = steps.program_for_serving(params, acfg, prng.PRNGKey(seed + 1), mesh=mesh,
                                        model_cfg=cfg)
    path = os.path.join(tmp, "chip")
    t1 = time.perf_counter()
    store.save_program(path, sharded)
    save_s = time.perf_counter() - t1
    want = {f"params::{k}": store._to_numpy(v) for k, v in store._flatten(host.params).items()}
    want.update({f"state::{k}": store._to_numpy(v, key=k.rsplit("::", 1)[-1] == "key")
                 for k, v in store._flatten(host.state).items()})
    with np.load(os.path.join(path, "arrays.npz")) as got:
        same = set(got.files) == set(want) and all(
            got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes() for k, w in want.items())
    del sharded
    loaded = store.load_program(path, params_like=params,
                                shardings=shd.program_shardings(params, mesh, cfg), device=DEV)
    reqs = [dataclasses.replace(q, max_new_tokens=8, arrival_t=0.0) for q in trace4[:4]]
    tokens = []
    for prog in (loaded, host):
        rep = ServingEngine.for_program(prog, cfg, ServingConfig(n_slots=4, s_max=512),
                                        device=DEV).run(reqs)
        tokens.append({r.rid: r.tokens.tolist() for r in rep.records})
    log(f"mesh: the sharded chip's artifact (tinyllama-1.1b, 1 layer, {len(want)} arrays, "
        f"written in {save_s:.2f} s) == the unsharded chip's arrays: {same}; loaded with "
        f"shardings= it serves the unsharded chip's tokens: {tokens[0] == tokens[1]}")
    check(same, "mesh: the sharded chip's artifact is bitwise the unsharded chip's")
    check(tokens[0] == tokens[1], "mesh: load_program(shardings=) serves the same tokens")
    return {"arrays": len(want), "save_s": save_s, "bitwise": same,
            "tokens_equal": tokens[0] == tokens[1]}


def family_requests(torch, cfg, seed: int) -> list:
    """Phase 18's requests of a token-fed family: the first
    MESH_FAMILY_REQUESTS of phase 17's trace, each cut to
    MESH_FAMILY_NEW_TOKENS tokens (the vision family's each with phase
    17's image patches)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.serving import poisson_trace

    trace = poisson_trace(prng.PRNGKey(seed + 7), ARCH_TRACE["n"], vocab=cfg.vocab,
                          rate=ARCH_TRACE["rate"], prompt_lens=ARCH_TRACE["prompt_lens"],
                          new_tokens=ARCH_TRACE["new_tokens"])
    patches = None
    if cfg.frontend == "vision_patches":
        patches = prng.normal(prng.PRNGKey(seed + 8).to(DEV),
                              (len(trace), cfg.num_patches, cfg.d_model)).to(cfg.dtype)
    return [dataclasses.replace(
        q, max_new_tokens=min(q.max_new_tokens, MESH_FAMILY_NEW_TOKENS), arrival_t=0.0,
        features=None if patches is None else {"patches": patches[i:i + 1]})
        for i, q in enumerate(trace[:MESH_FAMILY_REQUESTS])]


def family_serve(torch, chip, cfg, seed: int) -> dict:
    """Serve ``chip`` as phase 17 serves its family, per layer: the engine
    over :func:`family_requests` at phase 17's slots (a sharded chip over
    its mesh), or a codebook decoder's rectangle through the step makers
    (CODEBOOK_RUN's rows and frames, MESH_CODEBOOK_STEPS steps, its cache
    holding the chip's KV heads). The tokens (codes), launches and what
    they should be, ms a decode step, collective calls."""
    from repro_torch import collectives, prng
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import decode_rows as dr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import cache_kv_heads, init_lm_cache
    from repro_torch.serving import ServingConfig, ServingEngine

    def counts() -> dict:
        return {"b1": kernel.analog_mvm.launches,
                "designs": dict(kernel.analog_mvm.design_launches),
                "bank": kernel.analog_mvm_bank.launches, "b3": fa.flash_attention.launches,
                "rows": dict(dr.launches), "plain": plain_calls()}

    torch.cuda.synchronize()
    if cfg.n_codebooks:
        b, s, n = CODEBOOK_RUN["rows"], CODEBOOK_RUN["frames"], MESH_CODEBOOK_STEPS
        frames = prng.normal(prng.PRNGKey(seed + 9).to(DEV), (b, s + n, cfg.d_model)).to(cfg.dtype)
        cache = init_lm_cache(cfg, b, s + n, cfg.dtype, device=DEV,
                              kv_heads=cache_kv_heads(chip.params, cfg))
        prefill = make_prefill_step(cfg, chip.cfg, device=DEV)
        step = make_serve_step(cfg, chip.cfg, device=DEV)
        rng = prng.PRNGKey(seed + 10)
        reset_counts()
        collectives.reset_stats()
        t0 = time.perf_counter()
        logits, cache = prefill(chip.params, {"frames": frames[:, :s]}, cache, rng)
        out = [logits[:, -1].argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(n):
            code, cache = step(chip.params, {"frames": frames[:, s + i:s + i + 1]}, cache, rng)
            out.append(code)
        torch.cuda.synchronize()
        return {"codes": torch.stack(out, 1).tolist(), "counts": counts(),
                "want": moe_forward_launches(cfg, [b * s], n, b), "prefill_s": t1 - t0,
                "ms_per_decode_step": (time.perf_counter() - t1) / n * 1e3,
                "collective_calls": collectives.stats["calls"], "forwards": n + 1}
    reqs = family_requests(torch, cfg, seed)
    served = ServingEngine.for_program(
        chip, cfg, ServingConfig(**dict(ARCH_SERVE, s_max=ARCH_SERVE["s_max"] + cfg.num_patches)),
        device=DEV)
    reset_counts()
    collectives.reset_stats()
    rep = served.run(reqs)
    torch.cuda.synchronize()
    want = moe_forward_launches(cfg, [int(q.prompt.size) for q in reqs], rep.n_steps,
                                ARCH_SERVE["n_slots"])
    want["b1"] += sum(q.features is not None for q in reqs)  # patch_proj
    return {"tokens": {r.rid: r.tokens.tolist() for r in rep.records}, "counts": counts(),
            "want": want, "budgets_met": all(r.n_new == q.max_new_tokens for r, q in zip(
                sorted(rep.records, key=lambda r: r.rid), reqs)),
            "mesh": served.mesh is not None, **serve_metrics(rep),
            "collective_calls": collectives.stats["calls"],
            "forwards": rep.n_requests + rep.n_steps}


def mesh_family(torch, name: str, depth: int, seed: int, mesh, acfg) -> dict:
    """Phase 18's run of one family (see the module docstring): ``name`` at
    full width on ``depth`` layers from ``lm_init(seed)``, programmed
    through ``program_for_serving(mesh=)`` and unsharded at one key, each
    chip's digest (:func:`program_digest`) taken and its state dropped,
    each served (:func:`family_serve`): the same digests, tokens (codes)
    and launches, every launch exact, no plain call."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.launch import steps
    from repro_torch.models.common import set_logical_rules
    from repro_torch.models.lm import lm_init

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(name), n_layers=depth)
    params = lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    out = {"n_layers": depth, "analog_weights": analog_weights(cfg)[0]}
    for kind in ("sharded", "unsharded"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if kind == "sharded":
            chip = steps.program_for_serving(params, acfg, prng.PRNGKey(seed + 1), mesh=mesh,
                                             model_cfg=cfg)
        else:
            set_logical_rules({})
            chip = engine.compile_program(params, acfg, prng.PRNGKey(seed + 1), device=DEV)
        torch.cuda.synchronize()
        run = {"program_s": time.perf_counter() - t1, "digest": program_digest(torch, chip)}
        if kind == "sharded":
            splits = []
            engine._walk(chip.params, lambda path, node: splits.append(node.get("tp")) or node)
            run["layers_split"] = f"{sum(sp is not None for sp in splits)} of {len(splits)}"
        # no aging or refresh here: the state goes before serving
        chip = dataclasses.replace(chip, state={})
        if kind == "unsharded":
            del params
        run.update(family_serve(torch, chip, cfg, seed))
        out[kind] = run
        del chip
    set_logical_rules({})
    gc.collect()
    torch.cuda.empty_cache()
    sh, un = out["sharded"], out["unsharded"]
    out["digest_equal"] = sh.pop("digest") == un.pop("digest")
    key = "codes" if cfg.n_codebooks else "tokens"
    out["tokens_equal"] = sh[key] == un[key]
    out["counts_equal"] = sh["counts"] == un["counts"]
    c, w = sh["counts"], sh["want"]
    out["launches_exact"] = (c["b1"] == w["b1"] and c["b3"] == w["b3"] and c["bank"] == 0
                             and c["plain"] == 0 and un["counts"]["plain"] == 0)
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh: {name} at full width on {depth} layers ({out['analog_weights']} analog weights) "
        f"programmed through the mesh in {sh['program_s']:.2f} s ({sh['layers_split']} layers "
        f"carry a split) and unsharded in {un['program_s']:.2f} s; gathered == unsharded, every "
        f"param and state leaf: {out['digest_equal']}; served "
        f"{'its rectangle through the step makers' if cfg.n_codebooks else 'per layer'}: "
        f"{key} == the unsharded chip's: {out['tokens_equal']}; launches {c} (unsharded "
        f"{un['counts']}, want b1 {w['b1']} b3 {w['b3']}); {sh['ms_per_decode_step']:.2f} ms a "
        f"decode step (unsharded {un['ms_per_decode_step']:.2f}), {sh['collective_calls']} "
        f"collective calls over {sh['forwards']} forwards; {out['seconds']:.1f} s")
    check(out["digest_equal"], f"mesh: {name}'s sharded chip gathered is bitwise its unsharded "
                               "chip")
    check(out["tokens_equal"] and sh.get("budgets_met", True),
          f"mesh: {name} serves the unsharded chip's {key}")
    check(out["counts_equal"] and out["launches_exact"],
          f"mesh: {name}'s B1 (by design) and B3 launches exact, the unsharded chip's, no plain "
          "call")
    check(sh["collective_calls"] > 0, f"mesh: {name}'s sharded forward ran its collectives")
    return out


def mesh_cnn(torch, seed: int, mesh, reference: dict) -> dict:
    """Phase 18's CNN: MESH_CNN from ``cnn_init(seed)`` programmed with
    ``shardings=`` (``launch.sharding.program_shardings``) and its crossbar
    transforms and mapping at phase 14's config and key, against phase
    14's chip (``reference``: its digest and mapping) and the same params
    programmed unsharded: the gathered chip, its mapping and the logits of
    MESH_CNN_IMAGES images bitwise, one tiled B1 launch a layer."""
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import crossbar, engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.launch import sharding as shd
    from repro_torch.models import analognet as an

    t0 = time.perf_counter()
    cfg = get(MESH_CNN)
    acfg = AnalogConfig().infer(b_adc=8, t_seconds=CNN_AGES[0])
    kw = dict(transforms=an.crossbar_transforms(cfg), with_mapping=True, device=DEV)
    params = an.cnn_init(prng.PRNGKey(seed), cfg, device=DEV)
    sharded = engine.compile_program(params, acfg, prng.PRNGKey(seed + 1),
                                     shardings=shd.program_shardings(params, mesh), **kw)
    host = engine.compile_program(params, acfg, prng.PRNGKey(seed + 1), **kw)
    gathered = sharded.gather()
    x = prng.normal(prng.PRNGKey(seed + 12).to(DEV),
                    (MESH_CNN_IMAGES,) + cfg.input_hw + (cfg.in_channels,))
    reset_counts()
    logits = an.cnn_apply(sharded.params, x, sharded.cfg, cfg)
    torch.cuda.synchronize()
    launches = {"b1": kernel.analog_mvm.launches,
                "designs": dict(kernel.analog_mvm.design_launches), "plain": plain_calls()}
    want = b1_only("tiled", len(cfg.convs) + 1)
    out = {"mesh": sharded.mesh is mesh,
           "chip_equal": program_digest(torch, sharded) == reference["digest"]
           == program_digest(torch, host),
           "mapping_equal": crossbar.mapping_to_dict(gathered.mapping) == reference["mapping"]
           == crossbar.mapping_to_dict(host.mapping),
           "logits_equal": bool(torch.equal(
               logits, an.cnn_apply(host.params, x, host.cfg, cfg))),
           "launches": launches, "seconds": time.perf_counter() - t0}
    log(f"mesh: {MESH_CNN} programmed with shardings= and its crossbar transforms: gathered == "
        f"phase 14's chip at the same key (and the same params unsharded): {out['chip_equal']}; "
        f"mapping: {out['mapping_equal']}; logits of {MESH_CNN_IMAGES} images: "
        f"{out['logits_equal']}; launches {launches} (want {want}); {out['seconds']:.1f} s")
    check(out["mesh"] and out["chip_equal"] and out["mapping_equal"],
          f"mesh: {MESH_CNN}'s chip and mapping through shardings= are phase 14's, bitwise")
    check(out["logits_equal"], f"mesh: {MESH_CNN}'s logits are the unsharded chip's, bitwise")
    check(launches["designs"] == want and launches["plain"] == 0,
          f"mesh: {MESH_CNN}: one tiled B1 launch a layer, no plain call")
    return out


def train_mesh_hybrid(torch, seed: int, mesh) -> dict:
    """Phase 19's hybrid stack (TRAIN_MESH_HYBRID at full width, drawn from
    ``seed``): its stage-1 and stage-2 steps (:func:`lm_train_steps`, with
    Adafactor, one run each: phase 16 (b)'s stack shows a step repeats
    bitwise) unsharded, then through the sharded step over ``mesh``: every
    leaf of the params, optimizer state and metrics bitwise, the same
    launches and recomputes, no plain call."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.training import optim

    t0 = time.perf_counter()
    name, depth = TRAIN_MESH_HYBRID
    cfg = dataclasses.replace(get(name), n_layers=depth, remat=False)
    params = lm.lm_init(prng.PRNGKey(seed), cfg, device=DEV)
    ocfg = optim.OptimizerConfig(kind="adafactor", **LM_MESH_OPT)
    want = lm_train_steps(torch, params, cfg, ocfg=ocfg, runs=1)
    gc.collect()
    torch.cuda.empty_cache()
    got = lm_train_steps(torch, params, cfg, mesh, ocfg=ocfg, runs=1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"stages": {}}
    for stage, g in got.items():
        w = want[stage]
        same = g["digest"] == w["digest"]
        out["stages"][stage] = {
            "ms": g["s"] * 1e3, "unsharded_ms": w["s"] * 1e3, "counts": g["counts"],
            "unsharded_counts": w["counts"], "bitwise": same,
            "collective_calls": g["collective_calls"], "metrics": g["metrics"]}
        log(f"train mesh: {name} ({depth} layers, full width) stage {stage} through the "
            f"sharded step over a (1, 1) NCCL mesh == its unsharded step, every leaf: {same}; "
            f"one cold run each: {g['s'] * 1e3:.2f} ms a step (unsharded "
            f"{w['s'] * 1e3:.2f}); {g['collective_calls']} collective calls; launches "
            f"{g['counts']} (unsharded {w['counts']}); metrics {g['metrics']}")
        check(same, f"train mesh: {name} stage {stage} bitwise its unsharded step")
        check(g["counts"] == w["counts"] and g["counts"]["plain"] == 0
              and (stage == 1 or g["counts"]["b1"] > 0) and g["counts"]["b3"] > 0,
              f"train mesh: {name} stage {stage}'s B1 and B3 launches the unsharded step's, "
              "no plain call")
    out["b1_launches"] = sum(g["counts"]["b1"] for g in got.values())
    out["b3_launches"] = sum(g["counts"]["b3"] for g in got.values())
    out["seconds"] = time.perf_counter() - t0
    log(f"train mesh: {name} took {out['seconds']:.1f} s against its "
        f"{TRAIN_MESH_HYBRID_BUDGET_S} s share of the phase's budget (within: "
        f"{out['seconds'] <= TRAIN_MESH_HYBRID_BUDGET_S})")
    return out


# ---------------------------------------------------------------------------
# Phase 20: training the other families
# ---------------------------------------------------------------------------

#: phase 20's stacks at full width, (arch, depth) through the CLI's
#: ``lm_setup(n_layers=)``: mamba2-2.7b on 2 layers, recurrentgemma-9b on
#: one (rec, rec, attn) period, paligemma-3b on 2 layers; 1 x 64 tokens
TRAIN_FAMILIES = (("mamba2-2.7b", 2), ("recurrentgemma-9b", 3), ("paligemma-3b", 2))
TRAIN_FAMILIES_BUDGET_S = 60
#: B3's windowed training form at recurrentgemma-9b's heads: (rows, S,
#: window); the window bites from row 2048 on
B3_TRAIN_WINDOW = (1, 4096, 2048)


@contextlib.contextmanager
def plain_on_card():
    """B1's and B3's wrappers replaced by their plain versions while the
    body runs, on the card (``ref.analog_mvm_ref``, ``ref.flash_attention_ref``:
    what a CPU tensor runs, counted as plain calls): the control of phase
    20, the same step through the plain versions on the card."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import analog_mvm_ref, flash_attention_ref
    from repro_torch.models import attention

    def b1(x, w, *, r_adc, r_dac=None, out_scale=1.0, b_adc=8, tile_rows=1024,
           per_tile_adc=True, keep=None):
        return analog_mvm_ref(x, w, r_dac, r_adc, out_scale, b_dac=b_adc + 1, b_adc=b_adc,
                              tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                              apply_dac=r_dac is not None, keep=keep)

    def b3(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024, window=None):
        return flash_attention_ref(q, k, v, causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   window=window)

    saved = kernel.analog_mvm, fa.flash_attention, attention.flash_attention
    kernel.analog_mvm, fa.flash_attention, attention.flash_attention = b1, b3, b3
    try:
        yield
    finally:
        kernel.analog_mvm, fa.flash_attention, attention.flash_attention = saved


def family_step(torch, loss_fn, params, batch: dict, stage: int, tape, grad: bool = True):
    """Phase 20's step: ``loss_fn`` (``lm_setup``'s) on ``batch`` in stage 1
    (digital) or stage 2 (``analog_train`` at LM_TRAIN, keyed as phase 16
    (b) keys it), inside ``tape`` (None: untaped); with ``grad`` its
    gradients, kept on the card. The loss and the seconds (host clock to a
    synchronize)."""
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.training import lockstep
    from repro_torch.training.loop import value_and_grad

    acfg = AnalogConfig() if stage == 1 else AnalogConfig().train(**LM_TRAIN)
    key = prng.fold_in(prng.PRNGKey(0).to(DEV), LM_RUN["stage1"]) if acfg.needs_rng else None
    loss_of = lambda p: loss_fn(p, batch, acfg, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = None
    with lockstep.tape(tape) if tape is not None else contextlib.nullcontext():
        if grad:
            (loss, _), g = value_and_grad(loss_of, params)
            grads = {tree_lib.path_name(p): t.detach() for p, t in tree_lib.flatten_with_path(g)}
        else:
            with torch.no_grad():
                loss, _ = loss_of(params)
        loss = float(loss)
    torch.cuda.synchronize()
    return {"loss": loss, "s": time.perf_counter() - t0, "grads": grads}


def train_family_designs(torch, params, tokens: int) -> dict:
    """B1's training-form launches a stage-2 forward of ``params`` makes, by
    design: one a member of every analog layer but the vision family's
    ``patch_proj`` (a token batch carries no image), each at M = ``tokens``
    through the design ``select_design`` picks with a keep mask."""
    from repro_torch.core import engine
    from repro_torch.kernels import analog_mvm as kernel

    out = dict.fromkeys(kernel.DESIGNS, 0)

    def node_fn(path: str, node: dict) -> dict:
        if not path.startswith("extras/"):
            w = node["w"]
            out[kernel.select_design(torch.bfloat16, tokens, int(w.shape[-2]),
                                     int(w.shape[-1]), keep=True)] += math.prod(w.shape[:-2])
        return node

    engine._walk(params, node_fn)
    return out


def train_family(torch, name: str, depth: int) -> dict:
    """Phase 20's run of one family (see the module docstring)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_setup
    from repro_torch.models.lm import block_period, lm_loss
    from repro_torch.training import lockstep

    t0 = time.perf_counter()
    # lm_setup's params and first batch; its loss with the config's remat
    # off, as 16 (b) runs it: a tape records each forward call once, and
    # remat would run every group's calls again inside the backward
    cfg = dataclasses.replace(get(name), n_layers=depth, remat=False)
    check(cfg.dtype == torch.bfloat16, f"train families: {name} trains in bf16")
    params, _, batches = lm_setup(name, False, LM_STEP["batch"], LM_STEP["seq"], DEV,
                                  n_layers=depth)
    loss_fn = lambda p, b, acfg, rng: lm_loss(p, b, acfg, cfg, rng=rng)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in next(batches).items()}
    tokens = LM_STEP["batch"] * LM_STEP["seq"]
    period = block_period(cfg)
    attn = sum(k == "attn" for k in period) * (depth // len(period))
    n_b1 = sum(train_family_designs(torch, params, tokens).values())
    out = {"n_layers": depth, "analog_weights": analog_weights(cfg)[0], "stages": {}}
    bound = lockstep.GRAD_RTOL["bfloat16"]
    failed = []
    for stage in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        card = lockstep.Tape(on_host=False)
        k = family_step(torch, loss_fn, params, batch, stage, card)
        counts = {"b1": kernel.analog_mvm.launches,
                  "designs": dict(kernel.analog_mvm.design_launches),
                  "backward": ops.backward_calls, "b3": fa.flash_attention.launches,
                  "attention_backward": ops.attention_backward_calls, "plain": plain_calls()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        nb = 0 if stage == 1 else n_b1
        want = {"b1": nb, "designs": dict.fromkeys(kernel.DESIGNS, 0) if stage == 1 else
                train_family_designs(torch, params, tokens), "backward": nb, "b3": attn,
                "attention_backward": attn, "plain": 0}
        # the control: the same step through the plain versions on the card,
        # locked to the card's forward values; its free forward for the loss
        t2 = time.perf_counter()
        with plain_on_card():
            ctrl = lockstep.Tape(lock=card, on_host=False)
            c = family_step(torch, loss_fn, params, batch, stage, ctrl)
            t3 = time.perf_counter()
            free = family_step(torch, loss_fn, params, batch, stage, lockstep.Tape(
                lock=card, draw=set(), lock_kinds=("noise",), on_host=False), grad=False)
        t4 = time.perf_counter()
        fwd = lm_step_compare(card, {"tape": ctrl}, "bfloat16")
        loss_rel = abs(k["loss"] - free["loss"]) / abs(free["loss"])
        rel = {n: lockstep.rel_l2(k["grads"][n], g) for n, g in c["grads"].items()}
        over = lockstep.over_bound(k["grads"], c["grads"], bound)
        missed = lockstep.planted_faults(k["grads"], c["grads"], bound)
        mvm_ok = all(r["gate"] for r in fwd["mvm"])
        worst = {kind: max((v for n, v in rel.items() if lockstep.leaf_kind(n) == kind),
                           default=0.0) for kind in ("weight", "range")}
        del card, ctrl, c
        t5 = time.perf_counter()
        # one step untaped, profiled: its wall (host clock to a synchronize),
        # device kernels and idle share
        prof = profiled(torch, lambda: family_step(torch, loss_fn, params, batch, stage, None),
                        top=6, host_events=False)
        split_s = {"card": t2 - t1, "control": t3 - t2, "free": t4 - t3, "gates": t5 - t4,
                   "profiled": time.perf_counter() - t5}
        st = {"loss": {"card": k["loss"], "control_free": free["loss"]}, "loss_rel": loss_rel,
              "ms": prof["profile_wall_ms"], "taped_ms": k["s"] * 1e3, "counts": counts,
              "want": want,
              "peak_gib": peak, "forward": {"draws": fwd["draws"], "other": fwd["other"],
                                            "mvm_worst_steps": max(
                                                (r["max_steps"] for r in fwd["mvm"]), default=0.0),
                                            "mvm_worst_flip_share": max(
                                                (r["frac_half_step"] for r in fwd["mvm"]),
                                                default=0.0), "mvm_ok": mvm_ok},
              "worst": worst, "over": over, "faults_missed": missed, "profile": prof,
              "seconds": split_s}
        out["stages"][stage] = st
        del k
        log(f"train families: {name} ({depth} layers, full width, bf16, {tokens} tokens) "
            f"stage {stage}: loss card {st['loss']['card']:.7f}, the plain versions' free "
            f"forward {free['loss']:.7f} (rel {loss_rel:.2e}); taped {st['taped_ms']:.2f} ms, "
            f"peak {peak:.2f} GiB; launches {counts} (want {want}); draws {fwd['draws']}; B1 vs the "
            f"plain form on the card at the same values: worst "
            f"{st['forward']['mvm_worst_steps']:.3f} steps, flip share "
            f"{st['forward']['mvm_worst_flip_share']:.2e}, within the model: {mvm_ok}; "
            f"{fwd['other']}; gradients rel L2 to the control, worst {worst} (bound {bound}); "
            f"over {over or 'none'}; planted faults not caught {missed}; one step untaped, "
            f"profiled: {prof['profile_launches']} device kernels, busy "
            f"{prof['profile_device_ms']} ms of {prof['profile_wall_ms']} ms, idle share "
            f"{prof['profile_idle_share']}; top kernels {prof.get('top_kernels')}; seconds "
            f"{ {k_: round(v, 2) for k_, v in split_s.items()} }")
        checks = [
            (counts == want, f"launches and recomputes {counts}, want {want}"),
            (fwd["draws"]["masks_bitwise"] and fwd["draws"]["noise_bitwise"]
             and fwd["draws"]["masks"] == 2 * nb and fwd["draws"]["noise_calls"] == nb
             and fwd["draws"]["noise_drawn"] == nb, f"draws and masks bitwise: {fwd['draws']}"),
            (len(fwd["mvm"]) == nb and mvm_ok,
             "each B1 output within the ADC tolerance model of the plain form's"),
            (loss_rel <= TRAIN_STEP_LOSS_RTOL, f"loss card vs control {loss_rel:.2e}"),
            (not over, f"gradient leaves over their bound: {over}"),
            (not missed["zeroed"] and not missed["doubled"],
             f"the gradient gate misses a zeroed or doubled leaf: {missed}")]
        failed += [f"{name} stage {stage}: {what}" for ok_, what in checks if not ok_]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["failed"] = failed
    out["b1_launches"] = sum(s["counts"]["b1"] for s in out["stages"].values())
    out["b1_prefill_launches"] = sum(s["counts"]["designs"]["prefill"]
                                     for s in out["stages"].values())
    out["b3_launches"] = sum(s["counts"]["b3"] for s in out["stages"].values())
    out["seconds"] = time.perf_counter() - t0
    check(not failed, f"train families: {failed}")
    return out


def b3_train_window(torch, gen) -> dict:
    """B3's windowed training form (``ops.flash_attention_ste``) at
    recurrentgemma-9b's heads, B3_TRAIN_WINDOW, bf16, causal: the forward
    held to phase 8's bound with phase 17's ``fa_flip_rows`` allowance
    (``fa_compare``); ``dq``, ``dk``, ``dv`` against autograd of the plain
    version on the card from the same operands and output gradient. Their
    bound: twice the plain bf16 backward's own distance (rel L2) from the
    same backward in fp32 on the same bf16 values -- the rounding of the
    plain backward itself. One B3 launch and one recompute; check launches,
    not the main path's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain, flash_attention_ref
    from repro_torch.training.lockstep import rel_l2

    rows, s, window = B3_TRAIN_WINDOW
    c = {**FA_HEADS, **RG_HEADS}
    chunks = dict(q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    q, k, v = (torch.randn((rows, s, n, c["d"]), generator=gen, device=DEV).to(torch.bfloat16)
               .requires_grad_() for n in (c["h"], c["kv"], c["kv"]))
    g = torch.randn((rows, s, c["h"], c["d"]), generator=gen, device=DEV).to(torch.bfloat16)
    launches0, rec0 = fa.flash_attention.launches, ops.attention_backward_calls
    o_k = ops.flash_attention_ste(q, k, v, causal=True, window=window, **chunks)
    got = torch.autograd.grad(o_k, (q, k, v), g)
    torch.cuda.synchronize()
    launched = (fa.flash_attention.launches - launches0, ops.attention_backward_calls - rec0)
    fa.flash_attention.launches = launches0  # checks, not main-path launches
    qkv = [t.detach() for t in (q, k, v)]
    with torch.no_grad():
        o_p = flash_attention_ref(*qkv, True, window=window, **chunks)
    fwd = fa_compare(torch, *qkv, o_k.detach(), o_p, True, window, c, torch.bfloat16, rows, s)
    want, own = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [t.to(dtype).requires_grad_() for t in qkv]
        o = flash_attention_plain(*leaves, True, window=window, **chunks)
        want[dtype] = torch.autograd.grad(o, leaves, g.to(dtype))
        del o, leaves
    grads = {}
    for i, n in enumerate(("dq", "dk", "dv")):
        own[n] = rel_l2(want[torch.bfloat16][i], want[torch.float32][i])
        grads[n] = {"rel_l2": rel_l2(got[i], want[torch.bfloat16][i]),
                    "bitwise": bool(torch.equal(got[i], want[torch.bfloat16][i])),
                    "plain_bf16_vs_fp32": own[n], "bound": 2 * own[n],
                    "finite": bool(got[i].isfinite().all().item())}
        grads[n]["ok"] = grads[n]["finite"] and grads[n]["rel_l2"] <= grads[n]["bound"]
    out = {"shape": (rows, s, c["h"], c["kv"], c["d"]), "window": window, "forward": fwd,
           "grads": grads, "launches": launched[0], "recomputes": launched[1]}
    log(f"train families: B3's training form at {out['shape']}, window {window}, bf16: forward "
        f"vs plain {({k_: fwd[k_] for k_ in ('max_ulps', 'over_bound', 'differing', 'ok')})}; "
        f"gradients vs autograd of the plain version on the card {grads}; {launched[0]} B3 "
        f"launch and {launched[1]} recompute")
    check(fwd["ok"], f"train families: B3's windowed training-form forward out of phase 8's "
                     f"bound: {fwd}")
    check(all(r["ok"] for r in grads.values()),
          f"train families: B3's windowed training-form gradients past their bound: {grads}")
    check(launched == (1, 1), f"train families: B3's training form launched {launched}")
    return out


def phase_train_families(torch, gen, accuracy: dict, b1_launched: set, fa_launched: set,
                         flash: dict) -> dict:
    """Phase 20 (see the module docstring)."""
    t0 = time.perf_counter()
    b1_before, fa_before = set(b1_launched), set(fa_launched)
    res = {"archs": {}, "control": "the same step through the plain versions on the card, "
                                   "locked to the card's forward values"}
    for name, depth in TRAIN_FAMILIES:
        res["archs"][name] = train_family(torch, name, depth)
    t1 = time.perf_counter()
    res["b3_window"] = b3_train_window(torch, gen)
    res["b3_window"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    keys = sorted(b1_launched - b1_before - set(map(tuple, accuracy["checked"])))
    res["b1_checked_after"] = check_launched_b1(torch, gen, keys, accuracy)
    res["b3_new_shapes"] = sorted(fa_launched - fa_before)
    checked_fa = {(r["rows"], r["S"], r["dtype"]) for r in flash["cases"]}
    res["b3_checked_after"] = check_launched_fa(
        torch, gen, sorted(set(res["b3_new_shapes"]) - checked_fa), flash)
    res["checks_s"] = time.perf_counter() - t1
    for key in ("b1_launches", "b1_prefill_launches", "b3_launches"):
        res[key] = sum(a[key] for a in res["archs"].values())
    res["seconds"] = time.perf_counter() - t0
    log(f"train families: phase 20 took {res['seconds']:.1f} s of its "
        f"{TRAIN_FAMILIES_BUDGET_S} s budget "
        f"({ {n: round(a['seconds'], 1) for n, a in res['archs'].items()} }, B3 window "
        f"{res['b3_window']['seconds']:.1f}, the new keys' checks {res['checks_s']:.1f}); new B1 keys "
        f"{keys or 'none'}, new B3 shapes {res['b3_new_shapes'] or 'none'}")
    check(res["seconds"] <= TRAIN_FAMILIES_BUDGET_S,
          f"train families: phase 20 within its {TRAIN_FAMILIES_BUDGET_S} s budget")
    return res


#: phase 21: tinyllama-1.1b's layers in the digital and training cells and
#: in the pcm_infer cell (every MVM programs its layer), its budget, and
#: gate (c)'s bound on |dry-run peak - measured growth|: a share of the
#: growth plus a slack, set before the phase first ran (PERF.md §6): the
#: trace models the caching allocator's 512-byte rounding but not an
#: allocator block's unsplit tail (up to 1 MiB a large block) nor memory
#: an op takes inside its kernel (a reduction's or a sort's scratch)
DRYRUN_DEPTH = 4
DRYRUN_INFER_DEPTH = 2
DRYRUN_BUDGET_S = 45
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_PEAK_SLACK = 64 << 20
#: (name, kind, seq, rows, mode, depth) of phase 21's cells
DRYRUN_CELLS = (
    ("train_512", "train", 512, 1, "digital", DRYRUN_DEPTH),
    ("train_512_analog", "train", 512, 1, "analog_train", DRYRUN_DEPTH),
    ("prefill_4096", "prefill", 4096, 1, "digital", DRYRUN_DEPTH),
    ("decode_4096x8", "decode", 4096, 8, "digital", DRYRUN_DEPTH),
    ("decode_4096x8_pcm_infer", "decode", 4096, 8, "analog_infer", DRYRUN_INFER_DEPTH),
)


def dryrun_real(torch, cfg, cell, mode: str, mesh, seed: int) -> dict:
    """The cell's step for real on the card over ``mesh``: its counts under
    ``analysis.cost``, the growth of the allocator's peak over the step,
    and ms a step by CUDA events (three more calls, the first counted one
    aside)."""
    from repro_torch.analysis import cost
    from repro_torch.launch import dryrun

    c = dryrun.prepare(cfg, cell, mesh, mode, device=DEV, seed=seed)
    gc.collect()  # the set-up's garbage goes before the base is read
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with cost.count() as counter:
        out = c.step(*c.args)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    log(f"dryrun: allocated {base} before, {torch.cuda.memory_allocated()} after, peak "
        f"{torch.cuda.max_memory_allocated()}; the real run's traced peak {counter.peak_bytes}")
    del out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        c.step(*c.args)
    end.record()
    torch.cuda.synchronize()
    res = {**counter.summary(), "argument_bytes": c.argument_bytes, "growth_bytes": growth,
           "ms": start.elapsed_time(end) / 3}
    del c
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_dryrun(torch, card: str, seed: int) -> dict:
    """Phase 21 (see the module docstring)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    res = {"card": card, "cells": {}}
    for name, kind, seq, rows, mode, depth in DRYRUN_CELLS:
        cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=depth)
        cell = ShapeCell(name, seq, rows, kind)
        t1 = time.perf_counter()
        rec = dryrun.run_cell(LM_ARCH, name, False, mode, verbose=False, override_cfg=cfg,
                              cell=cell, mesh="1x1")
        check(rec["status"] == "ok", f"dry run: {name} traced ({rec.get('error')})")
        trace_s = time.perf_counter() - t1
        with nccl_mesh() as mesh:
            real = dryrun_real(torch, cfg, cell, mode, mesh, seed)
        fake = {"argument_bytes": rec["memory"]["argument_bytes"], **rec["cost"],
                "collectives": rec["collectives"]["counts"]}
        peak = rec["memory"]["peak_bytes"] - rec["memory"]["argument_bytes"]
        ops_diff = {k: (rec["op_counts"].get(k), real["ops"].get(k))
                    for k in set(rec["op_counts"]) | set(real["ops"])
                    if rec["op_counts"].get(k) != real["ops"].get(k)}
        gates = {
            "a_argument_bytes": fake["argument_bytes"] == real["argument_bytes"],
            "b_flops": fake["flops"] == real["flops"],
            "b_bytes": fake["bytes"] == real["bytes"],
            "b_collectives": fake["collectives"] == {
                k: v["calls"] for k, v in real["collectives"].items()},
            "c_peak": abs(peak - real["growth_bytes"])
            <= DRYRUN_PEAK_RTOL * real["growth_bytes"] + DRYRUN_PEAK_SLACK,
        }
        roof = rec["roofline"]
        res["cells"][name] = {
            "kind": kind, "seq": seq, "rows": rows, "mode": mode, "layers": depth,
            "gates": gates, "fake": fake, "real": {k: real[k] for k in (
                "argument_bytes", "flops", "bytes", "wire_bytes", "collectives", "growth_bytes",
                "peak_bytes", "ms")},
            "dry_peak_bytes": peak, "ops_diff": ops_diff,
            "t_step_s": roof["t_step_s"], "bottleneck": roof["bottleneck"],
            "roofline_fraction": roof["roofline_fraction"],
            "measured_fraction_of_t_step": roof["t_step_s"] * 1e3 / real["ms"],
            "trace_s": trace_s, "seconds": time.perf_counter() - t1,
        }
        log(f"dryrun: {name} ({mode}, {depth} layers): {real['ms']:.3f} ms a step measured "
            f"({card}); computed t_step {roof['t_step_s'] * 1e3:.3f} ms, "
            f"{roof['bottleneck']}-bound, roofline fraction {roof['roofline_fraction']:.4f}; "
            f"flops {fake['flops']} / {real['flops']}, bytes {fake['bytes']} / {real['bytes']}, "
            f"args {fake['argument_bytes']} / {real['argument_bytes']}, peak {peak} vs growth "
            f"{real['growth_bytes']}; gates {gates}; trace {trace_s:.1f} s; "
            f"ops differing {ops_diff or 'none'}")
        for gate, ok in gates.items():
            check(ok, f"dry run: {name} gate {gate}")
    res["seconds"] = time.perf_counter() - t0
    log(f"dryrun: phase 21 took {res['seconds']:.1f} s of its {DRYRUN_BUDGET_S} s budget")
    check(res["seconds"] <= DRYRUN_BUDGET_S, f"dry run: phase 21 within {DRYRUN_BUDGET_S} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where the full JSON record goes")
    ap.add_argument("--lm-cpu-step", nargs=2, type=Path, metavar=("SRC", "OUT"),
                    help=argparse.SUPPRESS)  # phase 16 (b)'s CPU child (lm_cpu_step)
    ap.add_argument("--lm-step-readings", type=lambda v: [int(x) for x in v.split(",")],
                    metavar="SEEDS", help="run phase 16 (b) alone at these seeds (comma-separated), "
                    "its gates reported, then the first seed's bf16 stage 2 through the gemv "
                    "design, and write the readings to --out")
    ap.add_argument("--b2-parent", type=Path, default=None,
                    help="a directory holding a parent's decode_fused.cu, decode_rows.cu and "
                         "their headers: phase 7 times that B2 (8 slots and 1) and phase 10 "
                         "that attention row kernel in turns with this one")
    ap.add_argument("--b1-parent", type=Path, default=None,
                    help="a directory holding a parent's analog_mvm.cu and its headers: "
                         "phases 14-16 time that gemv design in turns with the designs that "
                         "replaced it (without it, this tree's own gemv)")
    args = ap.parse_args(argv)
    if args.lm_cpu_step:
        return lm_cpu_step(*args.lm_cpu_step)
    # the drift lifecycle and resampling phases hold a second full-width
    # chip beside phase 4's: let the allocator grow segments in place
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if args.lm_step_readings:
        return lm_step_readings(torch, args.lm_step_readings, args.out)
    t_start = time.perf_counter()
    phase_s = {}  # seconds of each phase, in order

    def lap(name: str) -> None:
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    card = phase_device(torch)
    parent = build_parent(args.b2_parent) if args.b2_parent else None
    b1_parent = build_parent(args.b1_parent, ("analog_mvm",)) if args.b1_parent else None
    build_s, ptxas = phase_build()
    host0 = host_probe(torch)  # phase 17 reads the host's speed again beside musicgen's step
    log(f"host before any phase: {host0}")
    parent = parent() if parent else {"b2": None, "rows": None}
    parent.update(b1_parent() if b1_parent else {"b1": None})
    lap("1-2 device, build")
    gen = torch.Generator("cuda").manual_seed(args.seed)
    accuracy = phase_kernel_vs_plain(torch, gen, tuple(sorted({*b1_served_ms(),
                                                              *prefill_ms()})))
    timing = phase_timing(torch, gen, (SLOTS, *prefill_ms()))
    lap("3 B1 vs plain, timing")
    fa_launched = record_fa_shapes()
    b1_launched = record_b1_shapes()
    serve, ctx = phase_serve(torch, args.seed)
    chip4 = chip_digest(torch, ctx["program"])  # phase 18's sharded chip is held to it
    tokens4, trace4 = ctx["tokens"], ctx["trace"]
    lap("4 serve")
    bridge = phase_bridge(torch, ctx)
    lap("bridge")
    fused_check = phase_fused_check(torch, ctx)
    lap("5 B2 vs plain")
    fused_serve, fused_engine = phase_fused_serve(torch, ctx, serve)
    lap("6 fused serve")
    step_timing = phase_step_timing(torch, ctx, fused_engine, parent["b2"])
    fk = step_timing["kernel"]
    del fused_engine
    lap("7 step timing")
    flash = phase_flash_attention(
        torch, gen, fa_served_shapes(ctx["trace"]) + [(1, FA_CONTEXT)])
    lap("8 B3 vs plain")
    paged_serve = phase_paged_serve(torch, ctx, serve)
    lap("9 paged serve")
    rows = phase_rows(torch, gen, parent["rows"])
    lap("10 row kernels")
    lifecycle = phase_drift_lifecycle(torch, ctx)
    lap("11 drift lifecycle")
    resample = phase_resample(torch, ctx)
    lap("12 resample")
    fa_before, b1_before = set(fa_launched), set(b1_launched)
    fleet = phase_fleet(torch, ctx)
    # a migrated continuation prefills at prompt + prefix tokens: B1 and B3
    # shapes no earlier phase served, checked now as phases 3 and 8 check
    # (only the fleet phase's: an earlier phase's unchecked shape still fails)
    fleet["b3_checked_after"] = check_launched_fa(torch, gen, sorted(
        fa_launched - fa_before - {(r["rows"], r["S"], r["dtype"]) for r in flash["cases"]}),
        flash)
    fleet["b1_checked_after"] = check_launched_b1(torch, gen, sorted(
        b1_launched - b1_before - set(map(tuple, accuracy["checked"]))), accuracy)
    lap("13 fleet")
    cnn = phase_cnn(torch, gen, args.seed, accuracy, b1_launched, parent["b1"])
    lap("14 cnn")
    train = phase_train(torch, gen, args.seed, accuracy, b1_launched, parent["b1"])
    lap("15 train")
    lm = phase_lm_train(torch, gen, args.seed, accuracy, b1_launched, fa_launched, flash,
                        parent["b1"])
    lap("16 LM train")
    ctx.clear()  # the earlier phases' chips: phase 17 programs its own
    gc.collect()
    torch.cuda.empty_cache()
    archs = phase_archs(torch, gen, args.seed, accuracy, b1_launched, flash)
    archs["host_probe_start"] = host0
    lap("17 archs")
    with nccl_mesh() as nccl:
        mesh = phase_mesh(torch, gen, args.seed, nccl, chip4, tokens4, trace4, accuracy,
                          b1_launched, {ast.literal_eval(k) for k in archs["bank_cases"]},
                          cnn["mesh_reference"])
        lap("18 mesh")
        train_mesh = phase_train_mesh(torch, gen, args.seed, nccl, lm["train_steps"], accuracy,
                                      b1_launched, fa_launched, flash)
        lap("19 sharded training")
    train_families = phase_train_families(torch, gen, accuracy, b1_launched, fa_launched, flash)
    lap("20 training the families")
    dry = phase_dryrun(torch, card, args.seed)
    lap("21 dry run")
    log(f"seconds per phase: { {k: round(v, 1) for k, v in phase_s.items()} }")
    checked = {(r["rows"], r["S"], r["dtype"]) for r in flash["cases"]}
    unchecked = sorted(fa_launched - checked)
    log(f"B3 shapes launched by the serving phases (rows, S, dtype): {sorted(fa_launched)}; "
        f"not checked in phases 8 and 13: {unchecked or 'none'}")
    check(not unchecked, f"B3 launched at shapes phase 8 never checked: {unchecked}")
    b1_unchecked = sorted(b1_launched - set(map(tuple, accuracy["checked"])))
    log(f"B1 launches of the serving phases: {len(b1_launched)} (M, K, N, dtype, design, "
        f"tile_rows, per_tile_adc, dac) keys at M in "
        f"{sorted({key[0] for key in b1_launched})}; not checked in phase 3: "
        f"{b1_unchecked or 'none'}")
    check(not b1_unchecked, f"B1 launched at shapes phase 3 never checked: {b1_unchecked}")
    # B3 per prefill call: 22 launches at the largest bucket this trace uses
    fa_t = next(r for r in flash["timing"] if (r["rows"], r["S"]) == (1, 256))
    check(all(r["design"] == ("decode" if r["M"] <= SLOTS else "prefill") for r in timing),
          "B1 timed at 8 rows through the decode design and at prefill Ms through the prefill "
          "design")

    def b1_entry(design: str, m: int, per: str) -> dict:
        part = forward_rows(timing, m)
        total = lambda key: sum(r[key] * r["per_forward"] for r in part)
        return {
            "name": f"analog_mvm.{design}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/analog_mvm_tc.cu",
            "replaces": "src/repro/kernels/analog_mvm.py:41",
            "launches": serve["design_launches"][design]
            + fleet["launches"]["b1_designs"][design]
            + mesh["tinyllama"]["counts"]["designs"][design]
            + sum(f["sharded"]["counts"]["designs"][design] for f in mesh["families"].values()),
            "max_abs_err": accuracy["by_design"][design]["max_abs"],
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in part)
                         else "operations"),
            "library_ms": total("library_ms"),
            "cuda_core_ms": total("cuda_core_ms"),
            "per": per,
            "max_err_adc_steps": accuracy["by_design"][design]["max_steps"],
            "pass": all(r["design"] == design for r in part),
        }

    kernels = {"kernels": [b1_entry(
        "decode", 8, "one tinyllama-1.1b decode step at 8 slots, bf16: 22 x (wq, wk, wv, "
        "wo, w1, w3, w2) + lm_head; launches from the per-layer serving run and the fleet "
        "phase; cuda_core_ms: "
        "the CUDA-core design (analog_mvm.cu) on the same inputs"), b1_entry(
        "prefill", 256, "one tinyllama-1.1b prefill forward of 256 tokens (M = 256), bf16: "
        "the 154 layer projections (its lm_head runs at M = 1, through the decode design); "
        "launches from the per-layer serving run and the fleet phase; cuda_core_ms as above"), {
        "name": "decode_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_fused.cu",
        "replaces": "src/repro/kernels/decode_fused.py:139",
        "launches": fused_serve["decode_fused_launches"],
        "max_abs_err": max(v["logits_max_abs"] for k, v in fused_check.items()
                           if k.startswith("depth_")),
        "ms": fk["ms"],
        "plain_ms": fk["plain_ms"],
        "bound_ms": fk["bound_ms"],
        "bound_by": fk["bound_by"],
        "library_ms": None,
        "per": "one tinyllama-1.1b decode step at 8 slots, bf16, one launch; "
               "max_abs_err over the logits at depths 1, 2 and 22; mvm_items: the MVM work "
               "item of each projection; phase_ms: layer 1's phases (each with its closing "
               "grid barrier), the final row, the lm_head and the logits",
        "mvm_items": fused_check["items"],
        "phase_ms": fk["phase_ms"]["phase_ms"],
        "barriers_per_step": fk["phase_ms"]["barriers_per_step"],
        "parent_ms": step_timing.get("parent_kernel", {}).get("ms"),
        "pass": True,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": paged_serve["flash_attention_launches"] + fleet["launches"]["b3"]
        + archs["b3_launches"] + mesh["tinyllama"]["counts"]["b3"]
        + sum(f["sharded"]["counts"]["b3"] for f in mesh["families"].values()),
        "max_abs_err": max(r["max_abs"] for r in flash["cases"]),
        "ms": FA_LAUNCHES_PER_PREFILL * fa_t["ms"],
        "plain_ms": FA_LAUNCHES_PER_PREFILL * fa_t["plain_ms"],
        "bound_ms": FA_LAUNCHES_PER_PREFILL * fa_t["bound_ms"],
        "bound_by": fa_t["bound_by"],
        "library_ms": FA_LAUNCHES_PER_PREFILL * fa_t["library_ms"],
        "per": "one tinyllama-1.1b bucketed prefill call at bucket 256, 1 row, bf16, "
               "causal: 22 launches (library: scaled_dot_product_attention, is_causal, "
               "enable_gqa); launches from the paged serving run, the fleet phase and "
               "phases 17 and 18; max_abs_err over every checked shape, both dtypes, causal and "
               "full, with and without the window; window_256: one launch at "
               "recurrentgemma-9b's (1, 4096, 16/1, 256), window 2048 (library: "
               "scaled_dot_product_attention with the sliding-window boolean mask)",
        "window_256": {k: archs["b3_window"]["timing"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "max_err_bf16_ulps": flash["worst_bf16_ulps"],
        "pass": True,
    }, cnn_entry(cnn), train_entry(train, lm["launches"]["b1_fp32"]), *lm_entries(lm, train_mesh, train_families),
        bank_entry(archs, mesh)] + [{
        "name": f"decode_rows.{name}",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_rows.cu",
        "replaces": ROW_REPLACES[name],
        "launches": serve["row_launches"][name] + fleet["launches"]["rows"][name],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "per": f"one launch at the decode step's shapes (8 slots, bf16); launches from the "
               f"per-layer serving run and the fleet phase (chip and digital lockstep); "
               f"{ROW_PER[name]}",
        "max_err_bf16_ulps": r["max_bf16_ulps"],
        "pass": r["pass"],
    } for name, r in rows.items()] + [{
        "name": "prng.normal",
        "route": "cuda",
        "source": "src/repro_torch/csrc/prng.cu",
        "replaces": "src/repro/core/pcm.py:131 (jax.random.normal, XLA ops; not a TPU kernel)",
        "launches": serve["prng_launches"] + fleet["launches"]["prng"]
        + cnn["launches"]["prng"],
        "max_abs_err": 0.0 if bridge["normal_card_equals_cpu"] else None,
        "ms": bridge["normal_ms_11.5M"],
        "plain_ms": bridge["normal_plain_ms_11.5M"],
        "bound_ms": bridge["normal_bound_ms_11.5M"],
        "bound_by": bridge["normal_bound_by"],
        "library_ms": None,
        "per": "one 2048 x 5632 draw (a w1 member's programming noise); launches: phase 4's "
               "lm_init and program phase, the fleet phase's reprogram and the CNN phase's "
               "cnn_init and program phases; max_abs_err: 2^22 draws on the card against the "
               "CPU plain version (bitwise); library: none computes jax.random.normal's bits",
        "pass": bridge["normal_card_equals_cpu"],
    }]}
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build_s, "ptxas": ptxas, "kernel_vs_plain": accuracy, "timing": timing,
           "serve": serve, "fused_check": fused_check, "fused_serve": fused_serve,
           "step_timing": step_timing, "flash_attention": flash, "paged_serve": paged_serve,
           "bridge": bridge, "rows": rows, "drift_lifecycle": lifecycle, "resample": resample,
           "fleet": fleet, "cnn": cnn, "train": train, "lm_train": lm, "archs": archs,
           "mesh": mesh, "train_mesh": train_mesh, "train_families": train_families,
           "dryrun": dry, **kernels,
           "phase_s": phase_s,
           "seconds": time.perf_counter() - t_start}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    log(f"total {out['seconds']:.1f} s")
    log(card)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
