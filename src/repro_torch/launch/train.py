"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [--device cuda]``, counterpart of ``repro.launch.train``.

Runs the paper's two-stage method (``training.loop.run_two_stage``) on one
of the paper's CNNs at its published widths (``configs.get``), or on an LM
-- its reduced smoke config by default, its full size with ``--full`` --
with weights from ``*_init(PRNGKey(0))`` through the RNG bridge, over the
synthetic tasks of ``data.pipeline`` (the KWS-style task for a CNN, the
token stream of ``--batch`` x ``--seq`` for an LM of any family but the
frames-fed audio decoder, which ``refusal`` names), on ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels). Each
logged step prints one JSON line with the reference CLI's keys;
``--ckpt-dir`` checkpoints asynchronously and resumes from the newest
checkpoint there.

Examples:
  python -m repro_torch.launch.train --arch analognet-kws --stage1 150 --stage2 150
  python -m repro_torch.launch.train --arch tinyllama-1.1b --full --batch 4 --stage1 50 --stage2 50
  python -m repro_torch.launch.train --arch tinyllama-1.1b --device cpu --stage1 3 --stage2 2 --batch 2 --seq 16
  python -m repro_torch.launch.train --arch mamba2-2.7b --device cpu --stage1 1 --stage2 1 --batch 2 --seq 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from repro_torch import configs, prng
from repro_torch.data.pipeline import PipelineConfig, iterate
from repro_torch.device import resolve_device
from repro_torch.models import analognet, lm
from repro_torch.training.loop import TrainConfig, run_two_stage


def lm_setup(arch: str, smoke: bool, batch: int, seq: int, device="cuda",
             n_layers: Optional[int] = None):
    """(params, loss_fn, batches) of the LM ``arch``: its smoke config, or
    the full size with ``smoke=False``; ``n_layers`` cuts its depth and
    keeps its widths."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device=device)
    pipe = PipelineConfig(kind="lm", global_batch=batch, seq_len=seq, vocab=cfg.vocab)

    def loss_fn(p, b, acfg, rng):
        return lm.lm_loss(p, b, acfg, cfg, rng=rng)

    return params, loss_fn, iterate(pipe)


def cnn_setup(arch: str, batch: int, device="cuda"):
    """(params, loss_fn, batches) of ``arch`` at its published widths."""
    cfg = configs.get(arch)
    params = analognet.cnn_init(prng.PRNGKey(0), cfg, device=device)
    pipe = PipelineConfig(
        kind="kws",
        global_batch=batch,
        n_classes=cfg.n_classes,
        input_hw=cfg.input_hw,
        channels=cfg.in_channels,
    )

    def loss_fn(p, b, acfg, rng):
        return analognet.cnn_loss(p, b, acfg, cfg, rng=rng)

    return params, loss_fn, iterate(pipe)


def refusal(arch: str) -> Optional[str]:
    """Why ``arch`` does not train through this CLI, or None. The
    reference's ``lm_setup`` feeds the token stream only, so its CLI fails
    on a frames-fed decoder (musicgen-large: ``KeyError: 'frames'`` in its
    first forward); the port says so before it starts."""
    if arch in configs.CNN_ARCHS:
        return None
    cfg = configs.get_smoke(arch)
    if cfg.frontend == "audio_frames":
        return (f"--arch {arch}: the {cfg.frontend} frontend reads a batch's 'frames', and "
                "lm_setup feeds tokens only (the reference CLI fails the same arch with "
                "KeyError: 'frames')")
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ALL_ARCHS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="an LM's full-size config (the smoke config without it)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--stage1", type=int, default=100)
    ap.add_argument("--stage2", type=int, default=100)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--b-adc", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--history-out", default=None)
    return ap


def main(argv: Optional[list[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    why = refusal(args.arch)
    if why:
        ap.error(why)
    device = resolve_device(args.device)
    if args.arch in configs.CNN_ARCHS:
        params, loss_fn, batches = cnn_setup(args.arch, args.batch, device)
    else:
        params, loss_fn, batches = lm_setup(args.arch, not args.full, args.batch, args.seq,
                                            device)
    tcfg = TrainConfig(
        stage1_steps=args.stage1,
        stage2_steps=args.stage2,
        eta=args.eta,
        b_adc=args.b_adc,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
    )
    params, history = run_two_stage(
        loss_fn, params, batches, tcfg,
        on_metrics=lambda i, m: print(json.dumps(m), flush=True),
    )
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    print(f"done: {len(history)} log points; final loss "
          f"{history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
