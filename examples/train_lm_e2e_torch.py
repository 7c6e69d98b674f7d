"""End-to-end LM training example of the PyTorch port: a few hundred steps
of the two-stage HW-aware method on a small transformer over the synthetic
token stream, with asynchronous checkpoints and resume; counterpart of
``examples/train_lm_e2e.py`` (the same model, data and schedule).

    PYTHONPATH=src python examples/train_lm_e2e_torch.py [--steps 100] [--device cpu]
"""

import argparse
import json

import torch

from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import PipelineConfig, iterate
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.training.loop import TrainConfig, run_two_stage


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="lm-e2e", family="dense", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, remat=False,
        dtype=torch.float32, attn_chunk_q=64, attn_chunk_kv=64,
    )
    params = lm.lm_init(prng.PRNGKey(0), cfg, device=device)
    n = sum(x.numel() for x in tree_lib.leaves(params))
    print(f"model: {n/1e6:.2f}M params")

    pipe = PipelineConfig(kind="lm", global_batch=16, seq_len=64, vocab=cfg.vocab)

    def loss_fn(p, b, acfg, rng):
        return lm.lm_loss(p, b, acfg, cfg, rng=rng)

    tcfg = TrainConfig(
        stage1_steps=args.steps // 2, stage2_steps=args.steps // 2,
        eta=0.05, b_adc=8, lr=3e-3, ckpt_dir=args.ckpt_dir, log_every=10,
    )
    params, history = run_two_stage(
        loss_fn, params, iterate(pipe), tcfg,
        on_metrics=lambda i, m: print(json.dumps(m), flush=True),
    )
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'OK' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
