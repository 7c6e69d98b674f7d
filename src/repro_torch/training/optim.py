"""AdamW and Adafactor with the paper's parameter groups, port of
``repro.training.optim``.

* parameter groups by name: quantizer ranges (``r_adc``) take their own
  exponentially decaying LR (1e-3 -> 1e-4); the shared ADC gain
  ``gain_s`` has its gradient clipped at 0.01; ``*_buf`` buffers are frozen
  (their gradients still enter the global norm, as in the reference);
* the two-stage schedule: stage 2 restarts the cosine decay at LR/10;
* Adafactor (factored second moment) for large weights.

Trees are walked in ``jax.tree``'s order (``repro_torch.tree``: dict keys
sorted), so the global norm sums the leaves in the reference's order, and
:func:`update` returns its trees rebuilt in that order, as the reference's
jitted step returns them. Arithmetic is f32 on the leaves' device; the
schedules' and moments' values agree with the reference within rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib

Tensor = torch.Tensor


def _f32(v, device=None) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0):
    """Linear warm-up over ``warmup`` steps, then cosine decay to 0 at
    ``total_steps``."""

    def lr(step):
        step = _f32(step)
        warm = torch.minimum(step / max(warmup, 1), _f32(1.0, step.device))
        frac = ((step - warmup) / max(total_steps - warmup, 1)).clamp(0, 1)
        return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * frac))

    return lr


def exp_schedule(lr0: float, lr1: float, total_steps: int):
    """Exponential decay lr0 -> lr1 (the paper's quantizer-range LR)."""

    def lr(step):
        frac = (_f32(step) / max(total_steps, 1)).clamp(0, 1)
        return lr0 * torch.pow(_f32(lr1 / lr0, frac.device), frac)

    return lr


def classify_param(path) -> str:
    """'frozen' | 'range' (r_adc) | 'gain' (S) | 'weight', by the leaf's
    name (the last element of its path)."""
    leaf = str(path[-1]) if path else ""
    if leaf.endswith("_buf"):
        return "frozen"
    if leaf == "r_adc":
        return "range"
    if leaf == "gain_s":
        return "gain"
    return "weight"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    total_steps: int = 10_000
    warmup: int = 100
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    # paper-specific groups
    range_lr0: float = 1e-3
    range_lr1: float = 1e-4
    gain_grad_clip: float = 0.01
    # adafactor
    factored_min_dim: int = 128


class OptState(NamedTuple):
    step: Tensor
    m: Any  # first moment (adamw) or a tree of 0-d zeros (adafactor)
    v: Any  # second moment / factored rows
    v_col: Any  # factored cols (adafactor) or a tree of 0-d zeros


def _factored(cfg: OptimizerConfig, p: Tensor) -> bool:
    return p.dim() >= 2 and min(p.shape[-2:]) >= cfg.factored_min_dim


def init(cfg: OptimizerConfig, params) -> OptState:
    """The optimizer state of ``params`` (zeros), on the leaves' devices."""
    scalar = lambda p: torch.zeros((), dtype=torch.float32, device=p.device)
    dev = tree_lib.leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "adamw":
        zeros = lambda p: torch.zeros_like(p)
        return OptState(step, tree_lib.tree_map(zeros, params),
                        tree_lib.tree_map(zeros, params),
                        tree_lib.tree_map(scalar, params))
    if cfg.kind == "adafactor":

        def row_state(p):
            shape = p.shape[:-1] if _factored(cfg, p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def col_state(p):
            if _factored(cfg, p):
                return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                   device=p.device)
            return scalar(p)

        return OptState(step, tree_lib.tree_map(scalar, params),
                        tree_lib.tree_map(row_state, params),
                        tree_lib.tree_map(col_state, params))
    raise ValueError(cfg.kind)


def global_norm(tree) -> Tensor:
    """sqrt of the sum of squares of every leaf, the leaves added in the
    reference's order (a Python sum from 0); ``tree`` may be an iterable of
    leaves."""
    leaves = tree if hasattr(tree, "__next__") else tree_lib.leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _one(cfg: OptimizerConfig, kind: str, step: Tensor, lr_w, lr_r, p, g, m, v, vc):
    if kind == "frozen":
        return p, m, v, vc
    g = g.float()
    if kind == "gain":
        g = torch.minimum(torch.maximum(g, _f32(-cfg.gain_grad_clip, g.device)),
                          _f32(cfg.gain_grad_clip, g.device))
    lr = lr_r if kind == "range" else lr_w
    p32 = p.float()
    stepf = step.float()
    if cfg.kind == "adamw":
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / (1 - torch.pow(_f32(cfg.b1, g.device), stepf))
        vh = v / (1 - torch.pow(_f32(cfg.b2, g.device), stepf))
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        if kind == "weight":
            upd = upd + cfg.weight_decay * p32
        return (p32 - lr * upd).to(p.dtype), m, v, vc
    # adafactor
    decay = 1.0 - torch.pow(stepf, -0.8)
    if _factored(cfg, g):
        v = decay * v + (1 - decay) * torch.mean(g * g, dim=-1)
        vc = decay * vc + (1 - decay) * torch.mean(g * g, dim=-2)
        r = v / torch.clamp(torch.mean(v, dim=-1, keepdim=True), min=1e-30)
        denom = torch.sqrt(r[..., None] * vc[..., None, :] + cfg.eps)
    else:
        v = decay * v + (1 - decay) * g * g
        denom = torch.sqrt(v + cfg.eps)
    upd = g / denom
    # update clipping (Adafactor's RMS-1 rule)
    rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
    upd = upd / torch.clamp(rms, min=1.0)
    if kind == "weight":
        upd = upd + cfg.weight_decay * p32
    return (p32 - lr * upd).to(p.dtype), m, v, vc


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads, state: OptState,
           shardings=None) -> tuple[Any, OptState, dict]:
    """One optimizer step with the paper's parameter groups -> (params,
    state, {"grad_norm", "lr"}); ``grads`` has ``params``' structure.

    ``shardings`` = (the params' and the state's ``launch.sharding``
    trees): ``params``, ``grads`` and ``state`` hold a rank's slices. AdamW
    runs on the slices (it is elementwise); every reduction across a leaf
    runs on the gathered whole leaf in the unsharded order -- the global
    norm, and Adafactor (its row and column means and its RMS clip, each
    leaf's step taken whole and the rank's slices kept) -- so the norm, the
    clip scale and every updated value are the unsharded step's for the
    same gradients."""
    step = state.step + 1
    lr_w = cosine_schedule(cfg.lr, cfg.total_steps, cfg.warmup)(step)
    lr_r = exp_schedule(cfg.range_lr0, cfg.range_lr1, cfg.total_steps)(step)

    g_leaves = tree_lib.leaves(grads)
    if shardings is None:
        gnorm = global_norm(grads)
    else:
        from repro_torch.launch import sharding as shd

        p_sh = tree_lib.leaves(shardings[0])
        s_sh = [tree_lib.leaves(t) for t in (shardings[1].m, shardings[1].v, shardings[1].v_col)]
        gnorm = global_norm(shd.gather_leaf(g, sh) for g, sh in zip(g_leaves, p_sh))
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)

    flat = tree_lib.flatten_with_path(params)
    states = [tree_lib.leaves(t) for t in (state.m, state.v, state.v_col)]
    res = []
    for i, (path, p) in enumerate(flat):
        kind = classify_param(path)
        leaf = [p, g_leaves[i] * scale] + [st[i] for st in states]
        if shardings is None or cfg.kind == "adamw":
            res.append(_one(cfg, kind, step, lr_w, lr_r, *leaf))
            continue
        shs = [p_sh[i], p_sh[i]] + [sh[i] for sh in s_sh]
        out = _one(cfg, kind, step, lr_w, lr_r,
                   *(shd.gather_leaf(t, sh) for t, sh in zip(leaf, shs)))
        res.append([shd.take_leaf(t, sh) for t, sh in zip(out, shs[:1] + shs[2:])])
    new = [tree_lib.unflatten(params, [r[i] for r in res]) for i in range(4)]
    return new[0], OptState(step, *new[1:]), {"grad_norm": gnorm, "lr": lr_w}
