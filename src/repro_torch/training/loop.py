"""The paper's two-stage training with fault tolerance, port of
``repro.training.loop``.

Sec. 4.2 / 6.1 end to end:
  stage 1 -- digital training; the clip ranges recomputed from std(W)
             every ``clip_refresh_every`` steps;
  stage 2 -- ranges frozen (refreshed once at the boundary); noise
             injection (eta) and the DAC/ADC quantizers with trained ranges
             and the shared gain S (``analog_train``); the optimizer reset
             at LR/10; the quantizer-range LR decays 1e-3 -> 1e-4; S's
             gradient clipped at 0.01; quant noise at ``quant_noise_p``.

Step i draws its noise from ``fold_in(PRNGKey(0), i)`` through the RNG
bridge, so a step's draws are the reference's. On a card every analog MVM
of a stage-2 forward is one B1 launch (``kernels.ops.analog_mvm_ste``);
its backward differentiates the plain training form. Gradients are taken
for every float leaf -- the frozen ``*_buf`` buffers included, as
``jax.value_and_grad`` takes them -- so they enter the global norm as in
the reference.

Fault tolerance: asynchronous atomic checkpoints (``checkpoint.store``),
auto-resume from the newest one, a SIGTERM-triggered final save, and the
deterministic skip-ahead data of ``data.pipeline``. Resume is the
reference's, quirks included: only params are saved, so a resume
re-initialises the stage-1 optimizer, and a resume past the stage
boundary never switches to stage 2.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store
from repro_torch.core.analog import AnalogConfig, refresh_clip_ranges
from repro_torch.training import optim as optim_lib


@dataclasses.dataclass
class TrainConfig:
    stage1_steps: int = 200
    stage2_steps: int = 200
    eta: float = 0.1
    b_adc: int = 8
    quant_noise_p: float = 0.5
    lr: float = 3e-3
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    clip_refresh_every: int = 10  # stage-1 W_max refresh cadence (paper)
    log_every: int = 25


def value_and_grad(loss_fn: Callable, params: Any, *args, shardings: Any = None) -> tuple:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ((loss, metrics), grads), the grads a tree of ``params``' structure
    with a gradient for every leaf (zeros where the loss does not depend
    on it, as JAX gives).

    ``shardings`` (``launch.sharding.param_shardings``' tree; a sharded
    training step's): ``params`` holds a rank's slices. Each leaf is
    gathered over the FSDP axes before use (exact), so ``loss_fn`` sees the
    rank's tensor-parallel shards; each gradient, the rank's rows' part of
    it, is summed over ``data`` (``collectives.sum_in_rank_order``) and the
    rank keeps its FSDP slice."""
    flat = tree_lib.leaves(params)
    if shardings is not None:
        from repro_torch import collectives
        from repro_torch.launch import sharding as shd

        shs = tree_lib.leaves(shardings)
        fsdp = shd.fsdp_axes(shs[0].mesh)
        flat = [shd.gather_leaf(x, sh, fsdp) for x, sh in zip(flat, shs, strict=True)]
    leaves = [x.detach().requires_grad_(x.is_floating_point()) for x in flat]
    loss, metrics = loss_fn(tree_lib.unflatten(params, leaves), *args)
    wrt = [x for x in leaves if x.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in leaves:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    if shardings is not None:
        data = collectives.axis_of(shs[0].mesh, "data")
        grads = [shd.take_leaf(collectives.sum_in_rank_order(g, data), sh, fsdp)
                 if g.is_floating_point() else shd.take_leaf(g, sh, fsdp)
                 for g, sh in zip(grads, shs)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_lib.unflatten(params, grads)


def _device_of(params: Any) -> torch.device:
    return tree_lib.leaves(params)[0].device


def run_two_stage(
    loss_fn: Callable,  # (params, batch, analog_cfg, rng) -> (loss, metrics)
    params: Any,
    batches,  # iterator of batches (numpy or tensors)
    tcfg: TrainConfig,
    *,
    opt_kind: str = "adamw",
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    clock: Optional[clock_lib.Clock] = None,
):
    """Returns (params, history). Resumes from the latest checkpoint if any.
    Runs on the device of ``params``' leaves (batches are moved there);
    ``clock`` injects the time source of the ``wall_s`` metric."""
    preempted = {"flag": False}

    def _sigterm(_sig, _frm):
        preempted["flag"] = True

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not on the main thread (tests)

    digital = AnalogConfig()
    analog = AnalogConfig().train(
        eta=tcfg.eta, b_adc=tcfg.b_adc, quant_noise_p=tcfg.quant_noise_p
    )

    def make_step(analog_cfg: AnalogConfig, opt_cfg: optim_lib.OptimizerConfig):
        def step(params, opt_state, batch, rng):
            (loss, metrics), grads = value_and_grad(
                lambda p: loss_fn(p, batch, analog_cfg, rng), params)
            params2, opt_state2, om = optim_lib.update(opt_cfg, params, grads, opt_state)
            # sorted keys, as the reference's jitted step returns its dict
            return params2, opt_state2, dict(sorted({**metrics, **om}.items()))

        return step

    dev = _device_of(params)
    history = []
    rng = prng.PRNGKey(0).to(dev)
    start = 0
    ckpt = None
    if tcfg.ckpt_dir:
        ckpt = store.AsyncCheckpointer(tcfg.ckpt_dir)
        latest = store.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            meta = store.read_meta(tcfg.ckpt_dir, latest)
            params = store.restore(tcfg.ckpt_dir, latest, params)
            start = meta["step"]

    total = tcfg.stage1_steps + tcfg.stage2_steps

    opt1 = optim_lib.OptimizerConfig(
        kind=opt_kind, lr=tcfg.lr, total_steps=tcfg.stage1_steps,
        warmup=max(1, min(20, tcfg.stage1_steps // 10)),
    )
    opt2 = optim_lib.OptimizerConfig(
        kind=opt_kind, lr=tcfg.lr / 10.0, total_steps=tcfg.stage2_steps,
        warmup=max(1, min(20, tcfg.stage2_steps // 10)),
    )
    step1 = make_step(digital, opt1)
    step2 = make_step(analog, opt2)
    opt_state = optim_lib.init(opt1, params)
    stage = 1

    clk = clock or clock_lib.SYSTEM
    it = iter(batches)
    t0 = clk.now()
    for i in range(start, total):
        if i == tcfg.stage1_steps:
            # stage boundary: freeze clip ranges, reset the optimizer, enable
            # noise + quantizers (paper Sec. 4.2, two-stage protocol)
            params = refresh_clip_ranges(params)
            opt_state = optim_lib.init(opt2, params)
            stage = 2
        elif stage == 1 and i % tcfg.clip_refresh_every == 0:
            params = refresh_clip_ranges(params)

        batch = tree_lib.tree_map(
            lambda a: torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                                      device=dev), next(it))
        step_fn = step1 if stage == 1 else step2
        params, opt_state, metrics = step_fn(params, opt_state, batch, prng.fold_in(rng, i))
        if i % tcfg.log_every == 0 or i == total - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i, stage=stage, wall_s=round(clk.now() - t0, 1))
            history.append(m)
            if on_metrics:
                on_metrics(i, m)
        if ckpt and (i % tcfg.ckpt_every == 0 or preempted["flag"]):
            ckpt.save(i + 1, params, {"stage": stage})
        if preempted["flag"]:
            break

    if ckpt:
        ckpt.save(total, params, {"stage": stage, "final": True})
        ckpt.close()
    return params, history
