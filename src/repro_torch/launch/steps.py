"""Program-phase and training steps, port of ``repro.launch.steps``.

:func:`program_for_serving` programs a chip for a serving deployment;
:func:`refresh_program` is what the refresh policy calls to rewrite a
drifted chip from its source weights; :func:`make_train_step` is the LM's
training step, with microbatch gradient accumulation;
:func:`make_prefill_step` and :func:`make_serve_step` are the rectangle
batch's prefill and greedy decode step -- the only way a multi-codebook
decoder (musicgen) is served, since the request-level engine drives one
token stream. With ``mesh=`` (a ``DeviceMesh``, ``launch.mesh``) the
program phase programs this rank's shard of the chip
(``launch.sharding.program_shardings``) and installs the mesh's logical
rules for the tensor-parallel forward, and ``make_train_step(mesh=)`` is
the reference's train step under its param, optimizer and batch shardings
on a (data, model) mesh: FSDP x tensor-parallel, every draw a rank's slice
of the unsharded step's, no float summed by a collective (see
:func:`make_train_step`).
"""

from __future__ import annotations

import weakref
from typing import Any, Optional

import torch

from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.core import engine
from repro_torch.core import pcm as pcm_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import ModelConfig
from repro_torch.training import optim as optim_lib
from repro_torch.training.loop import value_and_grad


def program_for_serving(
    params: Any,
    analog_cfg: AnalogConfig,
    key: torch.Tensor,
    *,
    mesh: Any = None,
    model_cfg: Optional[ModelConfig] = None,
    transforms: Optional[dict] = None,
    b_adc_overrides: Optional[dict] = None,
    t_seconds: Optional[float] = None,
    chip_id: Optional[int] = None,
) -> engine.CiMProgram:
    """Program phase of an analog serving deployment -> CiMProgram, on the
    device ``params`` live on. ``t_seconds`` overrides the config's age for
    the first evaluation; ``transforms`` is ``engine.compile_program``'s
    (a CNN's crossbar blocks).

    With ``mesh``, every rank passes the whole ``params`` and keeps its
    shard of the chip in the inference layout (TP over ``model``), bitwise
    its slice of the single-host chip (``CiMProgram.gather`` returns the
    host chip); a layer with a ``transforms`` entry is programmed whole on
    every rank. The mesh's ``logical_rules`` (from ``model_cfg``) are
    installed for the forward."""
    shardings = None
    if mesh is not None:
        shardings = use_mesh(mesh, model_cfg, params)
    gain_s = params["gain_s"] if isinstance(params, dict) else params.gain_s
    return engine.compile_program(
        params, analog_cfg, key, t_seconds=t_seconds, transforms=transforms,
        shardings=shardings, b_adc_overrides=b_adc_overrides, chip_id=chip_id,
        device=gain_s.device,
    )


def use_mesh(mesh: Any, model_cfg: Optional[ModelConfig], params: Any = None) -> Any:
    """Install ``mesh``'s logical rules (``models.common.set_logical_rules``)
    and return the program shardings of ``params`` (None without them)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.common import set_logical_rules

    set_logical_rules(shd.logical_rules(mesh, model_cfg), mesh)
    return None if params is None else shd.program_shardings(params, mesh, model_cfg)


def refresh_program(
    program: engine.CiMProgram, src_params: Any, key: torch.Tensor, *,
    mesh: Any = None, model_cfg: Optional[ModelConfig] = None,
    transforms: Optional[dict] = None,
) -> engine.CiMProgram:
    """Rewrite a drifted chip from the stored source weights: fresh write
    noise, the drift clock reset to t_c, the same per-layer bitwidths and
    the same chip id (with ``mesh``: this rank's shard of it, as
    :func:`program_for_serving`); ``transforms`` as the chip was compiled
    with."""
    return program_for_serving(
        src_params, program.cfg, key, mesh=mesh, model_cfg=model_cfg, transforms=transforms,
        b_adc_overrides=engine.plan_bit_overrides(program) or None,
        t_seconds=pcm_lib.T_C,
        chip_id=program.chip_id,
    )


def make_train_step(
    cfg: ModelConfig,
    analog_cfg: AnalogConfig,
    opt_cfg: optim_lib.OptimizerConfig,
    accum_steps: int = 1,
    *,
    mesh: Any = None,
    shardings: Optional[tuple] = None,
):
    """(params, opt_state, batch, rng) -> (params, opt_state, metrics), the
    reference's step.

    The step's key is ``fold_in(rng, opt_state.step)``; the forward draws
    its noise from it only when ``analog_cfg.needs_rng``. ``accum_steps >
    1`` splits every batch leaf into (accum_steps, B / accum_steps, ...)
    microbatches, run in order with the same noise key each, and sums
    their gradients in f32 from zeros before dividing by ``accum_steps``;
    the metrics then hold the mean ``loss`` only (no ``ppl_proxy``), as the
    reference's do. Activation memory scales with the microbatch.

    **Sharded** (``mesh``, a (data, model) ``DeviceMesh``; ``shardings`` =
    (``launch.sharding.param_shardings(..., analog_cfg=analog_cfg)``,
    ``build_opt_shardings(...)``)): the step the reference jits with those
    in/out shardings. ``params`` and ``opt_state`` hold the rank's slices
    (``sharding.shard_tree``) and come back so; ``batch`` is the global
    batch, of which the rank takes its rows of each microbatch
    (``batch_shardings``: over ``data``). It computes the unsharded step's
    function: the same key schedule, each rank drawing its slice of every
    draw (its rows of the batch, its columns or tiles of a layer); each
    leaf gathered over ``data`` before use and its gradient summed over
    ``data`` in rank order (``training.loop.value_and_grad``); the loss
    gathered over the rows; the optimizer's reductions on whole leaves
    (``optim.update``). The metrics are the same on every rank. A leaf
    the forward consumes whole (the embedding table, the causal conv's
    ``conv_w`` and ``conv_b``) is gathered over ``model`` in
    ``sharding.train_view``. The shard_map MoE dispatch refuses a mesh.
    """

    def loss_for(p, batch, noise_rng):
        return lm_lib.lm_loss(p, batch, analog_cfg, cfg, rng=noise_rng)

    if mesh is not None:
        return _sharded_train_step(cfg, analog_cfg, opt_cfg, accum_steps, mesh, shardings,
                                   loss_for)

    def train_step(params, opt_state, batch, rng):
        step_rng = prng.fold_in(rng, opt_state.step)
        noise_rng = step_rng if analog_cfg.needs_rng else None

        if accum_steps <= 1:
            (_, metrics), grads = value_and_grad(loss_for, params, batch, noise_rng)
        else:
            grads, metrics = _accumulate(loss_for, params, _micro(batch, accum_steps),
                                         accum_steps, noise_rng, opt_state.step.device)

        params, opt_state, opt_metrics = optim_lib.update(opt_cfg, params, grads, opt_state)
        # sorted keys, as the reference's jitted step returns its dict
        return params, opt_state, dict(sorted({**metrics, **opt_metrics}.items()))

    return train_step


def _micro(batch: dict, accum_steps: int) -> list:
    """The batch's ``accum_steps`` microbatches of B / accum_steps rows."""
    return [tree_lib.tree_map(lambda x: x.reshape(
        (accum_steps, x.shape[0] // accum_steps) + x.shape[1:])[i], batch)
        for i in range(accum_steps)]


def _accumulate(loss_for, params, micro: list, accum_steps: int, noise_rng, dev,
                **kw) -> tuple:
    """The microbatches' gradients summed in f32 from zeros, then divided by
    ``accum_steps``, and their mean loss."""
    grads = tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in micro:
        (loss, _), g = value_and_grad(loss_for, params, mb, noise_rng, **kw)
        grads = tree_lib.tree_map(torch.add, grads, g)
        loss_sum = loss_sum + loss
    grads = tree_lib.tree_map(lambda g: g / accum_steps, grads)
    return grads, {"loss": loss_sum / accum_steps}


def _sharded_train_step(cfg, analog_cfg, opt_cfg, accum_steps, mesh, shardings, loss_for):
    """:func:`make_train_step` under ``mesh`` (see its docstring)."""
    from repro_torch import collectives
    from repro_torch.launch import sharding as shd
    from repro_torch.models.common import logical_rules_of

    if cfg.moe_dispatch == "shard_map" and cfg.family == "moe":
        raise NotImplementedError("the sharded train step runs the einsum MoE dispatch, the "
                                  "reference's default; shard_map dispatch is served only")
    if shardings is None:
        raise ValueError("a sharded train step takes shardings=(param_shardings(..., "
                         "analog_cfg=), build_opt_shardings(...))")
    p_sh, _ = shardings
    rules = shd.logical_rules(mesh, cfg, training=True)
    data = collectives.axis_of(mesh, "data")

    def sharded_loss(p, batch, noise_rng):
        return loss_for(shd.train_view(p, p_sh), batch, noise_rng)

    def rows_of(batch: dict) -> dict:
        rows = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.shape[0] % data.size:
                raise ValueError(f"batch leaf {k!r} of {t.shape[0]} rows does not split over "
                                 f"{data.size} data-parallel ranks")
            n = t.shape[0] // data.size
            rows[k] = t.narrow(0, data.rank * n, n)
        return rows

    def train_step(params, opt_state, batch, rng):
        step_rng = prng.fold_in(rng, opt_state.step)
        noise_rng = step_rng if analog_cfg.needs_rng else None
        with logical_rules_of(rules, mesh):
            if accum_steps <= 1:
                (_, metrics), grads = value_and_grad(sharded_loss, params, rows_of(batch),
                                                     noise_rng, shardings=p_sh)
            else:
                grads, metrics = _accumulate(
                    sharded_loss, params, [rows_of(mb) for mb in _micro(batch, accum_steps)],
                    accum_steps, noise_rng, opt_state.step.device, shardings=p_sh)
            params, opt_state, opt_metrics = optim_lib.update(opt_cfg, params, grads, opt_state,
                                                              shardings)
        return params, opt_state, dict(sorted({**metrics, **opt_metrics}.items()))

    return train_step


class _Cast:
    """A params object and its copy with the analog weights cast to ``dtype``."""

    __slots__ = ("src", "dtype", "params", "__weakref__")

    def __init__(self, src, dtype: torch.dtype):
        self.src, self.dtype = src, dtype
        self.params = engine.cast_weights(src, dtype)


#: id(params) -> its cast copy, alive while a step holds it
_CASTS: "weakref.WeakValueDictionary[int, _Cast]" = weakref.WeakValueDictionary()


def _cast_once(held: list, params, dtype: torch.dtype):
    """``params`` with its analog weights cast to the model ``dtype`` once
    per params object, as the serving engine casts them (bitwise the
    execute phase's per-call cast): the copy is shared by the steps handed
    the same object and freed when no step holds it. ``held`` is the
    calling step's one-entry memo."""
    if not (held and held[0].src is params and held[0].dtype == dtype):
        c = _CASTS.get(id(params))
        if c is None or c.src is not params or c.dtype != dtype:
            c = _CASTS[id(params)] = _Cast(params, dtype)
        held[:] = [c]
    return held[0].params


def _batch_on(params, batch: dict, dev: torch.device) -> dict:
    """``batch``'s leaves as tensors on ``dev`` (token ids as int64), where
    ``params`` must live."""
    if params.gain_s.device.type != dev.type:
        raise ValueError(f"params live on {params.gain_s.device}, the step runs on {dev}")
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        out[k] = t.long() if k == "tokens" else t
    return out


def make_prefill_step(cfg: ModelConfig, analog_cfg: AnalogConfig, *, device="cuda",
                      mesh: Any = None, shardings: Any = None):
    """(params, batch, cache, rng) -> (next-position logits, cache), the
    reference's prefill step on ``device``.

    ``batch`` holds ``tokens`` (B, S) -- with ``patches`` (B, P, d) for the
    vision family -- or the audio family's ``frames`` (B, S, d); ``cache``
    is a stacked :func:`~repro_torch.models.lm.init_lm_cache`. Only the
    last position's logits are computed: (B, 1, V), or (B, 1, C, V) for a
    codebook head. ``rng`` draws per-call noise only when
    ``analog_cfg.needs_rng``. The analog weights run from a copy cast to
    ``cfg.dtype`` once per params object (shared with a serve step handed
    the same object), not at every MVM.

    **Sharded** (``mesh``, a (data, model) ``DeviceMesh``; ``shardings``,
    ``launch.sharding.param_shardings(..., analog_cfg=analog_cfg)`` of the
    params, ``inference`` or not): the step the reference jits with its
    param, batch and cache shardings, from the engine's sharded forward.
    ``params`` holds the rank's slices (``sharding.shard_tree``), ``batch``
    is the global batch, of which the rank takes its rows where the data
    axes divide them (``batch_shardings``), and ``cache`` is the rank's:
    its rows, and the KV heads its attention runs (:func:`sharded_cache`).
    Each step gathers every leaf over the FSDP axes and the leaves the
    forward takes whole (``sharding.serve_view``); the tensor-parallel
    forward runs the rank's columns, tiles, heads and experts, every draw
    its slice of the unsharded step's, no float summed by a collective. It
    returns the rank's rows of what the unsharded step returns.
    """
    if mesh is not None:
        return _sharded_serving_step(cfg, analog_cfg, device, mesh, shardings, prefill=True)
    dev = resolve_device(device)
    held: list = []

    def prefill_step(params, batch, cache, rng):
        noise_rng = rng if analog_cfg.needs_rng else None
        return lm_lib.lm_forward(_cast_once(held, params, cfg.dtype),
                                 _batch_on(params, batch, dev), analog_cfg, cfg,
                                 rng=noise_rng, cache=cache, last_token_only=True)

    return prefill_step


def make_serve_step(cfg: ModelConfig, analog_cfg: AnalogConfig, *, device="cuda",
                    mesh: Any = None, shardings: Any = None):
    """One greedy decode step on ``device``: (params, batch, cache, rng) ->
    (next tokens, cache), the reference's serve step.

    ``batch`` holds the previous step's ``tokens`` (B, 1), or the audio
    family's next ``frames`` (B, 1, d). The argmax runs over the last axis:
    (B,) int32 tokens, or (B, C) codes for a codebook head. The weights
    are cast once per params object, as in :func:`make_prefill_step`;
    ``mesh`` and ``shardings`` as there (the rank's rows' tokens).
    """
    if mesh is not None:
        return _sharded_serving_step(cfg, analog_cfg, device, mesh, shardings, prefill=False)
    dev = resolve_device(device)
    held: list = []

    def serve_step(params, batch, cache, rng):
        noise_rng = rng if analog_cfg.needs_rng else None
        logits, cache = lm_lib.lm_forward(_cast_once(held, params, cfg.dtype),
                                          _batch_on(params, batch, dev), analog_cfg, cfg,
                                          rng=noise_rng, cache=cache)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    return serve_step


def _batch_rows(mesh: Any, batch: dict) -> Optional[Any]:
    """This rank's :class:`~repro_torch.launch.sharding.Split` of the
    batch rows over ``data`` (``batch_shardings``' rule), or None where
    every rank runs the whole batch."""
    from repro_torch import collectives
    from repro_torch.launch import sharding as shd

    b = next(iter(batch.values())).shape[0]
    data = collectives.axis_of(mesh, "data")
    if data is None or data.size == 1 or shd.batch_axis(mesh, b) is None:
        return None
    return shd.Split(0, shd.even_bounds(b, data.size), data.rank)


def sharded_cache(cfg: ModelConfig, params: Any, shardings: Any, mesh: Any, batch: int,
                  s_max: int, *, stacked: bool = True, device="cuda") -> tuple:
    """A rank's cache for a sharded serving step over the global ``batch``
    rows: its rows of them (where the data axes divide them) and the KV
    heads its attention runs (``attention.head_layout``: its own where the
    ``model`` degree divides them, else every one)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.common import logical_rules_of

    with logical_rules_of(shd.logical_rules(mesh, cfg), mesh):
        kv = lm_lib.cache_kv_heads(shd.layer_splits(params, shardings), cfg)
    rows = _batch_rows(mesh, {"b": torch.empty((batch,), device="meta")})
    b = batch if rows is None else rows.stop - rows.start
    return lm_lib.init_lm_cache(cfg, b, s_max, cfg.dtype, stacked=stacked, device=device,
                                kv_heads=kv)


def _sharded_serving_step(cfg, analog_cfg, device, mesh, shardings, prefill: bool):
    """:func:`make_prefill_step` / :func:`make_serve_step` under ``mesh``."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.common import logical_rules_of

    if shardings is None:
        raise ValueError("a sharded serving step takes shardings=param_shardings(params, "
                         "mesh, cfg, inference=..., analog_cfg=analog_cfg)")
    dev = resolve_device(device)
    held: list = []

    def step(params, batch, cache, rng):
        noise_rng = rng if analog_cfg.needs_rng else None
        rows = _batch_rows(mesh, batch)
        if rows is not None:
            batch = {k: rows.take(torch.as_tensor(v), 0) for k, v in batch.items()}
        rules = shd.logical_rules(mesh, cfg, rows=rows is not None)
        with torch.no_grad(), logical_rules_of(rules, mesh):
            view = shd.serve_view(_cast_once(held, params, cfg.dtype), shardings)
            logits, cache = lm_lib.lm_forward(view, _batch_on(params, batch, dev), analog_cfg,
                                              cfg, rng=noise_rng, cache=cache,
                                              last_token_only=prefill)
        if prefill:
            return logits, cache
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    return step
