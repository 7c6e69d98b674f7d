"""AnalogLinear: the analog-CiM-deployable layer, port of ``repro.core.analog``.

Every stationary-weight matmul goes through :func:`analog_matmul`, a plan
dispatcher over the execute phase (:mod:`repro_torch.core.engine`). The
modes:

  * ``digital``        -- plain matmul (the full-precision reference; the
                           paper's training stage 1).
  * ``analog_train``   -- the paper's HW-aware training graph (Fig. 4,
                           stage 2): STE weight clip -> Gaussian noise
                           (Eq. 1, ``core.noise``) -> DAC fake-quant of the
                           input -> MVM with a per-tile ADC, each quantizer
                           quant-noise masked at ``quant_noise_p`` -> digital
                           sum. The MVM goes through the STE function
                           ``kernels.ops.analog_mvm_ste``: on a CUDA tensor
                           B1 forward (with the ADC's keep mask), the plain
                           training form's VJP backward.
  * ``pcm_programmed`` -- execute phase of a compiled ``CiMProgram``: the
                           weights are already PCM effective weights and each
                           layer carries its GDC ``out_scale_buf``. The DAC
                           quantizes the input, then ``engine.execute_mvm``
                           runs the tiled MVM with per-tile ADC and the GDC
                           epilogue -- on a CUDA tensor through the Hopper
                           kernel ``kernels.analog_mvm``. A program
                           compiled with ``resample_read_noise`` and served
                           with a key redraws each layer's read noise per
                           MVM from its ``read_buf``.
  * ``pcm_infer``      -- per-call simulation: every MVM programs, drifts
                           and reads its layer afresh from the call's key
                           (``pcm.simulate_weights``), for statistical
                           accuracy sweeps, not serving.

Keys are the RNG bridge's threefry keys (``repro_torch.prng``);
:meth:`AnalogCtx.next_key` folds the layer counter in as the reference
does, so a keyed forward draws the reference's noise. ``analog_train``
takes the reference's keys in its order: the weight noise always, the DAC
mask if ``quant_noise_p < 1``, the ADC mask if also ``not use_kernel``.
:func:`refresh_clip_ranges` sets the stage-1 clip ranges from std(W).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import collectives, prng
from repro_torch.core import engine as engine_lib
from repro_torch.core import noise as noise_lib
from repro_torch.core import pcm as pcm_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.engine import PCM_PROGRAMMED
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor

DIGITAL = "digital"
ANALOG_TRAIN = "analog_train"
PCM_INFER = "pcm_infer"


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Static configuration of the analog execution environment.

    Every field of the reference's ``AnalogConfig`` is kept, so a stored
    artifact's config loads unchanged. ``use_kernel``/``interpret`` do not
    choose the execute path here: a CUDA tensor always runs the Hopper
    kernel, a CPU tensor its plain version. In ``analog_train``,
    ``use_kernel`` does as in the reference: with it, the ADC draws no
    quant noise (the reference's kernel has none).
    """

    mode: str = DIGITAL
    eta: float = 0.1
    b_adc: int = 8
    quant_noise_p: float = 1.0
    per_tile_adc: bool = True
    tile_rows: int = 1024
    tile_cols: int = 512
    t_seconds: float = 86400.0
    pcm: pcm_lib.PCMConfig = dataclasses.field(default_factory=pcm_lib.PCMConfig)
    use_kernel: bool = False
    interpret: bool = False
    resample_read_noise: bool = False

    @property
    def spec(self) -> QuantSpec:
        return QuantSpec(b_adc=self.b_adc, quant_noise_p=self.quant_noise_p)

    @property
    def needs_rng(self) -> bool:
        """True for modes that draw fresh noise on every forward call."""
        if self.mode == PCM_PROGRAMMED:
            return self.resample_read_noise
        return self.mode in (ANALOG_TRAIN, PCM_INFER)

    def train(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, mode=ANALOG_TRAIN, **kw)

    def infer(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, mode=PCM_INFER, quant_noise_p=1.0, **kw)


#: signature of an execute-phase MVM: (x_q, w, r_adc, plan, *, out_scale)
MvmFn = Callable[..., Tensor]


@dataclasses.dataclass
class AnalogCtx:
    """Per-call context threaded through the model.

    ``key`` is the call's threefry key: each analog layer that draws noise
    takes :meth:`next_key`. ``mvm`` replaces :func:`engine.execute_mvm` for this call when set --
    a check that drives a whole forward through the plain
    ``engine.execute_mvm_plain`` on the card uses it; serving leaves it None.
    """

    cfg: AnalogConfig
    gain_s: Tensor  # the single network-wide ADC gain S (Eq. 5)
    key: Optional[Tensor] = None  # base key of the call's draws (None: none)
    layer_counter: int = 0  # folded into each draw's key
    mvm: Optional[MvmFn] = None

    def next_key(self) -> Optional[Tensor]:
        if self.key is None:
            return None
        self.layer_counter += 1
        return prng.fold_in(self.key, self.layer_counter)


def analog_matmul(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Tensor,
    w_min: Tensor,
    w_max: Tensor,
    ctx: AnalogCtx,
    out_scale: Optional[Tensor] = None,
    b_adc: Optional[int] = None,
    read_buf: Optional[dict] = None,
    split=None,
    rows_axis=None,
) -> Tensor:
    """The framework-wide analog-aware matmul. x: (..., K), w: (K, N).

    ``read_buf`` is the layer's pre-read conductance buffer: with
    ``cfg.resample_read_noise`` and a key in ``ctx`` the frozen read draw
    is replaced by a fresh one per MVM; without a key the frozen weights
    execute bitwise as before.

    ``split``: ``w`` is a rank's shard of a programmed layer (its read
    noise redrawn at its slice of the whole draw's counters). With
    ``rows_axis`` the shard is a range of whole crossbar tiles of K and x
    holds those rows: each tile is one MVM with ``out_scale`` 1 (one B1
    launch per tile on a card; the plain version's partial on the CPU),
    the ranks' partials are gathered over the axis and summed in tile order
    (:func:`engine.tile_sum`). No float crosses the ranks in a reduction.

    In ``pcm_infer`` ``split`` is a rank's shard of the layer's weights:
    its program, drift and read draws are its slice of the whole layer's
    (the counters of ``engine.slice_counters``), its weight scale and GDC
    numerator and denominator the whole layer's (an f32 MAX and integer
    ``det_sum`` limbs over the axis), and the MVM runs as on a programmed
    shard. In training (``digital``, ``analog_train``) ``split`` is a
    rank's shard of a sharded training step's layer (:func:`_train_matmul`,
    :func:`_digital_columns`).
    """
    cfg = ctx.cfg
    if cfg.mode == DIGITAL:
        if split is not None:
            return _digital_columns(x, w, split)
        return engine_lib.execute_digital(x, w)
    if cfg.mode not in (ANALOG_TRAIN, PCM_PROGRAMMED, PCM_INFER):
        raise ValueError(f"unknown analog mode: {cfg.mode}")
    if cfg.mode == ANALOG_TRAIN:
        return _train_matmul(x, w, r_adc, w_min, w_max, ctx, b_adc, split)
    plan = engine_lib.plan_for(cfg, int(w.shape[-2]), int(w.shape[-1]), b_adc)
    out_dtype = x.dtype
    mvm = ctx.mvm or engine_lib.execute_mvm
    scale = 1.0 if out_scale is None else out_scale
    w_exec = w
    if cfg.mode == PCM_PROGRAMMED:
        if read_buf is not None and cfg.resample_read_noise:
            r_key = ctx.next_key()
            if r_key is not None:
                w_exec = engine_lib.resample_read(r_key, read_buf, split).to(w.dtype)
    else:
        w_key = ctx.next_key()
        if w_key is None:
            raise ValueError("pcm_infer requires a key in the AnalogCtx")
        engine_lib.record_program_event()  # per-call reprogramming
        w_c = torch.minimum(torch.maximum(w, w_min), w_max)
        if split is None:
            w_exec, scale = pcm_lib.simulate_weights(w_key, w_c.float(), cfg.t_seconds, cfg.pcm)
        else:
            w_exec, scale = pcm_lib.simulate_weights(
                w_key, w_c.float(), cfg.t_seconds, cfg.pcm,
                *engine_lib.slice_counters(tuple(w.shape), split), model_axis(split))
    x_q = quant_lib.dac_quantize(x, r_adc, ctx.gain_s, w_max, plan.spec)
    x_q = x_q.to(out_dtype)
    # a no-op when the weights were pre-cast to the activation dtype
    # (engine.cast_weights): the cast is deterministic, so keeping one
    # pre-cast copy is bitwise the reference's per-call cast
    w_exec = w_exec.to(x_q.dtype)
    if rows_axis is not None:
        tr = plan.tile_rows
        parts = []
        for lo in range(0, plan.k, tr):
            hi = min(lo + tr, plan.k)
            tile = engine_lib.plan_for(cfg, hi - lo, plan.n, b_adc)
            parts.append(mvm(x_q[..., lo:hi].contiguous(), w_exec[lo:hi], r_adc, tile,
                             out_scale=1.0).to(out_dtype))
        tiles = tuple(-(-b // tr) for b in split.bounds)
        parts = collectives.all_gather_dim(torch.stack(parts), 0, tiles, rows_axis)
        return engine_lib.tile_sum(parts, scale, out_dtype)
    return mvm(x_q, w_exec, r_adc, plan, out_scale=scale).to(out_dtype)


def _train_matmul(x: Tensor, w: Tensor, r_adc: Tensor, w_min: Tensor, w_max: Tensor,
                  ctx: AnalogCtx, b_adc: Optional[int], split) -> Tensor:
    """``analog_train``'s MVM (see the module docstring). Under a sharded
    training step (``models.common.row_axis``: ``x`` holds a data-parallel
    rank's rows of the global batch) every draw is the rank's slice of the
    unsharded step's: the DAC and ADC masks at its rows, and with ``split``
    (``w`` a rank's columns, or whole tiles of its rows with ``x`` whole)
    the weight noise and the ADC mask at its columns or tiles; the MVM then
    runs on the shard (``kernels.ops.analog_mvm_shard``)."""
    from repro_torch.models.common import row_axis

    cfg = ctx.cfg
    k, n = int(w.shape[-2]), int(w.shape[-1])
    if split is not None:
        k, n = (k, split.size) if split.dim == -1 else (split.size, n)
    plan = engine_lib.plan_for(cfg, k, n, b_adc)
    spec = plan.spec
    w_key = ctx.next_key()
    if split is None:
        w_eff = noise_lib.inject(w_key, w, cfg.eta, w_min, w_max)
    else:
        w_eff = noise_lib.inject(w_key, w, cfg.eta, w_min, w_max,
                                 *engine_lib.slice_counters(tuple(w.shape), split))
    masked = spec.quant_noise_p < 1.0
    qn_key_in = ctx.next_key() if masked else None
    qn_key_out = ctx.next_key() if masked and not cfg.use_kernel else None
    rows = row_axis()
    r = 0 if rows is None else rows.rank
    x_q = quant_lib.dac_quantize(x, r_adc, ctx.gain_s, w_max, spec, qn_key_in, r * x.numel())
    x_q = x_q.to(x.dtype)
    w_q = w_eff.to(x_q.dtype)
    if rows is None and split is None:
        mvm = ctx.mvm or engine_lib.execute_mvm
        return mvm(x_q, w_q, r_adc, plan, qn_key=qn_key_out).to(x.dtype)
    if ctx.mvm is not None:
        raise ValueError("ctx.mvm replaces the unsharded execute path; a sharded training "
                         "step runs its own")
    keep = engine_lib.quant_noise_keep(
        qn_key_out, spec, x.shape[:-1], k, n, plan.tile_rows, plan.per_tile_adc, x.device,
        row0=r * (x.numel() // x.shape[-1]), split=split)
    if split is None:
        return engine_lib.execute_mvm(x_q, w_q, r_adc, plan, keep=keep).to(x.dtype)
    return kernel_ops.analog_mvm_shard(
        x_q, w_q, r_adc=r_adc, split=split, axis=model_axis(split), bits=spec.b_adc,
        tile_rows=plan.tile_rows, per_tile_adc=plan.per_tile_adc, keep=keep).to(x.dtype)


def _digital_columns(x: Tensor, w: Tensor, split) -> Tensor:
    """``digital``'s MVM on a rank's columns of a layer: its output columns
    from the whole input (a digital layer has no tile, so its rows stay
    whole); the backward takes the whole layer's VJP
    (``kernels.ops.sharded``)."""
    if split.dim != -1:
        raise ValueError("a digital layer is split by its columns: it has no crossbar tile "
                         "to cut its rows at (launch.sharding's crossbar rule)")
    fn = engine_lib.execute_digital
    part = (-1, split.bounds)
    return kernel_ops.sharded(fn, kernel_ops.autograd_vjp(fn), (x, w), (None, part),
                              model_axis(split), part)


def analog_matmul_bank(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Tensor,
    w_min: Tensor,
    w_max: Tensor,
    ctx: AnalogCtx,
    out_scale: Optional[Tensor] = None,
    b_adc: Optional[int] = None,
) -> Tensor:
    """:func:`analog_matmul` over an expert bank: x (E, T, K), w (E, K, N)
    -> (E, T, N), one family of a MoE layer (``models.moe``); the range,
    the clip and the bitwidth are the family's, ``out_scale`` (E,) the
    experts' GDC scalars.

    On a programmed chip (and no ``ctx.mvm``) the DAC quantizes the whole
    bank's inputs and ``engine.execute_mvm_bank`` runs it as one MVM (B1's
    expert-bank form on a card). Every other mode runs the experts one at
    a time, each from the key counter the family started at: the
    reference vmaps one expert's function over the bank, so its experts
    draw from the same keys, and the counter ends where one expert's draws
    end.
    """
    cfg = ctx.cfg
    if cfg.mode == PCM_PROGRAMMED and ctx.mvm is None:
        plan = engine_lib.plan_for(cfg, int(w.shape[-2]), int(w.shape[-1]), b_adc)
        x_q = quant_lib.dac_quantize(x, r_adc, ctx.gain_s, w_max, plan.spec).to(x.dtype)
        y = engine_lib.execute_mvm_bank(x_q, w.to(x_q.dtype), r_adc, plan,
                                        out_scale=1.0 if out_scale is None else out_scale)
        return y.to(x.dtype)
    start, out = ctx.layer_counter, []
    for e in range(w.shape[0]):
        ctx.layer_counter = start
        out.append(analog_matmul(
            x[e], w[e], r_adc=r_adc, w_min=w_min, w_max=w_max, ctx=ctx,
            out_scale=None if out_scale is None else out_scale[e], b_adc=b_adc,
        ))
    return torch.stack(out)


def linear_init(
    key: Tensor,
    d_in: int,
    d_out: int,
    *,
    use_bias: bool = False,
    dtype=torch.float32,
    scale: Optional[float] = None,
) -> dict:
    """Analog linear params drawn from ``key`` (on the key's device), as the
    reference draws them: N(0, 1) * d_in^-1/2, r_adc = 1, clip [-1, 1]."""
    dev = key.device
    w_key = prng.split(key)[0]
    s = scale if scale is not None else d_in**-0.5
    params = {
        "w": (prng.normal(w_key, (d_in, d_out)) * s).to(dtype),
        "r_adc": torch.ones((), dtype=torch.float32, device=dev),
        "w_clip_buf": torch.tensor([-1.0, 1.0], dtype=torch.float32, device=dev),
    }
    if use_bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return params


def _linear(params: dict, x: Tensor, ctx: AnalogCtx, rows_axis=None) -> Tensor:
    """The layer on the weights it holds (a rank's shard, or all of it;
    ``rows_axis``: whole tiles of its rows, see :func:`analog_matmul`)."""
    y = analog_matmul(
        x,
        params["w"],
        r_adc=params["r_adc"],
        w_min=params["w_clip_buf"][..., 0],
        w_max=params["w_clip_buf"][..., 1],
        ctx=ctx,
        out_scale=params.get("out_scale_buf"),
        b_adc=engine_lib.bits_of(params.get("b_adc_buf")),
        read_buf=params.get("read_buf"),
        split=params.get("tp"),
        rows_axis=rows_axis,
    )
    if "b" in params:
        # bias is applied in the digital domain, after the ADC
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Tensor parallelism. A layer of a sharded chip carries its split
# (``launch.sharding.Split``) under ``"tp"``: its output columns, its rows
# at crossbar tile boundaries, or (a bank) its experts. Activations between
# layers are whole on every rank, except a column-parallel layer's output,
# which the next row-parallel layer may take as it lies (the attention's
# heads, the FFN's hidden units).
#
# A training step's layer carries the same splits (the training layout,
# ``launch.sharding.param_shardings(analog_cfg=)``); its row-parallel layer
# takes its whole input (gathered where it came as columns) so the DAC's
# range gradients are whole, and every sharded layer's backward is the
# unsharded layer's VJP on gathered inputs (``kernels.ops.sharded``).
#
# A measured hazard of the column split, and its condition: on the CPU,
# torch's fp32 ``x @ w[:, cols]`` is bitwise the whole product's columns
# at one intra-op thread (measured at K = 1024 and 2048, N = 2048, M = 1-8
# over 4 slices), but at 8 threads not at any M from 2 to 8. A CPU process
# group pins one thread (``launch.mesh.init_process_group``). The whole
# product itself is the same at 1 and 8 threads at M = 2-8 and differs at
# M = 1 (a GEMV route), so the host result a shard is held against is
# computed at one thread too. On a card, B1's split plan depends on
# (M, K, N), so a rank's columns at world size > 1 may be summed in
# another order than the whole layer's; one card cannot check it.
# ---------------------------------------------------------------------------


def model_axis(split):
    """The ``collectives.Axis`` a split layer lies across."""
    from repro_torch.models.common import mesh_axis

    axis = mesh_axis("model")
    if axis is None or axis.size != split.n:
        raise RuntimeError(
            f"a layer split over {split.n} ranks runs under a mesh of that "
            "'model' degree: set models.common.set_logical_rules(rules, mesh) "
            "(launch.steps.program_for_serving(mesh=) and ServingEngine(mesh=) do)"
        )
    return axis


def gather_columns(y: Tensor, split) -> Tensor:
    """The whole tensor of a rank's columns ``y`` (``split`` None: ``y`` is
    whole); its gradient keeps the rank's columns (``collectives.gather``)."""
    if split is None:
        return y
    return collectives.gather(y, -1, split.bounds, model_axis(split))


def linear_local(params: dict, x: Tensor, ctx: AnalogCtx) -> tuple:
    """A column-parallel layer on the whole input ``x`` -> (this rank's
    output columns, their split); any other layer -> (its whole output,
    None)."""
    split = params.get("tp")
    if split is None or split.dim != -1:
        return linear_apply(params, x, ctx), None
    return _linear(params, x, ctx), split


def linear_apply(params: dict, x: Tensor, ctx: AnalogCtx, x_split=None) -> Tensor:
    """The layer's whole output, on every rank. ``x`` is the whole input, or
    with ``x_split`` a rank's columns of it (a column-parallel layer's
    output): a row-parallel layer whose rows are those columns takes it as
    it lies, every other layer gathers it first."""
    split = params.get("tp")
    chip = ctx.cfg.mode in (PCM_PROGRAMMED, PCM_INFER)  # a chip's shard, not training's
    if chip and split is not None and split.dim == -2 and x_split is not None \
            and x_split.bounds == split.bounds:
        return _rows_parallel(params, x, ctx, split)
    x = gather_columns(x, x_split)
    if split is None:
        return _linear(params, x, ctx)
    if split.dim == -1:
        return gather_columns(_linear(params, x, ctx), split)
    if not chip:  # training: the row shard takes the whole input
        return _linear(params, x, ctx)
    return _rows_parallel(params, split.take(x, -1), ctx, split)


def _rows_parallel(params: dict, x: Tensor, ctx: AnalogCtx, split) -> Tensor:
    """A row-parallel layer on a rank's rows of the input: each tile's
    ADC'd partial here, then every rank's partials gathered and summed in
    tile order, in the dtype and at the rounding points of the one chip's
    tile-serial sum (``engine.tile_matmul_quant``), then ``out_scale``:
    bitwise the unsharded layer (one rank: the layer as it is)."""
    return _linear(params, x, ctx, None if split.n == 1 else model_axis(split))


def refresh_clip_ranges(params: dict, n_std: float = 2.0) -> dict:
    """Stage-1 helper: every layer's ``w_clip_buf`` recomputed from its
    sibling ``w`` as (-n_std std, +n_std std) (population std, one range
    per layer of a stacked ``(L, 2)`` buffer). Returns a new tree in the
    given order; called every 10 steps in stage 1, then frozen."""

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        new = {k: walk(v) for k, v in tree.items()}
        if "w" in new and "w_clip_buf" in new:
            w, buf = new["w"].detach(), new["w_clip_buf"]
            if buf.dim() == 1:
                std = torch.std(w, correction=0)
                new["w_clip_buf"] = torch.stack([-n_std * std, n_std * std])
            else:
                std = torch.std(w, dim=tuple(range(1, w.dim())), correction=0)
                new["w_clip_buf"] = torch.stack([-n_std * std, n_std * std], dim=-1)
        return new

    return walk(params)
