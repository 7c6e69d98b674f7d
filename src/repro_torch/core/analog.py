"""AnalogLinear: the analog-CiM-deployable layer, port of ``repro.core.analog``.

Every stationary-weight matmul goes through :func:`analog_matmul`, a plan
dispatcher over the execute phase (:mod:`repro_torch.core.engine`). This
slice ports the two serving modes:

  * ``digital``        -- plain matmul (the full-precision reference).
  * ``pcm_programmed`` -- execute phase of a compiled ``CiMProgram``: the
                           weights are already PCM effective weights and each
                           layer carries its GDC ``out_scale_buf``. The DAC
                           quantizes the input, then ``engine.execute_mvm``
                           runs the tiled MVM with per-tile ADC and the GDC
                           epilogue -- on a CUDA tensor through the Hopper
                           kernel ``kernels.analog_mvm``.

``analog_train`` and ``pcm_infer`` raise ``NotImplementedError``: they come
with the training and per-call-simulation slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import pcm as pcm_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.engine import PCM_PROGRAMMED
from repro_torch.core.quant import QuantSpec

Tensor = torch.Tensor

DIGITAL = "digital"
ANALOG_TRAIN = "analog_train"
PCM_INFER = "pcm_infer"


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Static configuration of the analog execution environment.

    Every field of the reference's ``AnalogConfig`` is kept, so a stored
    artifact's config loads unchanged. ``use_kernel``/``interpret`` are
    recorded but do not choose the execute path here: a CUDA tensor always
    runs the Hopper kernel, a CPU tensor its plain version.
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

    def infer(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, mode=PCM_INFER, quant_noise_p=1.0, **kw)


#: signature of an execute-phase MVM: (x_q, w, r_adc, plan, *, out_scale)
MvmFn = Callable[..., Tensor]


@dataclasses.dataclass
class AnalogCtx:
    """Per-call context threaded through the model.

    ``mvm`` replaces :func:`engine.execute_mvm` for this call when set --
    a check that drives a whole forward through the plain
    ``engine.execute_mvm_plain`` on the card uses it; serving leaves it None.
    """

    cfg: AnalogConfig
    gain_s: Tensor  # the single network-wide ADC gain S (Eq. 5)
    mvm: Optional[MvmFn] = None


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
) -> Tensor:
    """The framework-wide analog-aware matmul. x: (..., K), w: (K, N)."""
    cfg = ctx.cfg
    if cfg.mode == DIGITAL:
        return engine_lib.execute_digital(x, w)
    if cfg.mode != PCM_PROGRAMMED:
        raise NotImplementedError(
            f"analog mode {cfg.mode!r} is not ported yet: the training "
            "(analog_train) and per-call simulation (pcm_infer) slices come "
            "later; this slice serves digital and pcm_programmed"
        )
    if cfg.resample_read_noise:
        raise NotImplementedError(
            "per-MVM read-noise resampling (resample_read_noise=True) comes "
            "with the RNG-bridge slice"
        )
    plan = engine_lib.plan_for(cfg, int(w.shape[-2]), int(w.shape[-1]), b_adc)
    out_dtype = x.dtype
    x_q = quant_lib.dac_quantize(x, r_adc, ctx.gain_s, w_max, plan.spec)
    x_q = x_q.to(out_dtype)
    scale = 1.0 if out_scale is None else out_scale
    mvm = ctx.mvm or engine_lib.execute_mvm
    # a no-op when the weights were pre-cast to the activation dtype
    # (engine.cast_weights): the cast is deterministic, so keeping one
    # pre-cast copy is bitwise the reference's per-call cast
    return mvm(x_q, w.to(x_q.dtype), r_adc, plan, out_scale=scale).to(out_dtype)


def linear_init(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    *,
    stack: tuple = (),
    use_bias: bool = False,
    dtype=torch.float32,
    scale: Optional[float] = None,
) -> dict:
    """Analog linear params; ``stack`` prepends independent-layer dims."""
    dev = gen.device
    s = scale if scale is not None else d_in**-0.5
    w = torch.randn(
        tuple(stack) + (d_in, d_out), generator=gen, dtype=torch.float32,
        device=dev,
    )
    params = {
        "w": (w * s).to(dtype),
        "r_adc": torch.ones(tuple(stack), dtype=torch.float32, device=dev),
        "w_clip_buf": torch.tensor([-1.0, 1.0], device=dev).expand(
            tuple(stack) + (2,)
        ).contiguous(),
    }
    if use_bias:
        params["b"] = torch.zeros(tuple(stack) + (d_out,), dtype=dtype, device=dev)
    return params


def linear_apply(params: dict, x: Tensor, ctx: AnalogCtx) -> Tensor:
    y = analog_matmul(
        x,
        params["w"],
        r_adc=params["r_adc"],
        w_min=params["w_clip_buf"][..., 0],
        w_max=params["w_clip_buf"][..., 1],
        ctx=ctx,
        out_scale=params.get("out_scale_buf"),
        b_adc=engine_lib.bits_of(params.get("b_adc_buf")),
    )
    if "b" in params:
        # bias is applied in the digital domain, after the ADC
        y = y + params["b"].to(y.dtype)
    return y
