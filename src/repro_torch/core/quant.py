"""DAC/ADC fake-quantizers with the shared ADC-gain constraint (Eq. 3-6),
port of ``repro.core.quant``.

* symmetric fake-quantizers with straight-through rounding (Eq. 4):
  ``x + (round(x) - x).detach()`` is ``round(x)`` bit for bit, so serving's
  bits do not move, and its gradient passes straight through;
* ``b_DAC = b_ADC + 1`` (Eq. 3) and the shared-gain constraint (Eq. 5):
  ``r_DAC,l = |r_ADC,l| * |S| / |W_l,max|``, differentiable in all three;
* stochastic quant-noise masking (Fan et al. 2020): with a key, each
  element is quantized with probability ``quant_noise_p``.

Gradients follow ``jax.grad`` of the reference: ``|.|`` has JAX's
subgradient 1 at 0 (torch's is 0; :func:`abs_`), and the clip is
``minimum(maximum(...))``, whose gradient both frameworks split 0.5/0.5 at
a tie (``torch.clamp`` would not).

Dtype rule: JAX promotes a bf16 activation against an f32 range array to
f32, while torch keeps bf16 for a 0-dim f32 operand. The quantizers here
promote explicitly (``torch.promote_types``) so they return the dtype the
reference returns, and compute on the same f32 values.
"""

from __future__ import annotations

import dataclasses

from typing import Optional

import torch

from repro_torch import prng

Tensor = torch.Tensor

#: ADC bitwidths the serving path supports (paper Sec. 7).
SUPPORTED_B_ADC = (4, 6, 8)


def validate_b_adc(bits: int, where: str = "b_adc") -> int:
    """Check a serving-path ADC bitwidth against :data:`SUPPORTED_B_ADC`."""
    if bits not in SUPPORTED_B_ADC:
        raise ValueError(
            f"{where}={bits!r} is not a supported serving ADC bitwidth "
            f"(one of {SUPPORTED_B_ADC})"
        )
    return int(bits)


def _as_range(r, like: Tensor) -> Tensor:
    if isinstance(r, Tensor):
        return r
    return torch.tensor(float(r), dtype=torch.float32, device=like.device)


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's subgradient: ``jax.grad(jnp.abs)(0.0)`` is 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: Tensor) -> Tensor:
    """``x.abs()``, with JAX's gradient (+1 at 0) where one is needed."""
    return _Abs.apply(x) if x.requires_grad else x.abs()


def round_ste(x: Tensor) -> Tensor:
    """Round half to even with a straight-through gradient (Bengio et al.
    2013); the value is ``torch.round(x)`` bit for bit."""
    if not x.requires_grad:
        return torch.round(x)
    return x + (torch.round(x) - x).detach()


def fake_quant(x: Tensor, r_max, bits: int) -> Tensor:
    """Symmetric fake-quantization, Eq. (4), differentiable in x and r_max:

    ``round_ste(clip(x, -r, r) / step) * step`` with ``r = |r_max| + 1e-9``
    and ``step = r / (2^(b-1) - 1)``; rounding is half to even, as
    ``jnp.round``.
    """
    n_levels = 2 ** (bits - 1) - 1
    r_max = _as_range(r_max, x)
    x = x.to(torch.promote_types(x.dtype, r_max.dtype))
    r = abs_(r_max) + 1e-9
    # tensor / tensor: CUDA turns a division by a host scalar into a
    # multiply by its reciprocal, one ulp off the reference's true division
    step = r / torch.full_like(r, n_levels)
    clipped = torch.minimum(torch.maximum(x, -r), r)
    return round_ste(clipped / step) * step


def quant_noise(x: Tensor, x_quant: Tensor, key: Optional[Tensor], prob: float,
                offset: int = 0) -> Tensor:
    """Fan et al. 2020: with probability ``prob`` per element the quantized
    value is used, else the full-precision one (the mask is
    ``prng.bernoulli(key, prob, x.shape)``, the reference's draw; from
    counter ``offset`` on for a data-parallel rank's rows of it).
    ``prob >= 1`` or ``key=None`` is plain quantization-aware training."""
    if key is None or prob >= 1.0:
        return x_quant
    if offset:
        mask = prng.bernoulli(key.to(x.device), prob, x.shape, offset)
    else:
        mask = prng.bernoulli(key.to(x.device), prob, x.shape)
    return torch.where(mask, x_quant, x)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantizer configuration for one analog layer.

    ``b_adc``: ADC effective bits; the DAC gets ``b_adc + 1`` (Eq. 3).
    ``quant_noise_p``: training-time quant-noise probability (0.5 in the
    paper; 1.0 quantizes every element, as serving always does).
    """

    b_adc: int = 8
    quant_noise_p: float = 1.0

    @property
    def b_dac(self) -> int:
        return self.b_adc + 1


def dac_range(r_adc: Tensor, gain_s: Tensor, w_max: Tensor) -> Tensor:
    """Eq. (5): r_DAC,l = |r_ADC,l| * |S| / |W_l,max|."""
    return abs_(r_adc) * abs_(gain_s) / (abs_(w_max) + 1e-9)


def dac_quantize(
    x: Tensor,
    r_adc: Tensor,
    gain_s: Tensor,
    w_max: Tensor,
    spec: QuantSpec,
    key: Optional[Tensor] = None,
    offset: int = 0,
) -> Tensor:
    """Quantize input activations as the PWM DAC would (Eq. 3/4/5); with a
    key, quant-noise masked at ``spec.quant_noise_p`` (``offset``: see
    :func:`quant_noise`)."""
    xq = fake_quant(x, dac_range(r_adc, gain_s, w_max), spec.b_dac)
    return quant_noise(x, xq, key, spec.quant_noise_p, offset)


def adc_quantize(y: Tensor, r_adc: Tensor, spec: QuantSpec, key: Optional[Tensor] = None) -> Tensor:
    """Quantize pre-activations as the bitline ADC would (quant-noise masked
    with a key)."""
    yq = fake_quant(y, r_adc, spec.b_adc)
    return quant_noise(y, yq, key, spec.quant_noise_p)


def init_quant_params(n_layers_or_shape=(), device="cpu") -> dict:
    """Trainable quantizer parameters: per-layer ``r_adc`` and one global
    ``gain_s``, both 1.0 as in the paper. For stacked layers pass the
    leading stack shape, e.g. ``init_quant_params((n_layers,))``."""
    shape = (
        (n_layers_or_shape,)
        if isinstance(n_layers_or_shape, int)
        else tuple(n_layers_or_shape)
    )
    f32 = dict(dtype=torch.float32, device=device)
    return {"r_adc": torch.ones(shape, **f32), "gain_s": torch.ones((), **f32)}


def clip_s_gradient(grad_s: Tensor, threshold: float = 0.01) -> Tensor:
    """Gradient clipping on S (the paper uses 0.01) to stabilise its update."""
    return torch.minimum(torch.maximum(grad_s, torch.full_like(grad_s, -threshold)),
                         torch.full_like(grad_s, threshold))
