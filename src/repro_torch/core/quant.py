"""DAC/ADC fake-quantizers with the shared ADC-gain constraint (Eq. 3-6).

Port of ``repro.core.quant`` (forward only: the straight-through estimator
and quant-noise masking arrive with training in a later slice).

Dtype rule: JAX promotes a bf16 activation against an f32 range array to
f32, while torch keeps bf16 for a 0-dim f32 operand. The quantizers here
promote explicitly (``torch.promote_types``) so they return the dtype the
reference returns, and compute on the same f32 values.
"""

from __future__ import annotations

import dataclasses

import torch

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


def fake_quant(x: Tensor, r_max, bits: int) -> Tensor:
    """Symmetric fake-quantization, Eq. (4), forward:

    ``round(clip(x, -r, r) / step) * step`` with ``r = |r_max| + 1e-9`` and
    ``step = r / (2^(b-1) - 1)``; rounding is half to even, as ``jnp.round``.
    """
    n_levels = 2 ** (bits - 1) - 1
    r_max = _as_range(r_max, x)
    x = x.to(torch.promote_types(x.dtype, r_max.dtype))
    r = r_max.abs() + 1e-9
    # tensor / tensor: CUDA turns a division by a host scalar into a
    # multiply by its reciprocal, one ulp off the reference's true division
    step = r / torch.full_like(r, n_levels)
    clipped = torch.minimum(torch.maximum(x, -r), r)
    return torch.round(clipped / step) * step


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantizer configuration for one analog layer.

    ``b_adc``: ADC effective bits; the DAC gets ``b_adc + 1`` (Eq. 3).
    ``quant_noise_p``: training-time quant-noise probability (kept for
    config parity; serving always quantizes).
    """

    b_adc: int = 8
    quant_noise_p: float = 1.0

    @property
    def b_dac(self) -> int:
        return self.b_adc + 1


def dac_range(r_adc: Tensor, gain_s: Tensor, w_max: Tensor) -> Tensor:
    """Eq. (5): r_DAC,l = |r_ADC,l| * |S| / |W_l,max|."""
    return r_adc.abs() * gain_s.abs() / (w_max.abs() + 1e-9)


def dac_quantize(
    x: Tensor, r_adc: Tensor, gain_s: Tensor, w_max: Tensor, spec: QuantSpec
) -> Tensor:
    """Quantize input activations as the PWM DAC would (Eq. 3/4/5)."""
    return fake_quant(x, dac_range(r_adc, gain_s, w_max), spec.b_dac)


def adc_quantize(y: Tensor, r_adc: Tensor, spec: QuantSpec) -> Tensor:
    """Quantize pre-activations as the bitline ADC would."""
    return fake_quant(y, r_adc, spec.b_adc)
