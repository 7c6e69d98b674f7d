"""Public analog-MVM entry over (..., K) inputs, port of ``repro.kernels.ops``.

Dispatches by device: a CUDA tensor launches the Hopper kernel
(``kernels.analog_mvm``) -- a failed launch raises, nothing falls back -- and
a CPU tensor runs the plain version (``kernels.ref.analog_mvm_ref``). The
forward only; the STE ``autograd.Function`` comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels.ref import analog_mvm_ref

Tensor = torch.Tensor


def analog_mvm(
    x: Tensor,
    w: Tensor,
    *,
    r_adc,
    r_dac: Optional[Tensor] = None,
    out_scale=1.0,
    bits: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
) -> Tensor:
    """Analog MVM for (..., K) x (K, N). ``bits`` is the ADC ENOB; the DAC
    has one more (Eq. 3). ``r_dac=None``: x is already DAC-quantized."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = kernel.analog_mvm(
            x2.contiguous(), w.contiguous(), r_adc=r_adc, r_dac=r_dac,
            out_scale=out_scale, b_adc=bits, tile_rows=tile_rows,
            per_tile_adc=per_tile_adc,
        )
    elif x.device.type == "cpu":
        y = analog_mvm_ref(
            x2, w, r_dac, r_adc, out_scale, b_dac=bits + 1, b_adc=bits,
            tile_rows=tile_rows, per_tile_adc=per_tile_adc,
            apply_dac=r_dac is not None,
        )
    else:
        raise ValueError(f"analog_mvm: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[-1])
