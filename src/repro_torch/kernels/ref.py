"""Plain PyTorch version of the analog-MVM kernel, port of ``repro.kernels.ref``.

Semantics (what ``csrc/analog_mvm.cu`` computes)::

    x_q       = fake_quant(x, r_dac, b_dac)               # PWM DAC (optional)
    partial_t = x_q[:, tile t] @ w[tile t]                # fp32, one crossbar tile
    y         = sum_t (T)fake_quant(partial_t, r_adc, b_adc)   # per-tile ADC,
                                                               # tile-serial fp32
    out       = (T)(y * out_scale)

It follows ``repro.core.engine.tile_matmul_quant`` -- the function the JAX
serving path runs -- including the rounding of each quantized tile partial
to the activation dtype T; with ``per_tile_adc=False`` (or one tile) the
whole fp32 sum is converted once. In fp32 this is also the TPU kernel's
function. The reference's ``kernels/ref.py`` instead sums the partials in
fp32 with no intermediate rounding, so bf16 differs by rounding there (its
own tests allow 15% bf16 mismatches for this).

``analog_mvm_ref.calls`` counts calls, so a run can show that its main path
never took the plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import fake_quant

Tensor = torch.Tensor


def tile_mvm(
    x_f32: Tensor,
    w: Tensor,
    r_adc: Tensor,
    b_adc: int,
    tile_rows: int,
    per_tile_adc: bool,
    out_scale,
    out_dtype: torch.dtype,
) -> Tensor:
    """Per-tile ADC MVM on an fp32 input; the arithmetic both plain entry
    points share. A ragged last tile is quantized over its real rows."""
    k = w.shape[0]
    wf = w.float()
    if not per_tile_adc or k <= tile_rows:
        y = fake_quant(x_f32 @ wf, r_adc, b_adc)
        return (y * out_scale).to(out_dtype)
    y = None
    for lo in range(0, k, tile_rows):
        part = fake_quant(
            x_f32[..., lo:lo + tile_rows] @ wf[lo:lo + tile_rows], r_adc, b_adc
        )
        # quantized partials are stored at the activation dtype and summed
        # tile-serially (t = 0..T-1) in fp32
        part = part.to(out_dtype).float()
        y = part if y is None else y + part
    return (y * out_scale).to(out_dtype)


def analog_mvm_ref(
    x: Tensor,
    w: Tensor,
    r_dac,
    r_adc,
    out_scale=1.0,
    *,
    b_dac: int = 9,
    b_adc: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    apply_dac: bool = True,
) -> Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in x's dtype, fp32 accumulation."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} x {tuple(w.shape)}")
    analog_mvm_ref.calls += 1
    x_q = x.float()
    if apply_dac:
        x_q = fake_quant(x_q, r_dac, b_dac)
    return tile_mvm(
        x_q, w, r_adc, b_adc, tile_rows, per_tile_adc, out_scale, x.dtype
    )


#: calls since process start
analog_mvm_ref.calls = 0
