"""Appendix C: heuristic DAC/ADC ranges for models WITHOUT trained ranges,
port of ``repro.core.heuristic_ranges``.

Without trained ranges the paper sets each layer's quantizer scales from
empirical rules: the DAC range ``in^l`` is the 99.995th percentile of the
layer's input activations, and the ADC range covers ``n_std_out`` standard
deviations of the pre-activation distribution (Eq. 7; n_std_out = n_std_in
= 4, crossbar size 1024). As in the reference, a scale is 1/range here:
``r_dac = in^l`` and ``r_adc`` from Eq. 7's reasoning.

The statistics follow ``jnp``'s definitions: the percentile interpolates
linearly between the sorted neighbours in f32 (numpy's "linear" method, by
sort and gather: ``torch.quantile`` refuses inputs above 2^24 elements),
the standard deviation has ddof 0. The percentile takes the reference's
compiled arithmetic and is its value bit for bit. The standard deviations
are the correctly rounded f32 values; the reference's f32 sums round on
their own (up to 2 f32 ulps off the correctly rounded value).
"""

from __future__ import annotations

import torch

from repro_torch import prng

Tensor = torch.Tensor

N_STD_OUT = 4.0
N_STD_IN = 4.0
SIZE_CROSSBAR = 1024


def _f32(v: float, device) -> Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def input_percentile_range(x: Tensor, pct: float = 99.995) -> Tensor:
    """in^l: robust max of the input activations (Appendix C)."""
    a = torch.sort(x.abs().reshape(-1).float()).values
    dev = a.device
    # the reference's compiler divides by 100 as a multiply by its f32
    # reciprocal, folds that into the constant (n - 1) first, and fuses the
    # interpolation's second product into its sum
    q = _f32(pct, dev) * ((1.0 / _f32(100.0, dev)) * _f32(a.numel() - 1, dev))
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    top = a.numel() - 1
    lo = a[int(low.clamp(0, top).item())]
    hi = a[int(high.clamp(0, top).item())]
    return prng.fma(hi, w_high, lo * w_low)


def _std(x: Tensor) -> Tensor:
    """The population standard deviation (ddof 0) of x's f32 values,
    correctly rounded to f32 (summed in f64)."""
    return torch.std(x.double().reshape(-1), correction=0).float()


def heuristic_ranges(x_sample: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """(r_dac, r_adc) from the Appendix C rules: std_out ~ std_in * std_w *
    sqrt(fan_in) (central limit), r_adc = n_std_out * std_out."""
    r_dac = input_percentile_range(x_sample)
    fan_in = w.shape[0]
    std_in = _std(x_sample) * N_STD_IN / N_STD_IN
    std_w = _std(w)
    std_out = std_in * std_w * torch.sqrt(_f32(min(fan_in, SIZE_CROSSBAR), w.device))
    return r_dac, N_STD_OUT * std_out


def calibrate_model_ranges(params: dict, sample_acts: dict) -> dict:
    """Every listed layer's r_adc from the heuristic, given sample activations.

    ``sample_acts``: layer name -> calibration input batch of that layer
    (from a digital forward). Returns params with r_adc replaced and gain_s
    set so that Eq. 5 holds on average over the layers.
    """
    new = dict(params)
    gains = []
    for name, x in sample_acts.items():
        layer = dict(new[name])
        r_dac, r_adc = heuristic_ranges(x, layer["w"].reshape(-1, layer["w"].shape[-1]))
        layer["r_adc"] = r_adc.float()
        w_max = layer["w_clip_buf"][..., 1].abs()
        gains.append(r_dac * w_max / torch.clamp(r_adc, min=1e-9))
        new[name] = layer
    if gains:
        new["gain_s"] = torch.stack(gains).mean().float()
    return new
