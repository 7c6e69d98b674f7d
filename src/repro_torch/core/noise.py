"""Noise-injection training (paper Sec. 4.2, Eq. 1-2), port of
``repro.core.noise``.

At every forward pass a fresh additive Gaussian error is drawn for each
analog layer's weights,

    dW_l ~ N(0, sigma_{N,l}^2 I),    sigma_{N,l} = eta * W_{l,max}     (Eq. 1)

after a static clip ``W_l = clip(W_{l,0}; W_{l,min}, W_{l,max})`` (Eq. 2)
whose ranges are +/- 2 std(W_{l,0}), refreshed in stage 1 and frozen for
stage 2. Clip and noise are straight-through: the gradient is computed
with the clipped, noisy weights and applied to W_{l,0}.

The draw is the reference's: ``prng.normal`` from a per-layer, per-step
threefry key (on a card, the kernel ``csrc/prng.cu``), so a keyed forward
injects the reference's noise bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.quant import abs_

Tensor = torch.Tensor


def clip_ste(w: Tensor, w_min: Tensor, w_max: Tensor) -> Tensor:
    """Clip with a straight-through gradient: ``w + (clip(w) - w).detach()``
    (the reference's value, bit for bit, and gradient 1 to ``w``, none to
    the bounds)."""
    clipped = torch.minimum(torch.maximum(w, w_min), w_max)
    return w + (clipped - w).detach()


def sample_weight_noise(key: Tensor, w: Tensor, eta: float, w_max: Tensor, offset: int = 0,
                        stride: Optional[int] = None) -> Tensor:
    """dW ~ N(0, (eta * W_max)^2) in w's dtype (Eq. 1); ``offset`` and
    ``stride``: ``w`` is a slice of a wider weight (``prng.normal``)."""
    sigma = eta * abs_(w_max)
    return (sigma * prng.normal(key.to(w.device), w.shape, offset, stride)).to(w.dtype)


class _GradTo(torch.autograd.Function):
    """``value`` forward; the gradient passes to ``src`` unchanged."""

    @staticmethod
    def forward(ctx, value, src):
        return value

    @staticmethod
    def backward(ctx, g):
        return None, g


def inject(
    key: Optional[Tensor],
    w: Tensor,
    eta: float,
    w_min: Tensor,
    w_max: Tensor,
    offset: int = 0,
    stride: Optional[int] = None,
) -> Tensor:
    """The training-time weight path: STE clip, then Gaussian noise (a
    constant draw: no gradient flows through it). On a tensor-parallel
    rank ``w`` is its shard and draws its slice of the whole weight's draw:
    a column shard ``offset`` its first column and ``stride`` the whole
    width, a row shard ``offset`` its first row times the width.

    For f32 weights the sum is computed as the reference's compiled train
    step computes it: the compiler folds ``eta * sqrt(2)`` into one f32
    factor of ``|w_max|`` and fuses the product with ``erf_inv(u)`` into
    the add, one fused multiply-add (``prng.fma``); the value is then
    bitwise the reference's, and the gradient goes to the clipped weight.
    """
    w_c = clip_ste(w, w_min, w_max)
    if key is None or eta <= 0.0:
        return w_c
    if w.dtype != torch.float32:
        return w_c + sample_weight_noise(key, w, eta, w_max, offset, stride).detach()
    dev = w.device
    factor = torch.tensor(prng._f32(eta), device=dev) * torch.tensor(prng.SQRT2, device=dev)
    scale = (w_max.detach().abs() * factor).expand(w.shape)
    noisy = prng.fma(scale, prng.normal_erf_inv(key.to(dev), w.shape, offset, stride),
                     w_c.detach())
    return _GradTo.apply(noisy, w_c)


def clip_ranges_from_std(w: Tensor, n_std: float = 2.0) -> tuple[Tensor, Tensor]:
    """Stage-1 clip ranges ``(-2 std(W0), +2 std(W0))`` (population std, as
    ``jnp.std``)."""
    std = torch.std(w, correction=0)
    return -n_std * std, n_std * std


def layer_noise_key(base_key: Tensor, layer_index: int, step: int) -> Tensor:
    """The deterministic per-(layer, step) noise key:
    ``fold_in(fold_in(base_key, step), layer_index)``."""
    return prng.fold_in(prng.fold_in(base_key, step), layer_index)
