"""RecurrentGemma / Griffin recurrent block, port of ``repro.models.griffin``
(arXiv:2402.19427): RG-LRU with gating, alternating 2:1 with local attention.

    x -> [linear -> gelu]                  (gate branch)
      -> [linear -> conv1d(4) -> RG-LRU]   (recurrent branch)
    out = linear(gate * recurrent)

RG-LRU (per channel): r = sigmoid(W_a x), i = sigmoid(W_x x),
a = exp(-c softplus(Lambda) r) with c = 8, h_t = a_t h_{t-1} +
sqrt(1 - a_t^2) (i_t x_t). Prefill evaluates the linear recurrence with
the reference's associative scan (:func:`associative_scan`, its combine
tree, so the state rounds as the reference's does); decode is the exact
one-step update. The five projections are analog linears; the recurrence
and the conv are elementwise and stay digital (plain torch ops, as the
reference leaves them to XLA).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core.analog import AnalogCtx, linear_apply, linear_init
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import causal_conv

Tensor = torch.Tensor

_C = 8.0  # Griffin's fixed gate temperature


class RGLRUCache(NamedTuple):
    conv: Tensor  # (B, W-1, lru_width)
    h: Tensor  # (B, lru_width) fp32


def griffin_init(key: Tensor, cfg: ModelConfig) -> dict:
    """The reference's draws through the RNG bridge, bitwise."""
    m = cfg.d_model
    w = cfg.lru_width or cfg.d_model
    kg, kx, ko, ka, ki, kc, kl = prng.split(key, 7)
    return {
        "gate_proj": linear_init(kg, m, w),
        "x_proj": linear_init(kx, m, w),
        "out_proj": linear_init(ko, w, m),
        "a_gate": linear_init(ka, w, w),  # W_a (recurrence gate)
        "i_gate": linear_init(ki, w, w),  # W_x (input gate)
        "conv_w": prng.normal(kc, (cfg.conv_width, w)) * (cfg.conv_width * w) ** -0.5,
        "conv_b": torch.zeros((w,), device=key.device),
        "lambda_p": prng.uniform(kl, (w,), minval=2.0, maxval=5.0),
    }


def associative_scan(fn: Callable, elems: tuple, dim: int) -> tuple:
    """``jax.lax.associative_scan(fn, elems, axis=dim)``, in its combine tree:
    combine adjacent pairs, scan the half recursively (the odd outputs),
    combine each odd output with the next even input (the even outputs),
    interleave. Each output is combined in the reference's order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t: Tensor, start: int, stop: Optional[int], step: int = 1) -> Tensor:
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    out = []
    for e, o in zip(even, odd):  # interleave: even at 0, 2, ...; odd at 1, 3, ...
        shape = list(e.shape)
        shape[dim] = e.shape[dim] + o.shape[dim]
        res = e.new_empty(shape)
        res[(slice(None),) * dim + (slice(0, None, 2),)] = e
        res[(slice(None),) * dim + (slice(1, None, 2),)] = o
        out.append(res)
    return tuple(out)


def _rg_lru_scan(a: Tensor, bx: Tensor, h0: Optional[Tensor]) -> Tensor:
    """h_t = a_t h_{t-1} + bx_t over a, bx (B, S, W) via the associative scan."""

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, b_l * a_r + b_r

    a_s, bx_s = associative_scan(combine, (a, bx), 1)
    if h0 is not None:
        bx_s = bx_s + a_s * h0[:, None, :]
    return bx_s


def _gates(params: dict, xr: Tensor, ctx: AnalogCtx) -> tuple[Tensor, Tensor]:
    """(a, sqrt(1 - a^2) * i * x) of the RG-LRU, fp32."""
    r = torch.sigmoid(linear_apply(params["a_gate"], xr, ctx).float())
    i = torch.sigmoid(linear_apply(params["i_gate"], xr, ctx).float())
    a = torch.exp(-_C * F.softplus(params["lambda_p"]) * r)
    # sqrt(1 - a^2) normalises the input so the state variance is ~constant
    bx = torch.sqrt(torch.clamp(1.0 - a**2, min=1e-12)) * (i * xr.float())
    return a, bx


def rg_lru(params: dict, x: Tensor, ctx: AnalogCtx,
           h0: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """RG-LRU over x (B, S, W) -> (y in x's dtype, final fp32 state)."""
    a, bx = _gates(params, x, ctx)
    h = _rg_lru_scan(a, bx, h0)
    return h.to(x.dtype), h[:, -1, :]


def griffin_apply(
    params: dict,
    x: Tensor,
    ctx: AnalogCtx,
    cfg: ModelConfig,
    cache: Optional[RGLRUCache] = None,
) -> tuple[Tensor, Optional[RGLRUCache]]:
    """Griffin recurrent block, x (B, S, M) -> (out, new cache or None)."""
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(linear_apply(params["gate_proj"], x, ctx), approximate="tanh")
    xr = linear_apply(params["x_proj"], x, ctx)
    conv_cache = cache.conv if cache is not None else None
    xr, conv_tail = causal_conv(xr, params["conv_w"], params["conv_b"], conv_cache)
    if x.shape[1] == 1 and cache is not None:
        # decode: one exact recurrence step
        a, bx = _gates(params, xr, ctx)
        h_final = a[:, 0] * cache.h + bx[:, 0]
        y = h_final[:, None, :].to(x.dtype)
    else:
        y, h_final = rg_lru(params, xr, ctx, cache.h if cache is not None else None)
    out = linear_apply(params["out_proj"], gate * y, ctx)
    new_cache = None
    if cache is not None:
        new_cache = RGLRUCache(conv=conv_tail.to(cache.conv.dtype), h=h_final)
    return out, new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, *, device) -> RGLRUCache:
    w = cfg.lru_width or cfg.d_model
    return RGLRUCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
        h=torch.zeros((batch, w), device=device),
    )
