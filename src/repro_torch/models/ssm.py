"""Mamba-2 (SSD, state-space duality) block, port of ``repro.models.ssm``
(arXiv:2405.21060).

Chunked SSD: within a chunk of ``ssm_chunk`` steps the recurrence is a
masked attention-like product; across chunks a loop carries the fp32
(B, H, P, N) state. Decode (one token against a cache) is the exact
one-step recurrence.

``in_proj`` and ``out_proj`` are analog linears (programmed MVMs on a
chip). The SSD scan multiplies two dynamic tensors (state x input) and the
width-4 depthwise conv is CiM-hostile, so both stay digital: the reference
leaves them to XLA outside any Pallas kernel, and they are plain torch ops
here (``einsum`` and elementwise ops), at the reference's rounding points
where torch's ops allow (its ``exp``/``softplus``/``cumsum`` differ from
XLA's by ulps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core.analog import AnalogCtx, linear_apply, linear_init
from repro_torch.models.common import ModelConfig, rmsnorm_apply

Tensor = torch.Tensor


class SSMCache(NamedTuple):
    conv: Tensor  # (B, W-1, conv_channels) rolling conv input window
    h: Tensor  # (B, H, P, N) fp32 SSD state; position-free (no length)


def ssm_init(key: Tensor, cfg: ModelConfig) -> dict:
    """The reference's draws through the RNG bridge. ``dt_bias =
    log(exp(u) - 1)`` takes torch's ``exp`` (within an ulp of XLA's) before
    the bridge's XLA-exact ``log``; every other leaf is bitwise."""
    m, d_in, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = key.device
    conv_ch = d_in + 2 * n  # x, B, C streams
    k_in, k_out, k_conv, k_a, k_dt = prng.split(key, 5)
    proj_out = 2 * d_in + 2 * n + h  # z, x, B, C, dt
    u_dt = prng.uniform(k_dt, (h,), minval=1e-3, maxval=0.1)
    return {
        "in_proj": linear_init(k_in, m, proj_out),
        "out_proj": linear_init(k_out, d_in, m),
        "conv_w": prng.normal(k_conv, (cfg.conv_width, conv_ch))
        * (cfg.conv_width * conv_ch) ** -0.5,
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": prng.log(prng.uniform(k_a, (h,), minval=1.0, maxval=16.0)),
        "D": torch.ones((h,), device=dev),
        "dt_bias": prng.log(torch.exp(u_dt) - 1.0),
        "norm_scale": torch.ones((d_in,), device=dev),
    }


def causal_conv(x: Tensor, w: Tensor, b: Tensor, cache: Optional[Tensor]):
    """Depthwise causal conv1d, x (B, S, C), w (W, C) -> (y, new tail): the
    taps summed in order from the oldest, then the bias (no activation)."""
    width = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i : i + s] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, xp[:, xp.shape[1] - (width - 1):]


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, cache: Optional[Tensor]):
    """The SSM block's conv: :func:`causal_conv` then silu."""
    y, tail = causal_conv(x, w, b, cache)
    return F.silu(y), tail


def _ssd_chunked(
    x: Tensor,  # (B, S, H, P)
    dt: Tensor,  # (B, S, H) softplus'd step sizes
    a: Tensor,  # (H,) negative decay rates (A = -exp(A_log))
    b_mat: Tensor,  # (B, S, N)
    c_mat: Tensor,  # (B, S, N)
    h0: Optional[Tensor],  # (B, H, P, N) or None
    chunk: int,
) -> tuple[Tensor, Tensor]:
    """Chunked SSD scan -> (y (B, S, H, P) in x's dtype, final fp32 state).

    S is zero-padded to a multiple of the chunk with dt = 0 on the pad: a
    decay of exp(0) = 1 and no input, so the pad leaves the state alone."""
    bsz, s, nh, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xs = x.reshape(bsz, nc, chunk, nh, p)
    dts = dt.reshape(bsz, nc, chunk, nh)
    bs = b_mat.reshape(bsz, nc, chunk, n).float()
    cs = c_mat.reshape(bsz, nc, chunk, n).float()
    h = h0 if h0 is not None else torch.zeros((bsz, nh, p, n), device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xs[:, ci], dts[:, ci], bs[:, ci], cs[:, ci]
        a_cum = torch.cumsum(dtc * a, dim=1)  # (B, Q, H), inclusive
        # intra-chunk: L[t, s] = exp(A_cum[t] - A_cum[s]) on and below the diagonal
        l = torch.exp(torch.clamp(a_cum[:, :, None, :] - a_cum[:, None, :, :], -60.0, 0.0))
        l = torch.where(tri[None, :, :, None], l, torch.zeros_like(l))
        cb = torch.einsum("bqn,bsn->bqs", cc, bc)
        xd = dtc[..., None] * xc.float()  # (B, Q, H, P)
        y_intra = torch.einsum("bqs,bqsh,bshp->bqhp", cb, l, xd)
        # inter-chunk: the carried state's contribution
        decay_in = torch.exp(torch.clamp(a_cum, -60.0, 0.0))
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cc, h, decay_in)
        decay_out = torch.exp(torch.clamp(a_cum[:, -1:, :] - a_cum, -60.0, 0.0))
        s_c = torch.einsum("bsh,bshp,bsn->bhpn", decay_out, xd, bc)
        h = torch.exp(torch.clamp(a_cum[:, -1, :], -60.0, 0.0))[..., None, None] * h + s_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, nh, p)[:, :s_orig]
    return y.to(x.dtype), h


def ssm_apply(
    params: dict,
    x: Tensor,
    ctx: AnalogCtx,
    cfg: ModelConfig,
    cache: Optional[SSMCache] = None,
) -> tuple[Tensor, Optional[SSMCache]]:
    """Mamba-2 block, x (B, S, M) -> (out (B, S, M), new cache or None)."""
    bsz, s, _ = x.shape
    d_in, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = linear_apply(params["in_proj"], x, ctx)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * n, nh], dim=-1)

    conv_cache = cache.conv if cache is not None else None
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_cache)
    xs, b_mat, c_mat = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, s, nh, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])  # (H,)

    if s == 1 and cache is not None:
        # decode: the exact one-step recurrence
        da = torch.exp(torch.clamp(dt[:, 0] * a, -60.0, 0.0))  # (B, H)
        xd = dt[:, 0, :, None] * xs[:, 0].float()  # (B, H, P)
        s_c = torch.einsum("bhp,bn->bhpn", xd, b_mat[:, 0].float())
        h_final = da[..., None, None] * cache.h + s_c
        y = torch.einsum("bn,bhpn->bhp", c_mat[:, 0].float(), h_final)
        y = y[:, None].to(x.dtype)  # (B, 1, H, P)
    else:
        h0 = cache.h if cache is not None else None
        y, h_final = _ssd_chunked(xs, dt, a, b_mat, c_mat, h0, cfg.ssm_chunk)

    y = y + params["D"].to(x.dtype)[None, None, :, None] * xs
    y = y.reshape(bsz, s, d_in)
    y = y * F.silu(z)
    y = rmsnorm_apply({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = linear_apply(params["out_proj"], y, ctx)

    new_cache = None
    if cache is not None:
        new_cache = SSMCache(conv=conv_tail.to(cache.conv.dtype), h=h_final)
    return out, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device) -> SSMCache:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), device=device),
    )
