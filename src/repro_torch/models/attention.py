"""Attention, port of ``repro.models.attention`` (dense, non-paged branches).

GQA projections are analog layers (``core.analog.linear_apply``); the QK^T
and AV products have two dynamic operands, run on the digital datapath and
stay plain torch here, as the reference left them to XLA outside any Pallas
kernel. Two paths: the chunked online-softmax prefill (shape-stable kv
chunks, so real positions are bitwise independent of right-padding) and
one-token decode against a KV cache with scalar or per-slot (B,) lengths.

KV writes update the cache buffers in place (``index_copy_``/``index_put_``)
instead of copying the whole multi-layer cache every step; the returned
:class:`KVCache` shares the buffers with the one passed in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.analog import AnalogCtx, linear_apply, linear_init
from repro_torch.models.common import ModelConfig, rope

Tensor = torch.Tensor

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: Tensor  # (B, S_max, n_kv, hd)
    v: Tensor  # (B, S_max, n_kv, hd)
    #: tokens already written: () int32 for a rectangle batch, (B,) int32
    #: for a per-slot cache (each batch row an independent request)
    length: Tensor


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, stack: tuple = ()) -> dict:
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kw = dict(stack=stack, use_bias=cfg.qkv_bias)
    return {
        "wq": linear_init(gen, cfg.d_model, nh * hd, **kw),
        "wk": linear_init(gen, cfg.d_model, nkv * hd, **kw),
        "wv": linear_init(gen, cfg.d_model, nkv * hd, **kw),
        "wo": linear_init(gen, nh * hd, cfg.d_model, stack=stack),
    }


def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """q: (B, Sq, H, D), k: (B, Sk, Kv, D) -> (B, Kv, G, Sq, Sk) in f32."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())


def _gqa_values(p: Tensor, v: Tensor) -> Tensor:
    """p: (B, Kv, G, Sq, Sk), v: (B, Sk, Kv, D) -> (B, Sq, H, D) in f32.

    p is cast down to v's dtype first (the reference's order); the product
    accumulates in f32.
    """
    b, kv, g, sq, _ = p.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, kv * g, v.shape[-1])


def chunked_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    q_chunk: int,
    kv_chunk: int,
    causal: bool = True,
    q_offset: int = 0,
) -> Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, Kv, D). ``kv_chunk`` is never clamped to
    the sequence: a short sequence pads up to one full chunk, and padded or
    masked positions contribute exact zeros, as in the reference.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d**-0.5
    q_chunk = min(q_chunk, sq)
    sq_p = -(-sq // q_chunk) * q_chunk
    sk_p = -(-sk // kv_chunk) * kv_chunk
    if sq_p != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    kvh = k.shape[2]
    g = h // kvh
    dev = q.device
    q_pos_base = torch.arange(q_chunk, device=dev)
    k_pos_base = torch.arange(kv_chunk, device=dev)
    outs = []
    for qi in range(sq_p // q_chunk):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_offset + qi * q_chunk + q_pos_base
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, d), device=dev)
        for ki in range(sk_p // kv_chunk):
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = _gqa_scores(qc, kc) * scale  # (B, Kv, G, qc, kc) f32
            k_pos = ki * kv_chunk + k_pos_base
            mask = (k_pos[None, :] < sk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vc.dtype).float(), vc.float()
            )
            m = m_new
        out = acc / l[..., None].clamp(min=1e-30)  # (B, Kv, G, qc, D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def decode_attention(q: Tensor, cache: KVCache) -> Tensor:
    """One-token attention against the cache. q: (B, 1, H, D)."""
    b, _, h, d = q.shape
    s_max = cache.k.shape[1]
    s = _gqa_scores(q, cache.k) * d**-0.5  # (B, Kv, G, 1, S_max)
    pos = torch.arange(s_max, device=q.device)
    if cache.length.dim():
        valid = pos[None, :] < cache.length[:, None]  # (B, S_max)
        valid = valid[:, None, None, None, :]
    else:
        valid = (pos < cache.length)[None, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, cache.v).to(q.dtype)


def attn_apply(
    params: dict,
    x: Tensor,
    ctx: AnalogCtx,
    cfg: ModelConfig,
    *,
    positions: Tensor,
    cache: Optional[KVCache] = None,
    window: Optional[int] = None,
) -> tuple[Tensor, Optional[KVCache]]:
    """Full attention block. x: (B, S, M). Returns (out, updated_cache)."""
    if window is not None:
        raise NotImplementedError(
            "local-window attention (hybrid family) comes in a later slice"
        )
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = linear_apply(params["wq"], x, ctx).reshape(b, s, nh, hd)
    k = linear_apply(params["wk"], x, ctx).reshape(b, s, nkv, hd)
    v = linear_apply(params["wv"], x, ctx).reshape(b, s, nkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and s == 1:
        s_cache = cache.k.shape[1]
        # a write past the end lands on the last row, as the reference's
        # clamped dynamic_update_slice does (retired slots keep stepping)
        idx = cache.length.clamp(max=s_cache - 1).long()
        if cache.length.dim():
            rows = torch.arange(b, device=x.device)
            cache.k.index_put_((rows, idx), k[:, 0].to(cache.k.dtype))
            cache.v.index_put_((rows, idx), v[:, 0].to(cache.v.dtype))
        else:
            cache.k.index_copy_(1, idx.reshape(1), k.to(cache.k.dtype))
            cache.v.index_copy_(1, idx.reshape(1), v.to(cache.v.dtype))
        new_cache = KVCache(cache.k, cache.v, cache.length + 1)
        out = decode_attention(q, new_cache)
    else:
        if cache is not None:
            if cache.length.dim():
                raise ValueError(
                    "prefill writes a rectangle cache (scalar length); "
                    "prefill a request alone and write_cache_slot it"
                )
            s_cache = cache.k.shape[1]
            start = cache.length.clamp(max=s_cache - s).long()
            idx = start + torch.arange(s, device=x.device)
            cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
            cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
            new_cache = KVCache(cache.k, cache.v, cache.length + s)
        out = chunked_attention(
            q, k, v, q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv,
            causal=True,
        )
    out = out.reshape(b, s, nh * hd)
    return linear_apply(params["wo"], out, ctx), new_cache


def init_cache(
    cfg: ModelConfig, batch: int, s_max: int, dtype, *, per_slot: bool = False,
    device,
) -> KVCache:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
    )
