"""Attention, port of ``repro.models.attention``: global and local-window
(the hybrid family's) attention.

GQA projections are analog layers (``core.analog.linear_apply``); the QK^T
and AV products have two dynamic operands, run on the digital datapath and
stay plain torch here in decode, as the reference left them to XLA outside
any Pallas kernel. Two paths: the chunked online-softmax prefill (shape-stable
kv chunks, so real positions are bitwise independent of right-padding; on
the card the prefill-attention kernel, window included) and one-token
decode against a KV cache with scalar or per-slot (B,) lengths, or against
the paged cache (:class:`PagedKVCache`: a shared page pool read through
per-slot page tables). A local-window layer's cache is a rolling buffer of
``min(s_max, window)`` rows (decode writes at ``length % rows``); paged
caches refuse the window, as the reference's do.

KV writes update the cache buffers in place (``index_copy_``/``index_put_``)
instead of copying the whole multi-layer cache every step; the returned
:class:`KVCache` shares the buffers with the one passed in.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.core.analog import (AnalogCtx, gather_columns, linear_apply, linear_init,
                                     linear_local)
from repro_torch.kernels import build, decode_rows
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref
from repro_torch.models.common import ModelConfig, rope

Tensor = torch.Tensor


class KVCache(NamedTuple):
    k: Tensor  # (B, S_max, n_kv, hd)
    v: Tensor  # (B, S_max, n_kv, hd)
    #: tokens already written: () int32 for a rectangle batch, (B,) int32
    #: for a per-slot cache (each batch row an independent request)
    length: Tensor


class HeadLayout(NamedTuple):
    """The heads a rank's attention runs on a sharded chip: ``heads`` query
    heads from ``h0`` on and the ``kv_heads`` its cache holds. Where the
    query heads are the rank's (``q_split``: ``wq``'s column split, so
    ``wo`` takes the output as it lies), its KV heads are too
    (``kv_local``), or -- where the ``model`` degree does not divide the KV
    heads (``logical_rules``' ``kv_heads`` None) -- the KV heads its query
    heads read, one per query head. Unsharded (and in a training step
    whose KV heads are replicated): every head."""

    heads: int
    kv_heads: int
    q_split: Any
    kv_local: bool
    h0: int


def head_layout(params: dict, cfg: ModelConfig) -> HeadLayout:
    """The heads this rank runs (see :class:`HeadLayout`). In a sharded
    training step (``row_axis``) where the KV heads are replicated, every
    rank runs every head: with the query heads split, each rank's heads
    would add only their part of a KV head's gradient, and the whole one
    would be a float sum over the ranks. A sharded serving step (its rows
    split, no gradient) keeps the rank's heads."""
    from repro_torch.models.common import row_axis, split_axis

    hd = cfg.hd
    sq, sk = params["wq"].get("tp"), params["wk"].get("tp")
    col = lambda sp: sp is not None and sp.dim == -1 and sp.aligned(hd)
    whole = HeadLayout(cfg.n_heads, cfg.n_kv_heads, None, False, 0)
    if not (col(sq) and split_axis("heads") is not None):
        return whole
    h0, h1 = sq.start // hd, sq.stop // hd
    if col(sk) and split_axis("kv_heads") is not None:
        return HeadLayout(h1 - h0, (sk.stop - sk.start) // hd, sq, True, h0)
    if row_axis() is not None and torch.is_grad_enabled():
        return whole
    return HeadLayout(h1 - h0, h1 - h0, sq, False, h0)


def attn_init(key: Tensor, cfg: ModelConfig) -> dict:
    kq, kk, kv, ko = prng.split(key, 4)
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": linear_init(kq, cfg.d_model, nh * hd, use_bias=cfg.qkv_bias),
        "wk": linear_init(kk, cfg.d_model, nkv * hd, use_bias=cfg.qkv_bias),
        "wv": linear_init(kv, cfg.d_model, nkv * hd, use_bias=cfg.qkv_bias),
        "wo": linear_init(ko, nh * hd, cfg.d_model),
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
    window: Optional[int] = None,
) -> Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) blocks; ``window``
    (local attention) masks keys at ``q_pos - k_pos >= window`` on every
    route.

    q: (B, Sq, H, D); k, v: (B, Sk, Kv, D). ``kv_chunk`` is never clamped to
    the sequence: a short sequence pads up to one full chunk, and padded or
    masked positions contribute exact zeros, as in the reference, so real
    positions are bitwise independent of right-padding. The dense prefill's
    case (causal, ``q_offset == 0``, Sq == Sk) goes to the prefill-attention
    kernel (``kernels.flash_attention``: the Hopper kernel on a CUDA tensor,
    its plain version on the CPU) -- through its training form
    (``kernels.ops.flash_attention_ste``: the same forward, the plain
    version's VJP backward) while autograd records and q, k or v needs a
    gradient; every other case runs the plain version
    (``kernels.ref.flash_attention_ref``).
    """
    if causal and q_offset == 0 and q.shape[1] == k.shape[1]:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return kernel_ops.flash_attention_ste(q, k, v, causal=True, q_chunk=q_chunk,
                                                  kv_chunk=kv_chunk, window=window)
        return flash_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
                               window=window)
    return flash_attention_ref(
        q, k, v, causal, q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset,
        window=window,
    )


def decode_attention(q: Tensor, cache: KVCache) -> Tensor:
    """One-token attention against the cache. q: (B, 1, H, D).

    Row j is valid below ``min(length, S_max)``: the written rows of a
    rolling window buffer (every one inside the window by construction),
    and the same mask as ``j < length`` for a global cache."""
    b, _, h, d = q.shape
    s_max = cache.k.shape[1]
    s = _gqa_scores(q, cache.k) * d**-0.5  # (B, Kv, G, 1, S_max)
    pos = torch.arange(s_max, device=q.device)
    limit = cache.length.clamp(max=s_max)
    if cache.length.dim():
        valid = pos[None, :] < limit[:, None]  # (B, S_max)
        valid = valid[:, None, None, None, :]
    else:
        valid = (pos < limit)[None, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, cache.v).to(q.dtype)


class PagedKVCache(NamedTuple):
    """Paged KV cache: a pool of fixed-size pages shared by every request
    slot, plus a per-slot page table.

    A slot holds ``ceil(length / page_size)`` pages, so resident KV memory
    tracks usage, not provisioning. Page 0 is the reserved scratch page:
    never allocated, unused table entries point at it, and retired slots
    write their dead decode tokens into it.
    """

    k: Tensor  # (n_pages, page_size, n_kv, hd) -- pool shared by all slots
    v: Tensor  # (n_pages, page_size, n_kv, hd)
    table: Tensor  # (B, pages_per_slot) int32 page ids; 0 = scratch page
    length: Tensor  # (B,) int32 tokens written per slot
    #: the slot's virtual capacity: the gathered decode view is sliced to
    #: exactly the rectangle an equivalent slot cache has (reduction shapes
    #: match)
    s_max: int

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


def init_paged_cache(
    cfg: ModelConfig,
    batch: int,
    s_max: int,
    dtype,
    *,
    page_size: int,
    n_pages: int,
    device,
    kv_heads: Optional[int] = None,
) -> PagedKVCache:
    """One layer's page pool and per-slot tables (one page-id space for all
    layers: the serving allocator hands out ids valid in every pool);
    ``kv_heads`` as in :func:`init_cache`."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    pages_per_slot = -(-s_max // page_size)
    if n_pages < 2:
        raise ValueError(
            f"n_pages={n_pages}: need the scratch page plus at least one "
            "usable page"
        )
    # n_pages may be far below batch * pages_per_slot (s_max is virtual);
    # the serving engine's admission reservations keep usage in the pool
    shape = (n_pages, page_size, kv_heads or cfg.n_kv_heads, cfg.hd)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        table=torch.zeros((batch, pages_per_slot), dtype=torch.int32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        s_max=int(s_max),
    )


def paged_view(cache: PagedKVCache) -> KVCache:
    """Gather the pool through the page tables into a (B, s_max) slot-cache
    view: data movement only, sliced to the virtual capacity, so attention
    over it is bitwise attention over a rectangular slot cache holding the
    same tokens. Positions past a slot's length read scratch or stale rows
    and are masked to exact-zero probability by :func:`decode_attention`."""
    b, pages_per_slot = cache.table.shape
    ps = cache.page_size
    tab = cache.table.long()
    k = cache.k[tab].reshape(b, pages_per_slot * ps, *cache.k.shape[2:])
    v = cache.v[tab].reshape(b, pages_per_slot * ps, *cache.v.shape[2:])
    return KVCache(k[:, : cache.s_max], v[:, : cache.s_max], cache.length)


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
    """Full attention block. x: (B, S, M). Returns (out, updated_cache).

    ``window`` (the hybrid family's local attention) masks the prefill's
    keys and makes a cache of at most ``window`` rows a rolling buffer:
    decode writes at ``length % rows``, prefill writes its last ``rows``
    keys rolled by ``S % rows``. A global cache's writes clamp at its last
    row instead (retired slots keep stepping), as the reference's do."""
    if window is not None and isinstance(cache, PagedKVCache):
        raise NotImplementedError(
            "local-window attention keeps its bounded rolling buffer; "
            "paging applies to global-attention caches only"
        )
    b, s, _ = x.shape
    lay = head_layout(params, cfg)
    hd, nh, nkv = cfg.hd, lay.heads, lay.kv_heads
    q, sq = linear_local(params["wq"], x, ctx)
    k, sk = linear_local(params["wk"], x, ctx)
    v, sv = linear_local(params["wv"], x, ctx)
    if lay.q_split is None:
        q = gather_columns(q, sq)
    if not lay.kv_local:
        k, v = gather_columns(k, sk), gather_columns(v, sv)
        if lay.q_split is not None:  # each query head's KV head, one per query head
            idx = torch.arange(lay.h0, lay.h0 + nh, device=x.device) // (
                cfg.n_heads // cfg.n_kv_heads)
            k = k.reshape(b, s, cfg.n_kv_heads, hd).index_select(2, idx)
            v = v.reshape(b, s, cfg.n_kv_heads, hd).index_select(2, idx)
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    # one token per slot against a cache on a card: RoPE and attention run
    # the fused decode kernel's row code (kernels.decode_rows), so the
    # per-layer step's K rows and outputs are B2's bit for bit
    row_kernels = cache is not None and s == 1 and build.on_card(x)
    if row_kernels:
        q, k = decode_rows.rope(q, k, positions[:, 0].expand(b), cfg.rope_theta)
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if isinstance(cache, PagedKVCache):
        if s != 1:
            raise NotImplementedError(
                "paged caches are decode-only: prefill into a rectangular "
                "cache and scatter it into pages "
                "(models.lm.write_cache_slot_paged)"
            )
        # write this token's K/V row at (page, offset) of each slot's
        # position, then attend over the gathered view: the values a
        # rectangular slot cache would hold, so the same attention bits
        ps = cache.page_size
        entry = (cache.length // ps).clamp(max=cache.table.shape[1] - 1).long()
        rows = torch.arange(b, device=x.device)
        # out-of-range entries of retired slots clip onto their table's last
        # entry, which is 0 (scratch) once the slot is freed
        page = cache.table[rows, entry].long()
        off = (cache.length % ps).long()
        cache.k.index_put_((page, off), k[:, 0].to(cache.k.dtype))
        cache.v.index_put_((page, off), v[:, 0].to(cache.v.dtype))
        new_cache = PagedKVCache(
            cache.k, cache.v, cache.table, cache.length + 1, cache.s_max
        )
        view = paged_view(new_cache)
        out = (decode_rows.attention(q, view.k, view.v, view.length) if row_kernels
               else decode_attention(q, view)).reshape(b, s, nh * hd)
        return linear_apply(params["wo"], out, ctx, lay.q_split), new_cache

    new_cache = None
    s_cache = cache.k.shape[1] if cache is not None else 0
    rolling = window is not None and s_cache <= window
    if cache is not None and s == 1:
        if rolling:
            idx = (cache.length % s_cache).long()
        else:
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
        out = (decode_rows.attention(q, cache.k, cache.v, new_cache.length) if row_kernels
               else decode_attention(q, new_cache))
    else:
        if cache is not None:
            if cache.length.dim():
                raise ValueError(
                    "prefill writes a rectangle cache (scalar length); "
                    "prefill a request alone and write_cache_slot it"
                )
            if rolling and s >= s_cache:
                # the last s_cache keys at their position-mod-rows slots
                cache.k.copy_(torch.roll(k[:, -s_cache:], s % s_cache, dims=1))
                cache.v.copy_(torch.roll(v[:, -s_cache:], s % s_cache, dims=1))
            else:
                start = (torch.zeros_like(cache.length) if rolling
                         else cache.length.clamp(max=s_cache - s)).long()
                idx = start + torch.arange(s, device=x.device)
                cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
                cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
            new_cache = KVCache(cache.k, cache.v, cache.length + s)
        out = chunked_attention(
            q, k, v, q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv,
            causal=True, window=window,
        )
    out = out.reshape(b, s, nh * hd)
    return linear_apply(params["wo"], out, ctx, lay.q_split), new_cache


def init_cache(
    cfg: ModelConfig, batch: int, s_max: int, dtype, *, per_slot: bool = False,
    device, kv_heads: Optional[int] = None,
) -> KVCache:
    """One layer's KV cache; ``kv_heads`` (default ``cfg.n_kv_heads``): the
    heads a rank of a sharded chip holds (:func:`head_layout`)."""
    shape = (batch, s_max, kv_heads or cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
    )
