"""The LM, port of ``repro.models.lm``: the dense, MoE, SSM (mamba2),
hybrid (recurrentgemma: RG-LRU and local attention, 2:1), audio (musicgen)
and vision (paligemma) families.

Parameters keep the reference's layout -- :class:`LMParams` with the block
stack as ``(n_groups, ...)`` tensors -- so a JAX param tree or program
artifact maps onto it leaf for leaf (``convert.params_from_numpy``,
``checkpoint.store.load_program``). The forward walks the groups in a
Python loop (eager; no scan), each group reading views of the stacked
leaves. Every projection is an analog linear layer: under a compiled
program's ``pcm_programmed`` config each one is a programmed MVM.

:func:`lm_loss` is the training loss (next-token cross-entropy).

Caches: ``(group caches, tail caches)``, one cache per block: a
:class:`KVCache` for attention (a rolling window buffer in the hybrid
family), an ``SSMCache`` (``models.ssm``) or an ``RGLRUCache``
(``models.griffin``) for the recurrent blocks, whose fp32 states are
position-free. The *stacked* layout holds one ``(n_groups, ...)`` buffer
per leaf; the *list* layout (decode, and the serving engine's per-slot
cache) holds one cache per block of each group, or one
:class:`PagedKVCache` per group in the paged layout (page pools shared by
every slot, one page-id space across layers; attention families only). KV
rows are written in place in every layout; a recurrent block returns new
state tensors. A MoE block (``models.moe``) replaces the FFN with expert
banks. Layers past the last whole group (recurrentgemma's 38 = 12 x 3 + 2)
are the unstacked tail.

Inputs (:func:`_embed_inputs`): token ids; the audio family's
precomputed frame embeddings (``batch["frames"]``, no token embedding);
or the vision family's image patches (``batch["patches"]``), projected by
the analog ``extras["patch_proj"]`` and prepended to the embedded tokens.
A multi-codebook head (``n_codebooks``) is ``vocab * n_codebooks`` wide,
its logits reshaped to ``(..., n_codebooks, vocab)``.

``cfg.remat`` recomputes each group's forward in the backward
(``torch.utils.checkpoint``), as the reference wraps each group in
``jax.checkpoint``; the values do not change (see :func:`lm_forward`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives, prng
from repro_torch.core.analog import (AnalogConfig, AnalogCtx, MvmFn, linear_apply, linear_init,
                                     linear_local)
from repro_torch.device import resolve_device
from repro_torch.kernels import build, decode_rows
from repro_torch.models import attention as attn_lib
from repro_torch.models import griffin as griffin_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (
    ModelConfig,
    embedding_apply,
    embedding_init,
    rmsnorm_apply,
    rmsnorm_init,
    row_axis,
)

Tensor = torch.Tensor


def block_period(cfg: ModelConfig) -> list[str]:
    """The kinds of a group's blocks: dense, audio and vision ``["attn"]``;
    MoE ``["moe"]``, or ``moe_every - 1`` dense blocks then one MoE block
    (llama4's interleaving); SSM ``["ssm"]``; hybrid its ``block_pattern``
    (recurrentgemma: ``["rec", "rec", "attn"]``)."""
    if cfg.family == "ssm":
        return ["ssm"]
    if cfg.family == "hybrid":
        return list(cfg.block_pattern) or ["rec", "rec", "attn"]
    if cfg.family == "moe":
        if cfg.moe_every <= 1:
            return ["moe"]
        return ["attn"] * (cfg.moe_every - 1) + ["moe"]
    return ["attn"]  # dense / audio / vlm


def mlp_init(key: Tensor, cfg: ModelConfig) -> dict:
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w1": linear_init(k1, cfg.d_model, cfg.d_ff),
        "w3": linear_init(k3, cfg.d_model, cfg.d_ff),
        "w2": linear_init(k2, cfg.d_ff, cfg.d_model),
    }


def _rows(x: Tensor, cache) -> bool:
    """One token per slot against a cache on a card: the decode step, whose
    norms, RoPE, attention and gate run B2's row code
    (``kernels.decode_rows``)."""
    return cache is not None and x.shape[1] == 1 and build.on_card(x)


def _norm(params: dict, x: Tensor, eps: float, rows: bool) -> Tensor:
    if rows:
        return decode_rows.norm(x, params.get("scale"), eps)
    return rmsnorm_apply(params, x, eps)


def mlp_apply(params: dict, x: Tensor, ctx: AnalogCtx, *, rows: bool = False) -> Tensor:
    """SwiGLU. On a sharded chip w1 and w3 give the rank's hidden units and
    w2 takes them as they lie where its rows are the same units
    (``core.analog.linear_apply``)."""
    u, split = linear_local(params["w1"], x, ctx)
    g, _ = linear_local(params["w3"], x, ctx)
    h = decode_rows.gate(u, g) if rows else torch.nn.functional.silu(u) * g
    return linear_apply(params["w2"], h, ctx, split)


def _block_init(key: Tensor, kind: str, cfg: ModelConfig) -> dict:
    """A block's params: an ``"ssm"`` block is norm1 and the Mamba-2 mixer;
    every other kind adds norm2 and an FFN (the MoE layer in a ``"moe"``
    block) to its mixer (attention, or the RG-LRU block in a ``"rec"``)."""
    km, kf = prng.split(key, 4)[:2]
    params: dict[str, Any] = {"norm1": rmsnorm_init(cfg, device=key.device)}
    if kind == "ssm":
        params["ssm"] = ssm_lib.ssm_init(km, cfg)
        return params
    params["norm2"] = rmsnorm_init(cfg, device=key.device)
    if kind in ("attn", "moe"):
        params["attn"] = attn_lib.attn_init(km, cfg)
    elif kind == "rec":
        params["rec"] = griffin_lib.griffin_init(km, cfg)
    else:
        raise ValueError(kind)
    if kind == "moe":
        params["moe"] = moe_lib.moe_init(kf, cfg)
    else:
        params["ffn"] = mlp_init(kf, cfg)
    return params


def _stack(trees: list) -> Any:
    """Stack same-structured dicts of tensors along a new leading axis.

    Keys come out sorted, as the reference's ``vmap`` over the group init
    returns them: the program phase's layer keys follow this walk order.
    """
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return torch.stack(trees)


def _block_apply(
    params: dict, kind: str, x: Tensor, ctx: AnalogCtx, cfg: ModelConfig,
    positions: Tensor, cache,
):
    """One block: norm -> mixer -> residual [-> norm -> ffn (the MoE layer
    in a ``"moe"`` block) -> residual]; the mixer is attention (local in
    the hybrid family), the Mamba-2 block (``"ssm"``, no FFN) or the RG-LRU
    block (``"rec"``)."""
    rows = _rows(x, cache)
    h = _norm(params["norm1"], x, cfg.norm_eps, rows)
    if kind == "ssm":
        out, new_cache = ssm_lib.ssm_apply(params["ssm"], h, ctx, cfg, cache)
        return x + out, new_cache
    if kind == "rec":
        out, new_cache = griffin_lib.griffin_apply(params["rec"], h, ctx, cfg, cache)
    else:
        window = cfg.local_window if cfg.family == "hybrid" else None
        out, new_cache = attn_lib.attn_apply(
            params["attn"], h, ctx, cfg, positions=positions, cache=cache, window=window
        )
    x = x + out
    h = _norm(params["norm2"], x, cfg.norm_eps, rows)
    if kind == "moe":
        if cfg.moe_dispatch == "shard_map":
            from repro_torch.models.moe_shardmap import moe_apply_shardmap

            return x + moe_apply_shardmap(params["moe"], h, ctx, cfg), new_cache
        return x + moe_lib.moe_apply(params["moe"], h, ctx, cfg), new_cache
    return x + mlp_apply(params["ffn"], h, ctx, rows=rows), new_cache


class LMParams(NamedTuple):
    embed: dict
    blocks: Any  # tuple over the period of stacked (n_groups, ...) dicts
    tail: tuple  # leftover (unscanned) block params
    final_norm: dict
    lm_head: dict
    extras: dict
    gain_s: Tensor  # network-wide ADC gain S (Eq. 5)


def lm_init(key: Tensor, cfg: ModelConfig, *, device="cuda") -> LMParams:
    """Random LM params drawn from the threefry ``key`` on ``device``.

    The reference's initializers and key tree (N(0, d_in^-1/2) projections,
    N(0, 0.02) embeddings, unit norms, r_adc = 1, clip range [-1, 1],
    S = 1), drawn through the RNG bridge: the same key gives the
    reference's weights.
    """
    dev = resolve_device(device)
    key = key.to(dev)
    period = block_period(cfg)
    n_groups = cfg.n_layers // len(period)
    n_tail = cfg.n_layers - n_groups * len(period)
    k_embed, k_blocks, k_tail, k_head, k_extra = prng.split(key, 5)
    groups = []
    for gk in prng.split(k_blocks, n_groups):
        keys = prng.split(gk, len(period))
        groups.append([_block_init(keys[i], kind, cfg) for i, kind in enumerate(period)])
    blocks = tuple(_stack([g[i] for g in groups]) for i in range(len(period)))
    tail = tuple(_block_init(prng.fold_in(k_tail, i), period[i % len(period)], cfg)
                 for i in range(n_tail))
    extras: dict[str, Any] = {}
    if cfg.frontend == "vision_patches":
        extras["patch_proj"] = linear_init(k_extra, cfg.d_model, cfg.d_model)
    return LMParams(
        embed=embedding_init(k_embed, cfg.vocab, cfg.d_model),
        blocks=blocks,
        tail=tail,
        final_norm=rmsnorm_init(cfg, device=dev),
        lm_head=linear_init(k_head, cfg.d_model, cfg.vocab * max(cfg.n_codebooks, 1)),
        extras=extras,
        gain_s=torch.ones((), device=dev),
    )


def _embed_inputs(params: LMParams, batch: dict, cfg: ModelConfig, ctx: AnalogCtx) -> Tensor:
    """The forward's input rows: the audio family's ``frames`` (B, S, d)
    as they come; the vision family's ``patches`` (B, P, d), when given,
    through ``extras["patch_proj"]`` (an analog MVM drawing from ``ctx``,
    the lm_head's context, first) ahead of the embedded ``tokens``; else
    the embedded ``tokens``."""
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(cfg.dtype)
    tok = embedding_apply(params.embed, batch["tokens"], cfg.dtype)
    if cfg.frontend == "vision_patches" and "patches" in batch:
        patches = linear_apply(params.extras["patch_proj"], batch["patches"].to(cfg.dtype), ctx)
        return torch.cat([patches, tok], dim=1)
    return tok


def _index(tree: Any, i: int) -> Any:
    """Views of member ``i`` of every stacked leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i] if isinstance(tree, Tensor) else tree  # a layer's split


def _group_view(group_cache, gi: int):
    """Group ``gi``'s caches of a stacked cache, as views into it."""
    return tuple(type(c)(*(leaf[gi] for leaf in c)) for c in group_cache)


def _restack(stacked, caches: list):
    """One block's stacked cache after a forward from its per-group caches:
    KV rows were written in place into ``stacked``'s buffers (only the
    lengths are stacked anew); recurrent states are new tensors, stacked."""
    if isinstance(stacked, attn_lib.KVCache):
        return stacked._replace(length=torch.stack([c.length for c in caches]))
    return type(stacked)(*(torch.stack(leaves) for leaves in zip(*caches)))


def lm_forward(
    params: LMParams,
    batch: dict,
    analog_cfg: AnalogConfig,
    cfg: ModelConfig,
    *,
    rng: Optional[Tensor] = None,
    cache: Optional[tuple] = None,
    last_token_only: bool = False,
    last_index: Optional[Tensor] = None,
    mvm: Optional[MvmFn] = None,
):
    """Forward pass -> (logits, new_cache); runs where ``params`` live.

    ``rng`` is the call's threefry key for per-call noise (``pcm_infer``,
    or a program compiled with ``resample_read_noise``): group ``g`` draws
    under ``fold_in(rng, g)``, tail layer ``i`` under ``fold_in(rng,
    10_000 + i)`` and the lm_head under ``rng`` itself, as in the
    reference. ``cache`` is (group caches, tail caches) or None.
    ``last_token_only`` computes only the final position's logits;
    ``last_index`` ((B,) int, with ``last_token_only``) picks each row's
    position. ``mvm`` replaces the execute-phase MVM for this call (see
    ``core.analog.AnalogCtx``).

    Training: without a cache the forward is differentiable (the attention
    through B3's training form, the analog MVMs of ``analog_train``
    through B1's). With ``cfg.remat`` and grad enabled, each group runs
    under ``torch.utils.checkpoint`` (non-reentrant), as the reference
    wraps each group in ``jax.checkpoint``: only the group's input is kept,
    and the backward recomputes the group's forward. The recompute builds
    the group's ``AnalogCtx`` afresh, so its key counter starts where the
    forward's did and it draws the same weight noise and keep masks: the
    loss and every gradient are bitwise those without remat. The recompute
    is a second forward of every group: its kernel launches are counted as
    launches (B1 and B3 run again), the backward recomputes
    (``ops.backward_calls``) once, as without remat.
    """
    period = block_period(cfg)
    if rng is not None:  # draws land where the params live
        rng = rng.to(params.gain_s.device)
    sub = lambda i: None if rng is None else prng.fold_in(rng, i)
    ctx = AnalogCtx(cfg=analog_cfg, gain_s=params.gain_s, key=rng, mvm=mvm)
    h = _embed_inputs(params, batch, cfg, ctx)
    b, s, _ = h.shape
    dev = h.device

    if cache is not None:
        group_caches, tail_caches = cache
        start = _cache_length(group_caches, tail_caches)
    else:
        group_caches, tail_caches = None, None
        start = torch.zeros((), dtype=torch.int32, device=dev)
    steps = torch.arange(s, device=dev)
    if start.dim():
        positions = start[:, None] + steps[None, :]  # per-slot: (B, S)
    else:
        positions = (start + steps)[None, :]  # (1, S) broadcasts

    n_groups = cfg.n_layers // len(period)
    stacked = group_caches is not None and not isinstance(group_caches, list)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()

    def group(h: Tensor, gp, gc, key) -> tuple:
        # the context is built here, so a recompute draws from the counter
        # the forward started at
        ctx_g = AnalogCtx(cfg=analog_cfg, gain_s=params.gain_s, key=key, mvm=mvm)
        new_gc = []
        for i, kind in enumerate(period):
            h, nc = _block_apply(gp[i], kind, h, ctx_g, cfg, positions, gc[i])
            new_gc.append(nc)
        return h, tuple(new_gc)

    new_groups = []
    for gi in range(n_groups):
        gp = _index(params.blocks, gi)
        if group_caches is None:
            gc = (None,) * len(period)
        elif stacked:
            gc = _group_view(group_caches, gi)
        else:
            gc = group_caches[gi]
        if remat:
            h = checkpoint(lambda x, gp=gp, gc=gc, k=sub(gi): group(x, gp, gc, k)[0], h,
                           use_reentrant=False)
            new_groups.append(gc)
        else:
            h, new_gc = group(h, gp, gc, sub(gi))
            new_groups.append(new_gc)

    new_tail = []
    for i, tp in enumerate(params.tail):
        tc = None if tail_caches is None else tail_caches[i]
        ctx_t = AnalogCtx(cfg=analog_cfg, gain_s=params.gain_s, key=sub(10_000 + i), mvm=mvm)
        h, nc = _block_apply(tp, period[i % len(period)], h, ctx_t, cfg, positions, tc)
        new_tail.append(nc)

    h = _norm(params.final_norm, h, cfg.norm_eps, _rows(h, cache))
    if last_token_only:
        if last_index is not None:
            idx = last_index.long()[:, None, None].expand(b, 1, h.shape[-1])
            h = torch.gather(h, 1, idx)
        else:
            h = h[:, -1:, :]
    logits = linear_apply(params.lm_head, h, ctx)
    if cfg.n_codebooks:
        logits = logits.reshape(*logits.shape[:-1], cfg.n_codebooks, cfg.vocab)

    new_cache = None
    if cache is not None:
        if stacked:
            new_group_caches = tuple(
                _restack(c, [g[i] for g in new_groups]) for i, c in enumerate(group_caches)
            )
        else:
            new_group_caches = new_groups
        new_cache = (new_group_caches, tuple(new_tail))
    return logits, new_cache


def _cache_length(group_caches, tail_caches) -> Tensor:
    """The current position from any attention cache: a scalar for
    rectangle caches, the (B,) vector for a per-slot cache (stacked caches
    strip the layer axis). A pure-SSM cache is position-free: a scalar 0,
    as the reference returns (its positions feed no RoPE)."""
    stacked = not isinstance(group_caches, list)
    kinds = (attn_lib.KVCache, attn_lib.PagedKVCache)
    for group in (group_caches if not stacked else [group_caches]):
        for c in group:
            if isinstance(c, kinds):
                return c.length[0] if stacked else c.length
    for c in tail_caches:
        if isinstance(c, kinds):
            return c.length
    layers = cache_layers((group_caches if not stacked else [group_caches], tail_caches))
    return torch.zeros((), dtype=torch.int32, device=layers[0].h.device)


def check_pageable(cfg: ModelConfig) -> None:
    """Raise unless every cache of ``cfg`` is an attention KV cache, the only
    kind the paged layout holds."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            "paged serving supports attention-cache families only "
            f"(family={cfg.family!r} has recurrent blocks): SSM/RG-LRU "
            "recurrent state is position-free, so the right-padded "
            "bucketed prefill that paging relies on would fold pad "
            "tokens into it"
        )


def init_lm_cache(
    cfg: ModelConfig,
    batch: int,
    s_max: int,
    dtype,
    stacked: bool = True,
    per_slot: bool = False,
    paged: bool = False,
    page_size: int = 16,
    n_pages: Optional[int] = None,
    *,
    device="cuda",
    kv_heads: Optional[int] = None,
) -> tuple:
    """Build the (group caches, tail caches) tuple on ``device``.

    ``stacked=True``: one (n_groups, ...) buffer per leaf. ``stacked=False``:
    a list of per-group caches (the decode layout). ``per_slot=True``
    (requires ``stacked=False``): (B,) lengths, one independent request per
    batch row -- the serving engine's slot cache. ``paged=True`` (requires
    ``stacked=False``): every attention leaf is a :class:`PagedKVCache` of
    ``n_pages`` pages of ``page_size`` tokens (default: enough for ``batch``
    full slots plus the scratch page 0) with ``s_max`` the per-slot virtual
    capacity; slots are admitted and retired through
    :func:`write_cache_slot_paged` / :func:`free_cache_slot_paged` with page
    ids from the serving engine's allocator. ``kv_heads``: the KV heads of
    a rank of a sharded chip (:func:`cache_kv_heads`).
    """
    dev = resolve_device(device)
    if per_slot and stacked:
        raise ValueError(
            "per_slot caches use the unstacked decode layout (pass stacked=False)"
        )
    if paged:
        if stacked:
            raise ValueError(
                "paged caches use the unstacked decode layout (pass stacked=False)"
            )
        check_pageable(cfg)
        if n_pages is None:
            n_pages = batch * (-(-s_max // page_size)) + 1
    period = block_period(cfg)
    n_groups = cfg.n_layers // len(period)
    n_tail = cfg.n_layers - n_groups * len(period)

    def one(kind: str, slot_lengths: bool):
        if kind == "ssm":
            return ssm_lib.init_ssm_cache(cfg, batch, dtype, device=dev)
        if kind == "rec":
            return griffin_lib.init_rglru_cache(cfg, batch, dtype, device=dev)
        # local attention holds only a window of rows (a rolling buffer)
        rows = min(s_max, cfg.local_window) if cfg.family == "hybrid" else s_max
        if paged:
            return attn_lib.init_paged_cache(
                cfg, batch, rows, dtype, page_size=page_size,
                n_pages=n_pages, device=dev, kv_heads=kv_heads,
            )
        return attn_lib.init_cache(
            cfg, batch, rows, dtype, per_slot=slot_lengths, device=dev, kv_heads=kv_heads,
        )

    if stacked:
        groups = tuple(
            type(c)(*(torch.stack([leaf] * n_groups) for leaf in c))
            for c in (one(kind, False) for kind in period)
        )
    else:
        groups = [tuple(one(kind, per_slot) for kind in period) for _ in range(n_groups)]
    tail = tuple(one(period[i % len(period)], per_slot) for i in range(n_tail))
    return groups, tail


def cache_kv_heads(params: LMParams, cfg: ModelConfig) -> int:
    """The KV heads a cache of ``params``' forward holds: every KV head,
    or a rank's of a sharded chip (``attention.head_layout``)."""
    for group in tuple(params.blocks) + tuple(params.tail):
        if "attn" in group:
            return attn_lib.head_layout(group["attn"], cfg).kv_heads
    return cfg.n_kv_heads


def unstack_cache(cache: tuple) -> tuple:
    """Stacked cache -> the decode list layout (views, no copy)."""
    groups, tail = cache
    if isinstance(groups, list):
        return cache
    n_groups = groups[0][0].shape[0] if groups else 0
    return [_group_view(groups, gi) for gi in range(n_groups)], tail


def cache_layers(cache: tuple) -> list:
    """Every layer's cache (:class:`KVCache`, :class:`PagedKVCache`,
    ``SSMCache`` or ``RGLRUCache``) of a list-layout cache, in order."""
    groups, tail = cache
    return [c for g in list(groups) + [tail] for c in g]


def kv_layers(cache: tuple) -> list:
    """The attention caches of :func:`cache_layers`, in order."""
    kinds = (attn_lib.KVCache, attn_lib.PagedKVCache)
    return [c for c in cache_layers(cache) if isinstance(c, kinds)]


def write_cache_slot(cache: tuple, src: tuple, slot: int) -> tuple:
    """Write a single-request cache into batch row ``slot`` of a slot cache.

    ``src`` is the request's batch=1 cache in the list layout, built with
    the same ``s_max``. KV rows and the slot's length, or a recurrent
    block's conv window and state (a full-row copy), are written in place;
    the (mutated) ``cache`` is returned.
    """
    for dst, s in zip(cache_layers(cache), cache_layers(src), strict=True):
        if isinstance(dst, attn_lib.KVCache):
            dst.k[slot].copy_(s.k[0])
            dst.v[slot].copy_(s.v[0])
            dst.length[slot] = s.length
        else:
            for d_leaf, s_leaf in zip(dst, s):
                d_leaf[slot].copy_(s_leaf[0])
    return cache


def reset_cache_slot(cache: tuple, slot: int) -> tuple:
    """Zero batch row ``slot`` of a per-slot cache, in place."""
    for dst in cache_layers(cache):
        if isinstance(dst, attn_lib.KVCache):
            dst.length[slot] = 0
        for leaf in dst:
            if leaf.dim() > 1:
                leaf[slot].zero_()
    return cache


# ---------------------------------------------------------------------------
# Paged-cache slot helpers (serving paged mode). The engine owns ONE paged
# decode cache; admission scatters a request's rectangular prefill cache
# into its pages, growth appends a page id to the slot's table, retirement
# zeroes the slot's pages, table row and length so the ids can be reissued.
# All update the pools and tables in place.
# ---------------------------------------------------------------------------


def write_cache_slot_paged(
    cache: tuple, src: tuple, slot: int, row: int, pages, length: int
) -> tuple:
    """Scatter one request's prefill cache into slot ``slot``'s pages.

    ``src`` is a rectangular prefill cache in the list layout with
    ``S_bucket`` rows per leaf; ``row`` picks the request's batch row (a
    bucketed prefill batches several same-bucket requests). ``pages`` is a
    (ceil(S_bucket / page_size),) vector of page ids; entries past the
    request's ``ceil(length / page_size)`` real pages are 0, so pad rows of a
    short prompt land in the scratch page. ``length`` is the request's true
    token count; decode masks everything past it. Returns ``cache``.
    """
    for dst, s in zip(cache_layers(cache), cache_layers(src), strict=True):
        ps = dst.page_size
        pv = torch.as_tensor(pages, dtype=torch.long, device=dst.k.device)
        nbp = pv.shape[0]
        for pool, rows in ((dst.k, s.k), (dst.v, s.v)):
            rows = rows[row].to(pool.dtype)  # (S_bucket, kv, hd)
            pad = nbp * ps - rows.shape[0]
            if pad:
                rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
            # repeated 0 entries all write the scratch page; which one lands
            # there does not matter (it is never read unmasked)
            pool.index_put_((pv,), rows.reshape(nbp, ps, *rows.shape[1:]))
        dst.table[slot].zero_()
        dst.table[slot, :nbp] = pv.to(dst.table.dtype)
        dst.length[slot] = length
    return cache


def append_cache_page(cache: tuple, slot: int, entry: int, page: int) -> tuple:
    """Grow slot ``slot`` by one page: table[slot, entry] = page, all layers.
    The page's stale rows are never read (positions past the slot's length
    are masked), so it is not zeroed."""
    for dst in cache_layers(cache):
        dst.table[slot, entry] = page
    return cache


def free_cache_slot_paged(cache: tuple, slot: int, pages) -> tuple:
    """Retire slot ``slot``: zero its pages, table row and length.

    ``pages`` is the slot's page ids, padded with 0s (re-zeroing the scratch
    page is harmless). Zeroing the rows gives a newly admitted request the
    state a solo run would see, and leaves every other slot's pages bitwise
    untouched. Returns ``cache``.
    """
    for dst in cache_layers(cache):
        pv = torch.as_tensor(pages, dtype=torch.long, device=dst.k.device)
        dst.k[pv] = 0
        dst.v[pv] = 0
        dst.table[slot].zero_()
        dst.length[slot] = 0
    return cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(
    params: LMParams,
    batch: dict,
    analog_cfg: AnalogConfig,
    cfg: ModelConfig,
    rng: Optional[Tensor] = None,
    *,
    mvm: Optional[MvmFn] = None,
) -> tuple[Tensor, dict]:
    """Mean next-token cross-entropy of :func:`lm_forward` (no cache) on
    ``batch`` ({"tokens" or "frames"[, "patches"], "labels"[, "mask"]}) ->
    (loss, {"loss", "ppl_proxy"}), the reference's ``lm_loss``.

    The image-prefix positions of a patch-fed forward carry no loss. The
    logits go to f32; the label's logit is gathered where the reference
    contracts with a one-hot (one nonzero term: the same value and the same
    gradient), over (B, S) labels or a codebook head's (B, S, C); a
    ``mask`` weights each position (trailing axes broadcast), its sum
    clamped at 1. ``mvm`` is :func:`lm_forward`'s.

    Under a sharded training step (``models.common.row_axis``) ``batch``
    holds a data-parallel rank's rows: the per-token loss (and ``mask``) is
    gathered over the rows' axis, an exact concatenation
    (``collectives.gather``: its gradient keeps the rank's rows), and
    reduced as the unsharded loss is, so the loss is bitwise wherever the
    rows are.
    """
    logits, _ = lm_forward(params, batch, analog_cfg, cfg, rng=rng, mvm=mvm)
    if cfg.frontend == "vision_patches" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    logits = logits.float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("mask")
    rows = row_axis()
    if rows is not None:
        bounds = tuple(i * nll.shape[0] for i in range(rows.size + 1))
        nll = collectives.gather(nll, 0, bounds, rows)
        if mask is not None:
            mask = collectives.all_gather_dim(torch.as_tensor(mask, device=nll.device), 0,
                                              bounds, rows)
    if mask is None:
        loss = nll.mean()
    else:
        mask = torch.as_tensor(mask, device=nll.device)
        while mask.dim() < nll.dim():
            mask = mask[..., None]
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    metrics = {"loss": loss, "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    return loss, metrics
