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
never took the plain version on the card. The training form takes a
quant-noise ``keep`` mask and rounds straight-through, so autograd of it is
the reference's VJP (``kernels.ops``' STE function differentiates
:func:`analog_mvm_plain`, the same body uncounted). :func:`analog_mvm_bank_plain` is the expert-bank
form's (the 2-D version expert by expert). The module also holds the plain
versions of the other kernels: :func:`decode_fused_ref` (the fused decode
step) and :func:`flash_attention_ref` (the prefill attention; its body
:func:`flash_attention_plain` uncounted, for the attention's training
form), each with its own ``calls`` counter.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import fake_quant

Tensor = torch.Tensor

NEG_INF = -1e30


def tile_mvm(
    x_f32: Tensor,
    w: Tensor,
    r_adc: Tensor,
    b_adc: int,
    tile_rows: int,
    per_tile_adc: bool,
    out_scale,
    out_dtype: torch.dtype,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """Per-tile ADC MVM on an fp32 input; the arithmetic both plain entry
    points share. A ragged last tile is quantized over its real rows.

    ``keep`` is the training form's quant-noise mask, (M, T, N) over the
    flattened rows of x (T = 1 for one ADC conversion over all of K): an
    ADC'd partial becomes ``where(keep, q(p), p)``. The rounding is
    straight-through, so autograd of this function is the reference's VJP;
    without a mask the values are the serving function's, bit for bit.
    """
    k = w.shape[0]
    wf = w.float()
    lead = x_f32.shape[:-1]
    if keep is not None:
        keep = keep.reshape(*lead, keep.shape[-2], keep.shape[-1]).bool()

    def adc(p, t):
        q = fake_quant(p, r_adc, b_adc)
        return q if keep is None else torch.where(keep[..., t, :], q, p)

    if not per_tile_adc or k <= tile_rows:
        y = adc(x_f32 @ wf, 0)
        return (y * out_scale).to(out_dtype)
    y = None
    for t, lo in enumerate(range(0, k, tile_rows)):
        part = adc(x_f32[..., lo:lo + tile_rows] @ wf[lo:lo + tile_rows], t)
        # quantized partials are stored at the activation dtype and summed
        # tile-serially (t = 0..T-1) in fp32
        part = part.to(out_dtype).float()
        y = part if y is None else y + part
    return (y * out_scale).to(out_dtype)


def n_tiles(k: int, tile_rows: int, per_tile_adc: bool) -> int:
    """T of a keep mask: the ADC conversions per output element."""
    return -(-k // tile_rows) if per_tile_adc and k > tile_rows else 1


def analog_mvm_plain(
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
    keep: Optional[Tensor] = None,
) -> Tensor:
    """:func:`analog_mvm_ref` without its count: the body the STE
    function's backward recomputes (``kernels.ops``)."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} x {tuple(w.shape)}")
    x_q = x.float()
    if apply_dac:
        x_q = fake_quant(x_q, r_dac, b_dac)
    return tile_mvm(
        x_q, w, r_adc, b_adc, tile_rows, per_tile_adc, out_scale, x.dtype, keep
    )


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
    keep: Optional[Tensor] = None,
) -> Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in x's dtype, fp32 accumulation;
    ``keep`` (M, T, N): the training form's quant-noise mask
    (:func:`tile_mvm`)."""
    analog_mvm_ref.calls += 1
    return analog_mvm_plain(
        x, w, r_dac, r_adc, out_scale, b_dac=b_dac, b_adc=b_adc,
        tile_rows=tile_rows, per_tile_adc=per_tile_adc, apply_dac=apply_dac,
        keep=keep,
    )


#: calls since process start
analog_mvm_ref.calls = 0


def analog_mvm_bank_plain(
    x: Tensor,
    w: Tensor,
    r_adc,
    out_scale=1.0,
    *,
    b_adc: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """Plain version of B1's expert-bank form: x (E, M, K) already
    DAC-quantized, w (E, K, N), ``out_scale`` a float or the (E,) GDC
    scalars, ``keep`` the training form's (E, M, T, N) mask -> (E, M, N):
    the 2-D plain version (:func:`analog_mvm_plain`, no DAC) expert by
    expert, so each expert's slice is bitwise the 2-D call on it."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"bank shapes {tuple(x.shape)} x {tuple(w.shape)}")
    per = (out_scale.dim() > 0) if isinstance(out_scale, Tensor) else False
    return torch.stack([
        analog_mvm_plain(x[e], w[e], None, r_adc, out_scale[e] if per else out_scale,
                         b_adc=b_adc, tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                         apply_dac=False, keep=None if keep is None else keep[e])
        for e in range(x.shape[0])
    ])


def analog_mvm_bank_ref(x: Tensor, w: Tensor, r_adc, out_scale=1.0, **kw) -> Tensor:
    """:func:`analog_mvm_bank_plain`, counted in ``calls``."""
    analog_mvm_bank_ref.calls += 1
    return analog_mvm_bank_plain(x, w, r_adc, out_scale, **kw)


#: calls since process start
analog_mvm_bank_ref.calls = 0


def decode_fused_ref(
    tab: Tensor,
    h0: Tensor,
    lens: Tensor,
    n1: Tensor,
    n2: Tensor,
    stacks: list,
    w_head: Tensor,
    fin: Tensor,
    kc: Tensor,
    vc: Tensor,
    *,
    plan,
    cfg,
    taps: Optional[dict] = None,
) -> Tensor:
    """Plain version of the fused decode kernel (``csrc/decode_fused.cu``).

    One decode step of B slots over the stacked cache, from the port's own
    ops in ``models.lm._block_apply``'s order and shapes, so on the CPU it
    is bitwise the per-layer ``lm_forward`` decode. Arguments are the
    kernel's: ``tab`` the (L+1, 7, 3) f32 table of [r_adc, w_max,
    out_scale] (``gain_s`` at [L, 1, 0]), ``h0`` the embedded tokens (B, 1,
    D), ``lens`` the (B,) int32 slot lengths, ``n1``/``n2`` (L, D) and
    ``fin`` (D,) norm scales, ``stacks`` the seven (L, K, N) weight stacks
    in ``FUSED_PROJS`` order, ``w_head`` (D, V), ``kc``/``vc`` the (L, B,
    S, kv, hd) cache. Each slot's K/V row is written in place at
    ``min(length, S - 1)``, as the per-layer path clamps it (retired slots
    keep stepping). Returns the logits (B, 1, V). ``taps``, when given,
    receives the lm_head's DAC-quantized input as ``"head_x_q"`` (B, 1, D).
    """
    # models.attention and core.engine import this module: import late
    from repro_torch.core import engine
    from repro_torch.core.quant import dac_quantize
    from repro_torch.models.attention import KVCache, decode_attention
    from repro_torch.models.common import rmsnorm_apply, rope

    decode_fused_ref.calls += 1
    n_groups = plan.n_groups
    gain_s = tab[n_groups, 1, 0]
    b = h0.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_max = kc.shape[2]
    positions = lens.long()[:, None]  # (B, 1): each slot's own position
    rows = torch.arange(b, device=h0.device)
    idx = lens.clamp(max=s_max - 1).long()

    def proj(h, w, row, p, pplan):
        # analog_matmul's pcm_programmed execute, from the table's scalars
        x_q = dac_quantize(h, tab[row, p, 0], gain_s, tab[row, p, 1], pplan.spec)
        x_q = x_q.to(h.dtype)
        if taps is not None and row == n_groups:
            taps["head_x_q"] = x_q
        return engine.tile_matmul_quant(
            x_q, w.to(x_q.dtype), tab[row, p, 0], pplan.spec,
            pplan.tile_rows, pplan.per_tile_adc, tab[row, p, 2],
        ).to(h.dtype)

    x = h0
    pp = plan.proj_plans
    for g in range(n_groups):
        w = [s[g] for s in stacks]
        h = rmsnorm_apply({"scale": n1[g]}, x, cfg.norm_eps)
        q = proj(h, w[0], g, 0, pp[0]).reshape(b, 1, nh, hd)
        k = proj(h, w[1], g, 1, pp[1]).reshape(b, 1, nkv, hd)
        v = proj(h, w[2], g, 2, pp[2]).reshape(b, 1, nkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kc[g].index_put_((rows, idx), k[:, 0].to(kc.dtype))
        vc[g].index_put_((rows, idx), v[:, 0].to(vc.dtype))
        out = decode_attention(q, KVCache(kc[g], vc[g], lens + 1))
        x = x + proj(out.reshape(b, 1, nh * hd), w[3], g, 3, pp[3])
        h = rmsnorm_apply({"scale": n2[g]}, x, cfg.norm_eps)
        ff = torch.nn.functional.silu(proj(h, w[4], g, 4, pp[4])) * proj(
            h, w[5], g, 5, pp[5]
        )
        x = x + proj(ff, w[6], g, 6, pp[6])
    h = rmsnorm_apply({"scale": fin}, x, cfg.norm_eps)
    return proj(h, w_head, n_groups, 0, plan.head_plan)


#: calls since process start
decode_fused_ref.calls = 0


def flash_attention_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    *,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    window: Optional[int] = None,
) -> Tensor:
    """:func:`flash_attention_plain`, counted in ``flash_attention_ref.calls``."""
    flash_attention_ref.calls += 1
    return flash_attention_plain(q, k, v, causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                 q_offset=q_offset, window=window)


def flash_attention_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    *,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    window: Optional[int] = None,
) -> Tensor:
    """Plain version of the prefill-attention kernel (``csrc/flash_attention.cu``):
    online-softmax attention over (q_chunk, kv_chunk) blocks, the port of the
    reference's ``models.attention.chunked_attention`` (the chunks default
    to ``ModelConfig``'s).

    q: (B, Sq, H, D); k, v: (B, Sk, Kv, D); query head h reads KV head
    ``h // (H / Kv)``. Returns (B, Sq, H, D) in q's dtype. Scores are f32
    products scaled by D^-0.5 after QK^T; masked positions are ``NEG_INF``
    and add exact zeros; p is cast to v's dtype before PV; m, l and acc
    stay f32; the output is ``acc / max(l, 1e-30)``. ``window`` (local
    attention) masks keys with ``q_pos - k_pos >= window`` too; a row's
    wholly masked leading chunks form p = 1 against m = ``NEG_INF``, which
    the first live chunk's alpha = 0 wipes, as in the reference. ``kv_chunk`` is never
    clamped to the sequence, so the outputs at real positions are bitwise
    independent of right-padding. Differentiable: the training form's
    backward (``kernels.ops.flash_attention_ste``) recomputes it, uncounted.
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
        qg = qc.reshape(b, q_chunk, kvh, g, d).float()
        q_pos = q_offset + qi * q_chunk + q_pos_base
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, d), device=dev)
        for ki in range(sk_p // kv_chunk):
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            # (B, Kv, G, qc, kc) f32
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float()) * scale
            k_pos = ki * kv_chunk + k_pos_base
            mask = (k_pos[None, :] < sk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
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


#: calls since process start
flash_attention_ref.calls = 0
