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

from typing import Optional

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
