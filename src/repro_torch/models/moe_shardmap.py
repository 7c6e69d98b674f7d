"""shard_map MoE dispatch, port of ``repro.models.moe_shardmap``: manual
all-to-all expert parallelism over the ``model`` axis.

The one-hot einsum dispatch (``models.moe``) costs O(T * S_g * cf * M)
FLOPs. Here each rank

  1. routes its tokens (top-k with capacity, ``moe._topk_routing``) with
     the **local** capacity ``max(1, int(t_loc * k * cf / E))``,
  2. scatters them into an ``(n_model, e_loc, C, M)`` send buffer,
  3. ``all_to_all_single`` over the ``model`` axis delivers every expert's
     tokens to the rank that holds it,
  4. runs its experts' FFN (one B1 expert-bank launch a family over its
     ``e_loc`` experts on a card),
  5. sends the outputs back (a second ``all_to_all_single``) and combines
     them with the gates.

The ranks of one ``model`` group hold the same tokens (the activations are
whole on each), as the reference's shard_map sees them over a mesh whose
tokens ride the data axes only. A rank's noise keys are ``fold_in(key,
rank)``; the always-on shared expert runs outside the exchange. The
per-group capacity of the einsum path drops tokens differently from the
local one (``tests/test_torch_distributed.py``); at a capacity that drops
none (``capacity_factor = E / top_k``) the two agree to rounding. Per-MVM
read-noise resampling is the einsum path's: this one executes the frozen
read draw, as the reference's does. Without a mesh, or where the ``model``
degree does not divide the experts (the bank is then whole on every rank),
it is the einsum path.
"""

from __future__ import annotations

import torch

from repro_torch import collectives, prng
from repro_torch.core import engine as engine_lib
from repro_torch.core.analog import AnalogCtx
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ModelConfig, mesh_axis

Tensor = torch.Tensor


def moe_apply_shardmap(params: dict, x: Tensor, ctx: AnalogCtx, cfg: ModelConfig) -> Tensor:
    """x: (B, S, M) -> (B, S, M); the bank's experts split over ``model``."""
    split = params.get("tp")
    axis = mesh_axis("model")
    if split is None or axis is None:
        return moe_lib.moe_apply(params, x, ctx, cfg)
    n, e, k = split.n, cfg.n_experts, cfg.top_k
    e_loc = e // n
    b, s, m = x.shape
    key = None if ctx.key is None else prng.fold_in(ctx.key, axis.rank)
    ctx_local = AnalogCtx(cfg=ctx.cfg, gain_s=ctx.gain_s, key=key, mvm=ctx.mvm)
    toks = x.reshape(b * s, m)
    t_loc = toks.shape[0]
    cap = max(1, int(t_loc * k * cfg.capacity_factor / e))

    logits = torch.einsum("tm,me->te", toks.float(), params["router"]["w"].float())
    gates = torch.softmax(logits, dim=-1)
    idxs, poss, keeps, gvals = moe_lib._topk_routing(gates[None], k, cap)
    send = torch.zeros((e, cap, m), dtype=x.dtype, device=x.device)
    for idx, pos in zip(idxs, poss):
        ok = pos[0] < cap  # tokens past an expert's capacity are dropped
        send[idx[0][ok], pos[0][ok]] = toks[ok]
    # every rank's tokens for this rank's experts: (source rank, e_loc, C, M)
    recv = collectives.all_to_all(send.reshape(n, e_loc, cap, m), axis)
    recv = recv.permute(1, 0, 2, 3).reshape(e_loc, n * cap, m)
    bank = {name: params[name] for name in ("w1", "w3", "w2", "r_adc", "w_clip_buf")}
    bank["out_scale_buf"] = params.get("out_scale_buf")
    if bank["out_scale_buf"] is None:
        bank.pop("out_scale_buf")
    ye = moe_lib._expert_ffn(bank, recv[:, None], ctx_local, x.dtype,
                             b_adc=engine_lib.bits_of(params.get("b_adc_buf")))[:, 0]
    back = ye.reshape(e_loc, n, cap, m).permute(1, 0, 2, 3)
    back = collectives.all_to_all(back, axis).reshape(e, cap, m)

    # the gate-weighted combine, accumulated in fp32 and rounded to the
    # activation dtype once, as the einsum path's combine contraction is:
    # an fp32 run is the reference's sequence bit for bit, and a bf16 one
    # gives the einsum path's tokens where no token drops
    y = torch.zeros(toks.shape, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, pos, keep, gv in zip(idxs, poss, keeps, gvals):
        picked = back[idx[0], torch.clamp(pos[0], max=cap - 1)].float()
        y = y + torch.where(keep[0][:, None], picked * gv[0][:, None].to(x.dtype).float(), zero)
    y = y.to(x.dtype).reshape(b, s, m)
    if "shared" in params:
        y = y + moe_lib.shared_expert_apply(params, x, ctx)
    return y
