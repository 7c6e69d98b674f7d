"""Mixture-of-Experts FFN, port of ``repro.models.moe``.

GShard-style capacity routing: tokens are reshaped to ``(G, S_g, M)``
groups, a digital fp32 router picks each token's top-k experts, and each
expert takes at most ``C = S_g * top_k * capacity_factor / E`` tokens of a
group (the rest are dropped). Dispatch and combine are the reference's
one-hot einsums (``moe_dispatch="einsum"``) or its index scatter and
gather (``"scatter"``); the two agree to rounding.

Each expert's SwiGLU (w1, w3, w2) is analog-mapped, one family of the
``(E, K, N)`` bank sharing ``r_adc`` and the clip range (the paper's
per-layer fixed-gain ADC). On a programmed chip a family is ONE
programmed MVM over the whole bank: ``core.analog.analog_matmul_bank``
quantizes the ``(E, G*C, K)`` inputs at once and runs B1's expert-bank
form (``kernels.analog_mvm.analog_mvm_bank``, one launch over every
expert, each expert with its own GDC scalar). The reference vmaps one
expert's function over the bank, so every expert of a family draws from
the same key (one ``next_key`` per family); the other modes run the
experts one at a time from the same key counter, which draws the same.
The router stays digital.

In a sharded training step (``launch.steps.make_train_step(mesh=)``) a
bank split over ``model`` runs the rank's experts forward and the whole
bank's VJP backward (:func:`_experts_sharded`), and a data-parallel rank
routes its rows' groups of the whole batch's (``models.common.row_axis``).
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import engine as engine_lib
from repro_torch.core.analog import (AnalogCtx, analog_matmul_bank, linear_apply, linear_init,
                                     linear_local)
from repro_torch.core.engine import PCM_PROGRAMMED
from repro_torch.models.common import ModelConfig, row_axis

Tensor = torch.Tensor

#: the bank's weight families, in the row order of ``r_adc``, ``w_clip_buf``
#: and ``out_scale_buf``
FAMILIES = ("w1", "w3", "w2")


def moe_init(key: Tensor, cfg: ModelConfig) -> dict:
    """A MoE FFN's params drawn from ``key`` as the reference draws them:
    router N(0, 1/M), the bank's w1/w3 N(0, 1/M) and w2 N(0, 1/H), r_adc 1
    and clip [-1, 1] per family, and a shared expert if the config has one."""
    e, m, h = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = key.device
    k1, k2, k3, kr, ks = prng.split(key, 5)
    s_in, s_h = m**-0.5, h**-0.5
    params = {
        "router": {"w": prng.normal(kr, (m, e)) * s_in},
        "w1": prng.normal(k1, (e, m, h)) * s_in,
        "w3": prng.normal(k3, (e, m, h)) * s_in,
        "w2": prng.normal(k2, (e, h, m)) * s_h,
        "r_adc": torch.ones((3,), dtype=torch.float32, device=dev),
        "w_clip_buf": torch.tensor([[-1.0, 1.0]] * 3, dtype=torch.float32, device=dev),
    }
    if cfg.shared_expert:
        ke1, ke2, ke3 = prng.split(ks, 3)
        params["shared"] = {
            "w1": linear_init(ke1, m, h),
            "w3": linear_init(ke3, m, h),
            "w2": linear_init(ke2, h, m),
        }
    return params


def _expert_ffn(params: dict, x: Tensor, ctx: AnalogCtx, dtype, b_adc=None) -> Tensor:
    """x: (E, G, C, M) -> (E, G, C, M); each expert's SwiGLU, analog-mapped.

    ``out_scale_buf`` (3, E) holds the per-(family, expert) GDC scalars of
    a programmed bank (absent: 1). ``b_adc`` is the bank's ADC bitwidth,
    from its shape-encoded ``b_adc_buf`` when None. A programmed bank with
    ``read_buf`` and a key redraws the read noise of each whole family
    before the experts run, as the reference does.
    """
    scales = params.get("out_scale_buf")
    if b_adc is None:
        b_adc = engine_lib.bits_of(params.get("b_adc_buf"))
    bank = {f: params[f] for f in FAMILIES}
    read_buf = params.get("read_buf")
    split = params.get("tp")  # a sharded chip's bank: the rank's experts
    if (read_buf is not None and ctx.cfg.mode == PCM_PROGRAMMED
            and ctx.cfg.resample_read_noise and ctx.key is not None):
        for fam in FAMILIES:
            bank[fam] = engine_lib.resample_read(ctx.next_key(), read_buf[fam], split).to(
                params[fam].dtype)
    if split is not None and ctx.cfg.mode != PCM_PROGRAMMED:
        return _experts_sharded(params, x, ctx, dtype, b_adc, split)
    if split is not None:
        from repro_torch import collectives
        from repro_torch.core.analog import model_axis

        # the rank's experts on their tokens, every expert's output gathered
        # (an exact concatenation)
        local = dict(params, **bank)
        local.pop("tp")
        local.pop("read_buf", None)
        y = _expert_ffn(local, split.take(x, 0), ctx, dtype, b_adc)
        return collectives.all_gather_dim(y, 0, split.bounds, model_axis(split))
    clip = params["w_clip_buf"]
    e, m = x.shape[0], x.shape[-1]

    def family(i: int, h: Tensor) -> Tensor:
        return analog_matmul_bank(
            h, bank[FAMILIES[i]].to(dtype), r_adc=params["r_adc"][i], w_min=clip[i, 0],
            w_max=clip[i, 1], ctx=ctx, out_scale=None if scales is None else scales[i],
            b_adc=b_adc,
        )

    xf = x.reshape(e, -1, m)
    h = torch.nn.functional.silu(family(0, xf)) * family(1, xf)
    return family(2, h).reshape(x.shape)


def _experts_sharded(params: dict, x: Tensor, ctx: AnalogCtx, dtype, b_adc, split) -> Tensor:
    """A training step's bank on a tensor-parallel rank: forward, the
    rank's experts on their tokens (each drawing what every expert draws,
    from the counter the family starts at) and every expert's output
    gathered; backward, the whole bank's VJP recomputed on the gathered
    banks (``kernels.ops.sharded``), so the ranges', the clip's and S's
    gradients are whole on every rank."""
    from repro_torch import collectives
    from repro_torch.core.analog import model_axis
    from repro_torch.kernels import ops

    start, end, axis = ctx.layer_counter, [ctx.layer_counter], model_axis(split)

    def run(x, w1, w3, w2, r_adc, clip, gain):
        c = AnalogCtx(cfg=ctx.cfg, gain_s=gain, key=ctx.key, layer_counter=start)
        y = _expert_ffn({"w1": w1, "w3": w3, "w2": w2, "r_adc": r_adc, "w_clip_buf": clip},
                        x, c, dtype, b_adc)
        end[0] = c.layer_counter
        return y

    def local(x, *rest):
        return collectives.all_gather_dim(run(split.take(x, 0), *rest), 0, split.bounds, axis)

    bank = (-3, split.bounds)
    y = ops.sharded(local, ops.autograd_vjp(run),
                    (x, params["w1"], params["w3"], params["w2"], params["r_adc"],
                     params["w_clip_buf"], ctx.gain_s),
                    (None, bank, bank, bank, None, None, None), axis)
    ctx.layer_counter = end[0]
    return y


def shared_expert_apply(params: dict, x: Tensor, ctx: AnalogCtx) -> Tensor:
    """The always-on shared expert (llama4-style): a SwiGLU of analog
    linears on every token, added to the routed experts' output."""
    sh = params["shared"]
    u, split = linear_local(sh["w1"], x, ctx)
    g, _ = linear_local(sh["w3"], x, ctx)
    return linear_apply(sh["w2"], torch.nn.functional.silu(u) * g, ctx, split)


def one_hot(idx: Tensor, n: int, dtype) -> Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_routing(gates: Tensor, k: int, cap: int):
    """Iterative top-k with per-expert capacity. gates: (G, Sg, E).

    Returns per-choice lists of the expert index (G, Sg), the buffer slot
    (G, Sg; unclamped, a slot >= ``cap`` is a dropped token), the keep mask
    (G, Sg) and the gate value (G, Sg). Ties go to the lowest expert index,
    as ``jnp.argmax`` breaks them.
    """
    g, _, e = gates.shape
    idxs, poss, keeps, gvals = [], [], [], []
    gates_left = gates
    fills = torch.zeros((g, e), dtype=torch.int64, device=gates.device)
    for _ in range(k):
        idx = torch.argmax(gates_left, dim=-1)
        onehot = one_hot(idx, e, torch.int64)
        pos_e = torch.cumsum(onehot, dim=1) - onehot + fills[:, None, :]
        pos = torch.gather(pos_e, -1, idx[..., None])[..., 0]
        idxs.append(idx)
        poss.append(pos)
        keeps.append(pos < cap)
        gvals.append(torch.gather(gates, -1, idx[..., None])[..., 0])
        fills = fills + onehot.sum(dim=1)
        gates_left = gates_left * (1.0 - onehot.to(gates.dtype))
    return idxs, poss, keeps, gvals


def capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int, int]:
    """(groups G, tokens a group S_g, slots an expert takes a group C) for
    ``tokens`` tokens: the largest G <= ``moe_groups`` dividing them."""
    g = min(cfg.moe_groups, tokens)
    while tokens % g:
        g -= 1
    sg = tokens // g
    return g, sg, max(1, int(sg * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def moe_apply(params: dict, x: Tensor, ctx: AnalogCtx, cfg: ModelConfig) -> Tensor:
    """x: (B, S, M) -> (B, S, M).

    On a data-parallel rank's rows (``row_axis``) the routing groups are
    the rank's groups of the whole batch's; where the whole batch's groups
    do not split over the ranks, every rank gathers the rows, runs the
    whole batch's layer and keeps its rows (``collectives.gather`` and
    ``own_slice``). Backward, a rank's rows' gradient goes back through
    the whole batch's layer in zeros: a token's input gradient comes from
    its own output's alone (routing and capacity take no gradient, and
    every other op acts on one token), and the weights get the rank's
    rows' part, which ``training.loop.value_and_grad`` sums over ``data``
    as it sums every layer's."""
    rows = row_axis()
    b, s = x.shape[:2]
    if rows is None or capacity(cfg, b * s * rows.size)[0] % rows.size == 0:
        return _moe_apply(params, x, ctx, cfg, rows)
    from repro_torch import collectives
    from repro_torch.models.common import current_mesh, logical_rules, logical_rules_of

    bounds = tuple(i * b for i in range(rows.size + 1))
    whole = collectives.gather(x, 0, bounds, rows)
    rules = {k: v for k, v in logical_rules().items() if k != "rows"}
    with logical_rules_of(rules, current_mesh()):  # the whole batch's draws
        y = _moe_apply(params, whole, ctx, cfg, None)
    return collectives.own_slice(y, 0, bounds, rows)


def _moe_apply(params: dict, x: Tensor, ctx: AnalogCtx, cfg: ModelConfig, rows) -> Tensor:
    b, s, m = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dtype = x.dtype
    if rows is None:
        g, sg, cap = capacity(cfg, b * s)
    else:  # a data-parallel rank's rows: its groups of the whole batch's
        g, sg, cap = capacity(cfg, b * s * rows.size)
        g //= rows.size
    xt = x.reshape(g, sg, m)

    # the router: digital, fp32
    logits = torch.einsum("gsm,me->gse", xt.float(), params["router"]["w"].float())
    gates = torch.softmax(logits, dim=-1)
    idxs, poss, keeps, gvals = _topk_routing(gates, k, cap)

    if cfg.moe_dispatch == "scatter":
        # index dispatch: a scatter into the expert buffers and a gather
        # back, the one-hot contractions' values without their FLOPs
        xe = torch.zeros((e, g, cap, m), dtype=dtype, device=x.device)
        gi = torch.arange(g, device=x.device)[:, None].expand(g, sg)
        for idx_k, pos_k in zip(idxs, poss):
            ok = pos_k < cap  # out-of-capacity slots are dropped
            xe[idx_k[ok], gi[ok], pos_k[ok]] = xt[ok]
        ye = _expert_ffn(params, xe, ctx, dtype)
        y = torch.zeros_like(xt)
        for idx_k, pos_k, keep_k, gv in zip(idxs, poss, keeps, gvals):
            picked = ye[idx_k, gi, torch.clamp(pos_k, max=cap - 1)]
            y = y + torch.where(keep_k[..., None], picked * gv[..., None].to(dtype),
                                torch.zeros((), dtype=dtype, device=x.device))
    else:
        # the GShard one-hot einsums: dispatch (G, Sg, E, C) x (G, Sg, M)
        # -> (E, G, C, M), and the gate-weighted combine back
        dispatch = torch.zeros((g, sg, e, cap), dtype=dtype, device=x.device)
        combine = torch.zeros((g, sg, e, cap), dtype=torch.float32, device=x.device)
        for idx, pos, keep, gv in zip(idxs, poss, keeps, gvals):
            e_oh = one_hot(idx, e, torch.float32) * keep[..., None]
            oh = e_oh[..., :, None] * one_hot(pos, cap, torch.float32)[..., None, :]
            dispatch = dispatch + oh.to(dtype)
            combine = combine + oh * gv[..., None, None]
        xe = torch.einsum("gsec,gsm->egcm", dispatch, xt)
        ye = _expert_ffn(params, xe, ctx, dtype)
        y = torch.einsum("gsec,egcm->gsm", combine.to(dtype), ye)

    if "shared" in params:
        y = y + shared_expert_apply(params, xt, ctx)
    return y.reshape(b, s, m)


def aux_load_balance_loss(logits: Tensor, dispatch: Tensor) -> Tensor:
    """Switch-style auxiliary loss (kept for training completeness)."""
    gates = torch.softmax(logits, dim=-1)
    density = dispatch.sum(dim=-1).mean(dim=(0, 1))  # per-expert usage
    density_proxy = gates.mean(dim=(0, 1))
    return gates.shape[-1] * torch.sum(density * density_proxy)
