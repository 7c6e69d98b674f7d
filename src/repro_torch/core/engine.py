"""Program-once / execute-many engine, port of ``repro.core.engine``.

Two phases, as on the AON-CiM accelerator (paper Sec. 5):

  1. **Program phase** (:func:`compile_program`) -- every analog layer's
     weights are written into PCM once: programming noise is drawn here and
     frozen; drift and read noise are evaluated at the program's age. The
     unsharded program phase draws through the RNG bridge
     (``repro_torch.prng``) with the reference's keys, so the same key
     programs the reference's chip bit for bit. :meth:`CiMProgram.drift_to`
     and :func:`age_program` re-evaluate the same devices at a later age.
  2. **Execute phase** (:func:`execute_mvm`) -- DAC-quantized inputs against
     the programmed effective weights: tiled MVM, per-tile ADC, digital
     accumulation, GDC ``out_scale``. On a CUDA tensor it always launches
     the Hopper kernel; on a CPU tensor it runs the plain
     :func:`tile_matmul_quant`. Where gradients are needed or a
     quant-noise key is given (``analog_train``), it goes through the STE
     function ``kernels.ops.analog_mvm_ste`` -- B1 forward on a card, the
     plain training form's VJP backward. ``ExecutionPlan.use_kernel`` and
     ``interpret`` are kept for artifact parity and do not choose the
     device (``analog_train`` reads ``use_kernel`` as the reference does:
     whether the ADC quant noise is drawn).

:func:`build_fused_plan` lowers a compiled program's per-layer plans to the
static :class:`FusedDecodePlan` that ``kernels.decode_fused`` executes as
one launch per decode step.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import math
import threading
from typing import Any, Callable, Mapping as MappingT, Optional, Union

import torch

from repro_torch import collectives, prng
from repro_torch.core import crossbar
from repro_torch.core import pcm as pcm_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.quant import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import n_tiles, tile_mvm

Tensor = torch.Tensor

#: AnalogConfig.mode for inference against a compiled CiMProgram.
PCM_PROGRAMMED = "pcm_programmed"

# per-layer programming events since process start (the program-once
# contract: serving a compiled chip adds zero); a fleet refreshes its chips
# from worker threads, so the count is bumped under a lock
_PROGRAM_EVENTS = {"layers": 0}
_PROGRAM_EVENTS_LOCK = threading.Lock()


def program_event_count() -> int:
    """Number of per-layer PCM programming events since process start."""
    return _PROGRAM_EVENTS["layers"]


def record_program_event() -> None:
    with _PROGRAM_EVENTS_LOCK:
        _PROGRAM_EVENTS["layers"] += 1


# ---------------------------------------------------------------------------
# Execution plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static per-layer execution plan for the unified MVM hot path."""

    k: int
    n: int
    tile_rows: int
    tile_cols: int
    per_tile_adc: bool
    spec: QuantSpec
    use_kernel: bool
    interpret: bool


@functools.lru_cache(maxsize=4096)
def plan_for(cfg, k: int, n: int, b_adc: Optional[int] = None) -> ExecutionPlan:
    """The (cached) static execution plan of a (K, N) layer; ``b_adc``
    overrides the config's bitwidth (validated against {4, 6, 8})."""
    spec = cfg.spec
    if b_adc is not None and b_adc != spec.b_adc:
        quant_lib.validate_b_adc(b_adc, "per-layer b_adc override")
        spec = dataclasses.replace(spec, b_adc=int(b_adc))
    return ExecutionPlan(
        k=k, n=n, tile_rows=cfg.tile_rows, tile_cols=cfg.tile_cols,
        per_tile_adc=cfg.per_tile_adc, spec=spec,
        use_kernel=cfg.use_kernel, interpret=cfg.interpret,
    )


# ---------------------------------------------------------------------------
# Per-layer ADC bitwidths: shape-encoded ``b_adc_buf`` leaves, as in the
# reference (the bitwidth is the buffer's trailing dimension)
# ---------------------------------------------------------------------------

BitOverrides = Union[MappingT[str, int], tuple]


def normalize_b_adc_overrides(overrides: Optional[BitOverrides]) -> tuple:
    """Normalize overrides to a ((pattern, bits), ...) tuple; validate bits."""
    if not overrides:
        return ()
    items = (
        tuple(overrides.items())
        if isinstance(overrides, MappingT)
        else tuple(tuple(it) for it in overrides)
    )
    for pat, bits in items:
        quant_lib.validate_b_adc(int(bits), f"b_adc override for {pat!r}")
    return tuple((str(p), int(b)) for p, b in items)


def resolve_b_adc(overrides: tuple, path: str, default: int) -> int:
    """Bitwidth for ``path``: last matching override pattern wins."""
    bits = default
    for pat, b in overrides:
        if path == pat or fnmatch.fnmatchcase(path, pat):
            bits = b
    return bits


def b_adc_buf(stack: tuple, bits: int, device=None) -> Tensor:
    """Shape-encoded per-layer bitwidth buffer (values double as a record)."""
    return torch.full(
        tuple(stack) + (int(bits),), int(bits), dtype=torch.int8, device=device
    )


def bits_of(buf: Optional[Tensor]) -> Optional[int]:
    """Bitwidth of a ``b_adc_buf`` leaf (or None when absent)."""
    return None if buf is None else int(buf.shape[-1])


# ---------------------------------------------------------------------------
# Execute phase
# ---------------------------------------------------------------------------


def execute_digital(x: Tensor, w: Tensor) -> Tensor:
    """Digital baseline MVM (mode == "digital"): x's rows folded into one
    (M, K) product, as ``torch.matmul`` folds a contiguous x -- whatever
    strides x's size-1 dims carry (a fake tensor's may differ from a real
    one's there, and ``matmul`` would then batch the product)."""
    return torch.matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype)).reshape(
        *x.shape[:-1], w.shape[-1])


def tile_matmul_quant(
    x: Tensor,
    w: Tensor,
    r_adc: Tensor,
    spec: QuantSpec,
    tile_rows: int,
    per_tile_adc: bool,
    out_scale=1.0,
    *,
    qn_key: Optional[Tensor] = None,
) -> Tensor:
    """Plain execute: per-row-tile ADC quant + tile-serial digital sum.

    x: (..., K), w: (K, N) in x's dtype. Products accumulate in fp32 (an
    exact widening of bf16 operands), each tile's partial is ADC-quantized,
    rounded to x's dtype and summed tile by tile; ``out_scale`` (the GDC
    factor) multiplies the sum. With ``qn_key`` each ADC'd value is
    quant-noise masked (:func:`quant_noise_keep`). Differentiable (the
    rounding is straight-through). ``tile_matmul_quant.calls`` counts calls.
    """
    tile_matmul_quant.calls += 1
    k, n = w.shape
    keep = quant_noise_keep(qn_key, spec, x.shape[:-1], k, n, tile_rows, per_tile_adc,
                            x.device)
    return tile_mvm(
        x.float(), w, r_adc, spec.b_adc, tile_rows, per_tile_adc, out_scale,
        x.dtype, keep,
    )


tile_matmul_quant.calls = 0


def tile_sum(parts: Tensor, out_scale, out_dtype: torch.dtype) -> Tensor:
    """The one chip's tile-serial sum of ADC'd tile partials (T, ..., N),
    each stored at the activation dtype: summed t = 0..T-1 in fp32, then
    ``out_scale``, then the activation dtype -- :func:`tile_matmul_quant`'s
    rounding points, so a row-parallel layer's gathered partials give the
    unsharded layer's bits."""
    y = parts[0].float()
    for t in range(1, parts.shape[0]):
        y = y + parts[t].float()
    return (y * out_scale).to(out_dtype)


def quant_noise_keep(qn_key: Optional[Tensor], spec: QuantSpec, lead: tuple, k: int, n: int,
                     tile_rows: int, per_tile_adc: bool, device, *, row0: int = 0,
                     split=None) -> Optional[Tensor]:
    """The ADC quant-noise mask of one MVM as the reference draws it
    (``quant.quant_noise`` over y's shape: ``(*lead, N)`` for one ADC
    conversion, ``(*lead, T, N)`` per tile), as the (M, T, N) ``keep`` of
    the training form (the flat order is the same). None without a key or
    at ``quant_noise_p >= 1``.

    A shard's slice of the whole MVM's mask: ``row0``, the first of the
    whole draw's M rows that ``lead`` holds (a data-parallel rank's rows);
    ``split`` (``launch.sharding.Split``), the layer is a rank's columns
    (-> its columns of the mask) or whole tiles of its K rows (-> its tiles)
    of the whole ``k`` x ``n`` layer."""
    if qn_key is None or spec.quant_noise_p >= 1.0:
        return None
    t = n_tiles(k, tile_rows, per_tile_adc)
    if row0 == 0 and split is None:
        shape = (*lead, n) if t == 1 else (*lead, t, n)
        return prng.bernoulli(qn_key.to(device), spec.quant_noise_p, shape).reshape(-1, t, n)
    m = math.prod(lead)
    t_loc, n_loc, off, stride = t, n, row0 * t * n, None
    shape = (m, t * n)
    if split is not None and split.dim == -1:  # rows of the draw: (m, t) pairs
        n_loc, off, stride = split.stop - split.start, off + split.start, n
        shape = (m * t, n_loc)
    elif split is not None:  # whole tiles of K
        t0 = split.start // tile_rows
        t_loc = -(-split.stop // tile_rows) - t0
        off, stride = off + t0 * n, t * n
        shape = (m, t_loc * n)
    mask = prng.bernoulli(qn_key.to(device), spec.quant_noise_p, shape, off, stride)
    return mask.reshape(-1, t_loc, n_loc)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in ts
    )


def execute_mvm(
    x_q: Tensor,
    w_eff: Tensor,
    r_adc: Tensor,
    plan: ExecutionPlan,
    *,
    out_scale=1.0,
    qn_key: Optional[Tensor] = None,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """Unified execute-phase MVM: pre-quantized inputs x effective weights.

    A CUDA tensor launches the Hopper kernel (``r_adc`` is passed as is: the
    ADC quantizer takes |r_adc| itself); a CPU tensor runs the plain
    :func:`tile_matmul_quant`. Where a gradient is needed, or ``qn_key``
    draws an ADC quant-noise mask (or ``keep`` is one already drawn: a
    data-parallel rank's rows of it), the call goes through the STE function
    ``kernels.ops.analog_mvm_ste`` (B1 with the mask on a card; the plain
    training form on the CPU; the VJP of the plain training form backward).
    """
    if x_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"execute_mvm: unsupported device {x_q.device}")
    if keep is None:
        keep = quant_noise_keep(qn_key, plan.spec, x_q.shape[:-1], plan.k, plan.n,
                                plan.tile_rows, plan.per_tile_adc, x_q.device)
    if keep is not None or _needs_grad(x_q, w_eff, r_adc, out_scale):
        return kernel_ops.analog_mvm_ste(
            x_q, w_eff, r_adc=r_adc, out_scale=out_scale, bits=plan.spec.b_adc,
            tile_rows=plan.tile_rows, per_tile_adc=plan.per_tile_adc, keep=keep,
        )
    if build.on_card(x_q):
        return kernel_ops.analog_mvm(
            x_q, w_eff, r_adc=r_adc, out_scale=out_scale,
            bits=plan.spec.b_adc, tile_rows=plan.tile_rows,
            per_tile_adc=plan.per_tile_adc,
        )
    # the plain version is the same unit of work as the kernel's call
    return kernel_ops.b1_unit(lambda: execute_mvm_plain(x_q, w_eff, r_adc, plan,
                                                        out_scale=out_scale),
                              (), (x_q, w_eff, r_adc, out_scale))


def execute_mvm_plain(
    x_q: Tensor,
    w_eff: Tensor,
    r_adc: Tensor,
    plan: ExecutionPlan,
    *,
    out_scale=1.0,
    qn_key: Optional[Tensor] = None,
) -> Tensor:
    """:func:`execute_mvm` through the plain version on any device (for a
    check that holds a whole forward on the card against the kernel);
    differentiable, so it also gives a training step's plain gradients."""
    return tile_matmul_quant(
        x_q, w_eff, r_adc, plan.spec, plan.tile_rows, plan.per_tile_adc,
        out_scale, qn_key=qn_key,
    )


def execute_mvm_bank(
    x_q: Tensor,
    w_eff: Tensor,
    r_adc: Tensor,
    plan: ExecutionPlan,
    *,
    out_scale=1.0,
) -> Tensor:
    """:func:`execute_mvm` over an expert bank, one family of a MoE layer:
    x_q (E, T, K) pre-quantized, w_eff (E, K, N), ``out_scale`` a float or
    the (E,) GDC scalars -> (E, T, N). A CUDA tensor launches B1's bank
    form (``kernels.analog_mvm.analog_mvm_bank``: one launch for every
    expert), a CPU tensor runs its plain version (the 2-D plain version
    expert by expert, so each expert's rows are bitwise :func:`execute_mvm`'s
    on its slice). Where a gradient is needed the experts go through
    :func:`execute_mvm` one at a time."""
    e = w_eff.shape[0]
    scale = lambda i: out_scale[i] if isinstance(out_scale, Tensor) and out_scale.dim() else out_scale
    if _needs_grad(x_q, w_eff, r_adc, out_scale):
        return torch.stack([execute_mvm(x_q[i], w_eff[i], r_adc, plan, out_scale=scale(i))
                            for i in range(e)])
    if x_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"execute_mvm_bank: unsupported device {x_q.device}")
    return kernel_ops.analog_mvm_bank(
        x_q, w_eff, r_adc=r_adc, out_scale=out_scale, bits=plan.spec.b_adc,
        tile_rows=plan.tile_rows, per_tile_adc=plan.per_tile_adc,
    )


# ---------------------------------------------------------------------------
# Program phase (unsharded), keyed as the reference
#
# Each stack member (one layer of a stacked group) gets its own threefry key,
# ``split(layer key, n_members)``; its programming draws come from
# ``split(member key)`` and its drift and read draws from
# ``split(member key, 4)``. The member key is kept in the state, so a later
# age re-evaluation redraws the same devices.
# ---------------------------------------------------------------------------


#: elements of a member the program phase's elementwise chains take at
#: once. Their exact arithmetic (f64 FMAs, glibc's powf in f64 and int64)
#: holds ~230 bytes of temporaries a weight on a card, so a larger member
#: (qwen2-72b's lm_head: 1.25 B weights) is programmed, drifted and read in
#: row chunks: each chunk's draws over its own flat counters
#: (``prng.normal(offset=)``), ``det_sum`` from the chunks' summed limbs and
#: the weight scale from their maxima, so the chip is bitwise the one-pass
#: chip
_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class _Block:
    """Where a rank's (K_loc, N_loc) slice of a sharded member lies in the
    member: its first row ``k0`` and column ``c0`` and the member's width
    ``n`` (the counters' row stride); the member's whole-block reductions
    (the weight scale's max, ``det_sum``'s limbs) run over ``axis``."""

    k0: int
    c0: int
    n: int
    axis: Any


def _block_of(split, n_local: int, axis) -> Optional[_Block]:
    """The :class:`_Block` of a layer's ``launch.sharding.Split`` (None:
    the rank holds whole members -- unsharded, or a bank's experts)."""
    if split is None or split.dim not in (-1, -2):
        return None
    if split.dim == -1:
        return _Block(0, split.start, split.size, axis)
    return _Block(split.start, 0, n_local, axis)


def _chunks(k: int, n: int, blk: Optional[_Block] = None) -> list:
    """(row slice, flat counter of its first element, row stride of the
    counters or None) of each row chunk of a (K, N) member, or of a rank's
    block of one."""
    rows = max(1, _CHUNK // max(n, 1))
    if blk is None:
        return [(slice(r0, min(r0 + rows, k)), r0 * n, None) for r0 in range(0, k, rows)]
    return [(slice(r0, min(r0 + rows, k)), (blk.k0 + r0) * blk.n + blk.c0, blk.n)
            for r0 in range(0, k, rows)]


def _max_over(t: Tensor, blk: Optional[_Block]) -> Tensor:
    return t if blk is None else collectives.all_reduce_max(t, blk.axis)


def _limbs_over(limbs: Tensor, blk: Optional[_Block]) -> Tensor:
    return limbs if blk is None else collectives.all_reduce_sum_int(limbs, blk.axis)


def _f32_block(like: Tensor) -> Tensor:
    return torch.empty(like.shape[-2:], dtype=torch.float32, device=like.device)


def _program_2d(key: Tensor, w: Tensor, w_min, w_max, cfg: pcm_lib.PCMConfig,
                out: Optional[dict] = None, blk: Optional[_Block] = None) -> dict:
    """Program one (K, N) block: write noise drawn HERE, chunk by chunk
    (:data:`_CHUNK`). ``out``: (K, N) tensors to write ``g_pos``, ``g_neg``,
    ``q_pos`` and ``q_neg`` into (new ones when None). ``blk``: ``w`` is a
    rank's block of the member; its draws take the member's counters, and
    the weight scale and ``det_sum`` are the whole member's (an f32 MAX and
    an integer SUM over the ranks, both exact)."""
    # the reference clips in f32 (f32 bounds promote a bf16 weight)
    clip = lambda part: torch.minimum(torch.maximum(part.float(), w_min), w_max)
    chunks = _chunks(*w.shape, blk)
    # weights_to_conductances's scale, max |w_c| + 1e-12, from the chunks' maxima
    w_scale = _max_over(torch.stack([clip(w[rows]).abs().max() for rows, _, _ in chunks]).max(),
                        blk) + 1e-12
    k_pp, k_pn = prng.split(key)
    out = out or {name: _f32_block(w) for name in ("g_pos", "g_neg", "q_pos", "q_neg")}
    limbs = 0
    for rows, off, stride in chunks:
        g_pos_t, g_neg_t = pcm_lib.split_conductances(clip(w[rows]), w_scale)
        out["g_pos"][rows] = pcm_lib.program(k_pp, g_pos_t, cfg, off, stride)
        out["g_neg"][rows] = pcm_lib.program(k_pn, g_neg_t, cfg, off, stride)
        out["q_pos"][rows] = pcm_lib.read_noise_q(g_pos_t)
        out["q_neg"][rows] = pcm_lib.read_noise_q(g_neg_t)
        limbs = limbs + pcm_lib.det_limbs(g_pos_t + g_neg_t)
    return {**out, "gt_sum": pcm_lib.det_total(_limbs_over(limbs, blk)), "w_scale": w_scale,
            "key": key}


def _drifted_chunk(state: dict, rows: slice, off: int, stride, t,
                   cfg: pcm_lib.PCMConfig) -> tuple:
    """(g_pos, g_neg, their pair sum the GDC reads or None) of a row chunk
    drifted to age ``t`` (no read draw)."""
    g_pos, g_neg = state["g_pos"][rows], state["g_neg"][rows]
    if not cfg.drift:
        return g_pos, g_neg, g_pos + g_neg if cfg.gdc else None
    k_dp, k_dn = prng.split(state["key"], 4)[:2]
    f_p = pcm_lib.drift_factor(pcm_lib.sample_drift_nu(k_dp, g_pos.shape, cfg, off, stride), t)
    f_n = pcm_lib.drift_factor(pcm_lib.sample_drift_nu(k_dn, g_neg.shape, cfg, off, stride), t)
    # the reference's compiler fuses the first drift product into the pair
    # sum it feeds
    g_sum = prng.fma(g_pos, f_p, g_neg * f_n) if cfg.gdc else None
    return g_pos * f_p, g_neg * f_n, g_sum


def _drift_read_2d(state: dict, t, cfg: pcm_lib.PCMConfig, out: Optional[Tensor] = None,
                   blk: Optional[_Block] = None):
    """Evaluate programmed conductances at age ``t`` -> (w_eff, gdc), chunk
    by chunk; ``out``: the (K, N) tensor to write w_eff into; ``blk`` as in
    :func:`_program_2d` (the GDC from the member's reduced limbs)."""
    k_rp, k_rn = prng.split(state["key"], 4)[2:]
    dev = state["g_pos"].device
    w_eff = _f32_block(state["g_pos"]) if out is None else out
    scale_t = pcm_lib.read_noise_scale(t, dev) if cfg.read_noise else None
    limbs = 0
    for rows, off, stride in _chunks(*state["g_pos"].shape[-2:], blk):
        g_pos, g_neg, g_sum = _drifted_chunk(state, rows, off, stride, t, cfg)
        if cfg.gdc:  # det_sum makes the scalar order-free
            limbs = limbs + pcm_lib.det_limbs(g_sum)
        if cfg.read_noise:
            g_pos = prng.fma(g_pos * state["q_pos"][rows] * scale_t,
                             prng.normal(k_rp, g_pos.shape, off, stride), g_pos).clamp(min=0.0)
            g_neg = prng.fma(g_neg * state["q_neg"][rows] * scale_t,
                             prng.normal(k_rn, g_neg.shape, off, stride), g_neg).clamp(min=0.0)
        w_eff[rows] = (g_pos - g_neg) * state["w_scale"]
    if cfg.gdc:
        gdc = state["gt_sum"] / (pcm_lib.det_total(_limbs_over(limbs, blk)) + prng._f32(1e-12))
    else:
        gdc = torch.ones((), dtype=torch.float32, device=dev)
    return w_eff, gdc


def _read_buffers_2d(state: dict, t, cfg: pcm_lib.PCMConfig,
                     blk: Optional[_Block] = None) -> dict:
    """Pre-read execute-time buffers for per-MVM read-noise resampling: the
    drifted conductances before any read draw, the per-device read-noise
    sigmas at ``t`` and the weight scale (see :func:`resample_read`)."""
    names = ("g_pos", "g_neg", "sigma_pos", "sigma_neg")
    out = {name: _f32_block(state["g_pos"]) for name in names}
    scale_t = pcm_lib.read_noise_scale(t, state["g_pos"].device) if cfg.read_noise else None
    for rows, off, stride in _chunks(*state["g_pos"].shape[-2:], blk):
        g_pos, g_neg, _ = _drifted_chunk(state, rows, off, stride, t, cfg)
        out["g_pos"][rows], out["g_neg"][rows] = g_pos, g_neg
        if cfg.read_noise:
            out["sigma_pos"][rows] = g_pos * state["q_pos"][rows] * scale_t
            out["sigma_neg"][rows] = g_neg * state["q_neg"][rows] * scale_t
        else:
            out["sigma_pos"][rows] = 0.0
            out["sigma_neg"][rows] = 0.0
    return {**out, "w_scale": state["w_scale"]}


def resample_read(key: Tensor, buf: dict, split=None) -> Tensor:
    """One fresh per-MVM read-noise draw -> effective weights.

    ``buf`` is a per-layer ``read_buf`` (possibly with leading stack dims;
    one draw covers the whole stack, as in the reference). ``split`` (a
    ``launch.sharding.Split``): ``buf`` is a rank's slice of the layer's,
    and draws the counters of its slice of the whole draw.
    """
    k_p, k_n = prng.split(key.to(buf["g_pos"].device))
    shape = tuple(buf["g_pos"].shape)
    off, stride = slice_counters(shape, split)
    g_pos = prng.fma(buf["sigma_pos"], _normal_at(k_p, shape, off, stride, split),
                     buf["g_pos"]).clamp(min=0.0)
    g_neg = prng.fma(buf["sigma_neg"], _normal_at(k_n, shape, off, stride, split),
                     buf["g_neg"]).clamp(min=0.0)
    w_scale = buf["w_scale"]
    return (g_pos - g_neg) * w_scale.reshape(w_scale.shape + (1, 1))


def slice_counters(shape: tuple, split) -> tuple:
    """(offset, stride) of a rank's slice of a (stack..., K, N) draw within
    one member (row or column split); stacks are handled by
    :func:`_normal_at`."""
    if split is None or split.dim not in (-1, -2):
        return 0, None
    if split.dim == -1:
        return split.start, split.size
    return split.start * shape[-1], None


def _normal_at(key: Tensor, shape: tuple, off: int, stride, split) -> Tensor:
    """``prng.normal`` of the rank's slice of one draw over a whole
    (stack..., K, N) buffer: member by member, each member's counters at its
    global flat position."""
    if split is None:
        return prng.normal(key, shape)
    if split.dim == -3:  # a bank's experts: whole members, global index
        lead = shape[:-3]
        e_loc, k, n = shape[-3:]
        member = k * n
        parts = []
        for g in range(math.prod(lead)):
            base = (g * split.size + split.start) * member
            parts.append(prng.normal(key, (e_loc, k, n), base))
        return torch.stack(parts).reshape(shape)
    k_loc, n_loc = shape[-2:]
    g_k = k_loc if split.dim == -1 else split.size
    g_n = split.size if split.dim == -1 else n_loc
    parts = []
    for g in range(math.prod(shape[:-2])):
        base = g * g_k * g_n
        parts.append(prng.normal(key, (k_loc, n_loc), base + off, stride))
    return torch.stack(parts).reshape(shape) if shape[:-2] else parts[0]


def _members(state: dict) -> int:
    return math.prod(state["g_pos"].shape[:-2])


def _member(state: dict, i: int) -> dict:
    stack = state["g_pos"].shape[:-2]
    flat = {k: v.reshape((-1,) + tuple(v.shape[len(stack):])) for k, v in state.items()}
    return {k: v[i] for k, v in flat.items()}


def drift_state(state: dict, t_seconds, cfg: pcm_lib.PCMConfig,
                blk: Optional[_Block] = None):
    """(w_eff, out_scale) of a programmed (stack..., K, N) state re-evaluated
    at ``t_seconds``, member by member (the peak is one member's
    temporaries); ``blk``: the state is a rank's block of every member."""
    stack = tuple(state["g_pos"].shape[:-2])
    k, n = state["g_pos"].shape[-2:]
    dev = state["g_pos"].device
    m = _members(state)
    w_eff = torch.empty((m, k, n), dtype=torch.float32, device=dev)
    gdc = torch.empty((m,), dtype=torch.float32, device=dev)
    for i in range(m):
        _, gdc[i] = _drift_read_2d(_member(state, i), t_seconds, cfg, out=w_eff[i], blk=blk)
    return w_eff.reshape(stack + (k, n)), gdc.reshape(stack)


def read_buffers(state: dict, t_seconds, cfg: pcm_lib.PCMConfig,
                 blk: Optional[_Block] = None) -> dict:
    """Per-MVM read-noise buffers of a programmed state at ``t_seconds``
    (:func:`_read_buffers_2d` per member, stacked)."""
    stack = tuple(state["g_pos"].shape[:-2])
    bufs = [_read_buffers_2d(_member(state, i), t_seconds, cfg, blk)
            for i in range(_members(state))]
    return {k: torch.stack([b[k] for b in bufs]).reshape(stack + tuple(bufs[0][k].shape))
            for k in bufs[0]}


def program_weight(
    key: Tensor, w: Tensor, w_min: Tensor, w_max: Tensor, t_seconds,
    cfg: pcm_lib.PCMConfig, split=None, axis=None,
):
    """Program a (stack..., K, N) weight once and evaluate it at t_seconds.

    Every stack member gets its own key (``split(key, n_members)``), write-
    noise draw, weight scale and GDC scalar. Returns (w_eff, out_scale,
    state). Outputs are preallocated and filled member by member, so the
    peak is one member's temporaries.

    ``split`` (a ``launch.sharding.Split``) with ``axis`` (the ``model``
    axis): ``w`` is a rank's shard of the layer's weight -- a row or column
    block of every member, or a bank's experts (whole members, their keys
    picked from the whole bank's) -- and the state is the same shard of
    the host chip's.
    """
    record_program_event()
    stack = tuple(w.shape[:-2])
    dev = w.device
    k, n = w.shape[-2:]
    n_members = math.prod(stack)
    if split is not None and split.dim == -3:
        whole = stack[:-1] + (split.size,)
        keys = prng.split(key.to(dev), math.prod(whole)).reshape(whole + (2,))
        keys = keys.narrow(-2, split.start, split.stop - split.start).reshape(n_members, 2)
    else:
        keys = prng.split(key.to(dev), n_members)
    blk = _block_of(split, int(n), axis)
    w_flat = w.reshape(n_members, k, n)
    lo = torch.broadcast_to(w_min.float(), stack).reshape(n_members)
    hi = torch.broadcast_to(w_max.float(), stack).reshape(n_members)
    full = lambda: torch.empty((n_members, k, n), dtype=torch.float32, device=dev)
    state = {"g_pos": full(), "g_neg": full(), "q_pos": full(), "q_neg": full()}
    gt_sum = torch.empty((n_members,), dtype=torch.float32, device=dev)
    w_scale = torch.empty_like(gt_sum)
    out_scale = torch.empty_like(gt_sum)
    w_eff = full()
    for i in range(n_members):
        st = _program_2d(keys[i], w_flat[i], lo[i], hi[i], cfg,
                         out={name: state[name][i] for name in ("g_pos", "g_neg", "q_pos", "q_neg")},
                         blk=blk)
        gt_sum[i], w_scale[i] = st["gt_sum"], st["w_scale"]
        _, out_scale[i] = _drift_read_2d(st, t_seconds, cfg, out=w_eff[i], blk=blk)
    state = {key_: v.reshape(stack + (k, n)) for key_, v in state.items()}
    state["gt_sum"] = gt_sum.reshape(stack)
    state["w_scale"] = w_scale.reshape(stack)
    state["key"] = keys.reshape(stack + (2,))
    return w_eff.reshape(stack + (k, n)), out_scale.reshape(stack), state


def _is_linear_layer(node: dict) -> bool:
    return isinstance(node.get("w"), Tensor) and "r_adc" in node and "w_clip_buf" in node


def _is_expert_bank(node: dict) -> bool:
    return (
        all(isinstance(node.get(k), Tensor) for k in ("w1", "w3", "w2"))
        and "r_adc" in node and "w_clip_buf" in node and "w" not in node
    )


#: an expert bank's weight families, in the row order of its ``r_adc``,
#: ``w_clip_buf`` and ``out_scale_buf`` (``models.moe``)
MOE_FAMILIES = ("w1", "w3", "w2")

#: expert-bank keys the bank's programming consumes; its siblings (the MoE
#: dict's shared expert, the digital router) are still walked
_BANK_KEYS = frozenset(MOE_FAMILIES) | {
    "r_adc", "w_clip_buf", "out_scale_buf", "b_adc_buf", "read_buf", "tp"
}


def _walk(tree: Any, fn: Callable[[str, dict], dict], path: str = "") -> Any:
    """Rebuild ``tree``, applying ``fn(path, node)`` to analog-layer dicts
    and MoE expert banks (a bank's siblings walked after it, as in the
    reference: the program phase's keys follow this order)."""
    if isinstance(tree, dict):
        if _is_linear_layer(tree):
            return fn(path, tree)
        if _is_expert_bank(tree):
            new = fn(path, tree)
            for k, v in tree.items():
                if k not in _BANK_KEYS:
                    new[k] = _walk(v, fn, f"{path}/{k}" if path else k)
            return new
        return {k: _walk(v, fn, f"{path}/{k}" if path else k) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # NamedTuple (LMParams)
        return type(tree)(
            *(_walk(getattr(tree, f), fn, f"{path}/{f}" if path else f)
              for f in tree._fields)
        )
    if isinstance(tree, (tuple, list)):
        out = [_walk(v, fn, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return tree


# ---------------------------------------------------------------------------
# Drift lifecycle: schedules of chip ages and the aging entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """A monotone sequence of chip ages (seconds) to serve a program at."""

    times: tuple[float, ...]

    def __post_init__(self):
        ts = tuple(float(t) for t in self.times)
        if not ts:
            raise ValueError("DriftSchedule needs at least one age")
        if not all(math.isfinite(t) for t in ts):
            raise ValueError(f"DriftSchedule ages must be finite: {ts}")
        if any(b <= a for a, b in zip(ts, ts[1:])):
            raise ValueError(f"DriftSchedule ages must be strictly increasing: {ts}")
        if ts[0] < pcm_lib.T_C:
            raise ValueError(
                f"DriftSchedule ages must be >= t_c = {pcm_lib.T_C}s (the "
                f"drift law's programming reference age): {ts}"
            )
        object.__setattr__(self, "times", ts)

    def __iter__(self):
        return iter(self.times)

    def __len__(self) -> int:
        return len(self.times)

    @property
    def labels(self) -> tuple[str, ...]:
        return tuple(pcm_lib.format_age(t) for t in self.times)

    @classmethod
    def fig7(cls) -> "DriftSchedule":
        """The paper's Fig. 7 ages: 25s, 1h, 1d, 1mo, 1y."""
        return cls(tuple(pcm_lib.FIG7_TIMES.values()))

    @classmethod
    def log_spaced(cls, t_start: float, t_end: float, n: int) -> "DriftSchedule":
        """``n`` log-spaced ages in [max(t_start, t_c), t_end]."""
        return cls(pcm_lib.log_spaced_times(t_start, t_end, n))

    @classmethod
    def parse(cls, text: str) -> "DriftSchedule":
        """Parse a CLI schedule: 'fig7' or a comma list of seconds."""
        text = text.strip()
        if text.lower() == "fig7":
            return cls.fig7()
        try:
            times = tuple(float(x) for x in text.split(",") if x.strip())
        except ValueError as e:
            raise ValueError(
                f"bad drift schedule {text!r}: want 'fig7' or a comma "
                "list of seconds, e.g. '25,3600,86400'"
            ) from e
        return cls(times)


def plan_bit_overrides(program: "CiMProgram") -> dict[str, int]:
    """The per-layer ``b_adc_overrides`` a program was compiled with, read
    back from its plans (a refresh reprograms the same bitwidths). As in the
    reference, a parent path whose three w1/w3/w2 children share a bitwidth
    is added too (an expert bank's own pattern; harmless for a dense FFN)."""
    default = program.cfg.b_adc
    out = {p: plan.spec.b_adc for p, plan in program.plans.items()
           if plan.spec.b_adc != default}
    families = ("w1", "w3", "w2")
    for p, bits in list(out.items()):
        head, _, fam = p.rpartition("/")
        if head and fam in families and head not in program.plans:
            if all(out.get(f"{head}/{f}") == bits for f in families):
                out[head] = bits
    return out


def device_age(t_wall: float, refresh_wall: Optional[float]) -> float:
    """Device age of a chip at wall (deployment) age ``t_wall``: a chip last
    rewritten at wall age ``refresh_wall`` restarted its drift clock then
    (floored at t_c); never refreshed, it is ``t_wall`` old."""
    if refresh_wall is None:
        return float(t_wall)
    return max(float(t_wall) - float(refresh_wall), pcm_lib.T_C)


def age_program(program: "CiMProgram", t_seconds: float) -> "CiMProgram":
    """Advance a programmed chip to age ``t_seconds`` -- never reprograms.

    Re-evaluates the same devices (:meth:`CiMProgram.drift_to`) and appends
    the age to ``age_history``; raises if aging recorded a programming event.
    """
    before = program_event_count()
    aged = program.drift_to(t_seconds)
    after = program_event_count()
    if after != before:
        raise RuntimeError(
            f"age_program reprogrammed the chip ({after - before} "
            "programming events during drift_to) -- drift must only "
            "re-evaluate the frozen devices"
        )
    return dataclasses.replace(aged, age_history=program.age_history + (float(t_seconds),))


@dataclasses.dataclass
class CiMProgram:
    """A compiled analog deployment: programmed params + static plans.

    ``params`` mirror the source tree with every analog layer's weights
    replaced by PCM effective weights plus an ``out_scale_buf`` GDC scalar
    (and a ``read_buf`` when compiled with ``resample_read_noise``); they
    drop into ``models.lm.lm_forward`` with ``cfg`` (mode
    ``pcm_programmed``). ``state`` holds the frozen programming state per
    layer path, with each member's threefry key, so :meth:`drift_to`
    re-evaluates the same devices. ``mapping`` is the physical-array
    :class:`~repro_torch.core.crossbar.Mapping` of a program compiled (or
    saved) ``with_mapping``.

    A chip sharded over a mesh (``mesh`` set; ``compile_program(shardings=)``
    or ``checkpoint.store.load_program(shardings=)``) holds this rank's
    shard: every split layer carries its ``launch.sharding.Split`` under
    ``"tp"`` beside its leaves, the embedding table its rows of the vocab.
    Its ``plans`` are the whole layers'; :meth:`gather` returns the host
    chip.
    """

    params: Any
    cfg: Any
    t_seconds: float
    state: dict[str, Any]
    plans: dict[str, ExecutionPlan]
    mapping: Optional[crossbar.Mapping] = None
    age_history: tuple[float, ...] = ()
    chip_id: Optional[int] = None
    mesh: Any = None

    @property
    def n_layers(self) -> int:
        return len(self.plans)

    @property
    def axis(self):
        """The ``model`` axis a sharded chip is split over (else None)."""
        return None if self.mesh is None else collectives.axis_of(self.mesh, "model")

    def drift_to(self, t_seconds: float) -> "CiMProgram":
        """Same programmed conductances, re-evaluated at ``t_seconds``: only
        drift and read noise change, never the programming noise."""
        pcm_cfg = self.cfg.pcm
        axis = self.axis

        def reprogram(path: str, node: dict) -> dict:
            st = self.state[path]
            new = dict(node)
            if "w" in node:
                blk = _block_of(node.get("tp"), int(node["w"].shape[-1]), axis)
                w_eff, gdc = drift_state(st, t_seconds, pcm_cfg, blk)
                new["w"] = w_eff.to(node["w"].dtype)
                new["out_scale_buf"] = gdc
                if "read_buf" in node:
                    new["read_buf"] = read_buffers(st, t_seconds, pcm_cfg, blk)
                return new
            scales, read_bufs = [], {}  # an expert bank: family by family
            for fam in MOE_FAMILIES:
                w_eff, gdc = drift_state(st[fam], t_seconds, pcm_cfg)
                new[fam] = w_eff.to(node[fam].dtype)
                scales.append(gdc)
                if "read_buf" in node:
                    read_bufs[fam] = read_buffers(st[fam], t_seconds, pcm_cfg)
            if read_bufs:
                new["read_buf"] = read_bufs
            new["out_scale_buf"] = torch.stack(scales, dim=-2)
            return new

        return dataclasses.replace(
            self, params=_walk(self.params, reprogram), t_seconds=float(t_seconds)
        )

    def gather(self) -> "CiMProgram":
        """The host chip of a sharded chip, on every rank: each state tensor
        and param all-gathered into its global layout (an unsharded chip is
        returned as is)."""
        if self.mesh is None:
            return self
        axis = self.axis
        state: dict[str, Any] = {}

        def node_fn(path: str, node: dict) -> dict:
            split = node.get("tp")
            if split is None:
                state[path] = self.state[path]
                return node
            new, state[path] = _map_layer(node, self.state[path], lambda t, d: (
                collectives.all_gather_dim(t, d, split.bounds, axis)))
            return new

        params = _walk(self.params, node_fn)
        embed = getattr(params, "embed", None)
        if isinstance(embed, dict) and "tp" in embed:
            split = embed["tp"]
            params = params._replace(embed={
                **{k: v for k, v in embed.items() if k != "tp"},
                "table": collectives.all_gather_dim(embed["table"], -2, split.bounds, axis)})
        return dataclasses.replace(self, params=params, state=state, mesh=None)


#: a layer's leaves that are elementwise images of its weight
_PLANES = ("g_pos", "g_neg", "q_pos", "q_neg", "sigma_pos", "sigma_neg")


def _expert_dim(name: str) -> int:
    """The expert dim of a bank family's state or read-buffer leaf: the
    planes (stack..., E, K, N), the member keys (stack..., E, 2), the
    per-member scalars (stack..., E)."""
    return -2 if name == "key" else (-3 if name in _PLANES else -1)


def _map_layer(node: dict, st: dict, fn: Callable[[Tensor, int], Tensor]) -> tuple:
    """(node, state) of a split layer with ``fn(tensor, dim)`` applied to
    every leaf that lies across the split (``dim`` the one it is split
    along; its ``"tp"`` dropped): the weight, a column split's bias, the
    read buffer's and the state's planes; a bank's families, GDC scalars,
    and every state and read-buffer leaf along its experts."""
    split = node["tp"]
    new = {k: v for k, v in node.items() if k != "tp"}
    if "w" in node:
        d = split.dim
        new["w"] = fn(node["w"], d)
        if "b" in node and d == -1:
            new["b"] = fn(node["b"], -1)
        if "read_buf" in node:
            new["read_buf"] = {k: fn(v, d) if k in _PLANES else v
                               for k, v in node["read_buf"].items()}
        return new, {k: fn(v, d) if k in _PLANES else v for k, v in st.items()}
    experts = lambda t: {k: fn(v, _expert_dim(k)) for k, v in t.items()}
    for fam in MOE_FAMILIES:
        new[fam] = fn(node[fam], -3)
    new["out_scale_buf"] = fn(node["out_scale_buf"], -1)
    if "read_buf" in node:
        new["read_buf"] = {f: experts(b) for f, b in node["read_buf"].items()}
    return new, {f: experts(st[f]) for f in MOE_FAMILIES}


def _specs_of(shardings: Any) -> tuple[Any, dict]:
    """(mesh, {'/'-joined leaf path: spec}) of a ``launch.sharding`` tree."""
    from repro_torch import tree as tree_lib

    flat = tree_lib.flatten_with_path(shardings)
    if not flat:
        raise ValueError("shardings= holds no leaf")
    return flat[0][1].mesh, {tree_lib.path_name(p): sh.spec for p, sh in flat}


def _splitter(shardings: Any, cfg: Any):
    """(mesh, model axis, ``split(path, leaf, shape, bank)``) of a
    shardings tree: each programmed layer's ``launch.sharding.Split`` by
    its spec and the crossbar rule."""
    from repro_torch.launch import sharding as shd

    mesh, specs = _specs_of(shardings)
    axis = collectives.axis_of(mesh, "model")
    if axis is None:
        raise ValueError("a sharded chip needs a mesh with a 'model' axis")

    def split(path: str, leaf: str, shape: tuple, bank: bool = False):
        return shd.layer_split(specs.get(f"{path}/{leaf}" if path else leaf, ()), tuple(shape),
                               axis.size, axis.rank, cfg.tile_rows, cfg.per_tile_adc, bank)

    def table(params: Any):
        """The embedding's rows of the vocab, or None."""
        embed = getattr(params, "embed", None)
        if not isinstance(embed, dict) or "table" not in embed:
            return None
        return shd.layer_split(specs.get("embed/table", ()), tuple(embed["table"].shape),
                               axis.size, axis.rank, 1, True, bank=True)

    return mesh, axis, split, table


def _shard_embed(params: Any, split) -> Any:
    if split is None:
        return params
    embed = params.embed
    return params._replace(embed={**embed, "table": split.take(embed["table"]), "tp": split})


def shard_program(program: CiMProgram, shardings: Any) -> CiMProgram:
    """This rank's shard of a host chip (every rank holds the whole chip
    and keeps its slice: ``load_program(shardings=)``); bitwise the shard
    ``compile_program(shardings=)`` programs."""
    if program.mesh is not None:
        raise ValueError("the program is sharded already")
    mesh, _, split_of, table = _splitter(shardings, program.cfg)
    state: dict[str, Any] = {}

    def node_fn(path: str, node: dict) -> dict:
        split = (split_of(path, "w", node["w"].shape) if "w" in node
                 else split_of(path, "w1", node["w1"].shape, bank=True))
        if split is None:
            state[path] = program.state[path]
            return node
        new, state[path] = _map_layer({**node, "tp": split}, program.state[path],
                                      lambda t, d: split.take(t, d))
        return {**new, "tp": split}

    params = _shard_embed(_walk(program.params, node_fn), table(program.params))
    return dataclasses.replace(program, params=params, state=state, mesh=mesh)


def compile_program(
    params: Any,
    cfg: Any,
    key: Tensor,
    *,
    t_seconds: Optional[float] = None,
    transforms: Optional[dict] = None,
    with_mapping: bool = False,
    shardings: Any = None,
    b_adc_overrides: Optional[BitOverrides] = None,
    chip_id: Optional[int] = None,
    device="cuda",
) -> CiMProgram:
    """Program phase: walk ``params`` once and build a :class:`CiMProgram`.

    ``cfg`` is an AnalogConfig (its mode is ignored; the program's cfg is
    the same config in ``pcm_programmed`` mode). ``key`` is a threefry key
    (``prng.PRNGKey``): layer ``n`` of the walk programs from
    ``fold_in(key, n)``, as in the reference, so the same key gives the
    reference's chip. ``params`` live on ``device``. ``b_adc_overrides``
    maps fnmatch patterns over '/'-joined layer paths to per-layer ADC bits,
    recorded as shape-encoded ``b_adc_buf`` leaves. With
    ``cfg.resample_read_noise`` every layer also carries its ``read_buf``.

    ``transforms`` maps layer paths to the function that turns the layer's
    weight into its physical crossbar block (e.g.
    ``models.analognet.crossbar_transforms``: a conv kernel to its im2col
    2D block); the block is programmed and returned as the layer's ``w``,
    and its plan is the block's. ``with_mapping=True`` packs every
    programmed block onto the physical arrays (``crossbar.map_layers`` at
    the config's tile size) and attaches the :class:`~repro_torch.core.
    crossbar.Mapping` to the program.

    ``shardings`` (``launch.sharding.program_shardings``: a spec per leaf
    over a ``DeviceMesh``; every rank passes the whole ``params``) programs
    this rank's shard of every layer (``launch.sharding.layer_split``: a
    layer's columns, its rows at crossbar tile boundaries, or a bank's
    experts): the conductances, Q factors and read buffers of its slice,
    drawn at the slice's own counters, with the weight scale and the GDC
    scalar from the whole member (an f32 MAX and an integer SUM of
    ``det_sum``'s limbs over the ``model`` axis, both exact). A layer with
    a ``transforms`` entry changes shape, so it is programmed whole on
    every rank, as the reference programs it host-side. The gathered chip
    (:meth:`CiMProgram.gather`) is bitwise the unsharded one, its mapping
    too.
    """
    dev = resolve_device(device)
    mesh = axis = split_of = table = None
    if shardings is not None:
        mesh, axis, split_of, table = _splitter(shardings, cfg)
    t = float(cfg.t_seconds if t_seconds is None else t_seconds)
    transforms = transforms or {}
    overrides = normalize_b_adc_overrides(b_adc_overrides)
    if overrides:
        quant_lib.validate_b_adc(cfg.b_adc, "cfg.b_adc (with overrides)")
    want_read_buf = bool(getattr(cfg, "resample_read_noise", False))
    key = key.to(dev)
    state: dict[str, Any] = {}
    plans: dict[str, ExecutionPlan] = {}
    shapes: list[crossbar.LayerShape] = []
    counter = [0]

    def add_plan(path: str, k_dim: int, n_dim: int, count: int, bits: int) -> None:
        plans[path] = plan_for(cfg, k_dim, n_dim, b_adc=bits)
        shapes.extend(
            crossbar.LayerShape(f"{path}[{i}]" if count > 1 else path, k_dim, n_dim,
                                n_patches=1)
            for i in range(count)
        )

    def program_bank(path: str, node: dict) -> dict:
        """An expert bank: each family programmed as one (stack..., E, K,
        N) weight, its clip range broadcast over the experts; the GDC
        scalars stacked to (stack..., 3, E); one bitwidth for the bank."""
        bits = resolve_b_adc(overrides, path, cfg.b_adc)
        new = dict(node)
        st_fams, scales, read_bufs = {}, [], {}
        buf = node["w_clip_buf"]  # (stack..., 3, 2)
        split = split_of(path, "w1", node["w1"].shape, bank=True) if split_of else None
        for f, fam in enumerate(MOE_FAMILIES):
            w = node[fam]
            if w.device.type != dev.type:
                raise ValueError(f"layer {path!r} lives on {w.device}, not {dev}")
            counter[0] += 1
            stack = tuple(w.shape[:-2])
            w_eff, gdc, st = program_weight(
                prng.fold_in(key, counter[0]), w if split is None else split.take(w),
                buf[..., f, 0][..., None], buf[..., f, 1][..., None], t, cfg.pcm, split, axis,
            )
            new[fam] = w_eff.to(w.dtype)
            st_fams[fam] = st
            scales.append(gdc)
            if want_read_buf:
                read_bufs[fam] = read_buffers(st, t, cfg.pcm)
            add_plan(f"{path}/{fam}", int(w.shape[-2]), int(w.shape[-1]),
                     math.prod(stack), bits)
        new["out_scale_buf"] = torch.stack(scales, dim=-2)
        if split is not None:
            new["tp"] = split
        if bits != cfg.b_adc:
            # one bitwidth a bank: its families share the layer's ADC
            new["b_adc_buf"] = b_adc_buf(tuple(node["w1"].shape[:-2]), bits, dev)
        if want_read_buf:
            new["read_buf"] = read_bufs
        state[path] = st_fams
        return new

    def program_node(path: str, node: dict) -> dict:
        if "w" not in node:
            return program_bank(path, node)
        if node["w"].device.type != dev.type:
            raise ValueError(f"layer {path!r} lives on {node['w'].device}, not {dev}")
        w = transforms.get(path, lambda w: w)(node["w"])
        if w.dim() > 3:
            raise ValueError(
                f"layer '{path}': weight shape {tuple(w.shape)} has more than "
                "one stack dim; pass a transforms= entry (e.g. "
                "analognet.crossbar_transforms) to flatten conv kernels to "
                "their 2D crossbar blocks before programming"
            )
        counter[0] += 1
        bits = resolve_b_adc(overrides, path, cfg.b_adc)
        stack = tuple(w.shape[:-2])
        buf = node["w_clip_buf"]
        split = split_of(path, "w", w.shape) if split_of and path not in transforms else None
        w_eff, gdc, st = program_weight(
            prng.fold_in(key, counter[0]), w if split is None else split.take(w),
            buf[..., 0], buf[..., 1], t, cfg.pcm, split, axis,
        )
        new = dict(node)
        new["w"] = w_eff.to(node["w"].dtype)
        new["out_scale_buf"] = gdc
        if split is not None:
            new["tp"] = split
            if "b" in node and split.dim == -1:
                new["b"] = split.take(node["b"])
        if bits != cfg.b_adc:
            new["b_adc_buf"] = b_adc_buf(stack, bits, dev)
        if want_read_buf:
            new["read_buf"] = read_buffers(st, t, cfg.pcm,
                                           _block_of(split, int(w_eff.shape[-1]), axis))
        state[path] = st
        add_plan(path, int(w.shape[-2]), int(w.shape[-1]), math.prod(stack), bits)
        return new

    programmed = _walk(params, program_node)
    if table is not None:
        programmed = _shard_embed(programmed, table(params))
    mapping = None
    if with_mapping and shapes:
        mapping = crossbar.map_layers(shapes, cfg.tile_rows, cfg.tile_cols)
    return CiMProgram(
        params=programmed,
        cfg=dataclasses.replace(cfg, mode=PCM_PROGRAMMED, quant_noise_p=1.0),
        t_seconds=t,
        state=state,
        plans=plans,
        mapping=mapping,
        age_history=(t,),
        chip_id=chip_id,
        mesh=mesh,
    )


def cast_weights(params: Any, dtype: torch.dtype) -> Any:
    """``params`` with every analog layer's weights (an expert bank's three
    families) pre-cast to ``dtype``.

    The execute phase casts weights to the activation dtype on every call
    (``analog_matmul``); at tinyllama-1.1b width that is a 4 GB f32 -> bf16
    pass per decode step. The cast is deterministic, so executing one
    pre-cast copy is bitwise the same. Other leaves are shared, not copied.
    """

    def cast(_path: str, node: dict) -> dict:
        new = dict(node)
        for name in ("w",) if "w" in node else MOE_FAMILIES:
            new[name] = node[name].to(dtype)
        return new

    return _walk(params, cast)


# ---------------------------------------------------------------------------
# Fused decode plan (the whole decode step as one kernel launch)
# ---------------------------------------------------------------------------

#: Projection walk-path order of one attention period group, matching the
#: execution order of ``lm._block_apply``: wq/wk/wv are issued by
#: attn_apply, wo closes it, then the FFN triple.
FUSED_PROJS = (
    "attn/wq", "attn/wk", "attn/wv", "attn/wo",
    "ffn/w1", "ffn/w3", "ffn/w2",
)


@dataclasses.dataclass(frozen=True)
class FusedDecodePlan:
    """Static lowering of a whole programmed decode step to ONE launch.

    The paper's AON-CiM accelerator is layer-serial: the entire network
    walks one physical datapath. The per-layer :class:`ExecutionPlan` table
    collapses into one plan per projection (every stacked group shares it,
    so per-layer ``b_adc`` overrides resolve statically) plus the lm_head
    plan. ``kernels/decode_fused.py`` executes it. The reference's
    ``interpret`` field has no counterpart: the tensors' device picks the
    kernel or its plain version.
    """

    n_groups: int
    #: one ExecutionPlan per projection, in :data:`FUSED_PROJS` order
    proj_plans: tuple
    head_plan: ExecutionPlan


def build_fused_plan(program: CiMProgram) -> FusedDecodePlan:
    """Lower a compiled program's per-layer plans into one FusedDecodePlan.

    Raises ``ValueError`` when the program cannot be statically fused:
    anything beyond stacked attention+FFN period groups and an lm_head
    (tail layers, MoE expert banks, recurrent state, biased projections)
    has no place in the layer-serial walk.
    """
    cfg = program.cfg
    if cfg.use_kernel:
        raise ValueError(
            "fused decode replaces the per-layer kernel dispatch; serve "
            "the program with use_kernel=False"
        )
    required = tuple(f"blocks/0/{p}" for p in FUSED_PROJS) + ("lm_head",)
    have = set(program.plans)
    extras = {p for p in have if p.startswith("extras/")}
    missing = sorted(set(required) - have)
    unfusable = sorted(have - set(required) - extras)
    if missing or unfusable:
        raise ValueError(
            "program's per-layer plans cannot be statically fused into "
            f"one decode grid: missing={missing} unfusable={unfusable} "
            "(fused decode supports stacked attention+FFN blocks plus an "
            "lm_head -- no tail layers, MoE banks, or recurrent state)"
        )
    blocks = getattr(program.params, "blocks", None)
    head = getattr(program.params, "lm_head", None)
    if not blocks or head is None:
        raise ValueError(
            "fused decode needs LM params with stacked period blocks and "
            "an lm_head"
        )
    block = blocks[0]
    for path in FUSED_PROJS:
        kind, name = path.split("/")
        pp = block[kind][name]
        if "b" in pp:
            raise ValueError(
                f"blocks/0/{path} carries a bias; the fused decode grid "
                "executes bias-free projections only (qkv_bias "
                "architectures are unsupported)"
            )
        if "out_scale_buf" not in pp:
            raise ValueError(
                f"blocks/0/{path} has no GDC out_scale_buf -- not a "
                "compiled program?"
            )
    if "out_scale_buf" not in head:
        raise ValueError("lm_head has no GDC out_scale_buf -- not a "
                         "compiled program?")

    def _plan(path: str) -> ExecutionPlan:
        # re-derived from the program's cfg; the stored per-layer bitwidth
        # is what resolves statically per projection
        p = program.plans[path]
        return plan_for(cfg, p.k, p.n, b_adc=p.spec.b_adc)

    return FusedDecodePlan(
        n_groups=int(block["attn"]["wq"]["w"].shape[0]),
        proj_plans=tuple(_plan(f"blocks/0/{p}") for p in FUSED_PROJS),
        head_plan=_plan("lm_head"),
    )
