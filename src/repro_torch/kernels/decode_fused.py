"""The whole programmed decode step in one launch, port of
``repro.kernels.decode_fused``.

Replaces the TPU kernel ``repro/kernels/decode_fused.py::_decode_kernel``
with the hand-written Hopper kernel ``csrc/decode_fused.cu`` (its header
holds the design note); ``kernels.ref.decode_fused_ref`` is the plain
version of the same function.

* The stacked slot cache: :func:`init_fused_cache`, :func:`write_fused_slot`
  and :func:`reset_fused_slot` -- one ``(L, B, S, kv, hd)`` K/V buffer per
  side and one ``(B,)`` length vector. Writes happen in place.
* :func:`fused_decode_step` dispatches by device: a CUDA tensor launches the
  kernel (a failed launch raises, nothing falls back), a CPU tensor runs
  the plain version. The module's ``launches`` counts kernel launches and
  nothing else.
* :class:`FusedDecoder` holds what one engine reuses every step: the weight
  stacks, the scalar table, the norm scales, the RoPE frequencies and the
  kernel's workspace; :meth:`FusedDecoder.set_params` follows a chip that
  was aged or refreshed, and a program that resamples read noise draws its
  stacks afresh every step. It also owns the stacked cache's
  lifecycle (:meth:`FusedDecoder.new_cache`, ``write_slot``,
  ``reset_slot``), so a serving engine holds one decoder object.
* :func:`mvm_items` chooses each projection's MVM work item (the
  tensor-core item for bf16 shapes ``analog_mvm.tc_shape_ok`` takes, the
  CUDA-core item otherwise); :func:`fused_layout` sizes the kernel's
  dynamic shared memory (the weight ring, staged x, the work area),
  :func:`row_slices` and :func:`attn_heads` its row and attention items,
  and :func:`item_table` deals every MVM phase's items to the blocks once
  (:func:`phase_items` counts them).

The embedding gather stays outside the kernel, as in the reference.
"""

from __future__ import annotations

import ctypes
import math
import sys
from dataclasses import dataclass

import torch

from repro_torch import prng
from repro_torch.core import engine as engine_lib
from repro_torch.kernels import build
from repro_torch.kernels.analog_mvm import SUB_ROWS, tc_shape_ok
from repro_torch.kernels.decode_rows import MAX_PASS, PASS_SMEM, attn_heads, rope_freqs, sm_count
from repro_torch.kernels.ref import decode_fused_ref
from repro_torch.models.attention import KVCache
from repro_torch.models.common import ModelConfig, embedding_apply

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 256  # the kernel keeps one head's q/k/v rows in shared memory
_MAX_S = 8192  # and one head's scores in its 32 KB staging buffer
_MAX_D = 256 * 32  # a norm row is held in registers, 32 values a thread
_FN = None

#: the kernel's phases per layer, in order: norm + DAC of wq/wk/wv, their
#: MVM, attention, wo, norm + DAC of w1/w3, their MVM, the gate, w2; then
#: the final norm and the lm_head (``csrc/decode_fused.cu``)
PHASES_PER_LAYER = 8

#: kernel launches since process start (see the module docstring)
launches = 0

#: the MVM work items (``csrc/decode_fused.cu``): output columns and slots
#: of the tensor-core item (8 warps x 8 columns, one 16-row mma tile) and of
#: the CUDA-core item (``analog_mvm_core.cuh``)
TC_STRIP, TC_ROWS = 64, 16
CC_STRIP, CC_ROWS = 32, 8
#: one stage of the weight ring: a 128-row sub-chunk of an item's 64
#: columns (128-byte rows, one TMA box); the ring starts at a 1024-byte
#: boundary, so it takes RING_ALIGN more bytes
SLOT_BYTES = SUB_ROWS * TC_STRIP * 2
RING_ALIGN = 1024
MAX_STAGES = 16
#: x columns a tensor-core item stages at once, and one staged row's bytes
X_PIECE = 1024
X_ROW_BYTES = X_PIECE * 2 + 16
#: the CUDA-core item's shared memory (``amvm::TileSmem``)
CC_SMEM = (8 * 1024 + 8 * 8 * 32) * 4
#: threads of a block (``amvm::kThreads``)
THREADS = 256
#: an H100 SM's shared memory, the per-block reservation, and an upper
#: bound on the kernel's static shared memory
SM_SMEM, BLOCK_RESERVED, STATIC_SMEM = 228 * 1024, 1024, 4096


def mvm_items(plans, weights, dtype) -> tuple:
    """Each projection's MVM work item, in ``FUSED_PROJS`` order then the
    lm_head: ``"tensor_core"`` for bf16 at shapes the tensor-core designs
    take (``analog_mvm.tc_shape_ok``) with 16-byte aligned weights,
    ``"cuda_core"`` otherwise -- a choice made here, once, never at a failed
    launch."""
    return tuple(
        "tensor_core" if (dtype == torch.bfloat16
                          and tc_shape_ok(p.k, p.n, p.tile_rows, p.per_tile_adc)
                          and w.data_ptr() % 16 == 0) else "cuda_core"
        for p, w in zip(plans, weights))


@dataclass(frozen=True)
class FusedLayout:
    """The kernel's launch layout: the item of each projection, the weight
    ring's ``stages``, the rows of staged x, the most query heads an
    attention pass holds and the dynamic shared memory (the ring at 0,
    staged x at ``smem_x``, the work area that the row, attention and MVM
    phases take in turn at ``smem_work``; ``smem_bytes`` in all)."""

    items: tuple
    stages: int
    x_rows: int
    heads_per_pass: int
    smem_x: int
    smem_work: int
    smem_bytes: int

    @property
    def tc(self) -> tuple:
        return tuple(int(i == "tensor_core") for i in self.items)


def fused_layout(items, cfg: ModelConfig, n_slots: int, s_max: int) -> FusedLayout:
    """Size the shared memory of one persistent block per SM (a crossbar
    tile's 8 stages fit its ring at once): staged x and the work area
    first, then as many ring stages as fit (at most
    :data:`MAX_STAGES`); when a projection runs the tensor-core item, at
    least the 8 stages of one piece of staged x (its warps take 8
    sub-chunks at once). The work area holds a row phase's residual row, an
    attention pass's q rows, scores and AV sums (16 bytes of dims a
    thread), the tensor-core item's 8 chains of a piece, and, when a
    projection runs it, the CUDA-core item's tiles."""
    any_tc = "tensor_core" in items
    g = cfg.n_heads // cfg.n_kv_heads
    hp = min(g, MAX_PASS, max(1, PASS_SMEM // ((s_max + cfg.hd) * 4)))
    vec = 16 // torch.empty((), dtype=cfg.dtype).element_size()
    work = max(hp * (s_max + cfg.hd) * 4 + THREADS * vec * 4, cfg.d_model * 4)
    if "cuda_core" in items:
        work = max(work, CC_SMEM)
    x_rows = (8 if n_slots <= 8 else 16) if any_tc else 0
    xs = x_rows * X_ROW_BYTES
    group = X_PIECE // SUB_ROWS  # sub-chunks a tensor-core item runs at once
    work = max(work, group * x_rows * TC_STRIP * 4)
    budget = SM_SMEM - BLOCK_RESERVED - STATIC_SMEM
    stages = (min(MAX_STAGES, (budget - xs - work - RING_ALIGN) // SLOT_BYTES)
              if any_tc else 0)
    if any_tc and stages < group:
        raise ValueError(
            f"decode_fused kernel: {group} weight-ring stages do not fit beside {xs} bytes "
            f"of x and {work} of work area"
        )
    ring = stages * SLOT_BYTES + (RING_ALIGN if any_tc else 0)
    return FusedLayout(items=tuple(items), stages=stages, x_rows=x_rows or 8,
                       heads_per_pass=hp, smem_x=ring, smem_work=ring + xs,
                       smem_bytes=ring + xs + work)


#: the projections of each MVM phase kind, in the order their items are
#: dealt (index 7 = the lm_head)
PHASE_PROJS = {"qkv": (0, 1, 2), "wo": (3,), "w13": (4, 5), "w2": (6,), "lm_head": (7,)}
#: the last row of a block's item list (its MVM phase)
END = 0xFFFF


def _item_grid(items, plans, n_slots: int, span, i: int) -> tuple:
    """(strips, tiles, slot blocks) of projection i's items."""
    tc = items[i] == "tensor_core"
    cols, rows = (TC_STRIP, TC_ROWS) if tc else (CC_STRIP, CC_ROWS)
    p = plans[i]
    return -(-p.n // cols), -(-p.k // span[i]), -(-n_slots // rows)


def phase_items(items, plans, n_slots: int, span) -> dict:
    """Work items of each MVM phase kind (``qkv``, ``wo``, ``w13``, ``w2``,
    ``lm_head``): per projection, strips x crossbar tiles x slot blocks of
    its item."""
    return {kind: sum(math.prod(_item_grid(items, plans, n_slots, span, i)) for i in projs)
            for kind, projs in PHASE_PROJS.items()}


def item_table(items, plans, n_slots: int, span, n_layers: int, grid: int) -> torch.Tensor:
    """Every block's MVM work items over one step, in the order the kernel
    runs them: (grid, T, 4) int32. MVM phase mp (4 per layer -- qkv, wo,
    w13, w2 -- then the lm_head) numbers its items projection by projection
    (strip fastest, then crossbar tile, then slot block) and deals item
    ``it`` to block ``it % grid``. A row is [first output column, first row
    of K, p | j << 3 | tc << 5 | slot block << 6, mp | tile << 16] (j: the
    projection's place in its phase); each block's list ends in a row whose
    mp is :data:`END`. The kernel's producer walks it ahead of its
    consumers, so neither decodes an item on the card."""
    kinds = list(PHASE_PROJS.items())
    phases = [kinds[mp % 4] for mp in range(4 * n_layers)] + [kinds[4]]
    rows_per = []
    for _, projs in phases:
        parts = []
        for j, i in enumerate(projs):
            strips, tiles, rbs = _item_grid(items, plans, n_slots, span, i)
            local = torch.arange(strips * tiles * rbs)
            tc = int(items[i] == "tensor_core")
            cols = TC_STRIP if tc else CC_STRIP
            parts.append(torch.stack([
                local % strips * cols, local // strips % tiles * span[i],
                i | j << 3 | tc << 5 | (local // (strips * tiles)) << 6,
                local // strips % tiles << 16], 1))
        rows_per.append(torch.cat(parts))
    counts = torch.zeros(grid, dtype=torch.long)
    for r in rows_per:
        counts += torch.bincount(torch.arange(len(r)) % grid, minlength=grid)[:grid]
    table = torch.zeros((grid, int(counts.max()) + 1, 4), dtype=torch.int32)
    table[..., 3] = END
    fill = torch.zeros(grid, dtype=torch.long)
    for mp, r in enumerate(rows_per):
        it = torch.arange(len(r))
        blk = it % grid
        r = r.clone()
        r[:, 3] |= mp
        table[blk, fill[blk] + it // grid] = r.to(torch.int32)
        fill += torch.bincount(blk, minlength=grid)[:grid]
    return table


def spans(plans) -> list:
    """Rows of K per ADC conversion of each projection: the crossbar tile
    when the per-tile ADC splits K, else all of K."""
    return [p.tile_rows if (p.per_tile_adc and p.k > p.tile_rows) else p.k for p in plans]


def workspace_strides(plans, n_slots: int, cfg: ModelConfig) -> tuple:
    """(xq_stride, part_stride): elements of one DAC-quantized input region
    ((B, K) of the widest K) and of one partial region ((tile, B, N) of the
    largest projection); an MVM phase uses up to three of each (wq/wk/wv)."""
    span = spans(plans)
    part = max(-(-p.k // s) * n_slots * p.n for p, s in zip(plans, span))
    return n_slots * max(cfg.d_model, cfg.d_ff), part


def row_slices(grid: int, n_slots: int, d_model: int) -> int:
    """Blocks per slot in a row phase: as many as the grid holds, at most
    one per 256 columns (one column a thread)."""
    return max(1, min(grid // n_slots, -(-d_model // 256)))


# ---------------------------------------------------------------------------
# Fused slot cache: one stacked (L, B, S, kv, hd) KV buffer
# ---------------------------------------------------------------------------


def init_fused_cache(
    cfg: ModelConfig, n_groups: int, batch: int, s_max: int, dtype, *, device
) -> KVCache:
    """Stacked per-slot decode cache: k/v (n_groups, B, s_max, kv, hd) and
    one shared (B,) int32 length vector (every layer of a step advances
    together)."""
    shape = (n_groups, batch, s_max, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def write_fused_slot(fused: KVCache, src: tuple, slot: int) -> KVCache:
    """Write a prefilled request cache into batch row ``slot``, in place.

    ``src`` is the batch=1 prefill cache in the list layout (a list of
    per-group ``(KVCache,)`` tuples, k/v (1, S, kv, hd), scalar lengths).
    Rows are restacked along the leading axis: value for value what
    ``lm.write_cache_slot`` writes into the list-layout slot cache.
    """
    groups, _tails = src
    for g, (c,) in enumerate(groups):
        fused.k[g, slot].copy_(c.k[0])
        fused.v[g, slot].copy_(c.v[0])
    fused.length[slot] = groups[0][0].length
    return fused


def reset_fused_slot(fused: KVCache, slot: int) -> KVCache:
    """Zero batch row ``slot`` across every layer, in place."""
    fused.k[:, slot].zero_()
    fused.v[:, slot].zero_()
    fused.length[slot] = 0
    return fused


# ---------------------------------------------------------------------------
# Inputs of one step
# ---------------------------------------------------------------------------


def _resampled_stacks(params, analog_cfg, rng):
    """The seven effective weight stacks and the lm_head weights, with a
    fresh read-noise draw when the program resamples and ``rng`` is given.

    The keys mirror ``AnalogCtx.next_key`` of the per-layer path: the
    counter advances once per projection carrying a ``read_buf`` (wq, wk,
    wv, wo, w1, w3, w2 under the group key ``fold_in(rng, g)``); the
    lm_head is counter 1 under ``rng`` itself.
    """
    block = params.blocks[0]
    head = params.lm_head
    resample = analog_cfg.resample_read_noise and rng is not None
    if resample:
        rng = rng.to(params.gain_s.device)
    n_groups = int(block["attn"]["wq"]["w"].shape[0])
    group_keys = [prng.fold_in(rng, g) for g in range(n_groups)] if resample else []
    stacks = []
    counter = 0
    for path in engine_lib.FUSED_PROJS:
        kind, name = path.split("/")
        pp = block[kind][name]
        if analog_cfg.resample_read_noise and "read_buf" in pp:
            counter += 1
        if resample and "read_buf" in pp:
            stacks.append(torch.stack([
                engine_lib.resample_read(
                    prng.fold_in(group_keys[g], counter),
                    {k: v[g] for k, v in pp["read_buf"].items()})
                for g in range(n_groups)
            ]).to(pp["w"].dtype))
        else:
            stacks.append(pp["w"])
    if resample and "read_buf" in head:
        w_head = engine_lib.resample_read(prng.fold_in(rng, 1), head["read_buf"]).to(head["w"].dtype)
    else:
        w_head = head["w"]
    return stacks, w_head


def _scalar_table(params, n_groups: int) -> Tensor:
    """(L+1, 7, 3) f32 table: [r_adc, w_max, gdc out_scale] per (layer,
    projection); row L col 0 is the lm_head, row L col 1 carries the
    network-wide ADC gain S."""
    block = params.blocks[0]
    head = params.lm_head
    dev = params.gain_s.device
    tab = torch.zeros(
        (n_groups + 1, len(engine_lib.FUSED_PROJS), 3), dtype=torch.float32,
        device=dev,
    )
    for p, path in enumerate(engine_lib.FUSED_PROJS):
        kind, name = path.split("/")
        pp = block[kind][name]
        tab[:n_groups, p, 0] = pp["r_adc"].float()
        tab[:n_groups, p, 1] = pp["w_clip_buf"][..., 1].float()
        tab[:n_groups, p, 2] = pp["out_scale_buf"].float()
    tab[n_groups, 0, 0] = head["r_adc"].float()
    tab[n_groups, 0, 1] = head["w_clip_buf"][..., 1].float()
    tab[n_groups, 0, 2] = head["out_scale_buf"].float()
    tab[n_groups, 1, 0] = params.gain_s.float()
    return tab


def _norm_scales(node: dict, shape: tuple, dev) -> Tensor:
    scale = node.get("scale")
    if scale is None:  # nonparametric norm: a unit scale is exact
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return scale.float().contiguous()


class FusedDecoder:
    """One engine's fused decode step: inputs prepared once, then
    :meth:`step` per decode step.

    ``params`` are a compiled program's params whose weights are already
    in the model dtype (``engine.cast_weights``). On a CUDA device the
    kernel's workspace (residual stream, DAC-quantized inputs, tile
    partials), its launch layout and each block's item list are built
    here, once; a step allocates only its logits and length outputs.
    """

    def __init__(
        self,
        params,
        plan: engine_lib.FusedDecodePlan,
        cfg: ModelConfig,
        analog_cfg,
        n_slots: int,
        s_max: int,
        *,
        rng=None,
    ):
        self.plan, self.cfg, self.analog_cfg = plan, cfg, analog_cfg
        self.n_slots, self.s_max = int(n_slots), int(s_max)
        self.device = params.gain_s.device
        self.grid = None
        self.set_params(params, rng)
        #: each projection's MVM work item on the card (:func:`mvm_items`)
        self.items = mvm_items(list(plan.proj_plans) + [plan.head_plan],
                               self.stacks + [self.w_head], cfg.dtype)
        if self.device.type == "cuda":
            self._init_kernel()

    def set_params(self, params, rng=None) -> None:
        """Take the chip's current params (an aged or refreshed chip has new
        weights and GDC scalars, same shapes): the weight stacks, the
        lm_head, the scalar table and the norm scales are rebuilt, and so is
        what the kernel derives from their pointers."""
        self.params = params
        self._set_weights(*_resampled_stacks(params, self.analog_cfg, rng))
        n_groups, d, dev = self.plan.n_groups, self.cfg.d_model, self.device
        block = params.blocks[0]
        self.tab = _scalar_table(params, n_groups)
        self.n1 = _norm_scales(block["norm1"], (n_groups, d), dev)
        self.n2 = _norm_scales(block["norm2"], (n_groups, d), dev)
        self.fin = _norm_scales(params.final_norm, (d,), dev)

    def _set_weights(self, stacks, w_head) -> None:
        self.stacks = [w.contiguous() for w in stacks]
        self.w_head = w_head.contiguous()
        if self.grid is not None:
            self.vec_ok = self._vec_ok()

    def _vec_ok(self) -> list[int]:
        plans = list(self.plan.proj_plans) + [self.plan.head_plan]
        vec = 16 // torch.empty((), dtype=self.cfg.dtype).element_size()
        return [int(p.n % vec == 0 and w.data_ptr() % 16 == 0)
                for p, w in zip(plans, self.stacks + [self.w_head])]

    # -- the kernel's inputs -------------------------------------------------

    def _init_kernel(self) -> None:
        cfg, plan, dev = self.cfg, self.plan, self.device
        dtype = cfg.dtype
        if dtype not in _DTYPES:
            raise TypeError(f"decode_fused kernel takes float32 or bfloat16, got {dtype}")
        if cfg.hd > _MAX_HD or cfg.hd % 2 or cfg.n_heads % cfg.n_kv_heads:
            raise ValueError(
                f"decode_fused kernel: head_dim {cfg.hd} (even, <= {_MAX_HD}) "
                f"and {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads"
            )
        if self.s_max > _MAX_S or cfg.d_model > _MAX_D:
            raise ValueError(
                f"decode_fused kernel: s_max {self.s_max} (<= {_MAX_S}), "
                f"d_model {cfg.d_model} (<= {_MAX_D})"
            )
        for s in self.stacks + [self.w_head]:
            if s.dtype != dtype or s.device != dev:
                raise ValueError(
                    f"decode_fused kernel: weights {s.dtype} on {s.device}, "
                    f"the step runs {dtype} on {dev} (cast_weights first)"
                )
        b, d = self.n_slots, cfg.d_model
        plans = list(plan.proj_plans) + [plan.head_plan]
        self.bits = [p.spec.b_adc for p in plans]
        self.span = spans(plans)
        self.vec_ok = self._vec_ok()
        self.layout = fused_layout(self.items, cfg, b, self.s_max)
        self.xq_stride, self.part_stride = workspace_strides(plans, b, cfg)
        self.freqs = rope_freqs(cfg.hd, cfg.rope_theta, dev)
        self.x = torch.empty((b, d), dtype=dtype, device=dev)
        self.x1 = torch.empty((b, d), dtype=dtype, device=dev)
        self.xq = torch.empty((3, self.xq_stride), dtype=dtype, device=dev)
        self.part = torch.empty((3, self.part_stride), dtype=torch.float32, device=dev)
        self.grid = max_blocks(dtype, dev, self.layout.smem_bytes)
        self.row_slices = row_slices(self.grid, b, d)
        # sized by the card's SM count, not this grid: the per-layer decode's
        # attention kernel (kernels/decode_rows.py) takes the same passes, so
        # their AV sums agree bit for bit
        self.attn_heads = attn_heads(self.layout.heads_per_pass, b, cfg.n_heads,
                                     sm_count(dev))
        self.item_rows = item_table(self.items, plans, b, self.span, plan.n_groups,
                                    self.grid).to(dev)

    def _launch(self, h0: Tensor, cache: KVCache, grid: int, phases: int = 0):
        """Launch the kernel on ``grid`` blocks; ``phases`` > 0 ends it
        after that many phases (see :data:`PHASES_PER_LAYER`), leaving the
        workspace as that phase wrote it."""
        cfg, b = self.cfg, self.n_slots
        k, v, lens = cache
        if (h0.shape != (b, cfg.d_model) or h0.dtype != cfg.dtype
                or k.shape != (self.plan.n_groups, b, self.s_max, cfg.n_kv_heads, cfg.hd)
                or k.dtype != cfg.dtype or v.shape != k.shape or v.dtype != k.dtype
                or lens.shape != (b,) or lens.dtype != torch.int32):
            raise ValueError(
                f"decode_fused kernel: h0 {tuple(h0.shape)} {h0.dtype}, cache "
                f"{tuple(k.shape)} {k.dtype}, lengths {tuple(lens.shape)} "
                f"{lens.dtype} do not match the decoder's {b} slots x "
                f"{self.s_max} positions in {cfg.dtype}"
            )
        for t in (h0, k, v, lens):
            if t.device != self.device or not t.is_contiguous():
                raise ValueError("decode_fused kernel needs contiguous tensors on the decoder's device")
        logits = torch.empty((b, cfg.vocab), dtype=cfg.dtype, device=self.device)
        lens_out = torch.empty_like(lens)
        tensors = [h0, lens, lens_out, self.tab, self.n1, self.n2, self.fin,
                   *self.stacks, self.w_head, k, v, self.freqs, logits,
                   self.x, self.x1, self.xq, self.part, self.item_rows]
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        lay = self.layout
        ints = [self.plan.n_groups, b, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.hd, cfg.d_ff, cfg.vocab, self.s_max, *self.bits, *self.span,
                *self.vec_ok, self.xq_stride, self.part_stride, int(phases),
                *lay.tc, lay.stages, lay.x_rows, self.attn_heads, self.row_slices,
                lay.smem_x, lay.smem_work, lay.smem_bytes, self.item_rows.shape[1]]
        iarr = (ctypes.c_int * len(ints))(*ints)
        farr = (ctypes.c_float * 2)(cfg.norm_eps, cfg.hd**-0.5)
        fn, _, err_str = _fn()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = fn(ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(iarr, ctypes.c_void_p),
                    ctypes.cast(farr, ctypes.c_void_p), _DTYPES[cfg.dtype], grid, stream)
        if rc != 0:
            raise RuntimeError(
                f"decode_fused kernel launch failed: {err_str(rc).decode()} "
                f"(grid {grid}, {b} slots, {self.plan.n_groups} layers, "
                f"dtype {cfg.dtype})"
            )
        build.bump(sys.modules[__name__], "launches")
        return logits, lens_out

    # -- the slot cache ----------------------------------------------------------

    def new_cache(self) -> KVCache:
        """An empty stacked slot cache for this decoder's slots."""
        return init_fused_cache(self.cfg, self.plan.n_groups, self.n_slots,
                                self.s_max, self.cfg.dtype, device=self.device)

    @staticmethod
    def write_slot(cache: KVCache, src: tuple, slot: int) -> KVCache:
        return write_fused_slot(cache, src, slot)

    @staticmethod
    def reset_slot(cache: KVCache, slot: int) -> KVCache:
        return reset_fused_slot(cache, slot)

    @staticmethod
    def kv_bytes(cache: KVCache) -> int:
        return cache.k.nbytes + cache.v.nbytes

    # -- one step --------------------------------------------------------------

    def step(self, tok: Tensor, cache: KVCache, rng=None):
        """One decode step -> (logits (B, 1, V), cache with every length + 1).

        ``tok``: (B, 1) int. The K/V rows are written into ``cache`` in
        place; the returned cache shares its buffers. The kernel runs on
        every block the card holds at once. With ``rng`` and a program that
        resamples read noise, this step's weight stacks are drawn afresh.
        """
        if rng is not None and self.analog_cfg.resample_read_noise:
            self._set_weights(*_resampled_stacks(self.params, self.analog_cfg, rng))
        h0 = embedding_apply(self.params.embed, tok.long(), self.cfg.dtype)
        b = h0.shape[0]
        if h0.device.type == "cuda":
            logits, lens_out = self._launch(h0.reshape(b, -1).contiguous(), cache, self.grid)
            return logits[:, None, :], KVCache(cache.k, cache.v, lens_out)
        if h0.device.type != "cpu":
            raise ValueError(f"fused_decode_step: unsupported device {h0.device}")
        logits = decode_fused_ref(
            self.tab, h0, cache.length, self.n1, self.n2, self.stacks,
            self.w_head, self.fin, cache.k, cache.v, plan=self.plan, cfg=self.cfg,
        )
        return logits, KVCache(cache.k, cache.v, cache.length + 1)


def fused_decode_step(
    params,
    tok: Tensor,
    cache: KVCache,
    plan: engine_lib.FusedDecodePlan,
    model_cfg: ModelConfig,
    analog_cfg,
    *,
    rng=None,
):
    """One decode step for the whole programmed model.

    ``tok``: (B, 1) int; ``cache``: the :func:`init_fused_cache` layout.
    Returns ``(logits (B, 1, V), cache)`` with every slot's length advanced
    by one; the K/V rows are written in place. Builds its inputs on every
    call: a serving loop keeps one :class:`FusedDecoder` instead.
    """
    b, s_max = int(cache.k.shape[1]), int(cache.k.shape[2])
    dec = FusedDecoder(params, plan, model_cfg, analog_cfg, b, s_max, rng=rng)
    return dec.step(tok, cache)


# ---------------------------------------------------------------------------
# The library
# ---------------------------------------------------------------------------


def _fn():
    global _FN
    with build.LOCK:
        if _FN is None:
            lib = build.load("decode_fused")
            fn = lib.decode_fused_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            mb = lib.decode_fused_max_blocks
            mb.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            mb.restype = ctypes.c_int
            lib.decode_fused_error_string.argtypes = [ctypes.c_int]
            lib.decode_fused_error_string.restype = ctypes.c_char_p
            _FN = (fn, mb, lib.decode_fused_error_string)
    return _FN


def max_blocks(dtype: torch.dtype, device, smem_bytes: int) -> int:
    """Blocks of the kernel the card holds at once with ``smem_bytes`` of
    dynamic shared memory each: the largest grid a cooperative launch
    accepts."""
    dev = torch.device(device)
    _, mb, err_str = _fn()
    n = mb(_DTYPES[dtype], dev.index if dev.index is not None else torch.cuda.current_device(),
           int(smem_bytes))
    if n <= 0:
        raise RuntimeError(f"decode_fused occupancy query failed: {err_str(-n).decode()}")
    return n


