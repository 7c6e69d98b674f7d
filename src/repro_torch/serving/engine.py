"""Continuous-batching serving engine over ONE programmed chip.

Port of ``repro.serving.engine`` (the rectangular per-slot path). The
:class:`ServingEngine` owns a compiled ``CiMProgram`` (or digital params),
a per-slot KV cache (``models.lm.init_lm_cache(..., per_slot=True)``: B
independent request slots with per-slot lengths) and an eager decode step
that advances every slot together; on a card every programmed MVM of that
step launches the Hopper kernel.

Lifecycle of a request: *admit* -- prefilled alone (batch 1, exact prompt
length), its cache written into a free slot, the prefill's greedy token
seeding the slot; *decode* -- one forward over all slots per step;
*retire* -- on EOS or budget the slot is recorded and reset. Slots are
independent, so a request's tokens equal serving it alone.

With ``ref_params`` the engine also decodes a digital full-precision
reference in lockstep, teacher-forced on the served tokens, and counts
greedy top-1 agreement and logit MSE against it.

With ``ServingConfig(paged=True)`` the main cache is the paged layout
(``models.attention.PagedKVCache``): per-layer page pools shared by every
slot, pages handed out by a :class:`~repro_torch.serving.paging.PageAllocator`
(a request's worst case is reserved at admission, pages are appended as it
grows and freed at retirement). Prefill is bucketed: prompts are
right-padded to the bucket grid and same-bucket admissions share one
``(rows, bucket)`` prefill call, whose prefill attention is shape-stable,
so paged serving gives the rectangular engine's tokens.

With ``ServingConfig(fused_decode=True)`` the main cache is the stacked
``(L, B, S, kv, hd)`` layout of ``kernels.decode_fused`` and each decode
step of the programmed chip is ONE launch of the fused kernel on a card
(its plain version on the CPU); prefill stays per layer, and the digital
reference keeps the per-slot layout and the unfused forward.

The chip can change under a live engine: :meth:`ServingEngine.age_to`
re-evaluates it at a later age (zero programming events),
:meth:`ServingEngine.refresh` rewrites it from the source weights, and a
:class:`~repro_torch.serving.config.DriftPolicy` does both between decode
steps of one run. Per-call keys follow the reference: a request's prefill
draws under ``fold_in(rng, 1_000_000 + rid)``, decode step ``n`` under
``fold_in(rng, n)``, a refresh at step ``n`` under ``fold_in(rng,
7_000_000 + n)``.

Sharded serving (``mesh=``, a ``DeviceMesh`` over one rank a device; the
chip from ``launch.steps.program_for_serving(mesh=)`` or
``checkpoint.store.load_program(shardings=)``): every rank runs this same
engine -- scheduler, page allocator and keys are pure Python fed only
values that are the same on every rank (the forward's logits are whole on
each), so every decision is the same without a broadcast. The forward is
tensor-parallel over ``model`` (``core.analog``: a rank's columns, tiles
or experts; its caches hold its KV heads). A ``data`` axis greater than 1
gives each data group its rows of the slot batch in the decode step, the
step's logits all-gathered (prefill stays whole on every rank). The
recurrent families' SSD, conv and RG-LRU states are whole on every rank
(each projection's output is). Fused decode refuses a mesh, as the
reference does.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch import collectives
from repro_torch import prng
from repro_torch.core import engine as engine_mod
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.engine import CiMProgram
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_fused
from repro_torch.models.common import ModelConfig
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.lm import (
    append_cache_page,
    block_period,
    cache_kv_heads,
    cache_layers,
    check_pageable,
    free_cache_slot_paged,
    init_lm_cache,
    kv_layers,
    lm_forward,
    reset_cache_slot,
    write_cache_slot,
    write_cache_slot_paged,
)
from repro_torch.serving.config import DriftPolicy, ServingConfig
from repro_torch.serving.paging import (
    PageAllocator,
    bucket_for,
    default_buckets,
    pages_for,
    prefill_rows,
)
from repro_torch.serving.requests import Request, RequestRecord
from repro_torch.serving.scheduler import ContinuousScheduler

Tensor = torch.Tensor


class _LayerDecoder:
    """The served model's per-layer decode over the per-slot list cache (or
    over the paged cache, which the same forward reads): the counterpart of
    ``decode_fused.FusedDecoder``, with the same methods, so an engine holds
    one decoder and never branches on the cache layout."""

    def __init__(self, eng: "ServingEngine"):
        self.eng = eng

    def new_cache(self) -> tuple:
        return self.eng.new_cache(self.eng.n_slots, per_slot=True)

    write_slot = staticmethod(write_cache_slot)
    reset_slot = staticmethod(reset_cache_slot)

    @staticmethod
    def kv_bytes(cache) -> int:
        # attention K/V only, as the reference counts (recurrent states
        # are a fixed few rows a slot)
        return sum(c.k.nbytes + c.v.nbytes for c in kv_layers(cache))

    def step(self, tok: Tensor, cache, rng=None):
        eng = self.eng
        if eng.data_rows is None:
            return lm_forward(eng.params, {"tokens": tok.long()}, eng.acfg, eng.cfg,
                              rng=rng, cache=cache)
        # this data group's slots, the step's logits gathered over the groups
        rows, axis = eng.data_rows
        a, b = rows.start, rows.stop
        logits, _ = lm_forward(eng.params, {"tokens": tok[a:b].long()}, eng.acfg, eng.cfg,
                               rng=rng, cache=_rows_view(cache, a, b))
        return collectives.all_gather_dim(logits, 0, rows.bounds, axis), _advanced(cache)

    def set_params(self, params) -> None:
        pass  # the forward reads ``eng.params`` every step


def _rows_view(cache: tuple, a: int, b: int) -> tuple:
    """Slots ``a:b`` of a list-layout slot cache, as views (a step's KV
    writes land in the whole cache's buffers)."""
    def rows(c):
        if isinstance(c, KVCache):
            return KVCache(c.k[a:b], c.v[a:b], c.length[a:b])
        return PagedKVCache(c.k, c.v, c.table[a:b], c.length[a:b], c.s_max)

    groups, tail = cache
    return [tuple(rows(c) for c in g) for g in groups], tuple(rows(c) for c in tail)


def _advanced(cache: tuple) -> tuple:
    """The slot cache after a decode step: every slot one token longer, as
    the whole batch's forward leaves it (retired slots keep stepping)."""
    def step(c):
        return c._replace(length=c.length + 1)

    groups, tail = cache
    return [tuple(step(c) for c in g) for g in groups], tuple(step(c) for c in tail)


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list[int]
    admit_step: int
    admit_t: float


class _SlotRectangles:
    """How a rectangular (or fused) run holds its slots: each slot owns its
    ``s_max`` rectangle of the decoder's cache, so admission never waits
    for memory. The counterpart of :class:`_PagePool`, with its methods."""

    room = math.inf
    peak_in_use = 0

    def __init__(self, eng: "ServingEngine"):
        self.decoder = eng.decoder

    def new_cache(self) -> tuple:
        return self.decoder.new_cache()

    def check(self, req: Request) -> None:
        pass

    def worst_case(self, req: Request) -> int:
        return 0

    def write(self, cache, pcache, slot: int, row: int, req: Request):
        return self.decoder.write_slot(cache, pcache, slot)

    def grow(self, cache, slots: list):
        return cache

    def release(self, cache, slot: int):
        return self.decoder.reset_slot(cache, slot)

    def check_drained(self) -> None:
        pass


class _PagePool:
    """How a paged run holds its slots: one paged cache, its free list, the
    pages each slot owns and the pages reserved for their growth.

    Admission reserves a request's WORST-CASE page count (prompt + full
    budget) and allocates its prompt's pages; decode appends a page when a
    slot's next write crosses a page boundary, out of that reservation, so
    a request that got in can never run the pool dry mid-decode. Release
    zeroes the slot's pages and returns them with the unused reservation.
    """

    def __init__(self, eng: "ServingEngine"):
        self.eng = eng
        self.page_size = eng.page_size
        self.allocator = PageAllocator(eng.n_pages)
        self.reserved = 0  # pages reserved by live slots, not yet allocated
        self.owned: dict[int, list[int]] = {}  # slot -> page ids, in order
        self.reserve: dict[int, int] = {}  # slot -> its part of `reserved`

    def new_cache(self) -> tuple:
        eng = self.eng
        return init_lm_cache(
            eng.cfg, eng.n_slots, eng.s_max, eng.cfg.dtype, stacked=False,
            paged=True, page_size=self.page_size, n_pages=eng.n_pages,
            device=eng.device, kv_heads=cache_kv_heads(eng.params, eng.cfg),
        )

    @property
    def room(self) -> int:
        """Pages neither allocated nor reserved: what admission may claim."""
        return self.allocator.n_free - self.reserved

    @property
    def peak_in_use(self) -> int:
        return self.allocator.peak_in_use

    def worst_case(self, req: Request) -> int:
        return pages_for(req.prompt.size + req.max_new_tokens, self.page_size)

    def check(self, req: Request) -> None:
        """Refuse at submission what could never be admitted."""
        if req.features:
            raise NotImplementedError(
                f"request {req.rid}: feature-fed prefill is not "
                "supported in paged mode (bucketed prefill pads "
                "token prompts)"
            )
        need = self.worst_case(req)
        if need > self.allocator.n_pages - 1:
            raise ValueError(
                f"request {req.rid}: worst case needs {need} pages "
                f"of {self.page_size} but the pool has only "
                f"{self.allocator.n_pages - 1} usable -- it could never be "
                "admitted"
            )

    def write(self, cache, pcache, slot: int, row: int, req: Request):
        """Scatter row ``row`` of a bucketed prefill cache into the slot's
        newly allocated pages and reserve the rest of its worst case."""
        n_prompt = int(req.prompt.size)
        n_real = pages_for(n_prompt, self.page_size)
        pages = self.allocator.alloc(n_real)
        left = self.worst_case(req) - n_real
        self.owned[slot], self.reserve[slot] = pages, left
        self.reserved += left
        s_bucket = cache_layers(pcache)[0].k.shape[1]
        pvec = np.zeros((pages_for(s_bucket, self.page_size),), np.int64)
        pvec[:n_real] = pages
        return write_cache_slot_paged(cache, pcache, slot, row, pvec, n_prompt)

    def grow(self, cache, slots: list):
        """Give every live slot whose next write starts a page that page."""
        for i, st in enumerate(slots):
            if st is None:
                continue
            entry = (int(st.req.prompt.size) + len(st.tokens) - 1) // self.page_size
            if entry >= len(self.owned[i]):
                (page,) = self.allocator.alloc(1)
                self.reserved -= 1
                self.reserve[i] -= 1
                self.owned[i].append(page)
                cache = append_cache_page(cache, i, entry, page)
        return cache

    def release(self, cache, slot: int):
        pages = self.owned.pop(slot)
        pvec = np.zeros((self.eng.pages_per_slot,), np.int64)
        pvec[: len(pages)] = pages
        cache = free_cache_slot_paged(cache, slot, pvec)
        self.allocator.free(pages)
        self.reserved -= self.reserve.pop(slot)
        return cache

    def check_drained(self) -> None:
        if self.allocator.n_in_use or self.reserved:
            raise RuntimeError(
                f"page leak: {self.allocator.n_in_use} pages still "
                f"allocated and {self.reserved} still reserved after every "
                "request retired -- admit/retire must conserve the free list"
            )


@dataclasses.dataclass
class ServeReport:
    """Everything a serving run produced: outputs, counters, and metrics."""

    records: list[RequestRecord]
    scheduler: str
    n_slots: int
    n_steps: int  # decode steps
    slot_steps: int  # sum over steps of active slots
    t_prefill: float
    t_decode: float
    wall: float
    counters: Optional[dict]  # {"top1", "logit_mse", "decisions"} or None
    age_events: list[dict]
    reprograms: int
    program_events_delta: int  # beyond what refreshes account for: always 0
    #: distinct prefill shapes this ENGINE has run so far; bucketed prefill
    #: bounds it by the bucket count, exact-length prefill grows it with
    #: every distinct prompt length
    n_prefill_traces: int = 0
    #: resident K/V bytes of the decode cache: the slot rectangles, or the
    #: page pools in paged mode (allocated up front, so resident == peak)
    peak_kv_bytes: int = 0
    #: paged mode: the allocator's high-water mark (pages), else 0
    peak_pages_in_use: int = 0

    @property
    def n_requests(self) -> int:
        return len(self.records)

    @property
    def n_generated(self) -> int:
        return sum(r.n_new for r in self.records)

    @property
    def tokens_per_s(self) -> float:
        return self.n_generated / max(self.wall, 1e-9)

    @property
    def requests_per_s(self) -> float:
        return self.n_requests / max(self.wall, 1e-9)

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode slots holding a live request."""
        return self.slot_steps / max(self.n_steps * self.n_slots, 1)

    def latency_s(self, pct: float) -> float:
        """Arrival-to-retirement latency percentile (seconds)."""
        if not self.records:
            return 0.0
        return float(np.percentile([r.latency_s for r in self.records], pct))

    def ttft_s(self, pct: float) -> float:
        """Time-to-first-token percentile (seconds)."""
        if not self.records:
            return 0.0
        return float(np.percentile([r.ttft_s for r in self.records], pct))

    def tokens_of(self, rid: int) -> np.ndarray:
        for r in self.records:
            if r.rid == rid:
                return r.tokens
        raise KeyError(rid)

    def summary(self) -> str:
        line = (
            f"serving: mode={self.scheduler} requests={self.n_requests} "
            f"tokens={self.n_generated} steps={self.n_steps} "
            f"tokens_per_s={self.tokens_per_s:.1f} "
            f"requests_per_s={self.requests_per_s:.2f} "
            f"occupancy={self.occupancy:.3f} "
            f"p50_ms={self.latency_s(50) * 1e3:.0f} "
            f"p95_ms={self.latency_s(95) * 1e3:.0f} "
            f"p95_ttft_ms={self.ttft_s(95) * 1e3:.0f} "
            f"prefill_traces={self.n_prefill_traces} "
            f"kv_mib={self.peak_kv_bytes / 2**20:.1f} "
            f"reprograms={self.reprograms} "
            f"program_events_delta={self.program_events_delta}"
        )
        if self.counters is not None:
            line += (
                f" top1_agreement={self.counters['top1']:.4f}"
                f" logit_mse={self.counters['logit_mse']:.6e}"
            )
        return line


def _data_rows(mesh: Any, n_slots: int) -> Optional[tuple]:
    """(this rank's ``launch.sharding.Split`` of the slots, the data axis)
    when ``mesh`` has a data axis greater than 1 that divides the slots
    (``launch.sharding.batch_axis``), else None."""
    if mesh is None:
        return None
    from repro_torch.launch import sharding as shd

    axis = collectives.axis_of(mesh, "data")
    if axis is None or axis.size == 1 or shd.batch_axis(mesh, n_slots) is None:
        return None
    return shd.Split(0, shd.even_bounds(n_slots, axis.size), axis.rank), axis


class ServingEngine:
    """Request-level serving over one model (programmed chip or digital).

    ``ServingEngine(model_cfg, analog_cfg, params, ServingConfig(...),
    device=...)``; for a compiled chip use :meth:`for_program`. ``params``
    and ``ref_params`` must live on ``device``. Analog weights are executed
    from a copy pre-cast to the model dtype (``engine.cast_weights``:
    bitwise the reference's per-call cast). ``src_params`` is the refresh
    policy's reprogramming source; ``rng`` (a threefry key, default
    ``PRNGKey(0)``) keys the per-call draws of a config that needs them.

    ``config.paged`` switches the slot cache to the paged layout with
    bucketed prefill: prompts are right-padded to ``prefill_buckets``
    (default: a geometric 32*2^k grid up to ``s_max``), and ``prefill_batch``
    sets the rows of a prefill call at the SMALLEST bucket, fewer at larger
    buckets (a constant prefill token budget), so each bucket has exactly one
    ``(rows, bucket)`` shape.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        analog_cfg: AnalogConfig,
        params: Any,
        config: Optional[ServingConfig] = None,
        *,
        program: Optional[CiMProgram] = None,
        ref_params: Any = None,
        src_params: Any = None,
        mesh: Any = None,
        rng: Optional[Tensor] = None,
        device="cuda",
    ):
        if config is None:
            raise TypeError(
                "ServingEngine needs a ServingConfig, e.g. ServingEngine("
                "model_cfg, analog_cfg, params, ServingConfig(n_slots=4, "
                "s_max=64))"
            )
        if mesh is not None:
            if config.fused_decode:
                raise NotImplementedError(
                    "fused decode runs the whole step in one single-"
                    "device kernel; sharded serving keeps the per-layer "
                    "path"
                )
            from repro_torch.launch.steps import use_mesh

            use_mesh(mesh, model_cfg)
        if model_cfg.n_codebooks:
            raise NotImplementedError(
                "request-level serving drives a single token stream; "
                "multi-codebook decoders are not supported"
            )
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("ref_params", ref_params),
                           ("src_params", src_params)):
            if tree is not None and tree.gain_s.device.type != self.device.type:
                raise ValueError(
                    f"{name} live on {tree.gain_s.device}, the engine on "
                    f"{self.device}"
                )
        self.cfg = model_cfg
        self.acfg = analog_cfg
        self.mesh = mesh
        #: (this data group's slot rows, the data axis) when the slot batch
        #: is split over a data axis greater than 1
        self.data_rows = _data_rows(mesh, int(config.n_slots))
        self.params = engine_mod.cast_weights(params, model_cfg.dtype)
        self.program = program
        self.src_params = src_params
        self.rng = (prng.PRNGKey(0) if rng is None else rng).to(self.device)
        self.reprograms = 0
        self.config = config
        self.n_slots = int(config.n_slots)
        self.s_max = int(config.s_max)
        self._ref = ref_params is not None and config.ref_check
        self.ref_params = (
            engine_mod.cast_weights(ref_params, model_cfg.dtype)
            if self._ref else None
        )
        self._digital = AnalogConfig()
        #: distinct prefill shapes run by this engine
        self._prefill_shapes: set = set()

        self.paged = bool(config.paged)
        if self.paged:
            if model_cfg.frontend in ("audio_frames", "vision_patches"):
                raise NotImplementedError(
                    "bucketed prefill pads token prompts; feature-fed "
                    f"frontends ({model_cfg.frontend!r}) are not supported "
                    "in paged mode"
                )
            check_pageable(model_cfg)
            self.page_size = int(config.page_size)
            self.pages_per_slot = pages_for(self.s_max, self.page_size)
            self.n_pages = int(
                config.n_pages if config.n_pages is not None
                else self.n_slots * self.pages_per_slot + 1
            )
            buckets = (
                tuple(config.prefill_buckets) if config.prefill_buckets
                else default_buckets(self.s_max)
            )
            self.prefill_buckets = tuple(
                sorted({min(int(b), self.s_max) for b in buckets} | {self.s_max})
            )
            if min(self.prefill_buckets) < 1:
                raise ValueError(
                    f"prefill buckets must be >= 1: {self.prefill_buckets}"
                )
            # per-request rng keys and MoE capacity routing both couple a
            # prefill batch's rows to its composition; solo prefill keeps
            # paged serving bit-identical to the rectangular engine
            solo = analog_cfg.needs_rng or "moe" in block_period(model_cfg)
            self.prefill_batch = 1 if solo else int(config.prefill_batch)
            self._pb_of = prefill_rows(self.prefill_buckets, self.prefill_batch)

        self.decoder: Any = _LayerDecoder(self)
        if config.fused_decode:
            if program is None:
                raise ValueError(
                    "fused_decode executes a compiled CiMProgram's per-"
                    "layer plans as one launch; pass program= (or use "
                    "ServingEngine.for_program)"
                )
            if block_period(model_cfg) != ["attn"]:
                raise NotImplementedError(
                    "fused decode supports the dense attention+FFN layer "
                    f"walk; family {model_cfg.family!r} has recurrent or "
                    "MoE blocks with no grid-step lowering"
                )
            # raises ValueError when the artifact's plans can't be
            # statically fused (tail layers, biases, missing GDC scalars)
            self.decoder = decode_fused.FusedDecoder(
                self.params, engine_mod.build_fused_plan(program), model_cfg,
                analog_cfg, self.n_slots, self.s_max,
            )

    # -- chip lifecycle -------------------------------------------------------

    def set_program(self, program: CiMProgram) -> None:
        """Serve a new evaluation of the chip (an aged or refreshed one):
        the pre-cast weights and the decoder's inputs follow it."""
        self.program = program
        self.acfg = program.cfg
        self.params = engine_mod.cast_weights(program.params, self.cfg.dtype)
        self.decoder.set_params(self.params)

    def age_to(self, t_seconds: float) -> None:
        """Age the served chip in place (zero programming events, asserted
        by ``engine.age_program``)."""
        if self.program is None:
            raise RuntimeError("no compiled program to age (digital engine)")
        if float(t_seconds) != self.program.t_seconds:
            self.set_program(engine_mod.age_program(self.program, t_seconds))

    def refresh(self, key: Tensor) -> int:
        """Reprogram the chip from the source weights; returns the
        programming events consumed (the run's allowance)."""
        from repro_torch.launch import steps

        if self.program is None or self.src_params is None:
            raise RuntimeError("refresh needs a compiled program and src_params")
        before = engine_mod.program_event_count()
        self.set_program(steps.refresh_program(self.program, self.src_params, key,
                                               mesh=self.mesh, model_cfg=self.cfg))
        self.reprograms += 1
        return engine_mod.program_event_count() - before

    @classmethod
    def for_program(
        cls,
        program: CiMProgram,
        model_cfg: ModelConfig,
        config: Optional[ServingConfig] = None,
        **kw,
    ) -> "ServingEngine":
        """Engine over a compiled chip: executes (program.params, .cfg); a
        sharded chip is served over its mesh unless ``mesh=`` says
        otherwise."""
        kw.setdefault("mesh", program.mesh)
        return cls(model_cfg, program.cfg, program.params, config,
                   program=program, **kw)

    # -- the forward passes -------------------------------------------------

    def new_cache(self, batch: int, per_slot: bool, params: Any = None) -> tuple:
        """A list-layout cache for ``params``' forward (default: the served
        chip's; a sharded chip's holds the rank's KV heads)."""
        return init_lm_cache(
            self.cfg, batch, self.s_max, self.cfg.dtype, stacked=False,
            per_slot=per_slot, device=self.device,
            kv_heads=cache_kv_heads(self.params if params is None else params, self.cfg),
        )

    def _prefill_inputs(self, req: Request) -> dict:
        """A request's prefill batch: its prompt's tokens (1, S) and its
        ``features`` (a vision request's ``patches``), on the engine's
        device."""
        batch = {"tokens": torch.as_tensor(req.prompt, device=self.device)[None, :].long()}
        for k, v in (req.features or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)
        return batch

    def call_key(self, i: int) -> Optional[Tensor]:
        """``fold_in(rng, i)`` when the config draws per call, else None."""
        return prng.fold_in(self.rng, i) if self.acfg.needs_rng else None

    def prefill_bucket(self, toks: Tensor, last_idx: Tensor, rng=None):
        """Bucketed prefill of the served model: ``toks`` (PB, S_bucket)
        right-padded prompts, ``last_idx`` (PB,) each row's last real
        position -> (tokens (PB,), logits (PB, V), rectangular list cache)."""
        pb, sb = toks.shape
        cache = init_lm_cache(
            self.cfg, pb, sb, self.cfg.dtype, stacked=False, device=self.device,
            kv_heads=cache_kv_heads(self.params, self.cfg),
        )
        logits, cache = lm_forward(
            self.params, {"tokens": toks.long()}, self.acfg, self.cfg, rng=rng,
            cache=cache, last_token_only=True, last_index=last_idx,
        )
        last = logits[:, -1]
        return last.argmax(dim=-1).to(torch.int32), last, cache

    def prefill(self, params, acfg, req: Request, rng=None):
        """Prefill one request alone -> (token (1,), logits (1, V), cache).

        Prefill keeps its torch ops on a card: the fused kernel (B2) has no
        prefill counterpart, and its attention is B3."""
        cache = self.new_cache(1, per_slot=False, params=params)
        logits, cache = lm_forward(
            params, self._prefill_inputs(req), acfg, self.cfg,
            rng=rng, cache=cache, last_token_only=True,
        )
        last = logits[:, -1]
        return last.argmax(dim=-1).to(torch.int32), last, cache

    def decode(self, params, acfg, tok: Tensor, cache):
        """One decode step over all slots -> (tokens (B,), logits, cache)."""
        logits, cache = lm_forward(
            params, {"tokens": tok.long()}, acfg, self.cfg, cache=cache
        )
        last = logits[:, -1]
        return last.argmax(dim=-1).to(torch.int32), last, cache

    def decode_main(self, tok: Tensor, cache, rng=None):
        """One decode step of the served model over all slots, through its
        decoder (one fused launch with ``fused_decode``, else per layer)."""
        logits, cache = self.decoder.step(tok, cache, rng)
        last = logits[:, -1]
        return last.argmax(dim=-1).to(torch.int32), last, cache

    @staticmethod
    def count(a: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
        """Per-row greedy agreement and squared logit error vs the reference."""
        a, r = a.float(), r.float()
        agree = (a.argmax(dim=-1) == r.argmax(dim=-1)).float()
        return agree, ((a - r) ** 2).sum(dim=-1)

    # -- serving ------------------------------------------------------------

    def start_run(
        self,
        *,
        scheduler: Any = None,
        drift_policy: Any = None,
        clock: Optional[clock_lib.Clock] = None,
        max_steps: Optional[int] = None,
        track_events: bool = True,
        on_token=None,
        on_retire=None,
    ) -> "EngineRun":
        """Open a fresh :class:`EngineRun` (fresh slot caches). Time enters
        only through ``clock`` (default: the system clock).
        ``track_events=False`` leaves the
        program-event accounting to an outer owner (the fleet router owns
        it fleet-wide: engines share the process-wide counter, so a run's
        own delta would see a sibling chip's refresh).

        ``on_token(rid, token)`` fires for every token as it reaches the
        host -- the first at admission, then one per decode step -- and
        ``on_retire(record)`` when a request retires. Both run inline on
        the thread stepping the run; they must be cheap and must not call
        back into the run."""
        clk = clock or clock_lib.SYSTEM
        return EngineRun(
            self,
            scheduler=scheduler or ContinuousScheduler(),
            drift_policy=drift_policy,
            now_fn=clk.now,
            sleep_fn=clk.sleep,
            max_steps=max_steps,
            track_events=track_events,
            on_token=on_token,
            on_retire=on_retire,
        )

    def run(
        self,
        requests: list[Request],
        *,
        scheduler: Any = None,
        drift_policy: Optional[DriftPolicy] = None,
        clock: Optional[clock_lib.Clock] = None,
        max_steps: Optional[int] = None,
    ) -> ServeReport:
        """Serve ``requests`` to completion and return the run's report."""
        run = self.start_run(scheduler=scheduler, drift_policy=drift_policy,
                             clock=clock, max_steps=max_steps)
        run.submit(requests)
        while run.has_work:
            run.admit_arrived()
            if run.n_active == 0:
                if not run.queue:
                    break
                run.idle_wait()  # every queued request is still in flight
                continue
            run.decode_step()
        return run.finish()


class ChipClock:
    """The drift lifecycle of one served chip, the one place its policy
    lives (the engine's ``DriftPolicy`` ticks and the CLI's schedule both
    use it): wall (deployment) ages map to device ages, which restart at a
    refresh (``engine.device_age``), and a refresh is due when agreement
    with the digital reference falls below ``refresh_below``."""

    def __init__(self, engine: ServingEngine, t_wall: Optional[float],
                 refresh_below: Optional[float] = None):
        self.engine = engine
        self.refresh_below = refresh_below
        self.wall = t_wall  # wall age the chip was last aged to
        self.refresh_wall: Optional[float] = None  # wall age of the last refresh

    def age_to(self, t_wall: float) -> float:
        """Age the chip to wall age ``t_wall``; returns its device age."""
        self.wall = t_wall
        dev = engine_mod.device_age(t_wall, self.refresh_wall)
        self.engine.age_to(dev)
        return dev

    def wants_refresh(self, top1: float) -> bool:
        return self.refresh_below is not None and top1 < self.refresh_below

    def refresh(self, key: Tensor) -> int:
        """Rewrite the chip from its source weights at the current wall age;
        returns the programming events consumed."""
        consumed = self.engine.refresh(key)
        self.refresh_wall = self.wall
        return consumed


class EngineRun:
    """One serving run's state plus its stepping surface.

    Not internally synchronized: exactly one caller steps a run (in a
    fleet, the chip's owning worker).
    """

    def __init__(
        self,
        engine: ServingEngine,
        *,
        scheduler: Any,
        drift_policy: Optional[DriftPolicy] = None,
        now_fn,
        sleep_fn,
        max_steps: Optional[int],
        track_events: bool = True,
        on_token=None,
        on_retire=None,
    ):
        if drift_policy is not None and engine.program is None:
            raise ValueError("a drift policy ages a compiled program (program=)")
        self.eng = engine
        self.scheduler = scheduler
        self.drift_policy = drift_policy
        self.now_fn = now_fn
        self.sleep_fn = sleep_fn
        self.max_steps = max_steps
        self.track_events = track_events
        self.on_token = on_token
        self.on_retire = on_retire

        self.queue: deque[Request] = deque()
        self.pool = _PagePool(engine) if engine.paged else _SlotRectangles(engine)
        self.cache = self.pool.new_cache()
        self.peak_kv_bytes = engine.decoder.kv_bytes(self.cache)
        self.ref_cache = (
            engine.new_cache(engine.n_slots, per_slot=True, params=engine.ref_params)
            if engine._ref else None
        )
        self.cur = torch.zeros(
            (engine.n_slots, 1), dtype=torch.int32, device=engine.device
        )
        self.slots: list[Optional[_Slot]] = [None] * engine.n_slots
        self.records: list[RequestRecord] = []
        self.steps = 0
        self.slot_steps = 0
        self.agree_sum = 0.0
        self.err_sum = 0.0
        self.decisions = 0
        self.t_prefill = 0.0
        self.t_decode = 0.0
        self.events0 = engine_mod.program_event_count()
        self.allowed_events = 0
        self.reprograms0 = engine.reprograms
        self.age_events: list[dict] = []
        # drift-policy state: the program is compiled at the schedule's
        # first age
        self.pol_idx = 1
        self.chip = ChipClock(
            engine, drift_policy.schedule.times[0] if drift_policy else None,
            drift_policy.refresh_below if drift_policy else None,
        )
        self.seg_agree = 0.0
        self.seg_dec = 0
        self.t_start = now_fn()

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def elapsed(self) -> float:
        """Seconds since the run started (on the run's clock)."""
        return self.now_fn() - self.t_start

    def live(self) -> list[tuple[int, Request, list[int]]]:
        """Snapshot of the live slots: ``(slot, request, tokens so far)``."""
        return [(i, st.req, list(st.tokens)) for i, st in enumerate(self.slots)
                if st is not None]

    def submit(self, requests: list[Request]) -> None:
        """Validate and enqueue requests (arrival-sorted, FIFO within ties);
        mid-run submission is fine -- the fleet router feeds migrated
        continuations this way."""
        eng = self.eng
        for r in requests:
            if r.prompt.size + r.max_new_tokens > eng.s_max:
                raise ValueError(
                    f"request {r.rid}: prompt ({r.prompt.size}) + budget "
                    f"({r.max_new_tokens}) exceeds the engine's s_max="
                    f"{eng.s_max}"
                )
            self.pool.check(r)
        merged = list(self.queue) + list(requests)
        merged.sort(key=lambda r: r.arrival_t)
        self.queue = deque(merged)

    def idle_wait(self) -> None:
        """Sleep toward the next queued arrival (nothing is decodable)."""
        wait = self.queue[0].arrival_t - (self.now_fn() - self.t_start)
        self.sleep_fn(max(min(wait, 0.01), 1e-4))

    def admit_arrived(self) -> None:
        """Move arrived requests into free slots (scheduler-gated). The
        queue is arrival-sorted, so the arrived requests are its prefix; a
        scheduler's ``order`` hook picks WHICH of them enter (default:
        FIFO). In paged mode each admission reserves its worst-case pages
        and admission stops at the first request the pool cannot reserve."""
        eng = self.eng
        now = self.now_fn() - self.t_start
        n_arrived = sum(1 for r in self.queue if r.arrival_t <= now)
        free = [i for i, s in enumerate(self.slots) if s is None]
        n_admit = self.scheduler.admit(n_arrived, len(free), eng.n_slots - len(free))
        # a scheduler cannot over-admit
        n_admit = min(n_admit, n_arrived, len(free))
        arrived = [self.queue[j] for j in range(n_arrived)]
        order_fn = getattr(self.scheduler, "order", None)
        perm = list(order_fn(arrived)) if order_fn else list(range(n_arrived))
        admitted: list[tuple[Request, int]] = []  # (request, queue index)
        pending = 0  # pages claimed by this round's earlier admissions
        for j in perm[:n_admit]:
            req = arrived[j]
            need = self.pool.worst_case(req)
            if self.pool.room - pending < need:
                break  # head-of-line blocking: stop rather than starve a long request
            pending += need
            admitted.append((req, j))
        for j in sorted((j for _, j in admitted), reverse=True):
            del self.queue[j]
        if eng.paged:
            self._admit_paged([r for r, _ in admitted], free)
        else:
            for req, _ in admitted:
                self._admit(req, free.pop(0))

    def _admit(self, req: Request, slot: int) -> None:
        eng = self.eng
        t0 = self.now_fn()
        eng._prefill_shapes.add((1, int(req.prompt.size)))
        tok0, logits0, pcache = eng.prefill(
            eng.params, eng.acfg, req, eng.call_key(1_000_000 + req.rid))
        self.cache = self.pool.write(self.cache, pcache, slot, 0, req)
        self.cur[slot, 0] = tok0[0]
        first = [int(tok0[0])]  # repro-lint: disable=RL004 -- one sync per ADMISSION: the first token must reach the host record
        if eng._ref:
            r_tok, r_logits, r_pcache = eng.prefill(eng.ref_params, eng._digital, req)
            self.ref_cache = write_cache_slot(self.ref_cache, r_pcache, slot)
            self._count_decision(logits0, r_logits)
        self.t_prefill += self.now_fn() - t0
        self.slots[slot] = _Slot(req, first, self.steps, self.now_fn() - self.t_start)
        if self.on_token is not None:
            self.on_token(req.rid, first[0])
        self.maybe_retire(slot)

    def _admit_paged(self, reqs: list[Request], free: list[int]) -> None:
        """Prefill consecutive same-bucket admissions together in one padded
        ``(rows, bucket)`` call (dummy rows repeat row 0), then scatter each
        request's rows into its newly allocated pages."""
        eng = self.eng
        k0 = 0
        while k0 < len(reqs):
            sb = bucket_for(int(reqs[k0].prompt.size), eng.prefill_buckets)
            pb = eng._pb_of[sb]
            chunk = [reqs[k0]]
            while (
                len(chunk) < pb
                and k0 + len(chunk) < len(reqs)
                and bucket_for(int(reqs[k0 + len(chunk)].prompt.size),
                               eng.prefill_buckets) == sb
            ):
                chunk.append(reqs[k0 + len(chunk)])
            k0 += len(chunk)
            toks = np.zeros((pb, sb), np.int32)
            lens = np.ones((pb,), np.int32)
            for j, req in enumerate(chunk):
                toks[j, : req.prompt.size] = req.prompt
                lens[j] = req.prompt.size
            for j in range(len(chunk), pb):
                toks[j] = toks[0]  # dummy rows repeat row 0
                lens[j] = lens[0]
            t0 = self.now_fn()
            eng._prefill_shapes.add((pb, sb))
            tokv, logitsv, pcache = eng.prefill_bucket(
                torch.as_tensor(toks, device=eng.device),
                torch.as_tensor(lens - 1, device=eng.device),
                eng.call_key(1_000_000 + chunk[0].rid),
            )
            # repro-lint: disable=RL004 -- one sync per bucketed prefill CALL: the first tokens must reach the host records
            first = tokv.cpu().tolist()
            for j, req in enumerate(chunk):
                slot = free.pop(0)
                self.cache = self.pool.write(self.cache, pcache, slot, j, req)
                self.cur[slot, 0] = tokv[j]
                if eng._ref:
                    _, r_logits, r_pcache = eng.prefill(eng.ref_params, eng._digital, req)
                    self.ref_cache = write_cache_slot(self.ref_cache, r_pcache, slot)
                    self._count_decision(logitsv[j : j + 1], r_logits)
                self.slots[slot] = _Slot(
                    req, [first[j]], self.steps, self.now_fn() - self.t_start
                )
                if self.on_token is not None:
                    self.on_token(req.rid, first[j])
                self.maybe_retire(slot)
            self.t_prefill += self.now_fn() - t0

    def _count_decision(self, a_logits: Tensor, r_logits: Tensor) -> None:
        a, e = self.eng.count(a_logits, r_logits)
        # repro-lint: disable=RL004 -- one sync per ADMISSION for the prefill's counters
        agree, err = torch.stack([a[0].double(), e[0].double()]).cpu().tolist()
        self.agree_sum += agree
        self.err_sum += err
        self.decisions += 1
        self.seg_agree += agree
        self.seg_dec += 1

    def decode_step(self) -> None:
        """One decode step over all slots, then retirement and the runaway
        guard. The step's tokens (and counters) reach the host in ONE read."""
        eng = self.eng
        self.cache = self.pool.grow(self.cache, self.slots)
        t0 = self.now_fn()
        nxt, logits, self.cache = eng.decode_main(
            self.cur, self.cache, eng.call_key(self.steps))
        if eng._ref:
            _, r_logits, self.ref_cache = eng.decode(
                eng.ref_params, eng._digital, self.cur, self.ref_cache
            )
            a, e = eng.count(logits, r_logits)
            host = torch.stack([nxt.double(), a.double(), e.double()])
        else:
            host = nxt[None].double()
        # repro-lint: disable=RL004 -- the step's one host read: tokens + counters
        host = host.cpu().numpy()
        self.t_decode += self.now_fn() - t0
        self.steps += 1
        active = [i for i, s in enumerate(self.slots) if s is not None]
        self.slot_steps += len(active)
        for i in active:
            self.slots[i].tokens.append(int(host[0, i]))
            if self.on_token is not None:
                self.on_token(self.slots[i].req.rid, self.slots[i].tokens[-1])
            if eng._ref:
                self.agree_sum += float(host[1, i])
                self.err_sum += float(host[2, i])
                self.decisions += 1
                self.seg_agree += float(host[1, i])
                self.seg_dec += 1
        self.cur = nxt[:, None]
        for i in active:
            self.maybe_retire(i)
        self._drift_tick()
        if self.max_steps is not None and self.steps >= self.max_steps:
            raise RuntimeError(
                f"serving run exceeded max_steps={self.max_steps} with "
                f"{self.n_active} live slots and {len(self.queue)} queued "
                "requests"
            )

    def _drift_tick(self) -> None:
        """Every ``every_steps`` steps: refresh the chip if the segment's
        agreement fell below ``refresh_below``, then age it to the
        schedule's next wall age."""
        policy = self.drift_policy
        if policy is None or self.steps % policy.every_steps != 0:
            return
        eng = self.eng
        if (eng._ref and self.seg_dec > 0
                and self.chip.wants_refresh(self.seg_agree / self.seg_dec)):
            self.refresh_chip(prng.fold_in(eng.rng, 7_000_000 + self.steps),
                              top1=self.seg_agree / self.seg_dec)
        self.seg_agree, self.seg_dec = 0.0, 0
        if self.pol_idx < len(policy.schedule.times):
            t_wall = policy.schedule.times[self.pol_idx]
            self.pol_idx += 1
            dev = self.chip.age_to(t_wall)
            self.age_events.append(
                {"kind": "age", "step": self.steps, "t_wall": t_wall, "t_device": dev}
            )

    def refresh_chip(self, key: Tensor, top1: Optional[float] = None) -> int:
        """Reprogram this run's chip and add its programming events to the
        run's allowance (the zero-delta check still holds)."""
        consumed = self.chip.refresh(key)
        self.allowed_events += consumed
        self.age_events.append({
            "kind": "reprogram", "step": self.steps, "top1": top1,
            "t_device": self.eng.program.t_seconds,
        })
        return consumed

    def retire(self, i: int, st: _Slot, by: str) -> None:
        # a migrated continuation carries its first chip's first-token time,
        # so ttft_s spans every chip the request touched
        rec = RequestRecord(
            rid=st.req.rid,
            slot=i,
            tokens=np.asarray(st.tokens, np.int32),
            n_prompt=int(st.req.prompt.size),
            admit_step=st.admit_step,
            finish_step=self.steps,
            arrival_t=st.req.arrival_t,
            admit_t=st.admit_t if st.req.first_token_t is None else st.req.first_token_t,
            finish_t=self.now_fn() - self.t_start,
            finished_by=by,
        )
        self.records.append(rec)
        self._release_slot(i)
        if self.on_retire is not None:
            self.on_retire(rec)

    def evict(self, i: int) -> tuple[Request, list[int]]:
        """Remove a LIVE slot without recording a retirement: the fleet
        router's drain path. The request and its tokens so far come back
        for a continuation on a sibling chip; the slot and its pages are
        freed as at retirement, so the run's conservation holds."""
        st = self.slots[i]
        if st is None:
            raise ValueError(f"slot {i} holds no live request")
        self._release_slot(i)
        return st.req, list(st.tokens)

    def _release_slot(self, i: int) -> None:
        self.cache = self.pool.release(self.cache, i)
        if self.eng._ref:
            self.ref_cache = reset_cache_slot(self.ref_cache, i)
        self.slots[i] = None

    def maybe_retire(self, i: int) -> None:
        st = self.slots[i]
        if st.req.eos_id is not None and st.tokens[-1] == st.req.eos_id:
            self.retire(i, st, "eos")
        elif len(st.tokens) >= st.req.max_new_tokens:
            self.retire(i, st, "max_tokens")

    def finish(self) -> ServeReport:
        """Close the run: the program-once check + the final report."""
        eng = self.eng
        wall = self.now_fn() - self.t_start
        delta = engine_mod.program_event_count() - self.events0
        if self.track_events and eng.program is not None and delta != self.allowed_events:
            raise RuntimeError(
                f"serving run recorded {delta} programming events but "
                f"refreshes account for {self.allowed_events} -- the "
                "programmed chip must never be rewritten by serving itself"
            )
        self.pool.check_drained()
        counters = None
        if eng._ref:
            counters = {
                "top1": self.agree_sum / max(self.decisions, 1),
                "logit_mse": self.err_sum / max(self.decisions * eng.cfg.vocab, 1),
                "decisions": self.decisions,
            }
        return ServeReport(
            records=self.records,
            scheduler=getattr(self.scheduler, "name", type(self.scheduler).__name__),
            n_slots=eng.n_slots,
            n_steps=self.steps,
            slot_steps=self.slot_steps,
            t_prefill=self.t_prefill,
            t_decode=self.t_decode,
            wall=wall,
            counters=counters,
            age_events=self.age_events,
            reprograms=eng.reprograms - self.reprograms0,
            program_events_delta=delta - self.allowed_events if self.track_events else 0,
            n_prefill_traces=len(eng._prefill_shapes),
            peak_kv_bytes=self.peak_kv_bytes,
            peak_pages_in_use=self.pool.peak_in_use,
        )
