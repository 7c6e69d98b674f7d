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

With ``ServingConfig(fused_decode=True)`` the main cache is the stacked
``(L, B, S, kv, hd)`` layout of ``kernels.decode_fused`` and each decode
step of the programmed chip is ONE launch of the fused kernel on a card
(its plain version on the CPU); prefill stays per layer, and the digital
reference keeps the per-slot layout and the unfused forward. Paged caches,
meshes and drift policies come in later slices and raise here.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch.core import engine as engine_mod
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.engine import CiMProgram
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_fused
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import (
    block_period,
    cache_layers,
    init_lm_cache,
    lm_forward,
    reset_cache_slot,
    write_cache_slot,
)
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.requests import Request, RequestRecord
from repro_torch.serving.scheduler import ContinuousScheduler

Tensor = torch.Tensor


class _LayerDecoder:
    """The served model's per-layer decode over the per-slot list cache:
    the counterpart of ``decode_fused.FusedDecoder``, with the same methods,
    so an engine holds one decoder and never branches on the cache layout."""

    def __init__(self, eng: "ServingEngine"):
        self.eng = eng

    def new_cache(self) -> tuple:
        return self.eng.new_cache(self.eng.n_slots, per_slot=True)

    write_slot = staticmethod(write_cache_slot)
    reset_slot = staticmethod(reset_cache_slot)

    @staticmethod
    def kv_bytes(cache) -> int:
        return sum(c.k.nbytes + c.v.nbytes for c in cache_layers(cache))

    def step(self, tok: Tensor, cache):
        eng = self.eng
        return lm_forward(eng.params, {"tokens": tok.long()}, eng.acfg, eng.cfg, cache=cache)


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list[int]
    admit_step: int
    admit_t: float


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
    program_events_delta: int  # programming events while serving: always 0
    peak_kv_bytes: int = 0

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
            f"kv_mib={self.peak_kv_bytes / 2**20:.1f} "
            f"program_events_delta={self.program_events_delta}"
        )
        if self.counters is not None:
            line += (
                f" top1_agreement={self.counters['top1']:.4f}"
                f" logit_mse={self.counters['logit_mse']:.6e}"
            )
        return line


class ServingEngine:
    """Request-level serving over one model (programmed chip or digital).

    ``ServingEngine(model_cfg, analog_cfg, params, ServingConfig(...),
    device=...)``; for a compiled chip use :meth:`for_program`. ``params``
    and ``ref_params`` must live on ``device``. Analog weights are executed
    from a copy pre-cast to the model dtype (``engine.cast_weights``:
    bitwise the reference's per-call cast).
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
        mesh: Any = None,
        device="cuda",
    ):
        if config is None:
            raise TypeError(
                "ServingEngine needs a ServingConfig, e.g. ServingEngine("
                "model_cfg, analog_cfg, params, ServingConfig(n_slots=4, "
                "s_max=64))"
            )
        if mesh is not None:
            raise NotImplementedError("sharded serving comes in a later slice")
        if model_cfg.n_codebooks:
            raise NotImplementedError(
                "request-level serving drives a single token stream"
            )
        if analog_cfg.needs_rng:
            raise NotImplementedError(
                f"mode {analog_cfg.mode!r} draws noise per call; this slice "
                "serves frozen programs"
            )
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("ref_params", ref_params)):
            if tree is not None and tree.gain_s.device.type != self.device.type:
                raise ValueError(
                    f"{name} live on {tree.gain_s.device}, the engine on "
                    f"{self.device}"
                )
        self.cfg = model_cfg
        self.acfg = analog_cfg
        self.params = engine_mod.cast_weights(params, model_cfg.dtype)
        self.program = program
        self.config = config
        self.n_slots = int(config.n_slots)
        self.s_max = int(config.s_max)
        self._ref = ref_params is not None and config.ref_check
        self.ref_params = (
            engine_mod.cast_weights(ref_params, model_cfg.dtype)
            if self._ref else None
        )
        self._digital = AnalogConfig()

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
                    "MoE blocks"
                )
            # raises ValueError when the artifact's plans can't be
            # statically fused (tail layers, biases, missing GDC scalars)
            self.decoder = decode_fused.FusedDecoder(
                self.params, engine_mod.build_fused_plan(program), model_cfg,
                analog_cfg, self.n_slots, self.s_max,
            )

    @classmethod
    def for_program(
        cls,
        program: CiMProgram,
        model_cfg: ModelConfig,
        config: Optional[ServingConfig] = None,
        **kw,
    ) -> "ServingEngine":
        """Engine over a compiled chip: executes (program.params, .cfg)."""
        return cls(model_cfg, program.cfg, program.params, config,
                   program=program, **kw)

    # -- the forward passes -------------------------------------------------

    def new_cache(self, batch: int, per_slot: bool) -> tuple:
        return init_lm_cache(
            self.cfg, batch, self.s_max, self.cfg.dtype, stacked=False,
            per_slot=per_slot, device=self.device,
        )

    def _prefill_tokens(self, req: Request) -> Tensor:
        if req.features:
            raise NotImplementedError("feature-fed prefill comes with its families")
        return torch.as_tensor(req.prompt, device=self.device)[None, :].long()

    def prefill(self, params, acfg, req: Request):
        """Prefill one request alone -> (token (1,), logits (1, V), cache)."""
        cache = self.new_cache(1, per_slot=False)
        logits, cache = lm_forward(
            params, {"tokens": self._prefill_tokens(req)}, acfg, self.cfg,
            cache=cache, last_token_only=True,
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

    def decode_main(self, tok: Tensor, cache):
        """One decode step of the served model over all slots, through its
        decoder (one fused launch with ``fused_decode``, else per layer)."""
        logits, cache = self.decoder.step(tok, cache)
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
    ) -> "EngineRun":
        """Open a fresh :class:`EngineRun` (fresh slot caches). Time enters
        only through ``clock`` (default: the system clock)."""
        if drift_policy is not None:
            raise NotImplementedError(
                "drift policies (aging the chip while serving) come with the "
                "drift slice"
            )
        clk = clock or clock_lib.SYSTEM
        return EngineRun(
            self,
            scheduler=scheduler or ContinuousScheduler(),
            now_fn=clk.now,
            sleep_fn=clk.sleep,
            max_steps=max_steps,
        )

    def run(
        self,
        requests: list[Request],
        *,
        scheduler: Any = None,
        clock: Optional[clock_lib.Clock] = None,
        max_steps: Optional[int] = None,
    ) -> ServeReport:
        """Serve ``requests`` to completion and return the run's report."""
        run = self.start_run(scheduler=scheduler, clock=clock, max_steps=max_steps)
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


class EngineRun:
    """One serving run's state plus its stepping surface.

    Not internally synchronized: exactly one caller steps a run.
    """

    def __init__(
        self,
        engine: ServingEngine,
        *,
        scheduler: Any,
        now_fn,
        sleep_fn,
        max_steps: Optional[int],
    ):
        self.eng = engine
        self.scheduler = scheduler
        self.now_fn = now_fn
        self.sleep_fn = sleep_fn
        self.max_steps = max_steps

        self.queue: deque[Request] = deque()
        self.cache = engine.decoder.new_cache()
        self.peak_kv_bytes = engine.decoder.kv_bytes(self.cache)
        self.ref_cache = (
            engine.new_cache(engine.n_slots, per_slot=True) if engine._ref else None
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
        self.t_start = now_fn()

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def submit(self, requests: list[Request]) -> None:
        """Validate and enqueue requests (arrival-sorted, FIFO within ties)."""
        for r in requests:
            if r.prompt.size + r.max_new_tokens > self.eng.s_max:
                raise ValueError(
                    f"request {r.rid}: prompt ({r.prompt.size}) + budget "
                    f"({r.max_new_tokens}) exceeds the engine's s_max="
                    f"{self.eng.s_max}"
                )
        merged = list(self.queue) + list(requests)
        merged.sort(key=lambda r: r.arrival_t)
        self.queue = deque(merged)

    def idle_wait(self) -> None:
        """Sleep toward the next queued arrival (nothing is decodable)."""
        wait = self.queue[0].arrival_t - (self.now_fn() - self.t_start)
        self.sleep_fn(max(min(wait, 0.01), 1e-4))

    def admit_arrived(self) -> None:
        """Move arrived requests into free slots (scheduler-gated), FIFO."""
        eng = self.eng
        now = self.now_fn() - self.t_start
        n_arrived = sum(1 for r in self.queue if r.arrival_t <= now)
        free = [i for i, s in enumerate(self.slots) if s is None]
        n_admit = self.scheduler.admit(n_arrived, len(free), eng.n_slots - len(free))
        # a scheduler cannot over-admit
        n_admit = min(n_admit, n_arrived, len(free))
        admitted = [self.queue.popleft() for _ in range(n_admit)]
        for req in admitted:
            self._admit(req, free.pop(0))

    def _admit(self, req: Request, slot: int) -> None:
        eng = self.eng
        t0 = self.now_fn()
        tok0, logits0, pcache = eng.prefill(eng.params, eng.acfg, req)
        self.cache = eng.decoder.write_slot(self.cache, pcache, slot)
        self.cur[slot, 0] = tok0[0]
        first = [int(tok0[0])]  # repro-lint: disable=RL004 -- one sync per ADMISSION: the first token must reach the host record
        if eng._ref:
            r_tok, r_logits, r_pcache = eng.prefill(eng.ref_params, eng._digital, req)
            self.ref_cache = write_cache_slot(self.ref_cache, r_pcache, slot)
            self._count_decision(logits0, r_logits)
        self.t_prefill += self.now_fn() - t0
        self.slots[slot] = _Slot(req, first, self.steps, self.now_fn() - self.t_start)
        self.maybe_retire(slot)

    def _count_decision(self, a_logits: Tensor, r_logits: Tensor) -> None:
        a, e = self.eng.count(a_logits, r_logits)
        # repro-lint: disable=RL004 -- one sync per ADMISSION for the prefill's counters
        agree, err = torch.stack([a[0].double(), e[0].double()]).cpu().tolist()
        self.agree_sum += agree
        self.err_sum += err
        self.decisions += 1

    def decode_step(self) -> None:
        """One decode step over all slots, then retirement and the runaway
        guard. The step's tokens (and counters) reach the host in ONE read."""
        eng = self.eng
        t0 = self.now_fn()
        nxt, logits, self.cache = eng.decode_main(self.cur, self.cache)
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
            if eng._ref:
                self.agree_sum += float(host[1, i])
                self.err_sum += float(host[2, i])
                self.decisions += 1
        self.cur = nxt[:, None]
        for i in active:
            self.maybe_retire(i)
        if self.max_steps is not None and self.steps >= self.max_steps:
            raise RuntimeError(
                f"serving run exceeded max_steps={self.max_steps} with "
                f"{self.n_active} live slots and {len(self.queue)} queued "
                "requests"
            )

    def retire(self, i: int, st: _Slot, by: str) -> None:
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
        self.cache = self.eng.decoder.reset_slot(self.cache, i)
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
        if eng.program is not None and delta:
            raise RuntimeError(
                f"serving run recorded {delta} programming events -- the "
                "programmed chip must never be rewritten by serving itself"
            )
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
            program_events_delta=delta,
            peak_kv_bytes=self.peak_kv_bytes,
        )
