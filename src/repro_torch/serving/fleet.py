"""Fleet serving: N programmed chips behind one router.

Port of ``repro.serving.fleet``. Everything below ``serving/fleet.py``
serves ONE programmed chip. A
production deployment of the paper's always-on accelerator is a *fleet*:
each PCM chip is self-contained model storage with its own write-noise
draw and its own drift clock, so chips are non-interchangeable replicas
with per-chip age/accuracy state -- the physical reality the measurement
papers (Xiao et al., Luquin et al.) report as chip-to-chip variation.

:class:`FleetRouter` owns N :class:`~repro_torch.serving.engine.ServingEngine`
instances -- N independent chip draws (:meth:`FleetRouter.build`:
``compile_program`` under distinct RNG keys) and/or replicas of one
cim-program v1 artifact (:meth:`FleetRouter.from_program`) -- and drives
one :class:`~repro_torch.serving.engine.EngineRun` per chip in a tick loop:

* **dispatch** -- arrived requests go to the least-loaded chip whose
  recent top-1 agreement (vs the digital reference) clears the fleet's
  ``agreement_slo``; if no chip clears it, least-loaded wins outright
  (availability beats the SLO -- the router must not deadlock traffic).
* **step** -- every up chip admits then decodes once (the same
  admit-then-decode order the single-engine loop uses, so a fleet of one
  chip is bit-identical to no fleet at all).
* **staggered refresh** -- at each health check (every ``check_every``
  ticks) a chip whose window agreement fell below ``refresh_below`` is
  *drained*: its in-flight requests migrate losslessly to sibling chips
  (a continuation request re-prefills from the already-generated stream,
  so the destination chip produces the bit-identical remainder it would
  have produced serving that stream from scratch), the chip sits out
  ``refresh_steps`` ticks (the modelled PCM write latency), is
  reprogrammed from the stored source weights (``steps.refresh_program``:
  fresh write noise, age reset to t_c), and rejoins. At most
  ``max_refreshing`` chips are ever down at once, so the fleet keeps
  serving -- :class:`FleetReport` records the worst aggregate-agreement
  window so a refresh storm can be *asserted* to never dip below the SLO.

Conservation is enforced, not hoped for: every submitted request retires
exactly once fleet-wide (eviction removes a request from its source run
*without* recording a retirement; the continuation retires on the
destination), and the router does the fleet-level programming-event
accounting the per-run assertion cannot (N engines share the global
event counter): the run's total event delta must equal exactly what its
refreshes consumed.

Keys follow the reference, through the RNG bridge (``repro_torch.prng``):
chip ``c`` of :meth:`FleetRouter.build` programs from ``fold_in(key, c)``
and its engine draws under ``fold_in(key, 10_000 + c)``, so the port's
chips are the reference's, bit for bit. On a card the N chips share it;
:meth:`FleetRouter.from_program` replicas share one chip's tensors (a
full-width chip holds ~18 GB of state), and a refresh allocates one new
chip for the refreshed replica alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch import prng
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import CiMProgram
from repro_torch.models.common import ModelConfig
from repro_torch.serving.config import DriftPolicy, FleetConfig, ServingConfig
from repro_torch.serving.engine import ServeReport, ServingEngine
from repro_torch.serving.requests import Request


@dataclasses.dataclass
class FleetRecord:
    """One request's fleet-level completion record.

    ``tokens`` is the full generated stream stitched across every chip
    that served the request (migration segments + the final chip's
    remainder); ``chips`` lists them in serving order, so
    ``migrations == len(chips) - 1``.
    """

    rid: int
    tokens: np.ndarray
    n_prompt: int
    chips: tuple[int, ...]
    arrival_t: float
    finish_t: float
    finished_by: str
    #: when the request's FIRST chip emitted its first token -- carried
    #: through migration, so ttft_s spans chips (0.0 on legacy records)
    first_token_t: float = 0.0

    @property
    def n_new(self) -> int:
        return int(self.tokens.size)

    @property
    def migrations(self) -> int:
        return len(self.chips) - 1

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.arrival_t

    @property
    def ttft_s(self) -> float:
        """Arrival to the first chip's first token (migration-aware)."""
        return self.first_token_t - self.arrival_t


@dataclasses.dataclass
class FleetReport:
    """What a fleet run produced: stitched records, per-chip reports,
    refresh events, and the SLO evidence."""

    records: list[FleetRecord]
    per_chip: list[ServeReport]
    events: list[dict]  # drain / reprogram / rejoin, in tick order
    #: one dict per health-check window with fleet-wide decisions
    #: (``{"tick", "top1", "decisions", "any_down"}``); ``any_down`` marks
    #: windows during which at least one chip was drained or refreshing --
    #: the windows the refresh-storm SLO claim is about
    windows: list[dict]
    counters: Optional[dict]
    n_chips: int
    n_ticks: int
    wall: float
    program_events_delta: int  # beyond what refreshes consumed: always 0

    @property
    def n_requests(self) -> int:
        return len(self.records)

    @property
    def n_generated(self) -> int:
        return sum(r.n_new for r in self.records)

    @property
    def n_migrated(self) -> int:
        return sum(1 for r in self.records if r.migrations)

    @property
    def reprograms(self) -> int:
        return sum(1 for e in self.events if e["kind"] == "reprogram")

    @property
    def tokens_per_s(self) -> float:
        return self.n_generated / max(self.wall, 1e-9)

    @property
    def window_agreements(self) -> list[float]:
        return [w["top1"] for w in self.windows]

    @property
    def min_window_agreement(self) -> Optional[float]:
        return min(self.window_agreements) if self.windows else None

    @property
    def min_down_window_agreement(self) -> Optional[float]:
        """Worst aggregate-agreement window *while a chip was down* --
        the refresh-storm SLO evidence (None if no chip ever went down)."""
        vals = [w["top1"] for w in self.windows if w["any_down"]]
        return min(vals) if vals else None

    def tokens_of(self, rid: int) -> np.ndarray:
        """Full stitched generation of one request (across migrations)."""
        for r in self.records:
            if r.rid == rid:
                return r.tokens
        raise KeyError(rid)

    def latency_s(self, pct: float) -> float:
        """Arrival-to-retirement latency percentile (seconds), fleet-wide."""
        if not self.records:
            return 0.0
        return float(np.percentile([r.latency_s for r in self.records], pct))

    def ttft_s(self, pct: float) -> float:
        """Time-to-first-token percentile (seconds), fleet-wide; a
        migrated request's TTFT is measured on its FIRST chip."""
        if not self.records:
            return 0.0
        return float(np.percentile([r.ttft_s for r in self.records], pct))

    def summary(self) -> str:
        line = (
            f"fleet: chips={self.n_chips} requests={self.n_requests} "
            f"tokens={self.n_generated} ticks={self.n_ticks} "
            f"tokens_per_s={self.tokens_per_s:.1f} "
            f"p95_ms={self.latency_s(95) * 1e3:.0f} "
            f"p95_ttft_ms={self.ttft_s(95) * 1e3:.0f} "
            f"migrated={self.n_migrated} reprograms={self.reprograms} "
            f"program_events_delta={self.program_events_delta}"
        )
        if self.min_window_agreement is not None:
            line += f" min_window_agreement={self.min_window_agreement:.4f}"
        if self.counters is not None:
            line += f" top1_agreement={self.counters['top1']:.4f}"
        return line


class FleetRouter:
    """One service over N programmed chips (see the module docstring).

    ``engines`` must be homogeneous (one :class:`ServingConfig` across the
    fleet -- migration relies on a continuation fitting any sibling's
    ``s_max``) and exactly ``fleet_cfg.n_chips`` of them. Refresh
    (``fleet_cfg.refresh_below`` or a forced drain) additionally needs
    every engine to carry ``src_params`` (the reprogramming source) and,
    for the agreement trigger, reference counters (``ref_params`` with
    ``config.ref_check``). ``rng`` (default ``PRNGKey(0)``) keys the
    refreshes; it is kept on the host, so the coordinator hands each chip's
    worker a host key.
    """

    def __init__(
        self,
        engines: list[ServingEngine],
        fleet_cfg: FleetConfig,
        *,
        rng: Optional[torch.Tensor] = None,
    ):
        if len(engines) != fleet_cfg.n_chips:
            raise ValueError(
                f"FleetConfig says n_chips={fleet_cfg.n_chips} but "
                f"{len(engines)} engines were given"
            )
        if len({e.config for e in engines}) != 1:
            raise ValueError(
                "fleet engines must share one ServingConfig -- migration "
                "re-prefills a continuation on any sibling, so every chip "
                "needs the same slots/s_max/paging geometry"
            )
        self.engines = engines
        self.fleet_cfg = fleet_cfg
        self.rng = (prng.PRNGKey(0) if rng is None else rng).cpu()

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        params: Any,
        analog_cfg: Any,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        fleet_cfg: FleetConfig,
        *,
        key: torch.Tensor,
        ref_params: Any = None,
        src_params: Any = None,
        mesh: Any = None,
        t_seconds: Optional[float] = None,
        b_adc_overrides: Any = None,
    ) -> "FleetRouter":
        """Program N independent chips from one weight checkpoint.

        Each chip is its own ``compile_program`` call under a distinct
        fold of ``key`` -- N physical write-noise draws of the same model,
        tagged ``chip_id=0..N-1``. ``src_params`` defaults to ``params``
        when a refresh policy is configured (the checkpoint IS the
        reprogramming source). The chips are programmed and served on the
        device ``params`` live on; with ``mesh`` every chip is TP-sharded
        over the same group (``launch.steps.program_for_serving(mesh=)``).
        """
        from repro_torch.launch import steps

        device = params.gain_s.device
        if src_params is None and fleet_cfg.refresh_below is not None:
            src_params = params
        engines = []
        for c in range(fleet_cfg.n_chips):
            program = steps.program_for_serving(
                params,
                analog_cfg,
                prng.fold_in(key, c),
                mesh=mesh,
                model_cfg=model_cfg,
                t_seconds=t_seconds,
                b_adc_overrides=b_adc_overrides,
                chip_id=c,
            )
            engines.append(
                ServingEngine.for_program(
                    program, model_cfg, serving_cfg,
                    ref_params=ref_params, src_params=src_params, mesh=mesh,
                    rng=prng.fold_in(key, 10_000 + c), device=device,
                )
            )
        return cls(engines, fleet_cfg, rng=key)

    @classmethod
    def from_program(
        cls,
        program: CiMProgram,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        fleet_cfg: FleetConfig,
        *,
        ref_params: Any = None,
        src_params: Any = None,
        mesh: Any = None,
        rng: Optional[torch.Tensor] = None,
    ) -> "FleetRouter":
        """N replicas of ONE compiled chip (e.g. a loaded v1 artifact).

        Replicas start bit-identical (same programmed draw) but keep
        independent drift clocks and refresh histories from there -- a
        refreshed replica reprograms under its own key and diverges, which
        is exactly the physical story of re-writing a chip. The replicas
        share the program's tensors, and the first replica's weights cast to
        the model's dtype (its digital reference's too): the others execute
        those same tensors, bitwise what their own cast would give. They
        serve on the device the program lives on; with ``mesh`` every
        replica is TP-sharded over the same group (a whole ``program`` is
        cut to this rank's shard first).
        """
        device = program.params.gain_s.device
        mesh = program.mesh if mesh is None else mesh
        if mesh is not None and program.mesh is None:
            from repro_torch.launch import steps

            program = engine_mod.shard_program(
                program, steps.use_mesh(mesh, model_cfg, program.params))
        engines: list[ServingEngine] = []
        for c in range(fleet_cfg.n_chips):
            first = engines[0] if engines else None
            engines.append(
                ServingEngine(
                    model_cfg, program.cfg,
                    first.params if first else program.params, serving_cfg,
                    program=dataclasses.replace(program, chip_id=c),
                    ref_params=first.ref_params if first else ref_params,
                    src_params=src_params, mesh=mesh, device=device,
                )
            )
        return cls(engines, fleet_cfg, rng=rng)

    # -- serving -----------------------------------------------------------

    def run(
        self,
        requests: list[Request],
        *,
        scheduler: Any = None,
        drift_policies: Optional[list[Optional[DriftPolicy]]] = None,
        force_refresh: Optional[dict[int, int]] = None,
        clock: Optional[clock_lib.Clock] = None,
        max_ticks: Optional[int] = None,
    ) -> FleetReport:
        """Serve ``requests`` across the fleet to completion.

        ``scheduler`` is the per-engine admission policy (default:
        bucketed for paged engines, else continuous). ``drift_policies``
        ages each chip on its own decode cadence (one policy, or one per
        chip; ``refresh_below`` must be unset on them -- fleet refresh is
        router-driven so in-flight work can migrate: set
        ``FleetConfig.refresh_below`` instead). ``force_refresh`` maps
        router tick -> chip index to drain at that tick regardless of
        agreement (the chaos hook the kill-a-chip tests use); a forced
        drain blocked by the stagger cap (or an already-down chip) is
        re-queued to the next eligible tick, not dropped.

        A thin wrapper over the async front end's deterministic driver
        (:meth:`~repro_torch.serving.async_fleet.AsyncFleetRouter.serve`
        with ``deterministic=True``): the single-threaded tick loop, which
        replays bit for bit under a virtual clock.
        """
        from repro_torch.serving.async_fleet import AsyncFleetRouter

        front = AsyncFleetRouter(
            self.engines, self.fleet_cfg, rng=self.rng, deterministic=True
        )
        return front.serve(
            requests,
            scheduler=scheduler,
            drift_policies=drift_policies,
            force_refresh=force_refresh,
            clock=clock,
            max_ticks=max_ticks,
        )
