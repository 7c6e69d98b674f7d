"""Serving configuration, port of ``repro.serving.config.ServingConfig``.

:class:`ServingConfig` (one engine: slots, per-slot capacity, the paged KV
cache and bucketed prefill, the digital-reference counters, fused decode),
:class:`FleetConfig` (N chips behind one router) and :class:`AsyncConfig`
(the threaded front end over a fleet). :class:`DriftPolicy` (the reference keeps it in ``serving/engine.py``) ages
the served chip on a decode-step cadence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.engine import DriftSchedule


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Age the served chip on a decode-step cadence inside ``run``.

    Every ``every_steps`` decode steps the engine advances the chip to the
    next age of ``schedule`` (the program is compiled at the schedule's
    first age). Ages are wall deployment times: after a refresh the device
    age is ``max(t_wall - t_refresh_wall, t_c)``. ``refresh_below``: when
    the top-1 agreement vs the digital reference over the segment since the
    last tick drops below it, the chip is reprogrammed from the engine's
    source weights before the next age applies.
    """

    schedule: DriftSchedule
    every_steps: int
    refresh_below: Optional[float] = None

    def __post_init__(self):
        if self.every_steps < 1:
            raise ValueError("DriftPolicy.every_steps must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Plain-value configuration of one ServingEngine.

    ``n_slots``: decode slots (the continuous-batching width). ``s_max``:
    per-slot capacity in tokens (prompt + budget); with ``paged=True`` it is
    virtual capacity and resident memory is the page pool.
    ``paged`` / ``page_size`` / ``n_pages``: switch the slot rectangles to
    the shared paged KV cache -- per-layer pools of ``page_size``-token
    pages, ``n_pages`` in all (page 0 is the reserved scratch page);
    ``n_pages=None`` sizes the pool to ``n_slots * ceil(s_max/page_size) +
    1``. ``prefill_buckets`` / ``prefill_batch``: bucketed prefill (paged
    mode) -- prompts are right-padded to the bucket grid (default geometric
    ``32*2^k`` up to ``s_max``), and ``prefill_batch`` same-bucket rows
    share one prefill call at the smallest bucket (proportionally fewer at
    larger buckets). ``ref_check``: run the digital-reference accuracy
    counters when the engine has ``ref_params``. ``fused_decode``: execute
    the whole programmed decode step as ONE kernel launch
    (``kernels/decode_fused.py``); it needs a compiled ``CiMProgram`` whose
    plans pass ``engine.build_fused_plan``, is bitwise the per-layer decode
    on the CPU, and does not compose with ``paged``.
    """

    n_slots: int
    s_max: int
    paged: bool = False
    page_size: int = 16
    n_pages: Optional[int] = None
    prefill_buckets: Optional[tuple] = None
    prefill_batch: int = 4
    ref_check: bool = True
    fused_decode: bool = False

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("need at least one decode slot")
        if self.fused_decode and self.paged:
            raise ValueError(
                "fused_decode writes the stacked per-slot KV cache inside "
                "one decode launch; it does not compose with the paged KV "
                "cache -- pick one"
            )
        if self.s_max < 1:
            raise ValueError(f"s_max must be >= 1, got {self.s_max}")
        if self.prefill_buckets is not None:
            object.__setattr__(
                self, "prefill_buckets",
                tuple(int(b) for b in self.prefill_buckets),
            )
        if self.paged:
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}"
                )
            if self.prefill_batch < 1:
                raise ValueError(
                    f"prefill_batch must be >= 1, got {self.prefill_batch}"
                )
            if self.n_pages is not None and self.n_pages < 2:
                raise ValueError(
                    f"need at least 2 pages (scratch + 1 usable), got "
                    f"{self.n_pages}"
                )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Configuration of a :class:`~repro_torch.serving.fleet.FleetRouter`.

    ``n_chips``
        Independently-programmed chips behind the router. Each chip is its
        own write-noise draw with its own drift clock -- chips are
        non-interchangeable replicas, which is exactly why the router
        tracks per-chip age/agreement state.
    ``agreement_slo``
        Aggregate top-1-agreement floor for the fleet (vs the digital
        reference). Admission prefers chips whose recent agreement clears
        the SLO, and the router records the worst aggregate window so a
        refresh storm can be *asserted* to never dip below it
        (``FleetReport.min_window_agreement``). ``None`` disables both.
    ``refresh_below``
        Per-chip refresh trigger: when one chip's agreement over the last
        health-check window drops below this, the router drains the chip
        (in-flight requests migrate losslessly to siblings), reprograms it
        from the stored source weights, and rejoins it with a reset drift
        clock. Requires the engines to run with reference counters.
    ``check_every``
        Router ticks between health checks (agreement windows, refresh
        triggers, SLO tracking).
    ``max_refreshing``
        Stagger width: at most this many chips may be down (draining /
        rewriting) at any moment, so the fleet never loses more than a
        known fraction of its capacity to refreshes. When refreshes are
        armed (``refresh_below`` set) this must leave at least one chip
        serving (``max_refreshing < n_chips``) -- otherwise a drain of
        the last healthy chip has nowhere to migrate its in-flight
        requests and dispatch dies mid-run.
    ``refresh_steps``
        Router ticks a chip stays out of rotation while its rewrite is in
        flight -- the modelled PCM write latency. Siblings carry the
        migrated load for the whole window; at the end the chip is
        reprogrammed (fresh write noise, age reset to t_c) and rejoins.
    """

    n_chips: int
    agreement_slo: Optional[float] = None
    refresh_below: Optional[float] = None
    check_every: int = 8
    max_refreshing: int = 1
    refresh_steps: int = 4

    def __post_init__(self):
        if self.n_chips < 1:
            raise ValueError(f"need at least one chip, got {self.n_chips}")
        if self.check_every < 1:
            raise ValueError(
                f"check_every must be >= 1, got {self.check_every}"
            )
        if self.max_refreshing < 1:
            raise ValueError(
                f"max_refreshing must be >= 1, got {self.max_refreshing}"
            )
        if self.refresh_steps < 0:
            raise ValueError(
                f"refresh_steps must be >= 0, got {self.refresh_steps}"
            )
        for name in ("agreement_slo", "refresh_below"):
            v = getattr(self, name)
            if v is not None and not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"{name} is a top-1-agreement fraction in [0, 1], "
                    f"got {v}"
                )
        if self.refresh_below is not None and self.max_refreshing >= self.n_chips:
            raise ValueError(
                f"max_refreshing={self.max_refreshing} with "
                f"n_chips={self.n_chips} would allow every chip to drain at "
                f"once, leaving migrated requests nowhere to go -- "
                f"max_refreshing must be < n_chips when refreshes are armed"
            )


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Configuration of the async fleet front end.

    (:class:`~repro_torch.serving.async_fleet.AsyncFleetRouter` -- the threaded
    serving layer over a fleet of chips.)

    ``queue_cap``
        Fleet-wide queued-work cap: the number of accepted-but-not-yet-
        admitted requests (admission queue + per-chip engine queues +
        dispatched-but-unprocessed submissions) at which ``submit`` /
        ``submit_stream`` applies backpressure.
    ``shed_policy``
        What backpressure does: ``"block"`` makes submit wait until work
        drains below the cap (bounded by ``submit_timeout_s`` when set);
        ``"shed"`` raises :class:`~repro_torch.serving.async_fleet.QueueFull`
        immediately.
    ``workers``
        Decode worker threads. ``None`` (default) gives every chip its
        own worker (and, on a card, its own CUDA stream) -- the most decode
        overlap the interpreter lock allows. Fewer workers than chips round-robins
        chips across workers (chip ``c`` is owned by worker
        ``c % workers``); each chip is still owned by exactly one worker,
        which is the fleet's whole thread-safety story.
    ``submit_timeout_s``
        With ``shed_policy="block"``: how long a blocked submit waits for
        capacity before raising ``QueueFull``. ``None`` waits forever.
    ``poll_s``
        Idle poll cadence for workers with no admissible work and for the
        coordinator between bookkeeping ticks. Real-clock threads only;
        the deterministic driver paces itself off the injected clock.
    """

    queue_cap: int = 64
    shed_policy: str = "block"
    workers: Optional[int] = None
    submit_timeout_s: Optional[float] = None
    poll_s: float = 1e-3

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.shed_policy not in ("block", "shed"):
            raise ValueError(
                f"shed_policy must be 'block' or 'shed', got "
                f"{self.shed_policy!r}"
            )
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.submit_timeout_s is not None and self.submit_timeout_s < 0:
            raise ValueError(
                f"submit_timeout_s must be >= 0, got {self.submit_timeout_s}"
            )
        if self.poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")
