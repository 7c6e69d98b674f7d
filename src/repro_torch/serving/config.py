"""Serving configuration, port of ``repro.serving.config.ServingConfig``.

The fields ported so far: slot count, per-slot capacity, the paged KV
cache and bucketed prefill, whether the digital-reference counters run, and
fused decode. The fleet settings arrive with their slice.
:class:`DriftPolicy` (the reference keeps it in ``serving/engine.py``) ages
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
